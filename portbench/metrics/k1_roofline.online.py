"""K1 (the neighbourhood thresholds) at its least time over its
profiled time in the traced window, %; the count is
``kernel_counts.k1_work``."""

from portbench import readers


def read(run):
    return readers.k1_roofline(run)
