"""K4 (the correspondence match) at its least time over its profiled
time in the traced window, %; the count is ``kernel_counts.k4_work``."""

from portbench import readers


def read(run):
    return readers.k4_roofline(run)
