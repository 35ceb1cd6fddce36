"""Share of the traced window in which no device operation ran, %."""

from portbench import readers


def read(run):
    return readers.device_idle_share(run)
