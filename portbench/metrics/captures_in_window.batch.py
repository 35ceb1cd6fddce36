"""Programs the port captured inside the window (0: set-up captured
every key the cell uses)."""

from portbench import readers


def read(run):
    return readers.captures_in_window(run)
