"""Mean iteration count of the window's pairs."""

from portbench import readers


def read(run):
    return readers.iterations_per_pair(run)
