"""Pairs registered per second: pairs whose results reached the host
inside the window and passed the 2 degree / 0.25 gate, over the window."""

from portbench import readers


def read(run):
    return readers.pairs_per_s(run)
