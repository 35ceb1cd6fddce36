"""Share of the batch sides whose upload the program's identity memo
served: hits over hits and uploads in the window."""

from portbench import readers


def read(run):
    return readers.memo_hit_share(run)
