"""Median time of a scan from its submission to its transform on the
host, over every scan of the window, ms."""

from portbench import readers


def read(run):
    return readers.scan_latency_ms(run, 50)
