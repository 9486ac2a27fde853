"""Percent of the window in which no operation ran on the device (device-only
trace)."""

from benchmark.work import readers


def read(run):
    return readers.idle_share(run)
