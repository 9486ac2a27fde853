"""Peak device memory allocated in the window (GB), reset at its start."""

from benchmark.work import readers


def read(run):
    return readers.peak_gb(run)
