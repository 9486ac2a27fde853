"""Share of the window the host spent waiting on the program's loader: the
benchmark's span around each batch request of the entry (percent)."""

from benchmark.work import readers


def read(run):
    return readers.span_share(run, "loader_wait")
