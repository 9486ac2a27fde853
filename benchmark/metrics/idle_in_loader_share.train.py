"""Percent of the window in which the device idled while the program's
innermost open span was ``loader.wait``: the trainer waiting on its loader's
prefetch queue, outside validation (``benchmark/work/program_spans.py``)."""

from benchmark.work import program_spans


def read(run):
    split = program_spans.idle_split(run)
    return None if split is None else split["loader"]
