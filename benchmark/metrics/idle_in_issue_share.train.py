"""Percent of the window in which the device idled while the program's
innermost open span was ``train.step`` outside its copy: the host issuing a
step's forward, backward and Adam (``benchmark/work/program_spans.py``)."""

from benchmark.work import program_spans


def read(run):
    split = program_spans.idle_split(run)
    return None if split is None else split["issue"]
