"""Percent of the training loader's batch requests in the window (the
program's ``loader.wait`` spans outside ``val.epoch``) that found its
prefetch queue empty (``benchmark/work/program_spans.py``)."""

from benchmark.work import program_spans


def read(run):
    found = program_spans.spans(run)
    return None if not found else program_spans.starved_share(found, run.window_ns)
