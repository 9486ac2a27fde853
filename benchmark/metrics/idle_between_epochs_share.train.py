"""Percent of the window in which the device idled while the program was
between epochs: its own ``val.epoch`` (the whole of ``validate``) or
``train.epoch_end`` (triplet panel, debug print, metric flush) span was the
outermost one open. From the program's spans on the device trace's clock
(``benchmark/work/program_spans.py``)."""

from benchmark.work import program_spans


def read(run):
    split = program_spans.idle_split(run)
    return None if split is None else split["between_epochs"]
