"""Model FLOPs (counted on the plain reference at the cell's shapes) of the
window's work over its seconds, percent of the card's dense peak."""

from benchmark.work import readers


def read(run):
    return readers.mfu(run)
