"""The 3x3 convolution kernels (forward, input and filter gradients), in a
cell that sends the autoencoder's 3x3 stride-1 convolutions to them: the
least time of those calls at the cell's shapes over the device time of
kernels named ``conv3x3`` (percent of their roofline)."""

from benchmark.work import readers


def read(run):
    return readers.roofline(run, ("conv3x3",), "conv3x3_bound_s")
