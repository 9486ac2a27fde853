"""Flash-attention kernels, forward and backward: the least time of the
reference's attention calls at the cell's shapes (4 B S^2 D operations
forward, 2.5 times that backward) over the device time of kernels named
``flash_`` (percent of their roofline)."""

from benchmark.work import readers


def read(run):
    return readers.roofline(run, ("flash_",), "flash_bound_s")
