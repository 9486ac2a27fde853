"""GroupNorm+SiLU kernels: the least time of every call the reference makes
at the cell's shapes over the device time of kernels named ``groupnorm_silu``
(percent of their roofline)."""

from benchmark.work import readers


def read(run):
    return readers.roofline(run, ("groupnorm_silu",), "gn_silu_bound_s")
