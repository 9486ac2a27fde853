"""Percent of device time in PyTorch's own operations (elementwise,
reductions, copies, casts, pooling, the fused optimizer): neither the port's
hand kernels nor cuDNN / cuBLAS. Classes in ``benchmark/work/kernels.py``."""

from benchmark.work import readers


def read(run):
    return readers.glue_share(run)
