"""Classes of device operations by name, for the shares of device time.

Hand-written: the port's own CUDA kernels (GroupNorm+SiLU, flash attention,
3x3 convolutions). Library: cuDNN's and cuBLAS's convolution and product
kernels. Everything else is PyTorch's own glue: elementwise, reductions,
copies and casts, pooling, the fused optimizer, memory copies and sets."""

HAND = ("groupnorm_silu", "flash_", "conv3x3")
LIBRARY = ("cudnn", "xmma", "cutlass", "gemm", "nvjet", "cublas", "implicit_convolve",
           "fprop", "dgrad", "wgrad", "winograd", "fft", "convolve", "nchwtonhwc", "nhwctonchw")


def kind(name: str) -> str:
    low = name.lower()
    if any(k in low for k in HAND):
        return "hand"
    if any(k in low for k in LIBRARY):
        return "library"
    return "glue"


def device_s(kernels, *words: str) -> float:
    """Seconds of the operations whose name holds one of ``words``."""
    return sum(end - start for name, start, end in kernels if any(w in name for w in words)) / 1e9
