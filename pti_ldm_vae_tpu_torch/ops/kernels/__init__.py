"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``groupnorm_silu``: CUDA C++ GroupNorm+SiLU forward and backward, one
  thread-block-cluster launch each, ``csrc/groupnorm_silu_fwd.cu`` and
  ``csrc/groupnorm_silu_bwd.cu`` (replace
  ``pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py``: ``_forward`` and both
  kernels of ``_bwd_pallas``)
- ``flash_attention``: CUDA C++ flash-attention forward and backward,
  ``csrc/flash_attention_wgmma.cu`` and ``csrc/flash_attention_bwd_wgmma.cu``
  (bf16, tensor cores, head dims up to 128),
  ``csrc/flash_attention_wide_wgmma.cu`` and
  ``csrc/flash_attention_bwd_wide_wgmma.cu`` (bf16, tensor cores, above) and
  ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` (f32 FMAs)
  (replace
  ``pti_ldm_vae_tpu/ops/pallas/flash_attention.py``: ``_forward`` and
  ``_bwd_pallas``)
- ``conv3x3``: CUDA C++ 3x3 stride-1 SAME convolution, forward and input
  gradient ``csrc/conv3x3_wgmma.cu`` / ``csrc/conv3x3.cu`` and filter
  gradient ``csrc/conv3x3_wgrad_wgmma.cu`` / ``csrc/conv3x3_wgrad.cu`` (bf16
  tensor cores / f32 FMAs) (replace ``pti_ldm_vae_tpu/ops/pallas/conv2d.py``:
  ``_conv3x3_fwd_pallas`` and ``_conv3x3_dw_pallas``)

Each wrapper is differentiable (a ``torch.autograd.Function``), launches its
kernels for CUDA tensors and counts the launches; for CPU tensors it runs the
plain versions. ``launch_counts()`` reads the six counts by kernel name,
``reset_launch_counts()`` sets them to 0.
"""

from .conv3x3 import conv3x3, conv3x3_bwd_plain, conv3x3_plain
from .flash_attention import flash_attention, flash_attention_bwd_plain, flash_attention_plain
from .groupnorm_silu import groupnorm_silu, groupnorm_silu_bwd_plain, groupnorm_silu_plain

# kernel name -> (wrapper, the attribute that counts its launches)
COUNTERS = {
    "groupnorm_silu": (groupnorm_silu, "launches"),
    "groupnorm_silu_bwd": (groupnorm_silu, "bwd_launches"),
    "flash_attention": (flash_attention, "launches"),
    "flash_attention_bwd": (flash_attention, "bwd_launches"),
    "conv3x3": (conv3x3, "launches"),
    "conv3x3_wgrad": (conv3x3, "wgrad_launches"),
}

__all__ = [
    "COUNTERS",
    "conv3x3",
    "conv3x3_bwd_plain",
    "conv3x3_plain",
    "flash_attention",
    "flash_attention_bwd_plain",
    "flash_attention_plain",
    "groupnorm_silu",
    "groupnorm_silu_bwd_plain",
    "groupnorm_silu_plain",
    "launch_counts",
    "reset_launch_counts",
]


def launch_counts() -> dict[str, int]:
    """Launches of every kernel since the last reset, by kernel name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0, and the padded and the wide
    flash-attention launches (``flash_attention.padded_launches``,
    ``wide_launches``, ``wide_bwd_launches``: shares of its two counts) and
    the convolution's FMA and padded launches (``conv3x3.fma_launches``,
    ``padded_launches``: shares of ``conv3x3.launches``)."""
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)
    flash_attention.padded_launches = 0
    flash_attention.wide_launches = 0
    flash_attention.wide_bwd_launches = 0
    conv3x3.fma_launches = 0
    conv3x3.padded_launches = 0
