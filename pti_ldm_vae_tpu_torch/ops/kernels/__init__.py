"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``groupnorm_silu``: Triton GroupNorm+SiLU forward (replaces
  ``pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py:_forward``)
- ``flash_attention``: CUDA C++ flash-attention forward, ``csrc/flash_attention.cu``
  (replaces ``pti_ldm_vae_tpu/ops/pallas/flash_attention.py:_forward``)

Each wrapper launches its kernel for CUDA tensors and counts the launch in
``<wrapper>.launches``; for CPU tensors it runs the plain version.
"""

from .flash_attention import flash_attention, flash_attention_plain
from .groupnorm_silu import groupnorm_silu, groupnorm_silu_plain

KERNELS = (groupnorm_silu, flash_attention)

__all__ = [
    "KERNELS",
    "flash_attention",
    "flash_attention_plain",
    "groupnorm_silu",
    "groupnorm_silu_plain",
    "reset_launch_counts",
]


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for kernel in KERNELS:
        kernel.launches = 0
