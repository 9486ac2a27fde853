"""Multi-head self-attention over projected token tensors (counterpart of
``pti_ldm_vae_tpu/ops/attention.py``).

Every call goes through the flash-attention kernels on CUDA, forward and
backward (``ops/kernels/flash_attention.py``), whose plain versions run on
the CPU.
"""

from __future__ import annotations

import torch

from .kernels.flash_attention import flash_attention

__all__ = ["multi_head_attention", "attention_flops"]


def multi_head_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int
) -> torch.Tensor:
    """Attention over [B, S, C] tensors (already projected), scale
    1/sqrt(head_dim), softmax in f32."""
    b, s, c = q.shape
    if c % num_heads:
        raise ValueError(f"hidden size {c} not divisible by num_heads {num_heads}")
    head_dim = c // num_heads

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, s, num_heads, head_dim).transpose(1, 2).contiguous()

    out = flash_attention(heads(q), heads(k), heads(v))
    return out.transpose(1, 2).reshape(b, s, c)


def attention_flops(batch: int, seq: int, channels: int) -> int:
    """FLOPs of one self-attention (scores + weighted sum), for rooflines."""
    return 2 * 2 * batch * seq * seq * channels
