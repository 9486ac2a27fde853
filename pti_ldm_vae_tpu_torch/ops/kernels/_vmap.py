"""Pieces shared by the kernels' ``torch.func.vmap`` rules.

Under ``torch.func.vmap`` (and ``torch.func.grad``) a kernel's wrapper sees
the transforms' wrapper tensors, which have no data pointer; its
``torch.autograd.Function`` then runs, and the Function's ``vmap``
staticmethod hands the kernels plain tensors: the vmapped axis folded into
the batch (one launch for all images) where every image shares the weight,
one launch per image where each image has its own copy.
"""

from __future__ import annotations

import torch
from torch._C._functorch import is_functorch_wrapped_tensor

__all__ = ["fold", "front", "transformed", "unfold"]


def transformed(*tensors: torch.Tensor | None) -> bool:
    """Whether any of ``tensors`` is a ``torch.func`` transform's wrapper."""
    return any(isinstance(t, torch.Tensor) and is_functorch_wrapped_tensor(t) for t in tensors)


def front(t: torch.Tensor, dim: int | None, size: int) -> torch.Tensor:
    """``t`` with its vmapped axis first: moved there, or ``t`` broadcast to
    ``size`` copies where it has none."""
    if dim is None:
        return t.unsqueeze(0).expand(size, *t.shape)
    return t.movedim(dim, 0)


def fold(t: torch.Tensor) -> torch.Tensor:
    """``[V, B, ...]`` as the contiguous batch ``[V*B, ...]``."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:]).contiguous()


def unfold(t: torch.Tensor, size: int) -> torch.Tensor:
    """``[V*B, ...]`` back to ``[V, B, ...]``."""
    return t.reshape(size, t.shape[0] // size, *t.shape[1:])
