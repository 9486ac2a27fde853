"""Helpers for loss computations (counterpart of
``pti_ldm_vae_tpu/utils/losses.py``; NHWC)."""

from __future__ import annotations

import torch

__all__ = ["ensure_three_channels"]


def ensure_three_channels(x: torch.Tensor) -> torch.Tensor:
    """An NHWC batch with three channels for ImageNet backbones: single-channel
    inputs are repeated channel-wise, 3-channel inputs pass through, anything
    else is an error."""
    if x.dim() != 4:
        raise ValueError(f"Expected 4D NHWC tensor, got shape {tuple(x.shape)}")
    channels = x.shape[-1]
    if channels == 3:
        return x
    if channels == 1:
        return x.expand(*x.shape[:-1], 3)
    raise ValueError(f"expected 1 or 3 channels, got {channels}")
