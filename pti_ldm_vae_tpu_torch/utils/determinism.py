"""Determinism: seed the host RNGs and return an explicit ``torch.Generator``
(counterpart of ``pti_ldm_vae_tpu/utils/determinism.py``, which returns a JAX
PRNG key). Device-side randomness takes the returned generator explicitly."""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["set_determinism"]


def set_determinism(seed: int | None = 42, device: torch.device | str = "cpu") -> torch.Generator:
    """Seed python / numpy / torch; returns a generator on ``device`` seeded
    with ``seed``."""
    if seed is None:
        seed = 0
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)
