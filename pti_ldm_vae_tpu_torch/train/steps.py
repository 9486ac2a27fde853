"""Inference step (counterpart of ``pti_ldm_vae_tpu/train/steps.py:make_inference_fn``).

Training steps come with the backward kernels in a later part of the port.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.autoencoder_kl import AutoencoderKL

__all__ = ["make_inference_fn"]


def make_inference_fn(model: AutoencoderKL) -> Callable[[np.ndarray | torch.Tensor], torch.Tensor]:
    """Deterministic encode->decode (reference ``reconstruct_deterministic``,
    ``autoencoder.py:153-163``): NHWC images in, f32 NHWC reconstruction out,
    on the model's device."""
    device = next(model.parameters()).device

    def reconstruct(images: np.ndarray | torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(images).to(device, non_blocking=True)
            return model.reconstruct_deterministic(x)

    return reconstruct
