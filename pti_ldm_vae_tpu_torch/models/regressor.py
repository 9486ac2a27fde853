"""Latent regression head + frozen-VAE wrapper (counterpart of
``pti_ldm_vae_tpu/models/regressor.py``).

* ``LatentRegressor``: MLP ``[in, *hidden, out]``, activation in {relu,
  gelu (exact erf), leaky_relu (slope 0.01), elu}, optional dropout. ``mlp``
  is an ``nn.Sequential`` of Linear, activation[, dropout] per hidden layer
  and the output Linear, so ``state_dict()`` keys are the reference head
  files' ``mlp.{i}.weight`` / ``mlp.{i}.bias``. Dropout draws its keep-mask
  from an explicit ``torch.Generator`` and scales kept entries by
  ``1 / (1 - rate)`` (Flax ``nn.Dropout``); initialization is Flax
  ``nn.Dense``'s (lecun-normal kernels, zero biases) from a seeded generator.
* ``VAELatentRegressor``: the frozen AutoencoderKL's deterministic encode,
  run without autograd, flattened, into the head: no gradient and no
  backward kernel reach the VAE.
* ``infer_flat_dim_from_patch``: the flattened latent size from the encoder's
  downsampling arithmetic, without a forward pass.

Latents are flattened in channel-major (NCHW) order so reference head weights
stay valid.
"""

from __future__ import annotations

import math
import warnings
from typing import Sequence

import torch
from torch import nn

from .autoencoder_kl import AutoencoderKL, Downsample

__all__ = ["LatentRegressor", "VAELatentRegressor", "GeneratorDropout", "flatten_latent",
           "infer_flat_dim_from_patch"]

_ACTIVATIONS = {
    "relu": nn.ReLU,
    "gelu": nn.GELU,  # exact erf form
    "leaky_relu": lambda: nn.LeakyReLU(0.01),
    "elu": nn.ELU,
}
# Flax lecun_normal: variance 1 / fan_in of a normal truncated to [-2, 2],
# whose own standard deviation is this constant
_TRUNC_STD = 0.87962566103423978


def flatten_latent(latent: torch.Tensor) -> torch.Tensor:
    """Channel-last latent [B, *spatial, C] -> [B, C * prod(spatial)] in
    channel-major order (``torch.flatten`` of the NCHW latent). ``reshape``
    copies where needed: the encoder's output sits in ``channels_last``
    memory, where a ``view`` of the permuted tensor raises."""
    if latent.ndim > 2:
        latent = latent.permute(0, latent.ndim - 1, *range(1, latent.ndim - 1))
    return latent.reshape(latent.shape[0], -1)


class GeneratorDropout(nn.Module):
    """Dropout whose keep-mask comes from an explicit generator
    (``rand >= rate``), kept entries scaled by ``1 / (1 - rate)``; the
    identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def _lecun_normal_(linear: nn.Linear, generator: torch.Generator | None) -> None:
    std = math.sqrt(1.0 / linear.in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)
        linear.bias.zero_()


class LatentRegressor(nn.Module):
    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (), output_dim: int = 1,
                 dropout: float = 0.0, activation: str = "relu",
                 generator: torch.Generator | None = None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f"Unsupported activation: {activation}. Choose from {', '.join(_ACTIVATIONS)}."
            )
        if output_dim <= 0:
            raise ValueError("output_dim must be positive.")
        layers: list[nn.Module] = []
        width = input_dim
        for hidden in hidden_dims:
            layers += [nn.Linear(width, hidden), _ACTIVATIONS[activation]()]
            if dropout > 0:
                layers.append(GeneratorDropout(dropout))
            width = hidden
        layers.append(nn.Linear(width, output_dim))
        self.mlp = nn.Sequential(*layers)
        for layer in self.mlp:
            if isinstance(layer, nn.Linear):
                _lecun_normal_(layer, generator)

    def forward(self, latent_flat: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = latent_flat
        for layer in self.mlp:
            h = layer(h, generator) if isinstance(layer, GeneratorDropout) else layer(h)
        return h


class VAELatentRegressor(nn.Module):
    """Frozen VAE encoder + trainable MLP head. Only ``regressor``'s
    parameters take gradients; ``encode_flat`` runs under ``torch.no_grad()``
    (not ``inference_mode``: its output feeds a Linear whose weight gradient
    saves it for backward)."""

    FLATTEN_WARNING_THRESHOLD = 131072  # reference ``regression_head.py:90``

    def __init__(self, vae: AutoencoderKL, regressor: LatentRegressor, *, latent_dim: int):
        super().__init__()
        self.vae = vae.requires_grad_(False)
        self.regressor = regressor
        self.latent_dim = latent_dim
        if latent_dim > self.FLATTEN_WARNING_THRESHOLD:
            warnings.warn(
                f"Flattened latent dimension {latent_dim} is large; consider "
                "reducing patch size or latent channels.",
                stacklevel=2,
            )

    def encode_flat(self, images: torch.Tensor) -> torch.Tensor:
        """Frozen deterministic encode + flatten (no gradient into the VAE)."""
        with torch.no_grad():
            return flatten_latent(self.vae.encode_deterministic(images))

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.regressor(self.encode_flat(images), generator)


def infer_flat_dim_from_patch(vae: AutoencoderKL, patch_size, *, channels: int | None = None) -> int:
    """Flattened latent size for a patch of the VAE's spatial rank (``(H, W)``,
    ``(D, H, W)`` or ``(L,)``), from the encoder's arithmetic: each
    downsample, a (0, 1) pad and a 3x3 stride-2 convolution, halves a side
    rounding down; the latent has ``latent_channels`` channels."""
    stem = vae.encoder.blocks[0].conv
    if channels is not None and channels != stem.in_channels:
        raise ValueError(f"the encoder takes {stem.in_channels} input channels, not {channels}")
    spatial = [int(s) for s in patch_size]
    if len(spatial) != vae.spatial_dims:
        raise ValueError(f"a patch of {vae.spatial_dims} spatial axes for this VAE, got "
                         f"{tuple(patch_size)}")
    for _ in range(sum(isinstance(b, Downsample) for b in vae.encoder.blocks)):
        spatial = [s // 2 for s in spatial]
    return vae.quant_conv_mu.conv.out_channels * math.prod(spatial)
