"""PatchGAN discriminator in PyTorch with MONAI parameter names (counterpart
of ``pti_ldm_vae_tpu/models/discriminator.py``; ``spatial_dims`` 1, 2 and 3).

Equivalent of MONAI ``PatchDiscriminator(num_layers_d=3, channels=32,
in_channels=1, out_channels=1, norm="INSTANCE")`` as the reference builds it
(``vae_scripts/train_vae.py:268-275``): a pix2pix-style 70x70 PatchGAN — 4x4
convolutions with padding 1, LeakyReLU(0.2), InstanceNorm on the middle
layers, channels doubling per level, strides 2, 2, 2, 1, 1 at the default
depth; biases only on the first and the last convolution. ``forward`` returns
the list of per-layer feature maps; training reads only the final logits map
``[-1]``, which is f32.

Parameters sit under MONAI's names (``initial_conv.conv``, ``0.conv`` ...
``{num_layers_d-1}.conv``, ``final_conv.conv``), so a reference discriminator
``.pth`` loads with ``strict=True``. Convolution weights start from the
pix2pix ``normal(0, 0.02)`` of MONAI's ``initialise_weights``, biases from 0,
drawn from an explicit ``torch.Generator``.

Tensors are channel-last ([B, *spatial, C]) at the module's boundary and
between layers; a convolution views its input as channels-first as the
autoencoder's do (``nn.Conv{1,2,3}d`` parameters, cuDNN).

Under tensor sharding (``parallel/tensor.py``) a layer with a sharded weight
computes its block of output channels from the gathered input, the
InstanceNorm runs per channel on the block, and the last layer (one output
channel, replicated) gathers its input: the logits are whole on every rank.
Under spatial sharding the discriminator runs on the gathered full-height
images (``train/steps.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import instance_norm
from ..parallel.tensor import channels_in, tensor
from .autoencoder_kl import conv_channel_last

__all__ = ["PatchDiscriminator"]


class _Conv(nn.Module):
    """One 4x4 convolution under MONAI's ``.conv`` segment."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int, bias: bool,
                 spatial_dims: int):
        super().__init__()
        conv = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}[spatial_dims]
        self.conv = conv(cin, cout, kernel_size, stride=stride, padding=1, bias=bias)


class PatchDiscriminator(nn.Module):
    def __init__(
        self,
        spatial_dims: int = 2,
        num_layers_d: int = 3,
        channels: int = 32,
        in_channels: int = 1,
        out_channels: int = 1,
        kernel_size: int = 4,
        negative_slope: float = 0.2,
        compute_dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if spatial_dims not in (1, 2, 3):
            raise ValueError(f"spatial_dims must be 1, 2, or 3, got {spatial_dims}")
        self.num_layers_d = num_layers_d
        self.negative_slope = negative_slope
        self.compute_dtype = compute_dtype
        self.initial_conv = _Conv(in_channels, channels, kernel_size, 2, bias=True,
                                  spatial_dims=spatial_dims)
        ch = channels
        # strided middle layers "0" .. "n-2", then the stride-1 penultimate "n-1"
        for layer in range(num_layers_d):
            stride = 2 if layer < num_layers_d - 1 else 1
            self.add_module(str(layer), _Conv(ch, ch * 2, kernel_size, stride, bias=False,
                                              spatial_dims=spatial_dims))
            ch *= 2
        self.final_conv = _Conv(ch, out_channels, kernel_size, 1, bias=True,
                                spatial_dims=spatial_dims)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Convolution weights ~ normal(0, 0.02), biases 0."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("weight"):
                    p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
                else:
                    p.zero_()

    def _apply_conv(self, block: _Conv, h: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        conv = block.conv
        if tensor():
            h = channels_in(h, conv.in_channels, partitioned=conv.weight.shape[0] != conv.out_channels)
        bias = None if conv.bias is None else conv.bias.to(cd)
        return conv_channel_last(h, conv.weight.to(cd), bias, conv.stride, conv.padding)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        slope = self.negative_slope
        features: list[torch.Tensor] = []
        h = F.leaky_relu(self._apply_conv(self.initial_conv, x.to(self.compute_dtype)), slope)
        features.append(h)
        for layer in range(self.num_layers_d):
            h = self._apply_conv(getattr(self, str(layer)), h)
            h = F.leaky_relu(instance_norm(h), slope)
            features.append(h)
        features.append(self._apply_conv(self.final_conv, h).float())
        return features
