"""Plain AutoencoderKL (MONAI 1.5.1 ``AutoencoderKL``, the architecture of the
configurations' ``autoencoder_def``), written from the published layout:
parameters under MONAI's state-dict names, activations NCHW.

encoder: conv_in 3x3 -> per level {num_res_blocks x ResBlock (GroupNorm ->
SiLU -> conv3x3, twice; 1x1 skip on a channel change) [+ attention]} ->
(0,1)-pad + 3x3 stride-2 conv between levels -> [ResBlock, attention,
ResBlock] -> GroupNorm -> SiLU -> conv3x3 to the latent channels; 1x1
convolutions give mu and a log-variance clamped to [-30, 20], sigma =
exp(logvar / 2), z = mu + eps * sigma; the decoder mirrors it with nearest x2
upsampling + conv3x3. Attention blocks: GroupNorm (no SiLU), one head over
the H*W tokens, q/k/v/out projections, residual add.
"""

from __future__ import annotations

from typing import Iterator

import torch
import torch.nn.functional as F

from .ops import Ops

LOGVAR_MIN, LOGVAR_MAX = -30.0, 20.0


def _levels(ae: dict) -> tuple[list[int], list[int], list[bool]]:
    channels = list(ae["channels"])
    nrb = ae.get("num_res_blocks", 2)
    nrb = [nrb] * len(channels) if isinstance(nrb, int) else list(nrb)
    attn = ae.get("attention_levels") or [False] * len(channels)
    return channels, nrb, list(attn)


def _encoder_blocks(ae: dict) -> list[tuple]:
    """(kind, *sizes) in MONAI's order."""
    channels, nrb, attn = _levels(ae)
    blocks: list[tuple] = [("conv3", ae["in_channels"], channels[0])]
    cin = channels[0]
    for level, ch in enumerate(channels):
        for _ in range(nrb[level]):
            blocks.append(("res", cin, ch))
            cin = ch
            if attn[level]:
                blocks.append(("attn", ch))
        if level != len(channels) - 1:
            blocks.append(("down", ch))
    if ae.get("with_encoder_nonlocal_attn", True):
        blocks += [("res", cin, cin), ("attn", cin), ("res", cin, cin)]
    return blocks + [("gn", cin), ("conv3", cin, ae["latent_channels"])]


def _decoder_blocks(ae: dict) -> list[tuple]:
    channels, nrb, attn = _levels(ae)
    channels, nrb, attn = channels[::-1], nrb[::-1], attn[::-1]
    cin = channels[0]
    blocks: list[tuple] = [("conv3", ae["latent_channels"], cin)]
    if ae.get("with_decoder_nonlocal_attn", True):
        blocks += [("res", cin, cin), ("attn", cin), ("res", cin, cin)]
    for level, ch in enumerate(channels):
        for _ in range(nrb[level]):
            blocks.append(("res", cin, ch))
            cin = ch
            if attn[level]:
                blocks.append(("attn", ch))
        if level != len(channels) - 1:
            blocks.append(("up", ch))
    return blocks + [("gn", cin), ("conv3", cin, ae["out_channels"])]


def _block_params(prefix: str, block: tuple) -> Iterator[tuple[str, tuple[int, ...], str]]:
    """(name, shape, role) of a block's parameters; role is ``conv``, ``linear``,
    ``norm_w``, ``norm_b`` or ``bias`` (``logvar``: the log-variance projection)."""
    kind = block[0]

    def conv(name: str, cin: int, cout: int, k: int):
        yield f"{name}.weight", (cout, cin, k, k), "conv"
        yield f"{name}.bias", (cout,), "bias"

    def norm(name: str, c: int):
        yield f"{name}.weight", (c,), "norm_w"
        yield f"{name}.bias", (c,), "norm_b"

    if kind == "conv3":
        yield from conv(f"{prefix}.conv", block[1], block[2], 3)
    elif kind in ("down", "up"):
        yield from conv(f"{prefix}.conv.conv", block[1], block[1], 3)
    elif kind == "gn":
        yield from norm(prefix, block[1])
    elif kind == "res":
        cin, cout = block[1], block[2]
        yield from norm(f"{prefix}.norm1", cin)
        yield from conv(f"{prefix}.conv1.conv", cin, cout, 3)
        yield from norm(f"{prefix}.norm2", cout)
        yield from conv(f"{prefix}.conv2.conv", cout, cout, 3)
        if cin != cout:
            yield from conv(f"{prefix}.nin_shortcut.conv", cin, cout, 1)
    elif kind == "attn":
        c = block[1]
        yield from norm(f"{prefix}.norm", c)
        for proj in ("to_q", "to_k", "to_v", "out_proj"):
            yield f"{prefix}.attn.{proj}.weight", (c, c), "linear"
            yield f"{prefix}.attn.{proj}.bias", (c,), "bias"


def param_spec(ae: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """Every parameter of the autoencoder: (MONAI name, shape, role)."""
    spec: list[tuple[str, tuple[int, ...], str]] = []
    for side, blocks in (("encoder", _encoder_blocks(ae)), ("decoder", _decoder_blocks(ae))):
        for i, block in enumerate(blocks):
            spec += list(_block_params(f"{side}.blocks.{i}", block))
    lat = ae["latent_channels"]
    for name in ("quant_conv_mu", "quant_conv_log_sigma", "post_quant_conv"):
        role = "logvar" if name == "quant_conv_log_sigma" else "conv"
        spec += [(f"{name}.conv.weight", (lat, lat, 1, 1), role),
                 (f"{name}.conv.bias", (lat,), "bias")]
    return spec


class VAE:
    """Functional forward over a parameter dict ``P`` (MONAI names)."""

    def __init__(self, ae: dict, ops: Ops):
        self.ae, self.ops = ae, ops
        self.groups, self.eps = ae.get("norm_num_groups", 32), ae.get("norm_eps", 1e-6)
        self.enc, self.dec = _encoder_blocks(ae), _decoder_blocks(ae)

    def _conv(self, P: dict, name: str, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.ops.conv(x, P[f"{name}.weight"], P[f"{name}.bias"], **kw)

    def _gn_silu(self, P: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.ops.group_norm_silu(x, P[f"{name}.weight"], P[f"{name}.bias"], self.groups,
                                        self.eps)

    def _block(self, P: dict, prefix: str, block: tuple, h: torch.Tensor) -> torch.Tensor:
        kind = block[0]
        if kind == "conv3":
            return self._conv(P, f"{prefix}.conv", h, padding=1, hand_kernel=True)
        if kind == "down":
            return self._conv(P, f"{prefix}.conv.conv", F.pad(h, (0, 1, 0, 1)), stride=2)
        if kind == "up":
            return self._conv(P, f"{prefix}.conv.conv", F.interpolate(h, scale_factor=2.0,
                                                                      mode="nearest"),
                              padding=1, hand_kernel=True)
        if kind == "gn":
            return self._gn_silu(P, prefix, h)
        if kind == "res":
            r = self._conv(P, f"{prefix}.conv1.conv", self._gn_silu(P, f"{prefix}.norm1", h),
                           padding=1, hand_kernel=True)
            r = self._conv(P, f"{prefix}.conv2.conv", self._gn_silu(P, f"{prefix}.norm2", r),
                           padding=1, hand_kernel=True)
            if block[1] != block[2]:
                h = self._conv(P, f"{prefix}.nin_shortcut.conv", h)
            return self.ops.q(h + r)
        if kind == "attn":
            b, c, hh, ww = h.shape
            normed = self.ops.q(F.group_norm(h, self.groups, P[f"{prefix}.norm.weight"],
                                             P[f"{prefix}.norm.bias"], self.eps))
            seq = normed.flatten(2).transpose(1, 2)
            q, k, v = (self.ops.linear(seq, P[f"{prefix}.attn.{n}.weight"],
                                       P[f"{prefix}.attn.{n}.bias"])
                       for n in ("to_q", "to_k", "to_v"))
            out = self.ops.linear(self.ops.attention(q, k, v), P[f"{prefix}.attn.out_proj.weight"],
                                  P[f"{prefix}.attn.out_proj.bias"])
            return self.ops.q(h + out.transpose(1, 2).reshape(b, c, hh, ww))
        raise ValueError(kind)

    def encode(self, P: dict, x_nhwc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(z_mu, z_sigma), NHWC."""
        h = x_nhwc.permute(0, 3, 1, 2)
        for i, block in enumerate(self.enc):
            h = self._block(P, f"encoder.blocks.{i}", block, h)
        mu = self._conv(P, "quant_conv_mu.conv", h)
        logvar = self._conv(P, "quant_conv_log_sigma.conv", h).clamp(LOGVAR_MIN, LOGVAR_MAX)
        return mu.permute(0, 2, 3, 1), torch.exp(0.5 * logvar).permute(0, 2, 3, 1)

    def decode(self, P: dict, z_nhwc: torch.Tensor) -> torch.Tensor:
        h = self._conv(P, "post_quant_conv.conv", z_nhwc.permute(0, 3, 1, 2))
        for i, block in enumerate(self.dec):
            h = self._block(P, f"decoder.blocks.{i}", block, h)
        return h.permute(0, 2, 3, 1)

    def forward(self, P: dict, x_nhwc: torch.Tensor, eps_nhwc: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(reconstruction, z_mu, z_sigma), NHWC; the posterior sample is
        ``z_mu + eps * z_sigma``."""
        mu, sigma = self.encode(P, x_nhwc)
        return self.decode(P, mu + eps_nhwc * sigma), mu, sigma

    def latent_shape(self, batch: int, height: int, width: int) -> tuple[int, int, int, int]:
        down = 2 ** (len(self.ae["channels"]) - 1)
        return batch, height // down, width // down, self.ae["latent_channels"]
