"""Diffusion UNet — timestep-conditioned latent-space UNet in PyTorch with
MONAI parameter names.

Counterpart of ``pti_ldm_vae_tpu/models/unet.py`` (2-D path). Architecture
(MONAI ``DiffusionModelUNet`` with cross-attention conditioning): sinusoidal
timestep embedding -> two-layer MLP; per level ``num_res_blocks``
time-conditioned ResBlocks, each followed by a spatial transformer
(self-attention, cross-attention over a ``context`` sequence, GEGLU
feed-forward) where the level has attention; a 3x3 stride-2 padding-1
convolution between levels; a middle ResBlock -> transformer -> ResBlock; an
up path that concatenates the skips and upsamples by nearest x2 + 3x3
convolution; GroupNorm -> SiLU -> 3x3 convolution head predicting the noise.

Modules are named so that ``state_dict()`` holds exactly
``checkpoint/unet_convert.py:unet_expected_torch_keys`` (``time_embed.{0,2}``,
``conv_in.conv``, ``down_blocks.{i}.{resnets,attentions}.{j}``,
``down_blocks.{i}.downsampler.op.conv``, ``middle_block.{resnet_1,
attention,resnet_2}``, ``up_blocks.{k}.{resnets,attentions}.{j}``,
``up_blocks.{k}.upsampler.conv.conv``, ``out.{0,2}``), so MONAI-keyed
``.pth`` files load with ``strict=True``.

Tensors between blocks are channel-last ([B, H, W, C], the JAX package's
layout); convolutions view them as NCHW (``torch.channels_last`` memory) and
run on cuDNN, as the JAX UNet's ``nn.Conv`` runs outside any Pallas kernel.
Every GroupNorm+SiLU goes through the GroupNorm+SiLU kernels and every
self-attention through the flash-attention kernels (``ops/kernels``), forward
and backward; the spatial transformer's input norm (no SiLU), the LayerNorms,
the cross-attention (query length differs from key length) and the GEGLU are
plain tensor code, as in the JAX package. Parameters stay f32; activations run
in ``compute_dtype`` (bf16 on the accelerator by default); the output is f32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..ops.attention import multi_head_attention
from ..ops.norm import DEFAULT_NORM_STATS
from .autoencoder_kl import Convolution, GroupNormOp, Upsample

__all__ = [
    "ConditionProjector",
    "DiffusionUNet",
    "diffusion_unet_from_config",
    "project_latent_condition",
    "timestep_embedding",
]

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (flax ``Dense(dtype=...)``), with or without bias."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding [B, dim] in f32: the sin half, then the cos half
    (MONAI convention); one zero column when ``dim`` is odd."""
    half = dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    freqs = torch.exp(-math.log(max_period) * exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimeResBlock(nn.Module):
    """GroupNorm+SiLU -> 3x3 conv -> + Linear(silu(temb)) per channel ->
    GroupNorm+SiLU -> 3x3 conv, residual; 1x1 ``skip_connection`` conv when the
    channel count changes (MONAI ``ResnetBlock``)."""

    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int, eps: float,
                 norm_stats: str, compute_dtype: torch.dtype):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.norm1 = GroupNormOp(groups, cin, eps, silu=True, norm_stats=norm_stats)
        self.conv1 = Convolution(cin, cout, 3, padding=1, **cd)
        self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = GroupNormOp(groups, cout, eps, silu=True, norm_stats=norm_stats)
        self.conv2 = Convolution(cout, cout, 3, padding=1, **cd)
        self.skip_connection = Convolution(cin, cout, 1, **cd) if cin != cout else None
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        h = self.conv1(self.norm1(x))
        t = _linear(F.silu(temb.to(cd)), self.time_emb_proj, cd)
        h = self.norm2(h + t[:, None, None, :])
        h = self.conv2(h)
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class CrossAttention(nn.Module):
    """q/k/v projections without bias and ``to_out.0`` with bias (MONAI
    ``CrossAttention``); the attention itself is computed by ``TransformerBlock``."""

    def __init__(self, channels: int, context_dim: int | None = None):
        super().__init__()
        kv_dim = channels if context_dim is None else context_dim
        self.to_q = nn.Linear(channels, channels, bias=False)
        self.to_k = nn.Linear(kv_dim, channels, bias=False)
        self.to_v = nn.Linear(kv_dim, channels, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])


class GEGLU(nn.Module):
    """``proj``: Linear(C -> 8C), split into a value and a gate half."""

    def __init__(self, channels: int):
        super().__init__()
        self.proj = nn.Linear(channels, channels * 8)


class FeedForward(nn.Module):
    """``net.0`` GEGLU projection, ``net.2`` Linear(4C -> C) (MONAI layout;
    ``net.1`` is MONAI's dropout, inert here)."""

    def __init__(self, channels: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(channels), nn.Identity(), nn.Linear(channels * 4, channels)])


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with statistics in f32, output in ``dtype`` (flax ``LayerNorm(dtype=...)``)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


class TransformerBlock(nn.Module):
    """Pre-norm self-attention + cross-attention + GEGLU feed-forward, each
    residual (LDM ``BasicTransformerBlock``). Without ``cross_attention_dim``
    the cross-attention and its norm are absent."""

    def __init__(self, channels: int, num_heads: int, cross_attention_dim: int | None,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.num_heads, self.compute_dtype = num_heads, compute_dtype
        self.norm1 = nn.LayerNorm(channels, eps=LAYER_NORM_EPS)
        self.attn1 = CrossAttention(channels)
        self.norm2 = self.attn2 = None
        if cross_attention_dim is not None:
            self.norm2 = nn.LayerNorm(channels, eps=LAYER_NORM_EPS)
            self.attn2 = CrossAttention(channels, cross_attention_dim)
        self.norm3 = nn.LayerNorm(channels, eps=LAYER_NORM_EPS)
        self.ff = FeedForward(channels)

    def _cross_attention(self, h: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """Scores in f32 at scale head_dim^-0.5, softmax weights cast to v's
        dtype before the second product (``unet.py:119-125``)."""
        cd, a = self.compute_dtype, self.attn2
        b, sq, c = h.shape
        heads = self.num_heads
        head_dim = c // heads
        ctx = context.to(cd)
        q = _linear(h, a.to_q, cd).reshape(b, sq, heads, head_dim).transpose(1, 2)
        k = _linear(ctx, a.to_k, cd).reshape(b, -1, heads, head_dim).transpose(1, 2)
        v = _linear(ctx, a.to_v, cd).reshape(b, -1, heads, head_dim).transpose(1, 2)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * head_dim**-0.5
        weights = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.matmul(weights, v).transpose(1, 2).reshape(b, sq, c)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None) -> torch.Tensor:
        cd, a = self.compute_dtype, self.attn1
        h = _layer_norm(x, self.norm1, cd)
        attn = multi_head_attention(_linear(h, a.to_q, cd), _linear(h, a.to_k, cd),
                                    _linear(h, a.to_v, cd), num_heads=self.num_heads)
        x = x + _linear(attn, a.to_out[0], cd)
        if context is not None and self.attn2 is not None:
            attn = self._cross_attention(_layer_norm(x, self.norm2, cd), context)
            x = x + _linear(attn, self.attn2.to_out[0], cd)
        gate = _linear(_layer_norm(x, self.norm3, cd), self.ff.net[0].proj, cd)
        value, g = gate.chunk(2, dim=-1)
        # exact-erf GELU, as the JAX package asks for (jax.nn.gelu defaults to tanh)
        h = value * F.gelu(g, approximate="none")
        return x + _linear(h, self.ff.net[2], cd)


class SpatialTransformer(nn.Module):
    """GroupNorm (no SiLU) -> 1x1 ``proj_in`` -> tokens -> transformer block
    -> 1x1 ``proj_out``, residual (MONAI ``SpatialTransformer``)."""

    def __init__(self, channels: int, num_heads: int, groups: int, eps: float, norm_stats: str,
                 cross_attention_dim: int | None, compute_dtype: torch.dtype):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype)
        self.norm = GroupNormOp(groups, channels, eps, norm_stats=norm_stats)
        self.proj_in = Convolution(channels, channels, 1, **cd)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(channels, num_heads, cross_attention_dim, compute_dtype)])
        self.proj_out = Convolution(channels, channels, 1, **cd)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        hidden = self.proj_in(self.norm(x)).reshape(b, -1, c)
        hidden = self.transformer_blocks[0](hidden, context)
        hidden = self.proj_out(hidden.reshape(*x.shape[:-1], c))
        return x + hidden


class StridedDownsample(nn.Module):
    """3x3 stride-2 convolution with padding 1 on every side (MONAI
    ``Downsample`` with a convolution); not the VAE's (0,1)-padded one."""

    def __init__(self, channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.op = Convolution(channels, channels, 3, stride=2, padding=1, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class DownBlock(nn.Module):
    def __init__(self, resnets: list[nn.Module], attentions: list[nn.Module] | None,
                 downsampler: nn.Module | None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.downsampler = downsampler


class MiddleBlock(nn.Module):
    def __init__(self, resnet_1: nn.Module, attention: nn.Module, resnet_2: nn.Module):
        super().__init__()
        self.resnet_1, self.attention, self.resnet_2 = resnet_1, attention, resnet_2


class UpBlock(nn.Module):
    def __init__(self, resnets: list[nn.Module], attentions: list[nn.Module] | None,
                 upsampler: nn.Module | None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions) if attentions else None
        self.upsampler = upsampler


class DiffusionUNet(nn.Module):
    """Noise predictor ``forward(x [B, H, W, C_in], timesteps [B], context
    [B, S, cross_attention_dim] | None) -> eps [B, H, W, C_out]`` (f32).

    ``remat``: each ``TimeResBlock`` and ``SpatialTransformer`` is
    checkpointed where a gradient is being recorded (``torch.utils.checkpoint``,
    non-reentrant; the JAX UNet's ``nn.remat`` of the same blocks): its
    internals are recomputed in the backward, kernels included.
    ``spatial_dims`` other than 2 is not ported and raises
    ``NotImplementedError``."""

    def __init__(
        self,
        spatial_dims: int = 2,
        in_channels: int = 4,
        out_channels: int = 4,
        channels: Sequence[int] = (32, 64, 128, 256),
        attention_levels: Sequence[bool] = (False, True, True, True),
        num_head_channels: Sequence[int] = (0, 32, 32, 32),
        num_res_blocks: int = 2,
        with_conditioning: bool = True,
        cross_attention_dim: int = 512,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        remat: bool = False,
        norm_stats: str = DEFAULT_NORM_STATS,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if spatial_dims not in (1, 2, 3):
            raise ValueError(f"spatial_dims must be 1, 2, or 3, got {spatial_dims}")
        if spatial_dims != 2:
            raise NotImplementedError(f"spatial_dims={spatial_dims} is not ported yet (2-D only)")
        channels = tuple(channels)
        self.channels = channels
        self.remat = remat
        self.with_conditioning = with_conditioning
        self.compute_dtype = compute_dtype
        cd = dict(compute_dtype=compute_dtype)
        temb_dim = channels[0] * 4
        norm = dict(groups=norm_num_groups, eps=norm_eps, norm_stats=norm_stats)
        cross = cross_attention_dim if with_conditioning else None

        def heads(level: int) -> int:
            nhc = num_head_channels[level]
            return max(1, channels[level] // nhc) if nhc else 1

        def res(cin: int, cout: int) -> TimeResBlock:
            return TimeResBlock(cin, cout, temb_dim, **norm, **cd)

        def attn(level: int) -> SpatialTransformer:
            return SpatialTransformer(channels[level], heads(level), **norm,
                                      cross_attention_dim=cross, **cd)

        self.time_embed = nn.Sequential(nn.Linear(channels[0], temb_dim), nn.SiLU(),
                                        nn.Linear(temb_dim, temb_dim))
        self.conv_in = Convolution(in_channels, channels[0], 3, padding=1, **cd)

        # channel counts of the skips, in the order the down path pushes them
        skip_channels = [channels[0]]
        down, cin = [], channels[0]
        for level, ch in enumerate(channels):
            resnets, attentions = [], []
            for _ in range(num_res_blocks):
                resnets.append(res(cin, ch))
                cin = ch
                if attention_levels[level]:
                    attentions.append(attn(level))
                skip_channels.append(ch)
            last = level == len(channels) - 1
            if not last:
                skip_channels.append(ch)
            down.append(DownBlock(resnets, attentions,
                                  None if last else StridedDownsample(ch, **cd)))
        self.down_blocks = nn.ModuleList(down)

        last = len(channels) - 1
        self.middle_block = MiddleBlock(res(cin, cin), attn(last), res(cin, cin))

        up = []
        for level in reversed(range(len(channels))):
            ch = channels[level]
            resnets, attentions = [], []
            for _ in range(num_res_blocks + 1):
                resnets.append(res(cin + skip_channels.pop(), ch))
                cin = ch
                if attention_levels[level]:
                    attentions.append(attn(level))
            up.append(UpBlock(resnets, attentions, Upsample(ch, **cd) if level != 0 else None))
        self.up_blocks = nn.ModuleList(up)

        self.out = nn.ModuleList([
            GroupNormOp(norm_num_groups, cin, norm_eps, silu=True, norm_stats=norm_stats),
            nn.Identity(),
            Convolution(cin, out_channels, 3, padding=1, **cd),
        ])

    def _run(self, block: nn.Module, h: torch.Tensor, extra: torch.Tensor | None) -> torch.Tensor:
        """A ``TimeResBlock`` (``extra``: the time embedding) or a
        ``SpatialTransformer`` (``extra``: the context), checkpointed under
        ``remat`` where a gradient is being recorded."""
        if self.remat and torch.is_grad_enabled():
            # the whole block is recomputed (no early stop): its kernels launch twice per step
            with set_checkpoint_early_stop(False):
                return checkpoint(block, h, extra, use_reentrant=False)
        return block(h, extra)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor | None = None) -> torch.Tensor:
        cd = self.compute_dtype
        ctx = context if self.with_conditioning else None
        temb = timestep_embedding(timesteps, self.channels[0])
        temb = _linear(temb, self.time_embed[0], cd)
        temb = _linear(F.silu(temb), self.time_embed[2], cd)

        h = self.conv_in(x)
        skips = [h]
        for block in self.down_blocks:
            for j, resnet in enumerate(block.resnets):
                h = self._run(resnet, h, temb)
                if block.attentions is not None:
                    h = self._run(block.attentions[j], h, ctx)
                skips.append(h)
            if block.downsampler is not None:
                h = block.downsampler(h)
                skips.append(h)

        mid = self.middle_block
        h = self._run(mid.resnet_1, h, temb)
        h = self._run(mid.resnet_2, self._run(mid.attention, h, ctx), temb)

        for block in self.up_blocks:
            for j, resnet in enumerate(block.resnets):
                h = self._run(resnet, torch.cat([h, skips.pop()], dim=-1), temb)
                if block.attentions is not None:
                    h = self._run(block.attentions[j], h, ctx)
            if block.upsampler is not None:
                h = block.upsampler(h)

        return self.out[2](self.out[0](h)).float()


class ConditionProjector(nn.Linear):
    """Linear(latent channels -> cross_attention_dim) in f32 (reference
    ``create_condition_projector``); state-dict keys ``weight`` and ``bias``."""

    def __init__(self, latent_channels: int, cross_attention_dim: int = 512):
        super().__init__(latent_channels, cross_attention_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.linear(tokens.float(), self.weight, self.bias)


def project_latent_condition(projector: nn.Module, latent_nhwc: torch.Tensor) -> torch.Tensor:
    """Channel-last latent [B, *spatial, C] -> tokens [B, prod(spatial), C] ->
    context [B, prod(spatial), cross_attention_dim]."""
    b, c = latent_nhwc.shape[0], latent_nhwc.shape[-1]
    return projector(latent_nhwc.reshape(b, -1, c))


def diffusion_unet_from_config(
    config: dict, *, compute_dtype: torch.dtype = torch.float32, remat: bool | None = None,
    norm_stats: str | None = None,
) -> DiffusionUNet:
    """A ``DiffusionUNet`` from a ``diffusion_def`` dict (parity with
    ``DiffusionUNet.from_config``). ``remat`` / ``norm_stats`` default to the
    keys of ``config``; the CLIs pass the top-level keys explicitly."""
    if remat is None:
        remat = bool(config.get("remat", False))
    if norm_stats is None:
        norm_stats = str(config.get("norm_stats", DEFAULT_NORM_STATS))
    return DiffusionUNet(
        spatial_dims=config["spatial_dims"],
        in_channels=config["in_channels"],
        out_channels=config["out_channels"],
        channels=tuple(config["channels"]),
        attention_levels=tuple(config["attention_levels"]),
        num_head_channels=tuple(config["num_head_channels"]),
        num_res_blocks=config.get("num_res_blocks", 2),
        with_conditioning=config.get("with_conditioning", True),
        cross_attention_dim=config.get("cross_attention_dim", 512),
        norm_num_groups=config.get("norm_num_groups", 32),
        remat=remat,
        norm_stats=norm_stats,
        compute_dtype=compute_dtype,
    )
