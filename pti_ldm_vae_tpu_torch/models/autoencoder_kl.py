"""AutoencoderKL — convolutional VAE in PyTorch with MONAI parameter names.

Counterpart of ``pti_ldm_vae_tpu/models/autoencoder_kl.py`` (2-D).
Architecture (MONAI 1.5.1 ``AutoencoderKL``, CompVis VAE lineage):

* encoder: conv_in 3x3 -> per level {num_res_blocks x ResBlock
  (GroupNorm->SiLU->Conv3x3, 1x1 skip on channel change) [+ self-attention]}
  -> (0,1)-pad + 3x3 stride-2 conv between levels -> optional non-local mid
  block (ResBlock -> SpatialAttention -> ResBlock) -> GroupNorm -> SiLU ->
  Conv3x3 to latent_channels
* two 1x1 quant convs give ``z_mu`` and a log-variance clamped to [-30, 20];
  ``sigma = exp(0.5 * logvar)`` in f32; sampling ``z = mu + eps * sigma``
* the decoder mirrors the encoder with nearest-x2 upsample + conv.

Modules are built in MONAI's order under ``encoder.blocks.{n}`` /
``decoder.blocks.{n}``, with ``Convolution`` wrappers adding the ``.conv``
segment and attention under ``.attn.{to_q,to_k,to_v,out_proj}``, so
``state_dict()`` keys are MONAI's and reference ``.pth`` files load with
``strict=True``.

Tensors between blocks are channel-last ([B, H, W, C], the JAX package's
layout and the model's I/O layout). A convolution views its input as NCHW
(a free permute of channel-last memory, i.e. ``torch.channels_last``), which
cuDNN prefers on Hopper, and hands back the channel-last view of its output.
Every GroupNorm+SiLU goes through the GroupNorm+SiLU kernels and every
attention through the flash-attention kernels (``ops/kernels``), forward and
backward. With ``conv_kernel=True`` every 3x3 stride-1 padding-1 convolution
(the stems, the res-block convolutions, the upsample convolutions, the output
convolutions) goes through the hand-written convolution kernels instead
(``ops/conv.py``), on the channel-last tensor as it is; the 1x1 skips, the
stride-2 downsample and the quant convolutions stay with cuDNN. Parameters
and state-dict keys are the same either way. Compute dtype: parameters stay f32, activations run in
``compute_dtype`` (bf16 on the accelerator by default).

Two apply-time knobs leave the parameters as they are. ``s2d_stem`` runs the
encoder's level 0 (``conv_in``, its ResBlocks, the downsample) and the
decoder's full-resolution tail (the last upsample, its ResBlocks,
``norm_out``, ``conv_out``) in the space-to-depth domain: the same modules
and parameters at half resolution with 4x the channels, the weights
transformed at apply time (``ops/space_to_depth.py``); the GroupNorm+SiLU and
3x3 convolutions there go through the same routes as everywhere else.
``remat`` recomputes each ResBlock's and attention block's internals in the
backward (``torch.utils.checkpoint``, non-reentrant) instead of keeping them,
as the JAX package wraps the same blocks in ``nn.remat``; the kernels then
launch again for the recomputed forward.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..ops.attention import multi_head_attention
from ..ops.conv import conv3x3
from ..ops.norm import DEFAULT_NORM_STATS, group_norm, group_norm_silu
from ..ops.resize import upsample_nearest_2x
from ..ops import space_to_depth as s2d_policy
from ..ops.space_to_depth import (
    depth_to_space,
    s2d_conv1x1_kernel,
    s2d_conv3x3_kernel,
    s2d_downsample_kernel,
    s2d_repeat_channels,
    space_to_depth,
)

__all__ = ["AutoencoderKL", "autoencoder_from_config"]

LOGVAR_CLAMP_MIN = -30.0
LOGVAR_CLAMP_MAX = 20.0


class Convolution(nn.Module):
    """MONAI ``Convolution`` wrapper (parameters under ``conv.``); NHWC in and out."""

    def __init__(self, cin: int, cout: int, kernel_size: int, *, stride: int = 1,
                 padding: int = 0, compute_dtype: torch.dtype = torch.float32,
                 conv_kernel: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = compute_dtype
        # the convolution kernels compute the 3x3 stride-1 SAME form only
        self.conv_kernel = conv_kernel and (kernel_size, stride, padding) == (3, 1, 1)

    def forward(self, x: torch.Tensor, s2d: bool = False) -> torch.Tensor:
        """``s2d``: ``x`` is in the space-to-depth domain, [B, H/2, W/2, 4*Cin];
        the transformed 3x3 and 1x1 convolutions stay in it, the stride-2 one
        (after its caller's (0,1) pad: a 2x2 VALID convolution) leaves it."""
        cd = self.compute_dtype
        weight, bias = self.conv.weight, self.conv.bias
        stride, padding = self.conv.stride, self.conv.padding
        if s2d and stride[0] == 2:
            weight, stride = s2d_downsample_kernel(weight), 1
        elif s2d:
            to_s2d = s2d_conv3x3_kernel if self.conv.kernel_size[0] == 3 else s2d_conv1x1_kernel
            weight, bias = to_s2d(weight), s2d_repeat_channels(bias)
        if self.conv_kernel:
            return conv3x3(x.to(cd), weight, bias)
        y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), weight.to(cd), bias.to(cd), stride=stride,
                     padding=padding)
        return y.permute(0, 2, 3, 1)


class GroupNormOp(nn.Module):
    """GroupNorm (MONAI ``weight``/``bias``) with optional fused SiLU; NHWC."""

    def __init__(self, num_groups: int, channels: int, eps: float, *, silu: bool = False,
                 norm_stats: str = DEFAULT_NORM_STATS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.num_groups, self.eps, self.silu, self.norm_stats = num_groups, eps, silu, norm_stats

    def forward(self, x: torch.Tensor, s2d: bool = False) -> torch.Tensor:
        """``s2d``: ``x`` is in the space-to-depth domain, where each group's
        elements are the same and ``weight`` / ``bias`` repeat 4x."""
        weight, bias = self.weight, self.bias
        if s2d:
            weight, bias = s2d_repeat_channels(weight), s2d_repeat_channels(bias)
        fn = group_norm_silu if self.silu else group_norm
        return fn(x, weight, bias, num_groups=self.num_groups, eps=self.eps, stats=self.norm_stats)


class ResBlock(nn.Module):
    """GroupNorm->SiLU->Conv3x3 (x2) residual block, 1x1 skip on channel change
    (MONAI ``AEKLResBlock``)."""

    def __init__(self, cin: int, cout: int, groups: int, eps: float, norm_stats: str,
                 compute_dtype: torch.dtype, conv_kernel: bool = False):
        super().__init__()
        cd = dict(compute_dtype=compute_dtype, conv_kernel=conv_kernel)
        self.norm1 = GroupNormOp(groups, cin, eps, silu=True, norm_stats=norm_stats)
        self.conv1 = Convolution(cin, cout, 3, padding=1, **cd)
        self.norm2 = GroupNormOp(groups, cout, eps, silu=True, norm_stats=norm_stats)
        self.conv2 = Convolution(cout, cout, 3, padding=1, **cd)
        self.nin_shortcut = Convolution(cin, cout, 1, **cd) if cin != cout else None

    def forward(self, x: torch.Tensor, s2d: bool = False) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x, s2d), s2d), s2d), s2d)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x, s2d)
        return x.to(h.dtype) + h


class SABlock(nn.Module):
    """The q/k/v/output projections of MONAI ``SABlock`` (``use_combined_linear=False``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.out_proj = nn.Linear(channels, channels)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class SpatialAttentionBlock(nn.Module):
    """GroupNorm -> single-head self-attention over HW tokens -> residual add
    (MONAI ``SpatialAttentionBlock`` with its default one head)."""

    def __init__(self, channels: int, groups: int, eps: float, norm_stats: str,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.norm = GroupNormOp(groups, channels, eps, norm_stats=norm_stats)
        self.attn = SABlock(channels)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, cd = x.shape[0], x.shape[-1], self.compute_dtype
        seq = self.norm(x).reshape(b, -1, c)
        q = _linear(seq, self.attn.to_q, cd)
        k = _linear(seq, self.attn.to_k, cd)
        v = _linear(seq, self.attn.to_v, cd)
        out = multi_head_attention(q, k, v, num_heads=1)
        out = _linear(out, self.attn.out_proj, cd)
        return x.to(cd) + out.reshape(x.shape)


class Downsample(nn.Module):
    """(0,1) pad of H and W + 3x3 stride-2 valid conv (MONAI ``AEKLDownsample``)."""

    def __init__(self, channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.conv = Convolution(channels, channels, 3, stride=2, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, s2d: bool = False) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)), s2d)


class Upsample(nn.Module):
    """Nearest x2 + 3x3 conv (MONAI decoder upsample, non-transposed)."""

    def __init__(self, channels: int, compute_dtype: torch.dtype, conv_kernel: bool = False):
        super().__init__()
        self.conv = Convolution(channels, channels, 3, padding=1, compute_dtype=compute_dtype,
                                conv_kernel=conv_kernel)

    def forward(self, x: torch.Tensor, s2d: bool = False) -> torch.Tensor:
        """``s2d``: nearest x2 as the phase repeat, entering the space-to-depth
        domain ([B, H, W, C] -> [B, H, W, 4*C]) instead of the 2x tensor."""
        if s2d:
            return self.conv(s2d_repeat_channels(x), s2d)
        return self.conv(upsample_nearest_2x(x))


class _Coder(nn.Module):
    """Shared by Encoder and Decoder: ``blocks`` applied in order (MONAI
    layout); ``s2d_blocks`` of them, at the start (encoder) or the end
    (decoder), run in the space-to-depth domain when ``s2d_stem`` applies;
    with ``remat`` the ResBlocks and attention blocks are checkpointed."""

    def _init_knobs(self, channels: Sequence[int], attention_levels: Sequence[bool],
                    s2d_blocks: int, s2d_stem: bool | str, remat: bool) -> None:
        self.n_levels = len(channels)
        self.full_res_attention = bool(attention_levels[0])
        self.s2d_blocks, self.s2d_stem, self.remat = s2d_blocks, s2d_stem, remat

    def _run(self, block: nn.Module, h: torch.Tensor, s2d: bool) -> torch.Tensor:
        args = (h, True) if s2d else (h,)
        if self.remat and torch.is_grad_enabled() and isinstance(block, (ResBlock,
                                                                         SpatialAttentionBlock)):
            # the whole block is recomputed (no early stop): its kernels launch twice per step
            with set_checkpoint_early_stop(False):
                return checkpoint(block, *args, use_reentrant=False)
        return block(*args)


class Encoder(_Coder):
    def __init__(self, in_channels: int, channels: Sequence[int], latent_channels: int,
                 num_res_blocks: Sequence[int], groups: int, eps: float,
                 attention_levels: Sequence[bool], with_nonlocal_attn: bool,
                 norm_stats: str, compute_dtype: torch.dtype, conv_kernel: bool = False,
                 s2d_stem: bool | str = False, remat: bool = False):
        super().__init__()
        # in the s2d domain: conv_in, level 0's ResBlocks, its downsample
        self._init_knobs(channels, attention_levels, num_res_blocks[0] + 2, s2d_stem, remat)
        cd = dict(compute_dtype=compute_dtype)
        ck = dict(conv_kernel=conv_kernel, **cd)
        blk = dict(groups=groups, eps=eps, norm_stats=norm_stats, **cd)
        res = dict(conv_kernel=conv_kernel, **blk)
        blocks: list[nn.Module] = [Convolution(in_channels, channels[0], 3, padding=1, **ck)]
        cin = channels[0]
        for level, ch in enumerate(channels):
            for _ in range(num_res_blocks[level]):
                blocks.append(ResBlock(cin, ch, **res))
                cin = ch
                if attention_levels[level]:
                    blocks.append(SpatialAttentionBlock(ch, **blk))
            if level != len(channels) - 1:
                blocks.append(Downsample(ch, **cd))
        if with_nonlocal_attn:
            blocks += [ResBlock(cin, cin, **res), SpatialAttentionBlock(cin, **blk),
                       ResBlock(cin, cin, **res)]
        blocks += [GroupNormOp(groups, cin, eps, silu=True, norm_stats=norm_stats),
                   Convolution(cin, latent_channels, 3, padding=1, **ck)]
        self.blocks = nn.ModuleList(blocks)

    def _use_s2d(self, x: torch.Tensor) -> bool:
        """Whether level 0 runs in the s2d domain (JAX ``Encoder._use_s2d``):
        ``"auto"`` where eligible and the batch is within the H100 inference
        threshold; an explicit form on an ineligible input raises."""
        eligible = (x.dim() == 4 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0
                    and not self.full_res_attention and self.n_levels >= 2)
        if self.s2d_stem == "auto":
            return eligible and x.shape[0] <= s2d_policy.S2D_AUTO_INFER_ENCODER_MAX_BATCH
        if self.s2d_stem and not eligible:
            if x.dim() != 4:
                raise ValueError("s2d_stem requires spatial_dims == 2")
            if self.full_res_attention:
                raise ValueError("s2d_stem does not support level-0 attention")
            if self.n_levels < 2:
                raise ValueError("s2d_stem requires >= 2 levels")
            raise ValueError(f"s2d_stem requires even H, W; got {tuple(x.shape[1:3])}")
        return bool(self.s2d_stem)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.s2d_blocks if self._use_s2d(x) else 0
        h = space_to_depth(x) if n else x
        for i, block in enumerate(self.blocks):
            h = self._run(block, h, i < n)
        return h


class Decoder(_Coder):
    def __init__(self, channels: Sequence[int], latent_channels: int, out_channels: int,
                 num_res_blocks: Sequence[int], groups: int, eps: float,
                 attention_levels: Sequence[bool], with_nonlocal_attn: bool,
                 norm_stats: str, compute_dtype: torch.dtype, conv_kernel: bool = False,
                 s2d_stem: bool | str = False, remat: bool = False):
        super().__init__()
        # in the s2d domain: the last upsample, the full-resolution ResBlocks,
        # norm_out and conv_out
        self._init_knobs(channels, attention_levels, num_res_blocks[0] + 3, s2d_stem, remat)
        cd = dict(compute_dtype=compute_dtype)
        ck = dict(conv_kernel=conv_kernel, **cd)
        blk = dict(groups=groups, eps=eps, norm_stats=norm_stats, **cd)
        res = dict(conv_kernel=conv_kernel, **blk)
        rev_channels = list(reversed(channels))
        rev_blocks = list(reversed(num_res_blocks))
        rev_attention = list(reversed(attention_levels))
        cin = rev_channels[0]
        blocks: list[nn.Module] = [Convolution(latent_channels, cin, 3, padding=1, **ck)]
        if with_nonlocal_attn:
            blocks += [ResBlock(cin, cin, **res), SpatialAttentionBlock(cin, **blk),
                       ResBlock(cin, cin, **res)]
        for level, ch in enumerate(rev_channels):
            for _ in range(rev_blocks[level]):
                blocks.append(ResBlock(cin, ch, **res))
                cin = ch
                if rev_attention[level]:
                    blocks.append(SpatialAttentionBlock(ch, **blk))
            if level != len(rev_channels) - 1:
                blocks.append(Upsample(ch, **ck))
        blocks += [GroupNormOp(groups, cin, eps, silu=True, norm_stats=norm_stats),
                   Convolution(cin, out_channels, 3, padding=1, **ck)]
        self.blocks = nn.ModuleList(blocks)

    def _use_s2d(self, z: torch.Tensor) -> bool:
        """Whether the full-resolution tail runs in the s2d domain (JAX
        ``Decoder._use_s2d``; its output is even-sized by construction)."""
        eligible = z.dim() == 4 and not self.full_res_attention and self.n_levels >= 2
        if self.s2d_stem == "auto":
            return eligible and z.shape[0] <= s2d_policy.S2D_AUTO_INFER_DECODER_MAX_BATCH
        if self.s2d_stem and not eligible:
            if z.dim() != 4:
                raise ValueError("s2d_stem requires spatial_dims == 2")
            if self.full_res_attention:
                raise ValueError("s2d_stem does not support full-res attention")
            raise ValueError("s2d_stem requires >= 2 levels")
        return bool(self.s2d_stem)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        n = self.s2d_blocks if self._use_s2d(z) else 0
        first = len(self.blocks) - n
        h = z
        for i, block in enumerate(self.blocks):
            h = self._run(block, h, i >= first)
        return depth_to_space(h) if n else h


class AutoencoderKL(nn.Module):
    """Conv VAE with KL-regularized latent space, NHWC in and out.

    Methods as in the JAX package (reference wrapper ``VAEModel``):

    * ``forward(x, eps=None, generator=None)`` -> (reconstruction, z_mu, z_sigma)
    * ``encode(x)`` -> (z_mu, z_sigma); ``encode_deterministic(x)`` -> z_mu
    * ``sampling(z_mu, z_sigma, eps=None, generator=None)`` -> z
    * ``encode_stage_2_inputs(x, eps=None, generator=None)`` -> sampled z
    * ``decode(z)`` / ``decode_stage_2_outputs(z)`` -> reconstruction
    * ``reconstruct_deterministic(x)`` -> decode(z_mu)

    ``remat``: checkpoint the ResBlocks and attention blocks (only where a
    gradient is being recorded). ``s2d_stem``: ``False``, ``True``,
    ``"encoder"``, ``"decoder"`` (one side) or ``"auto"`` (each side where
    eligible and the batch is within ``ops/space_to_depth.py``'s H100
    inference thresholds, which take the standard path at every batch for
    now); one state dict loads into every form. ``conv_kernel`` sends the 3x3
    stride-1 convolutions through the hand-written convolution kernels
    (default: cuDNN, as the JAX models call ``lax.conv``).
    """

    def __init__(
        self,
        spatial_dims: int = 2,
        in_channels: int = 1,
        out_channels: int = 1,
        latent_channels: int = 4,
        channels: Sequence[int] = (32, 64, 128, 128),
        num_res_blocks: Sequence[int] | int = 2,
        norm_num_groups: int = 32,
        norm_eps: float = 1e-6,
        attention_levels: Sequence[bool] | None = None,
        with_encoder_nonlocal_attn: bool = True,
        with_decoder_nonlocal_attn: bool = True,
        norm_stats: str = DEFAULT_NORM_STATS,
        remat: bool = False,
        s2d_stem: bool | str = False,
        compute_dtype: torch.dtype = torch.float32,
        conv_kernel: bool = False,
    ):
        super().__init__()
        if spatial_dims not in (1, 2, 3):
            raise ValueError(f"spatial_dims must be 1, 2, or 3, got {spatial_dims}")
        if s2d_stem in (True, "encoder", "decoder") and spatial_dims != 2:
            # an explicit form on a non-2-D model is a user error; "auto" takes the standard path
            raise ValueError("s2d_stem requires spatial_dims == 2")
        if spatial_dims != 2:
            raise NotImplementedError(f"spatial_dims={spatial_dims} is not ported yet (2-D only)")
        s2d_enc = s2d_stem if s2d_stem in (False, True, "auto") else s2d_stem == "encoder"
        s2d_dec = s2d_stem if s2d_stem in (False, True, "auto") else s2d_stem == "decoder"
        n_levels = len(channels)
        nrb = (num_res_blocks,) * n_levels if isinstance(num_res_blocks, int) else tuple(num_res_blocks)
        attn = (False,) * n_levels if attention_levels is None else tuple(attention_levels)
        common = dict(num_res_blocks=nrb, groups=norm_num_groups, eps=norm_eps,
                      attention_levels=attn, norm_stats=norm_stats, compute_dtype=compute_dtype,
                      conv_kernel=conv_kernel, remat=remat)
        self.compute_dtype = compute_dtype
        self.conv_kernel = conv_kernel
        self.encoder = Encoder(in_channels, channels, latent_channels,
                               with_nonlocal_attn=with_encoder_nonlocal_attn, s2d_stem=s2d_enc,
                               **common)
        self.decoder = Decoder(channels, latent_channels, out_channels,
                               with_nonlocal_attn=with_decoder_nonlocal_attn, s2d_stem=s2d_dec,
                               **common)
        cd = dict(compute_dtype=compute_dtype)
        self.quant_conv_mu = Convolution(latent_channels, latent_channels, 1, **cd)
        self.quant_conv_log_sigma = Convolution(latent_channels, latent_channels, 1, **cd)
        self.post_quant_conv = Convolution(latent_channels, latent_channels, 1, **cd)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (z_mu, z_sigma), both f32; logvar clamped to [-30, 20] like MONAI."""
        h = self.encoder(x.to(self.compute_dtype))
        z_mu = self.quant_conv_mu(h)
        z_log_var = self.quant_conv_log_sigma(h).float().clamp(LOGVAR_CLAMP_MIN, LOGVAR_CLAMP_MAX)
        return z_mu.float(), torch.exp(0.5 * z_log_var)

    def sampling(self, z_mu: torch.Tensor, z_sigma: torch.Tensor, eps: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """``z_mu + eps * z_sigma``; ``eps`` standard normal from ``generator``
        unless given."""
        if eps is None:
            eps = torch.randn(z_mu.shape, generator=generator, dtype=z_mu.dtype,
                              device=z_mu.device)
        return z_mu + eps * z_sigma

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = self.post_quant_conv(z.to(self.compute_dtype))
        return self.decoder(z).float()

    def forward(self, x: torch.Tensor, eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        z_mu, z_sigma = self.encode(x)
        reconstruction = self.decode(self.sampling(z_mu, z_sigma, eps, generator))
        return reconstruction, z_mu, z_sigma

    def encode_stage_2_inputs(self, x: torch.Tensor, eps: torch.Tensor | None = None,
                              generator: torch.Generator | None = None) -> torch.Tensor:
        z_mu, z_sigma = self.encode(x)
        return self.sampling(z_mu, z_sigma, eps, generator)

    def encode_deterministic(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(x)[0]

    def decode_stage_2_outputs(self, z: torch.Tensor) -> torch.Tensor:
        return self.decode(z)

    def reconstruct_deterministic(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode_deterministic(x))


def autoencoder_from_config(
    config: dict,
    *,
    norm_stats: str = DEFAULT_NORM_STATS,
    remat: bool = False,
    s2d_stem: bool | str = False,
    compute_dtype: torch.dtype = torch.float32,
    conv_kernel: bool = False,
) -> AutoencoderKL:
    """Build an AutoencoderKL from a reference-format ``autoencoder_def`` dict
    (parity with ``VAEModel.from_config``, ``autoencoder.py:81-103``)."""
    attn = config.get("attention_levels")
    return AutoencoderKL(
        spatial_dims=config["spatial_dims"],
        in_channels=config["in_channels"],
        out_channels=config["out_channels"],
        latent_channels=config["latent_channels"],
        channels=tuple(config["channels"]),
        num_res_blocks=config.get("num_res_blocks", 2),
        norm_num_groups=config.get("norm_num_groups", 32),
        norm_eps=config.get("norm_eps", 1e-6),
        attention_levels=tuple(attn) if attn is not None else None,
        with_encoder_nonlocal_attn=config.get("with_encoder_nonlocal_attn", True),
        with_decoder_nonlocal_attn=config.get("with_decoder_nonlocal_attn", True),
        norm_stats=norm_stats,
        remat=remat,
        s2d_stem=s2d_stem,
        compute_dtype=compute_dtype,
        conv_kernel=conv_kernel,
    )
