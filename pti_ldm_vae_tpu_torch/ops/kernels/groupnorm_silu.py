"""Fused GroupNorm + SiLU forward: hand-written Triton kernel + its plain PyTorch version.

Replaces ``pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py`` (``_forward``, body
``_kernel``): per-image f32 sums and sums of squares per group of contiguous
channels, the one-pass biased variance (clamped at 0, as the plain path
``ops/norm.py`` of the JAX package does), then ``silu(x * mul + add)``
computed in f32 and stored once in the input dtype.

Bound on an H100: the work is a reduction plus one elementwise pass, a few
FLOP per element, so the bound is bytes: at least one read and one write of
``x``. On the VAE's main path (42 calls per reconstruct at b8, 256²x32 down to
32²x128) that is 36.0 M elements per image, 2.3 GB per b8 reconstruct in f32.

Design (the TPU kernel ran one grid step per image, which on this card would
fill 8 of 132 SMs at b8):

1. ``_stats_kernel``, grid (B, n_blk): each program sums a contiguous slab of
   rows of one image into per-channel f32 partial sums and sums of squares,
   ``[B, n_blk, 2, C]``. Rows are split so that B * n_blk fills the card.
2. ``_apply_kernel``, same grid: each program first folds the partials of its
   image, in a fixed order (no float atomics: every program of an image gets
   the same statistics bit for bit, run after run), reduces channels to
   groups with a one-hot group map (a group's channels are strided in
   NHWC), and turns mean and inverse std into per-channel ``mul`` / ``add``;
   then it streams its slab once more and writes ``silu(x * mul + add)``.

So ``x`` is read twice and written once; the partials are a few KB. Fusing
the second read away (keeping a slab in registers across a grid-wide
barrier) is later work.

``groupnorm_silu`` launches the kernels for CUDA tensors (or raises) and runs
the plain version for CPU tensors; nothing falls back from one to the other.
``groupnorm_silu.launches`` counts calls that launched the kernels.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["groupnorm_silu", "groupnorm_silu_plain", "launch_grid"]

# Bound at build time by _triton_kernels(): this module must import without
# triton, which only the GPU host has.
tl = None

_TARGET_PROGRAMS = 4 * 132  # four programs per H100 SM
_MAX_BLOCKS_PER_IMAGE = 64
_TILE_ELEMENTS = 4096  # elements of one [BLOCK_R, BLOCK_C] tile


def groupnorm_silu_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
) -> torch.Tensor:
    """Plain PyTorch version of the kernel on an NHWC [B, H, W, C] tensor:
    f32 one-pass group statistics, biased variance clamped at 0, SiLU in
    f32, one rounding to ``x.dtype``."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    xg = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(xg.square().mean(dim=(1, 3), keepdim=True) - mean.square(), min=0.0)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    y = y * scale.float() + bias.float()
    return (y * torch.sigmoid(y)).to(x.dtype)


def _stats_kernel(x_ptr, part_ptr, HW, C, rows_per_blk, n_blk,
                  BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    blk = tl.program_id(1)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    row_start = blk * rows_per_blk
    row_end = tl.minimum(row_start + rows_per_blk, HW)
    x_img = x_ptr + b.to(tl.int64) * HW * C
    acc1 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
    for r0 in range(row_start, row_end, BLOCK_R):
        rows = r0 + tl.arange(0, BLOCK_R)
        mask = (rows < row_end)[:, None] & cmask[None, :]
        xv = tl.load(x_img + rows[:, None] * C + cols[None, :], mask=mask, other=0.0).to(tl.float32)
        acc1 += xv
        acc2 += xv * xv
    out = part_ptr + (b * n_blk + blk) * 2 * C
    tl.store(out + cols, tl.sum(acc1, axis=0), mask=cmask)
    tl.store(out + C + cols, tl.sum(acc2, axis=0), mask=cmask)


def _apply_kernel(x_ptr, y_ptr, part_ptr, scale_ptr, bias_ptr, HW, C, CG, rows_per_blk, n_blk,
                  count, eps, BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                  BLOCK_G: tl.constexpr, BLOCK_N: tl.constexpr):
    b = tl.program_id(0)
    blk = tl.program_id(1)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C

    # fold this image's partials: a fixed-shape reduction, identical in every program
    blks = tl.arange(0, BLOCK_N)
    pmask = (blks < n_blk)[:, None] & cmask[None, :]
    parts = part_ptr + b * n_blk * 2 * C + blks[:, None] * 2 * C + cols[None, :]
    s1 = tl.sum(tl.load(parts, mask=pmask, other=0.0), axis=0)
    s2 = tl.sum(tl.load(parts + C, mask=pmask, other=0.0), axis=0)

    # channels -> groups -> channels through the one-hot map [BLOCK_G, BLOCK_C]
    groups = tl.arange(0, BLOCK_G)
    onehot = ((cols[None, :] // CG) == groups[:, None]) & cmask[None, :]
    mean = tl.sum(tl.where(onehot, s1[None, :], 0.0), axis=1) / count
    var = tl.sum(tl.where(onehot, s2[None, :], 0.0), axis=1) / count - mean * mean
    inv = 1.0 / tl.sqrt(tl.maximum(var, 0.0) + eps)
    mean_c = tl.sum(tl.where(onehot, mean[:, None], 0.0), axis=0)
    inv_c = tl.sum(tl.where(onehot, inv[:, None], 0.0), axis=0)
    gamma = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    beta = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    mul = inv_c * gamma
    add = beta - mean_c * mul

    row_start = blk * rows_per_blk
    row_end = tl.minimum(row_start + rows_per_blk, HW)
    img = b.to(tl.int64) * HW * C
    for r0 in range(row_start, row_end, BLOCK_R):
        rows = r0 + tl.arange(0, BLOCK_R)
        mask = (rows < row_end)[:, None] & cmask[None, :]
        offs = img + rows[:, None] * C + cols[None, :]
        xv = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        yv = xv * mul[None, :] + add[None, :]
        yv = yv / (1.0 + tl.exp(-yv))
        tl.store(y_ptr + offs, yv.to(y_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _triton_kernels():
    import triton
    import triton.language

    globals()["tl"] = triton.language
    return triton.jit(_stats_kernel), triton.jit(_apply_kernel)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def launch_grid(batch: int, hw: int, channels: int) -> tuple[int, int, int, int]:
    """(BLOCK_R, BLOCK_C, rows per program, programs per image) for one shape."""
    block_c = _next_pow2(channels)
    block_r = max(1, _TILE_ELEMENTS // block_c)
    want = -(-_TARGET_PROGRAMS // batch)
    rows = max(-(-hw // want), -(-hw // _MAX_BLOCKS_PER_IMAGE), block_r)
    rows = -(-rows // block_r) * block_r
    return block_r, block_c, rows, -(-hw // rows)


def groupnorm_silu(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
) -> torch.Tensor:
    """``silu(group_norm(x))`` of an NHWC [B, H, W, C] tensor: the Triton kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, scale, bias, num_groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu runs on cuda or cpu, got {x.device}")
    c = x.shape[-1]
    if x.dim() != 4 or c % num_groups:
        raise ValueError(f"expected NHWC with C divisible by {num_groups}, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"groupnorm_silu takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_silu takes a contiguous NHWC tensor")
    if scale.shape != (c,) or bias.shape != (c,) or scale.device != x.device or bias.device != x.device:
        raise ValueError("scale and bias must be [C] tensors on x's device")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        raise NotImplementedError("groupnorm_silu has no backward kernel yet")
    b, hw = x.shape[0], x.shape[1] * x.shape[2]
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    block_r, block_c, rows, n_blk = launch_grid(b, hw, c)
    cg = c // num_groups
    stats_kernel, apply_kernel = _triton_kernels()
    parts = torch.empty((b, n_blk, 2, c), device=x.device, dtype=torch.float32)
    scale, bias = scale.contiguous(), bias.contiguous()
    with torch.cuda.device(x.device):
        stats_kernel[(b, n_blk)](x, parts, hw, c, rows, n_blk, BLOCK_R=block_r, BLOCK_C=block_c)
        apply_kernel[(b, n_blk)](
            x, y, parts, scale, bias, hw, c, cg, rows, n_blk, float(hw * cg), float(eps),
            BLOCK_R=block_r, BLOCK_C=block_c,
            BLOCK_G=_next_pow2(num_groups), BLOCK_N=_next_pow2(n_blk),
        )
    groupnorm_silu.launches += 1
    return y


groupnorm_silu.launches = 0
