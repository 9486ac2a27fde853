"""Fused GroupNorm + SiLU, forward and backward: hand-written Triton kernels
beside their plain PyTorch versions, bound to autograd.

Replaces ``pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py``:

* ``_forward`` (body ``_kernel``): per-image f32 sums and sums of squares
  per group of contiguous channels, the one-pass biased variance (clamped at
  0, as the plain path ``ops/norm.py`` of the JAX package does), then
  ``silu(x * mul + add)`` computed in f32 and stored once in the input
  dtype; also the ``[B, G]`` f32 mean and inverse std, which the backward
  reads instead of recomputing them;
* ``_bwd_pallas`` (bodies ``_bwd_reduce_kernel`` and ``_bwd_dx_kernel``):
  with ``xhat = (x - mean) * inv``, ``n = xhat * gamma + beta`` and
  ``dn = g * sigmoid(n) * (1 + n * (1 - sigmoid(n)))`` (the upstream gradient
  through the SiLU), the reduce kernel gives ``r1 = sum_rows dn`` and
  ``r2 = sum_rows dn * xhat`` per (image, channel); the dx kernel gives
  ``dx = inv * (dn * gamma - A_g / m - xhat * B_g / m)`` with
  ``A_g = sum_g gamma * r1``, ``B_g = sum_g gamma * r2`` and
  ``m = HW * C / G``; ``dgamma = sum_b r2`` and ``dbeta = sum_b r1``.

Bound on an H100: every kernel here is a reduction and/or one elementwise
pass, a few FLOP per element, so the bound is bytes. Forward: one read and
one write of ``x``. Backward reduce: one read of ``x`` and ``g``. Backward
dx: one read of ``x`` and ``g``, one write of ``dx``. On the VAE's main path
(42 calls per flagship step at b8, 256²x32 down to 32²x128) ``x`` is 36.0 M
elements per image.

Design (the TPU kernels ran one grid step per image in the forward, and
summed ``r1`` / ``r2`` across a sequential row-block grid axis in the
backward; on this card blocks run in parallel in no order, and 8 images
would fill 8 of 132 SMs):

1. ``_stats_kernel``, grid (B, n_blk): each program sums a contiguous slab of
   rows of one image into per-channel f32 partial sums and sums of squares,
   ``[B, n_blk, 2, C]``. Rows are split so that B * n_blk fills the card.
2. ``_apply_kernel``, same grid: each program first folds the partials of its
   image, in a fixed order (no float atomics: every program of an image gets
   the same statistics bit for bit, run after run), reduces channels to
   groups with a one-hot group map (a group's channels are strided in
   NHWC), and turns mean and inverse std into per-channel ``mul`` / ``add``;
   then it streams its slab once more and writes ``silu(x * mul + add)``.
   When a backward will follow, the first program of each image also stores
   the image's ``[G]`` mean and inverse std (two launches either way).
3. ``_bwd_reduce_kernel``, same grid: recomputes ``xhat`` and ``dn`` from
   ``x``, ``g`` and the saved statistics and writes per-channel f32 partials
   of ``r1`` and ``r2``, ``[B, n_blk, 2, C]``.
4. ``_bwd_dx_kernel``, same grid: folds its image's partials in a fixed
   order, does the ``[B, G]`` group fold (``A_g``, ``B_g``) itself through the
   one-hot map, then streams its slab once more and writes ``dx``, rounded
   once to ``x``'s dtype. ``dgamma`` and ``dbeta`` are one ``torch.sum`` of
   the partials over (B, n_blk), outside the kernels, as the JAX package
   leaves that sum to XLA. No float atomics anywhere: ``dx``, ``dgamma`` and
   ``dbeta`` are bit-identical run to run.

So a backward call is two Triton launches plus one small ``torch.sum``, and
reads ``x`` and ``g`` twice. Fusing the second read away (a slab kept in
registers across a grid-wide barrier) is later work.

Semantics of the backward: it is the analytic derivative of
``silu((x - mean) * inv * gamma + beta)`` with ``inv = rsqrt(var + eps)``.
The forward clamps the one-pass variance at 0; the analytic backward, like
the TPU kernel's (which has no clamp at all), ignores the clamp's
zero-gradient region. It therefore differs from autograd of the plain
forward only for a group whose values are all equal.

``groupnorm_silu`` launches the kernels for CUDA tensors (or raises) and runs
the plain versions, forward and backward formula, for CPU tensors; nothing
falls back from one to the other. ``groupnorm_silu.launches`` counts forward
calls that launched the kernels, ``groupnorm_silu.bwd_reduce_launches`` and
``groupnorm_silu.bwd_dx_launches`` count launches of the two backward kernels.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["groupnorm_silu", "groupnorm_silu_plain", "groupnorm_silu_bwd_plain", "launch_grid"]

# Bound at build time by _triton_kernels(): this module must import without
# triton, which only the GPU host has.
tl = None

_TARGET_PROGRAMS = 4 * 132  # four programs per H100 SM
_MAX_BLOCKS_PER_IMAGE = 64
_TILE_ELEMENTS = 4096  # elements of one [BLOCK_R, BLOCK_C] tile


def _plain_forward(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean_g [B, G], inv_g [B, G]) of the plain forward."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    xg = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp(xg.square().mean(dim=(1, 3), keepdim=True) - mean.square(), min=0.0)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    y = y * scale.float() + bias.float()
    y = (y * torch.sigmoid(y)).to(x.dtype)
    return y, mean.reshape(b, num_groups), torch.rsqrt(var + eps).reshape(b, num_groups)


def groupnorm_silu_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
) -> torch.Tensor:
    """Plain PyTorch version of the forward kernels on an NHWC [B, H, W, C]
    tensor: f32 one-pass group statistics, biased variance clamped at 0, SiLU
    in f32, one rounding to ``x.dtype``."""
    return _plain_forward(x, scale, bias, num_groups, eps)[0]


def groupnorm_silu_bwd_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean_g: torch.Tensor,
    inv_g: torch.Tensor, g: torch.Tensor, num_groups: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: ``(dx, dscale, dbias)``
    from the saved ``[B, G]`` mean and inverse std, by the formulas in the
    module docstring. All math in f32; ``dx`` rounded once to ``x.dtype``,
    ``dscale`` and ``dbias`` f32."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xf = x.float().reshape(b, -1, c)
    gf = g.float().reshape(b, -1, c)
    count = xf.shape[1] * cg
    gamma, beta = scale.float(), bias.float()
    mean_c = mean_g.float().repeat_interleave(cg, dim=1)[:, None, :]  # [B, 1, C]
    inv_c = inv_g.float().repeat_interleave(cg, dim=1)[:, None, :]
    xhat = (xf - mean_c) * inv_c
    n = xhat * gamma + beta
    sig = torch.sigmoid(n)
    dn = gf * sig * (1.0 + n * (1.0 - sig))
    r1 = dn.sum(dim=1)  # [B, C]
    r2 = (dn * xhat).sum(dim=1)
    a_g = (r1 * gamma).reshape(b, num_groups, cg).sum(dim=2) / count  # [B, G]
    b_g = (r2 * gamma).reshape(b, num_groups, cg).sum(dim=2) / count
    a_c = a_g.repeat_interleave(cg, dim=1)[:, None, :]
    b_c = b_g.repeat_interleave(cg, dim=1)[:, None, :]
    dx = inv_c * (dn * gamma - a_c - xhat * b_c)
    return dx.reshape(x.shape).to(x.dtype), r2.sum(dim=0), r1.sum(dim=0)


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


def _apply_kernel(x_ptr, y_ptr, part_ptr, scale_ptr, bias_ptr, mean_ptr, inv_ptr,
                  HW, C, CG, G, rows_per_blk, n_blk, count, eps,
                  BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                  BLOCK_G: tl.constexpr, BLOCK_N: tl.constexpr, SAVE_STATS: tl.constexpr):
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
    if SAVE_STATS:
        # every program of an image holds the same values; the first stores them
        smask = (groups < G) & (blk == 0)
        tl.store(mean_ptr + b * G + groups, mean, mask=smask)
        tl.store(inv_ptr + b * G + groups, inv, mask=smask)
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


def _bwd_reduce_kernel(x_ptr, g_ptr, mean_ptr, inv_ptr, scale_ptr, bias_ptr, part_ptr,
                       HW, C, CG, G, rows_per_blk, n_blk,
                       BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
    b = tl.program_id(0)
    blk = tl.program_id(1)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    group = cols // CG
    mean_c = tl.load(mean_ptr + b * G + group, mask=cmask, other=0.0)
    inv_c = tl.load(inv_ptr + b * G + group, mask=cmask, other=0.0)
    gamma = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    beta = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(tl.float32)

    row_start = blk * rows_per_blk
    row_end = tl.minimum(row_start + rows_per_blk, HW)
    img = b.to(tl.int64) * HW * C
    acc1 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK_R, BLOCK_C], dtype=tl.float32)
    for r0 in range(row_start, row_end, BLOCK_R):
        rows = r0 + tl.arange(0, BLOCK_R)
        mask = (rows < row_end)[:, None] & cmask[None, :]
        offs = img + rows[:, None] * C + cols[None, :]
        xv = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        gv = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)  # 0 past the edge: dn = 0
        xhat = (xv - mean_c[None, :]) * inv_c[None, :]
        n = xhat * gamma[None, :] + beta[None, :]
        sig = 1.0 / (1.0 + tl.exp(-n))
        dn = gv * sig * (1.0 + n * (1.0 - sig))
        acc1 += dn
        acc2 += dn * xhat
    out = part_ptr + (b * n_blk + blk) * 2 * C
    tl.store(out + cols, tl.sum(acc1, axis=0), mask=cmask)
    tl.store(out + C + cols, tl.sum(acc2, axis=0), mask=cmask)


def _bwd_dx_kernel(x_ptr, g_ptr, dx_ptr, mean_ptr, inv_ptr, scale_ptr, bias_ptr, part_ptr,
                   HW, C, CG, G, rows_per_blk, n_blk, count,
                   BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                   BLOCK_G: tl.constexpr, BLOCK_N: tl.constexpr):
    b = tl.program_id(0)
    blk = tl.program_id(1)
    cols = tl.arange(0, BLOCK_C)
    cmask = cols < C
    group = cols // CG
    mean_c = tl.load(mean_ptr + b * G + group, mask=cmask, other=0.0)
    inv_c = tl.load(inv_ptr + b * G + group, mask=cmask, other=0.0)
    gamma = tl.load(scale_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    beta = tl.load(bias_ptr + cols, mask=cmask, other=0.0).to(tl.float32)

    # fold this image's r1 / r2 partials in a fixed order, then channels ->
    # groups -> channels through the one-hot map: A_g / m and B_g / m per channel
    blks = tl.arange(0, BLOCK_N)
    pmask = (blks < n_blk)[:, None] & cmask[None, :]
    parts = part_ptr + b * n_blk * 2 * C + blks[:, None] * 2 * C + cols[None, :]
    r1 = tl.sum(tl.load(parts, mask=pmask, other=0.0), axis=0)
    r2 = tl.sum(tl.load(parts + C, mask=pmask, other=0.0), axis=0)
    groups = tl.arange(0, BLOCK_G)
    onehot = ((cols[None, :] // CG) == groups[:, None]) & cmask[None, :]
    a_g = tl.sum(tl.where(onehot, (r1 * gamma)[None, :], 0.0), axis=1) / count
    b_g = tl.sum(tl.where(onehot, (r2 * gamma)[None, :], 0.0), axis=1) / count
    a_c = tl.sum(tl.where(onehot, a_g[:, None], 0.0), axis=0)
    b_c = tl.sum(tl.where(onehot, b_g[:, None], 0.0), axis=0)

    row_start = blk * rows_per_blk
    row_end = tl.minimum(row_start + rows_per_blk, HW)
    img = b.to(tl.int64) * HW * C
    for r0 in range(row_start, row_end, BLOCK_R):
        rows = r0 + tl.arange(0, BLOCK_R)
        mask = (rows < row_end)[:, None] & cmask[None, :]
        offs = img + rows[:, None] * C + cols[None, :]
        xv = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        gv = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        xhat = (xv - mean_c[None, :]) * inv_c[None, :]
        n = xhat * gamma[None, :] + beta[None, :]
        sig = 1.0 / (1.0 + tl.exp(-n))
        dn = gv * sig * (1.0 + n * (1.0 - sig))
        dxv = inv_c[None, :] * (dn * gamma[None, :] - a_c[None, :] - xhat * b_c[None, :])
        tl.store(dx_ptr + offs, dxv.to(dx_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _triton_kernels():
    """(stats, apply, backward reduce, backward dx) as Triton JIT functions."""
    import triton
    import triton.language

    globals()["tl"] = triton.language
    return (triton.jit(_stats_kernel), triton.jit(_apply_kernel),
            triton.jit(_bwd_reduce_kernel), triton.jit(_bwd_dx_kernel))


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


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int) -> None:
    c = x.shape[-1]
    if x.dim() != 4 or c % num_groups:
        raise ValueError(f"expected NHWC with C divisible by {num_groups}, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"groupnorm_silu takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_silu takes a contiguous NHWC tensor")
    if scale.shape != (c,) or bias.shape != (c,) or scale.device != x.device or bias.device != x.device:
        raise ValueError("scale and bias must be [C] tensors on x's device")


def _launch_forward(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
    save_stats: bool,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """The two forward launches on a CUDA tensor: (y, mean_g, inv_g); the
    statistics are ``None`` unless ``save_stats``."""
    _check(x, scale, bias, num_groups)
    b, hw, c = x.shape[0], x.shape[1] * x.shape[2], x.shape[-1]
    y = torch.empty_like(x)
    mean_g = inv_g = None
    if save_stats:
        mean_g, inv_g = torch.empty((2, b, num_groups), device=x.device, dtype=torch.float32)
    if x.numel() == 0:
        return y, mean_g, inv_g
    block_r, block_c, rows, n_blk = launch_grid(b, hw, c)
    cg = c // num_groups
    stats_kernel, apply_kernel, _, _ = _triton_kernels()
    parts = torch.empty((b, n_blk, 2, c), device=x.device, dtype=torch.float32)
    scale, bias = scale.contiguous(), bias.contiguous()
    with torch.cuda.device(x.device):
        stats_kernel[(b, n_blk)](x, parts, hw, c, rows, n_blk, BLOCK_R=block_r, BLOCK_C=block_c)
        apply_kernel[(b, n_blk)](
            x, y, parts, scale, bias,
            mean_g if save_stats else parts, inv_g if save_stats else parts,  # unread when not saving
            hw, c, cg, num_groups, rows, n_blk, float(hw * cg), float(eps),
            BLOCK_R=block_r, BLOCK_C=block_c, BLOCK_G=_next_pow2(num_groups),
            BLOCK_N=_next_pow2(n_blk), SAVE_STATS=save_stats,
        )
    groupnorm_silu.launches += 1
    return y, mean_g, inv_g


def _launch_backward(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean_g: torch.Tensor,
    inv_g: torch.Tensor, g: torch.Tensor, num_groups: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two backward launches on CUDA tensors: (dx, dscale f32, dbias f32)."""
    _check(x, scale, bias, num_groups)
    if g.shape != x.shape or g.device != x.device or g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"upstream gradient {tuple(g.shape)} {g.dtype} does not match x")
    g = g.contiguous()  # autograd often hands over a strided view
    b, hw, c = x.shape[0], x.shape[1] * x.shape[2], x.shape[-1]
    dx = torch.empty_like(x)
    if x.numel() == 0:
        zeros = torch.zeros(c, device=x.device, dtype=torch.float32)
        return dx, zeros, zeros.clone()
    block_r, block_c, rows, n_blk = launch_grid(b, hw, c)
    cg = c // num_groups
    _, _, reduce_kernel, dx_kernel = _triton_kernels()
    parts = torch.empty((b, n_blk, 2, c), device=x.device, dtype=torch.float32)
    scale, bias = scale.contiguous(), bias.contiguous()
    mean_g, inv_g = mean_g.contiguous(), inv_g.contiguous()
    with torch.cuda.device(x.device):
        reduce_kernel[(b, n_blk)](
            x, g, mean_g, inv_g, scale, bias, parts, hw, c, cg, num_groups, rows, n_blk,
            BLOCK_R=block_r, BLOCK_C=block_c,
        )
        groupnorm_silu.bwd_reduce_launches += 1
        dx_kernel[(b, n_blk)](
            x, g, dx, mean_g, inv_g, scale, bias, parts, hw, c, cg, num_groups, rows, n_blk,
            float(hw * cg),
            BLOCK_R=block_r, BLOCK_C=block_c, BLOCK_G=_next_pow2(num_groups),
            BLOCK_N=_next_pow2(n_blk),
        )
        groupnorm_silu.bwd_dx_launches += 1
    r = parts.sum(dim=(0, 1))  # [2, C]: dbeta = sum_b r1, dgamma = sum_b r2
    return dx, r[1], r[0]


class _GroupNormSiLU(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA) or their plain versions (CPU)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        if x.device.type == "cpu":
            y, mean_g, inv_g = _plain_forward(x, scale, bias, num_groups, eps)
        else:
            y, mean_g, inv_g = _launch_forward(x, scale, bias, num_groups, eps, save_stats=True)
        ctx.save_for_backward(x, scale, bias, mean_g, inv_g)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, mean_g, inv_g = ctx.saved_tensors
        bwd = groupnorm_silu_bwd_plain if x.device.type == "cpu" else _launch_backward
        dx, dscale, dbias = bwd(x, scale, bias, mean_g, inv_g, g, ctx.num_groups)
        return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None


def groupnorm_silu(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
) -> torch.Tensor:
    """``silu(group_norm(x))`` of an NHWC [B, H, W, C] tensor, differentiable
    in ``x``, ``scale`` and ``bias``: the Triton kernels for CUDA tensors, the
    plain versions for CPU tensors. With no gradient wanted nothing is saved."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"groupnorm_silu runs on cuda or cpu, got {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        if x.device.type == "cuda":
            _check(x, scale, bias, num_groups)
        return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps)
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, scale, bias, num_groups, eps)
    return _launch_forward(x, scale, bias, num_groups, eps, save_stats=False)[0]


groupnorm_silu.launches = 0
groupnorm_silu.bwd_reduce_launches = 0
groupnorm_silu.bwd_dx_launches = 0
