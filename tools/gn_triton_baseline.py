"""The GroupNorm+SiLU Triton kernels that served the port before the cluster
kernels (``csrc/groupnorm_silu_fwd.cu``, ``csrc/groupnorm_silu_bwd.cu``)
replaced them, kept here only as the baseline that
``tools/check_gn_kernels.py --time`` times in turns with the new kernels.

Forward: ``_stats_kernel`` writes per-block partial sums ``[B, n_blk, 2, C]``,
``_apply_kernel`` folds them (every program of an image, in a fixed order)
and streams ``x`` a second time to write ``y``. Backward: ``_bwd_reduce_kernel``
writes partials of ``r1`` / ``r2``, ``_bwd_dx_kernel`` folds them and streams
``x`` and ``g`` a second time to write ``dx``; then one ``torch.sum``. Needs
``triton`` (imported at the first launch).
"""

from __future__ import annotations

import functools

import torch

# Bound at build time by _triton_kernels(): this module must import without triton.
tl = None

_TARGET_PROGRAMS = 4 * 132  # four programs per H100 SM
_MAX_BLOCKS_PER_IMAGE = 64
_TILE_ELEMENTS = 4096  # elements of one [BLOCK_R, BLOCK_C] tile


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


def launch_forward(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
    save_stats: bool,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """The two forward launches on a CUDA tensor: (y, mean_g, inv_g); the
    statistics are ``None`` unless ``save_stats``."""
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
    return y, mean_g, inv_g


def launch_backward(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean_g: torch.Tensor,
    inv_g: torch.Tensor, g: torch.Tensor, num_groups: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two backward launches on CUDA tensors: (dx, dscale f32, dbias f32)."""
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
        dx_kernel[(b, n_blk)](
            x, g, dx, mean_g, inv_g, scale, bias, parts, hw, c, cg, num_groups, rows, n_blk,
            float(hw * cg),
            BLOCK_R=block_r, BLOCK_C=block_c, BLOCK_G=_next_pow2(num_groups),
            BLOCK_N=_next_pow2(n_blk),
        )
    r = parts.sum(dim=(0, 1))  # [2, C]: dbeta = sum_b r1, dgamma = sum_b r2
    return dx, r[1], r[0]
