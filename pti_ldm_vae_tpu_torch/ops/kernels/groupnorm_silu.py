"""Fused GroupNorm + SiLU, forward and backward: hand-written CUDA C++
thread-block-cluster kernels beside their plain PyTorch versions, bound to
autograd.

Replaces ``pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py``:

* ``_forward`` (body ``_kernel``) by ``csrc/groupnorm_silu_fwd.cu``: per-image
  f32 sums and sums of squares per group of contiguous channels, the
  one-pass biased variance (clamped at 0, as the plain path ``ops/norm.py``
  of the JAX package does), then ``silu(x * mul + add)`` computed in f32 and
  stored once in the input dtype; also the ``[B, G]`` f32 mean and inverse
  std, which the backward reads instead of recomputing them;
* ``_bwd_pallas`` (bodies ``_bwd_reduce_kernel`` and ``_bwd_dx_kernel``) by
  one launch of ``csrc/groupnorm_silu_bwd.cu``: with
  ``xhat = (x - mean) * inv``, ``n = xhat * gamma + beta`` and
  ``dn = g * sigmoid(n) * (1 + n * (1 - sigmoid(n)))`` (the upstream gradient
  through the SiLU), ``r1 = sum_rows dn`` and ``r2 = sum_rows dn * xhat`` per
  (image, channel), then
  ``dx = inv * (dn * gamma - A_g / m - xhat * B_g / m)`` with
  ``A_g = sum_g gamma * r1``, ``B_g = sum_g gamma * r2`` and
  ``m = HW * C / G``; ``dgamma = sum_b r2`` and ``dbeta = sum_b r1`` (one
  small ``torch.sum`` of the kernel's ``[B, 2, C]`` output).

Bound on an H100: a few FLOP per element, so bytes. Forward: one read and
one write of ``x``. Backward: one read of ``x`` and ``g``, one write of
``dx``. On the VAE's main path (42 calls per flagship pass at b8, 256²x32
down to 32²x128) ``x`` is 36.0 M elements per image.

Design (the TPU kernels ran one grid step per image, the whole image in
VMEM; on this card a block holds at most 227 KB and 8 images would fill 8
of 132 SMs): an image's channels are cut into slices of whole groups
(``gn_plan``), each (image, slice) is one thread-block cluster of up to 16
blocks that split its rows, stage them in shared memory while summing, fold
the sums through distributed shared memory in a fixed order, and write the
output from the staged copy, so ``x`` (and ``g``) cross HBM once per call.
Where no cluster holds a slice within room for two blocks per SM (the 256²
images of the flagship path), nothing is staged: both passes stream, the
second mostly from L2, with slices widened to at most 16 clusters, which
the card holds at once (measured faster than staging part of each slice,
``tools/check_gn_kernels.py --ablate``). No float atomics: every output is
bit-identical run to run. The sources describe the kernels.

Semantics of the backward: it is the analytic derivative of
``silu((x - mean) * inv * gamma + beta)`` with ``inv = rsqrt(var + eps)``.
The forward clamps the one-pass variance at 0; the analytic backward, like
the TPU kernel's (which has no clamp at all), ignores the clamp's
zero-gradient region. It therefore differs from autograd of the plain
forward only for a group whose values are all equal.

The split form (``groupnorm_silu_split``), for an image whose rows lie on
several ranks (spatial sharding), is the TPU backward's two-kernel shape
applied to both directions, four entries of the same two sources around the
caller's all-reduce: the per-(image, group) partial sums of x and x^2
(``groupnorm_silu_split_stats``), the normalisation, affine and SiLU from
the mean and inverse std of the all-reduced sums
(``groupnorm_silu_split_apply``), the per-(image, channel) partial sums of
dn and dn * xhat (``groupnorm_silu_split_bwd_reduce``), and dx from the
all-reduced sums (``groupnorm_silu_split_bwd_dx``). Each launches over
(row tile, image) blocks of all channels with a two-stage, atomic-free
reduction (``split_plan``); each has its plain version here, and counts its
launches (``groupnorm_silu.split_launches``, keyed by entry). The one-pass
formula ``var = max(E[x^2] - E[x]^2, 0)`` on the summed partials is the
fused kernel's arithmetic up to the order of the sums. The fused kernels
stay the unsharded path.

``groupnorm_silu`` launches the kernels for CUDA tensors (or raises) and runs
the plain versions, forward and backward formula, for CPU tensors; nothing
falls back from one to the other. ``groupnorm_silu.launches`` counts forward
launches, ``groupnorm_silu.bwd_launches`` backward launches. Under
``torch.func.vmap`` the forward and the backward fold the vmapped axis into
the batch (one launch) where ``scale`` and ``bias`` are shared, and launch
once per image where each image has its own (``_vmap.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._vmap import fold, front, transformed, unfold

__all__ = ["groupnorm_silu", "groupnorm_silu_plain", "groupnorm_silu_bwd_plain", "GnPlan",
           "gn_plan", "gn_smem_bytes", "SOURCES", "SPLIT_ENTRIES", "SplitPlan", "split_plan",
           "groupnorm_silu_split", "groupnorm_silu_split_stats_plain",
           "groupnorm_silu_split_apply_plain", "groupnorm_silu_split_bwd_reduce_plain",
           "groupnorm_silu_split_bwd_dx_plain", "split_moments"]

_FWD_SOURCE = "groupnorm_silu_fwd.cu"
_BWD_SOURCE = "groupnorm_silu_bwd.cu"
SOURCES = (_FWD_SOURCE, _BWD_SOURCE)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

SMEM_LIMIT = 232_448  # shared memory one block may use on an H100
SM_SMEM = 233_472  # shared memory of one SM, of which each resident block takes 1 KB more
STAGE_BLOCKS_PER_SM = 2  # a block stages a slice only within room for two blocks per SM
MAX_THREADS = 256  # threads per block (the kernels' __launch_bounds__)
MAX_CLUSTER = 16  # blocks per cluster (above 8 only as a non-portable size)
TARGET_BLOCKS = 256  # about two blocks per SM of an H100
MIN_SEGMENT_BYTES = 32  # a slice's part of one pixel row: at least one sector
MIN_ROWS_PER_THREAD = 2  # a cluster grows for more blocks only while each thread keeps this many rows
STREAM_CLUSTERS = 16  # a call that cannot stage its slices is cut into at most this many clusters
# clusters of 16 blocks an H100 holds for each block it can place on every SM
# (cudaOccupancyMaxActiveClusters: 7, 14, 21, 28 at 1 to 4 blocks per SM)
CLUSTERS_OF_16_PER_SLOT = 7


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
    dx, r = _plain_backward(x, scale, bias, mean_g, inv_g, g, num_groups)
    r = r.sum(dim=0)
    return dx, r[1], r[0]


def _plain_backward(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean_g: torch.Tensor,
    inv_g: torch.Tensor, g: torch.Tensor, num_groups: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, r [B, 2, C])`` of the plain backward, ``r[:, 0]`` = r1 and
    ``r[:, 1]`` = r2 per image: the kernel's own output."""
    r = groupnorm_silu_split_bwd_reduce_plain(x, g, scale, bias, mean_g, inv_g, num_groups)
    count = x[0, ..., 0].numel() * (x.shape[-1] // num_groups)
    dx = groupnorm_silu_split_bwd_dx_plain(x, g, scale, bias, mean_g, inv_g, r, num_groups, count)
    return dx, r


def _dn_xhat(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             mean_g: torch.Tensor, inv_g: torch.Tensor, num_groups: int
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(xhat, dn, inv_c)`` in f32, ``[B, HW, C]`` (``inv_c`` ``[B, 1, C]``)."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xf = x.float().reshape(b, -1, c)
    gf = g.float().reshape(b, -1, c)
    gamma, beta = scale.float(), bias.float()
    mean_c = mean_g.float().repeat_interleave(cg, dim=1)[:, None, :]  # [B, 1, C]
    inv_c = inv_g.float().repeat_interleave(cg, dim=1)[:, None, :]
    xhat = (xf - mean_c) * inv_c
    n = xhat * gamma + beta
    sig = torch.sigmoid(n)
    return xhat, gf * sig * (1.0 + n * (1.0 - sig)), inv_c


def groupnorm_silu_split_stats_plain(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Plain version of ``groupnorm_silu_split_stats``: per (image, group) the
    f32 sums of x and x^2 over this tensor's rows, ``[B, G, 2]``."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    xg = x.float().reshape(b, -1, num_groups, c // num_groups)
    return torch.stack([xg.sum(dim=(1, 3)), xg.square().sum(dim=(1, 3))], dim=-1)


def split_moments(stats: torch.Tensor, count: float, eps: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean, inv)`` ``[B, G]`` from the whole image's ``[B, G, 2]`` sums of
    ``count`` elements a group: the one-pass variance clamped at 0, as the
    fused kernels and the JAX ``ops/norm.py`` compute it."""
    mean = stats[..., 0] / count
    var = torch.clamp(stats[..., 1] / count - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)


def groupnorm_silu_split_apply_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean_g: torch.Tensor,
    inv_g: torch.Tensor, num_groups: int,
) -> torch.Tensor:
    """Plain version of ``groupnorm_silu_split_apply``: ``silu(x * mul + add)``
    with ``mul = inv * gamma``, ``add = beta - mean * mul`` in f32, one
    rounding to ``x.dtype``."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    mul = inv_g.float().repeat_interleave(cg, dim=1)[:, None, :] * scale.float()  # [B, 1, C]
    add = bias.float() - mean_g.float().repeat_interleave(cg, dim=1)[:, None, :] * mul
    y = x.float().reshape(b, -1, c) * mul + add
    return (y * torch.sigmoid(y)).reshape(x.shape).to(x.dtype)


def groupnorm_silu_split_bwd_reduce_plain(
    x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    mean_g: torch.Tensor, inv_g: torch.Tensor, num_groups: int,
) -> torch.Tensor:
    """Plain version of ``groupnorm_silu_split_bwd_reduce``: per (image,
    channel) ``r1 = sum dn`` and ``r2 = sum dn * xhat`` over this tensor's
    rows, ``[B, 2, C]`` f32."""
    xhat, dn, _ = _dn_xhat(x, g, scale, bias, mean_g, inv_g, num_groups)
    return torch.stack([dn.sum(dim=1), (dn * xhat).sum(dim=1)], dim=1)


def groupnorm_silu_split_bwd_dx_plain(
    x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    mean_g: torch.Tensor, inv_g: torch.Tensor, r: torch.Tensor, num_groups: int, count: float,
) -> torch.Tensor:
    """Plain version of ``groupnorm_silu_split_bwd_dx``: ``dx = inv * (dn *
    gamma - A_g / m - xhat * B_g / m)`` from the whole image's ``[B, 2, C]``
    sums ``r`` and ``m = count`` elements a group, rounded once to
    ``x.dtype``."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    gamma = scale.float()
    xhat, dn, inv_c = _dn_xhat(x, g, scale, bias, mean_g, inv_g, num_groups)
    a_g = (r[:, 0] * gamma).reshape(b, num_groups, cg).sum(dim=2) / count  # [B, G]
    b_g = (r[:, 1] * gamma).reshape(b, num_groups, cg).sum(dim=2) / count
    a_c = a_g.repeat_interleave(cg, dim=1)[:, None, :]
    b_c = b_g.repeat_interleave(cg, dim=1)[:, None, :]
    dx = inv_c * (dn * gamma - a_c - xhat * b_c)
    return dx.reshape(x.shape).to(x.dtype)


class GnPlan(NamedTuple):
    """How one call is cut (the kernels' arguments).

    ``slice_channels`` (SC): channels of one slice, whole groups; a cluster of
    ``cluster_size`` blocks owns one (image, slice), block rank ``r`` its rows
    ``[r * rows_per_block, (r + 1) * rows_per_block)``; the first
    ``staged_rows`` of a block's rows of each tensor named in ``staged``
    (``"x"``, ``"g"``, ``"xg"`` or ``""``) are staged in shared memory;
    ``vec`` channels per thread and access (one 16-byte vector, or 1 for
    tensors not 16-byte aligned), ``threads`` per block, ``smem_bytes`` of
    dynamic shared memory per block."""

    slice_channels: int
    cluster_size: int
    rows_per_block: int
    staged_rows: int
    smem_bytes: int
    vec: int
    threads: int
    staged: str


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def gn_smem_bytes(slice_channels: int, cluster_size: int, threads: int, vec: int, staged_x: int,
                  staged_g: int, esize: int) -> int:
    """Dynamic shared memory of one block (``layout`` in ``csrc/groupnorm_silu.cuh``):
    the staged rows of x and of g, the block's published partials (2*SC f32),
    the cluster's partials gathered (CS*2*SC f32), the per-warp (or per
    thread-row) partials (2*P*SC f32) and the per-channel coefficients
    (2*SC f32), each rounded up to 16 bytes."""
    sc = slice_channels
    nv = sc // vec
    rows = threads // 32 if 32 % nv == 0 else threads // nv
    return (_round16(staged_x * sc * esize) + _round16(staged_g * sc * esize) + _round16(8 * sc)
            + _round16(cluster_size * 8 * sc) + _round16(8 * rows * sc) + _round16(8 * sc))


def _blocks_per_sm(backward: bool, dtype: torch.dtype) -> int:
    """Blocks of 256 threads an SM holds by the kernels' register caps
    (``__launch_bounds__``: 64 registers a thread forward, 128 backward in
    bf16, 85 backward in f32)."""
    if not backward:
        return 4
    return 2 if dtype == torch.bfloat16 else 3


def gn_plan(b: int, h: int, w: int, c: int, num_groups: int, dtype: torch.dtype,
            backward: bool = False, aligned: bool = True, *, staged: str | None = None,
            cluster_size: int | None = None, min_segment: int = MIN_SEGMENT_BYTES) -> GnPlan:
    """The cut of one GroupNorm+SiLU call on a [b, h, w, c] tensor (a pure function).

    - Slice: the fewest whole groups whose part of a pixel row is at least
      ``min_segment`` bytes (one 32-byte sector) and, on the vector route, a
      multiple of 16 bytes; all channels if none is.
    - Vector route (``vec`` = 16 bytes of channels) when ``aligned`` (the
      caller's tensors start 16-byte aligned) and rows and slices are whole
      16-byte vectors; else one channel per access and nothing staged.
    - Threads: ``SC / vec`` columns times as many rows of threads as fit in
      ``MAX_THREADS``.
    - Staging: the forward stages x, the backward x and g, when some cluster
      of at most ``MAX_CLUSTER`` blocks holds the whole slice within room for
      ``STAGE_BLOCKS_PER_SM`` blocks per SM. Cluster: the fewest blocks that do, then
      twice as many while the grid has fewer than ``TARGET_BLOCKS`` blocks and
      every thread keeps ``MIN_ROWS_PER_THREAD`` rows.
    - Otherwise (256² and larger images) nothing is staged and both passes
      stream: slices widen (by whole groups, doubling the segment) until the
      call has at most ``STREAM_CLUSTERS`` clusters, of 16 blocks where the
      card holds them all at once by the kernel's register cap, else of 8.

    ``staged`` ("x", "g", "xg" or "") and ``cluster_size`` force a cut (for
    measurements): the fewest fitting blocks as above, and the rows that do
    not fit are read from global memory twice (``staged_rows <
    rows_per_block``)."""
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"groupnorm_silu takes float32 or bfloat16, got {dtype}")
    if staged not in (None, "x", "g", "xg", ""):
        raise ValueError(f"staged must be 'x', 'g', 'xg' or '', got {staged!r}")
    esize = 4 if dtype == torch.float32 else 2
    vector = aligned and c * esize % 16 == 0
    slices = [k * (c // num_groups) for k in range(1, num_groups + 1) if num_groups % k == 0]

    def slice_of(segment: int) -> int:
        return next((s for s in slices if s * esize >= segment
                     and (not vector or s * esize % 16 == 0)), c)

    def cut(sc: int, mode: str, cs: int | None) -> GnPlan:
        return _cut(b, h * w, c, sc, esize, vector, mode, cs)

    if staged is not None:
        return cut(slice_of(min_segment), staged, cluster_size)
    plan = cut(slice_of(min_segment), "xg" if backward else "x", cluster_size)
    if plan.staged_rows == plan.rows_per_block or plan.vec == 1:
        return plan
    segment = min_segment
    while b * (c // slice_of(segment)) > STREAM_CLUSTERS and slice_of(segment) < c:
        segment *= 2
    sc = slice_of(segment)
    resident = CLUSTERS_OF_16_PER_SLOT * _blocks_per_sm(backward, dtype)
    return cut(sc, "", cluster_size or (MAX_CLUSTER if b * (c // sc) <= resident else MAX_CLUSTER // 2))


def _cut(b: int, hw: int, c: int, sc: int, esize: int, vector: bool, staged: str,
         cluster_size: int | None) -> GnPlan:
    """``gn_plan``'s cut for one slice width and staging mode."""
    vec = 16 // esize if vector and sc * esize % 16 == 0 else 1
    nv = sc // vec
    if nv > MAX_THREADS:
        raise ValueError(f"a slice of {sc} channels needs {nv} threads a row (at most {MAX_THREADS})")
    threads = nv * (MAX_THREADS // nv)
    rit = threads // nv
    n_staged = len(staged) if vec > 1 else 0
    row_bytes = sc * esize
    budget = min(SMEM_LIMIT, SM_SMEM // STAGE_BLOCKS_PER_SM - 1024)

    def rows(cs: int) -> int:
        return -(-hw // cs)

    def fits(cs: int) -> bool:
        return (gn_smem_bytes(sc, cs, threads, vec, 0, 0, esize)
                + n_staged * _round16(rows(cs) * row_bytes)) <= budget

    cs = 1
    while cs < MAX_CLUSTER and not fits(cs):
        cs *= 2
    while (cs < MAX_CLUSTER and b * (c // sc) * cs < TARGET_BLOCKS
           and rows(2 * cs) >= MIN_ROWS_PER_THREAD * rit):
        cs *= 2
    if cluster_size is not None:
        cs = cluster_size
    rows_per_block = rows(cs)
    staged_rows = 0
    if n_staged:
        room = budget - gn_smem_bytes(sc, cs, threads, vec, 0, 0, esize)
        staged_rows = max(0, min(rows_per_block, room // (n_staged * row_bytes)))
    sx = staged_rows if "x" in staged and n_staged else 0
    sg = staged_rows if "g" in staged and n_staged else 0
    return GnPlan(sc, cs, rows_per_block, staged_rows, gn_smem_bytes(sc, cs, threads, vec, sx, sg, esize),
                  vec, threads, staged if n_staged else "")


@functools.lru_cache(maxsize=256)
def _plan(b: int, h: int, w: int, c: int, num_groups: int, dtype: torch.dtype, backward: bool,
          aligned: bool) -> GnPlan:
    """``gn_plan`` once per shape: the wrappers need it at every launch, on a
    path the host already holds back."""
    return gn_plan(b, h, w, c, num_groups, dtype, backward, aligned)


@functools.cache
def _library(source: str) -> ctypes.CDLL:
    from ._build import load

    lib = load(source)
    if source == _FWD_SOURCE:
        lib.groupnorm_silu_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
                                           + [ctypes.c_float, ctypes.c_void_p])
        lib.groupnorm_silu_fwd.restype = ctypes.c_int
    else:
        lib.groupnorm_silu_bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        lib.groupnorm_silu_bwd.restype = ctypes.c_int
    prefix = "groupnorm_silu_fwd" if source == _FWD_SOURCE else "groupnorm_silu_bwd"
    fn = getattr(lib, f"{prefix}_clusters")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def max_active_clusters(source: str, dtype_code: int, vec: int, cluster_size: int, threads: int,
                        smem_bytes: int) -> int:
    """Clusters of one plan the card holds at once (``cudaOccupancyMaxActiveClusters``);
    raises if the plan cannot be scheduled at all. Asked once per plan and process."""
    lib = _library(source)
    prefix = "groupnorm_silu_fwd" if source == _FWD_SOURCE else "groupnorm_silu_bwd"
    out = ctypes.c_int(0)
    err = getattr(lib, f"{prefix}_clusters")(dtype_code, vec, cluster_size, threads, smem_bytes,
                                              ctypes.byref(out))
    if err != 0 or out.value < 1:
        raise RuntimeError(f"{prefix}: a cluster of {cluster_size} blocks x {threads} threads x "
                           f"{smem_bytes} bytes cannot be scheduled (CUDA error {err}, "
                           f"{out.value} clusters)")
    return out.value


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int) -> None:
    c = x.shape[-1]
    if x.dim() != 4 or c % num_groups:
        raise ValueError(f"expected NHWC with C divisible by {num_groups}, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"groupnorm_silu takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_silu takes a contiguous NHWC tensor")
    if scale.shape != (c,) or bias.shape != (c,) or scale.device != x.device or bias.device != x.device:
        raise ValueError("scale and bias must be [C] tensors on x's device")


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_forward(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
    save_stats: bool, plan: GnPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """One forward launch on a CUDA tensor: (y, mean_g, inv_g); the statistics
    are ``None`` unless ``save_stats``. ``plan`` overrides ``gn_plan`` (for
    measurements of other cuts)."""
    _check(x, scale, bias, num_groups)
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    mean_g = inv_g = None
    if save_stats:
        mean_g, inv_g = torch.empty((2, b, num_groups), device=x.device, dtype=torch.float32)
    if x.numel() == 0:
        return y, mean_g, inv_g
    if plan is None:
        plan = _plan(b, h, w, c, num_groups, x.dtype, False, _aligned(x, y))
    code = _DTYPE_CODES[x.dtype]
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    with torch.cuda.device(x.device):
        max_active_clusters(_FWD_SOURCE, code, plan.vec, plan.cluster_size, plan.threads,
                            plan.smem_bytes)
        err = _library(_FWD_SOURCE).groupnorm_silu_fwd(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean_g.data_ptr() if save_stats else None, inv_g.data_ptr() if save_stats else None,
            b, h * w, c, c // num_groups, plan.slice_channels, plan.cluster_size,
            plan.rows_per_block, plan.staged_rows if "x" in plan.staged else 0, plan.vec,
            plan.threads, plan.smem_bytes, code, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_silu forward launch failed: CUDA error {err} ({plan})")
    groupnorm_silu.launches += 1
    return y, mean_g, inv_g


def _launch_backward(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean_g: torch.Tensor,
    inv_g: torch.Tensor, g: torch.Tensor, num_groups: int, plan: GnPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward launch on CUDA tensors, then the sum over images of its
    ``[B, 2, C]`` output: (dx, dscale f32, dbias f32). ``plan`` overrides
    ``gn_plan`` (for measurements of other cuts)."""
    dx, r = _launch_backward_parts(x, scale, bias, mean_g, inv_g, g, num_groups, plan)
    r = r.sum(dim=0)  # [2, C]: dbeta = sum_b r1, dgamma = sum_b r2
    return dx, r[1], r[0]


def _launch_backward_parts(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean_g: torch.Tensor,
    inv_g: torch.Tensor, g: torch.Tensor, num_groups: int, plan: GnPlan | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One backward launch on CUDA tensors: (dx, its ``[B, 2, C]`` f32 sums
    r1, r2 per image)."""
    _check(x, scale, bias, num_groups)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"upstream gradient {tuple(g.shape)} on {g.device} does not match x")
    g = g.to(x.dtype).contiguous()  # autograd often hands over a strided view
    b, h, w, c = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx, torch.zeros((b, 2, c), device=x.device, dtype=torch.float32)
    if plan is None:
        plan = _plan(b, h, w, c, num_groups, x.dtype, True, _aligned(x, g, dx))
    code = _DTYPE_CODES[x.dtype]
    r = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    mean_g, inv_g = mean_g.float().contiguous(), inv_g.float().contiguous()
    with torch.cuda.device(x.device):
        max_active_clusters(_BWD_SOURCE, code, plan.vec, plan.cluster_size, plan.threads,
                            plan.smem_bytes)
        err = _library(_BWD_SOURCE).groupnorm_silu_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean_g.data_ptr(), inv_g.data_ptr(), r.data_ptr(),
            b, h * w, c, c // num_groups, plan.slice_channels, plan.cluster_size,
            plan.rows_per_block, plan.staged_rows if "x" in plan.staged else 0,
            plan.staged_rows if "g" in plan.staged else 0, plan.vec, plan.threads,
            plan.smem_bytes, code, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"groupnorm_silu backward launch failed: CUDA error {err} ({plan})")
    groupnorm_silu.bwd_launches += 1
    return dx, r


class _GroupNormSiLU(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA) or their plain versions
    (CPU): ``(y, mean_g, inv_g)``, the statistics not differentiable."""

    @staticmethod
    def forward(x, scale, bias, num_groups, eps):
        if x.device.type == "cpu":
            return _plain_forward(x, scale, bias, num_groups, eps)
        return _launch_forward(x, scale, bias, num_groups, eps, save_stats=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias, num_groups, _ = inputs
        _, mean_g, inv_g = output
        ctx.mark_non_differentiable(mean_g, inv_g)
        ctx.save_for_backward(x, scale, bias, mean_g, inv_g)
        ctx.num_groups = num_groups

    @staticmethod
    def backward(ctx, g, _g_mean, _g_inv):
        x, scale, bias, mean_g, inv_g = ctx.saved_tensors
        dx, r = _GroupNormSiLUBackward.apply(x, scale, bias, mean_g, inv_g, g, ctx.num_groups)
        r = r.sum(dim=0)  # [2, C]: dbeta = sum_b r1, dgamma = sum_b r2
        return dx, r[1].to(scale.dtype), r[0].to(bias.dtype), None, None

    @staticmethod
    def vmap(info, in_dims, x, scale, bias, num_groups, eps):
        n = info.batch_size
        x = front(x, in_dims[0], n)
        if in_dims[1] is None and in_dims[2] is None:  # shared scale and bias: one launch
            out = _GroupNormSiLU.apply(fold(x), scale, bias, num_groups, eps)
            return tuple(unfold(t, n) for t in out), (0, 0, 0)
        scale, bias = front(scale, in_dims[1], n), front(bias, in_dims[2], n)
        outs = [_GroupNormSiLU.apply(x[i].contiguous(), scale[i], bias[i], num_groups, eps)
                for i in range(n)]
        return tuple(torch.stack(t) for t in zip(*outs)), (0, 0, 0)


class _GroupNormSiLUBackward(torch.autograd.Function):
    """The backward launch (CUDA) or its plain version (CPU) as a Function of
    its own, so that ``torch.func.vmap`` reaches it through ``vmap``:
    ``(dx, r [B, 2, C])``. Not differentiable itself."""

    @staticmethod
    def forward(x, scale, bias, mean_g, inv_g, g, num_groups):
        if x.device.type == "cpu":
            return _plain_backward(x, scale, bias, mean_g, inv_g, g, num_groups)
        return _launch_backward_parts(x, scale, bias, mean_g, inv_g, g, num_groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("groupnorm_silu is differentiable once")

    @staticmethod
    def vmap(info, in_dims, x, scale, bias, mean_g, inv_g, g, num_groups):
        n = info.batch_size
        x, mean_g, inv_g, g = (front(t, d, n) for t, d in zip(
            (x, mean_g, inv_g, g), (in_dims[0], in_dims[3], in_dims[4], in_dims[5])))
        if in_dims[1] is None and in_dims[2] is None:  # shared scale and bias: one launch
            dx, r = _GroupNormSiLUBackward.apply(fold(x), scale, bias, fold(mean_g), fold(inv_g),
                                                 fold(g), num_groups)
            return (unfold(dx, n), unfold(r, n)), (0, 0)
        scale, bias = front(scale, in_dims[1], n), front(bias, in_dims[2], n)
        outs = [_GroupNormSiLUBackward.apply(x[i].contiguous(), scale[i], bias[i], mean_g[i],
                                             inv_g[i], g[i], num_groups) for i in range(n)]
        return tuple(torch.stack(t) for t in zip(*outs)), (0, 0)


def groupnorm_silu(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float
) -> torch.Tensor:
    """``silu(group_norm(x))`` of an NHWC [B, H, W, C] tensor, differentiable
    in ``x``, ``scale`` and ``bias``: the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors. With no gradient wanted nothing is saved.
    Under ``torch.func`` transforms it runs through its Function's rules."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"groupnorm_silu runs on cuda or cpu, got {x.device}")
    if transformed(x, scale, bias):
        return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps)[0]
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        if x.device.type == "cuda":
            _check(x, scale, bias, num_groups)
        return _GroupNormSiLU.apply(x, scale, bias, num_groups, eps)[0]
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, scale, bias, num_groups, eps)
    return _launch_forward(x, scale, bias, num_groups, eps, save_stats=False)[0]


groupnorm_silu.launches = 0
groupnorm_silu.bwd_launches = 0


# ---- the split form -------------------------------------------------------------------

# entry -> source; the calls of each are counted in groupnorm_silu.split_launches[entry], one
# a call: a statistics or backward-reduce call is two device launches (per-tile partial sums,
# then their fold in tile order)
SPLIT_ENTRIES = {
    "groupnorm_silu_split_stats": _FWD_SOURCE,
    "groupnorm_silu_split_apply": _FWD_SOURCE,
    "groupnorm_silu_split_bwd_reduce": _BWD_SOURCE,
    "groupnorm_silu_split_bwd_dx": _BWD_SOURCE,
}
SPLIT_TARGET_BLOCKS = 264  # two blocks per SM of an H100
SPLIT_MIN_ROWS_PER_THREAD = 4  # a tile stays at least this many rows per thread row


class SplitPlan(NamedTuple):
    """How a split-form call is cut: ``vec`` channels per thread and access
    (one 16-byte vector, or 1), ``threads`` per block (``C / vec`` columns
    times as many thread rows as fit in ``MAX_THREADS``), ``tiles`` blocks
    per image of ``rows_per_tile`` pixel rows each."""

    vec: int
    threads: int
    tiles: int
    rows_per_tile: int


def split_plan(b: int, hw: int, c: int, dtype: torch.dtype, aligned: bool = True) -> SplitPlan:
    """The cut of a split-form call on ``[b, hw, c]`` (a pure function): about
    ``SPLIT_TARGET_BLOCKS`` blocks over the batch, each thread row keeping at
    least ``SPLIT_MIN_ROWS_PER_THREAD`` rows."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"groupnorm_silu takes float32 or bfloat16, got {dtype}")
    esize = 4 if dtype == torch.float32 else 2
    vec = 16 // esize if aligned and c * esize % 16 == 0 else 1
    nv = c // vec
    if nv > MAX_THREADS:
        raise ValueError(f"the split form takes at most {MAX_THREADS} columns of {vec} "
                         f"channels; got {c} channels")
    threads = nv * (MAX_THREADS // nv)
    rit = threads // nv
    tiles = max(1, min(-(-hw // (rit * SPLIT_MIN_ROWS_PER_THREAD)), -(-SPLIT_TARGET_BLOCKS // b)))
    rows = -(-hw // tiles)
    return SplitPlan(vec, threads, -(-hw // rows), rows)


@functools.cache
def _split_library(source: str) -> ctypes.CDLL:
    lib = _library(source)
    p, i = ctypes.c_void_p, ctypes.c_int
    if source == _FWD_SOURCE:
        lib.groupnorm_silu_split_stats.argtypes = [p] * 3 + [i] * 9 + [p]
        lib.groupnorm_silu_split_apply.argtypes = [p] * 6 + [i] * 9 + [p]
    else:
        lib.groupnorm_silu_split_bwd_reduce.argtypes = [p] * 8 + [i] * 9 + [p]
        lib.groupnorm_silu_split_bwd_dx.argtypes = [p] * 8 + [i] * 9 + [ctypes.c_float, p]
    for entry, src in SPLIT_ENTRIES.items():
        if src == source:
            getattr(lib, entry).restype = ctypes.c_int
    return lib


def _split_launch(entry: str, x: torch.Tensor, num_groups: int, tensors: list[torch.Tensor],
                  extra: list | None = None, plan: SplitPlan | None = None) -> None:
    """One split-form entry on CUDA tensors: ``tensors``' addresses (its
    tensor arguments, in order), then the cut (``split_plan``'s unless given),
    the dtype and ``extra``."""
    b, h, w, c = x.shape
    plan = plan or split_plan(b, h * w, c, x.dtype, _aligned(*tensors))
    with torch.cuda.device(x.device):
        err = getattr(_split_library(SPLIT_ENTRIES[entry]), entry)(
            *(t.data_ptr() for t in tensors), b, h * w, c, c // num_groups, plan.tiles, plan.rows_per_tile, plan.vec,
            plan.threads, _DTYPE_CODES[x.dtype], *(extra or []),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({plan})")
    groupnorm_silu.split_launches[entry] += 1


def _split_check(x: torch.Tensor, num_groups: int, *others: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[-1] % num_groups:
        raise ValueError(f"expected NHWC with C divisible by {num_groups}, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"groupnorm_silu takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_silu takes a contiguous NHWC tensor")
    for t in others:
        if t.device != x.device:
            raise ValueError(f"a tensor on {t.device}, x on {x.device}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def split_stats(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``[B, G, 2]`` f32 sums of x and x^2 over ``x``'s rows: the kernel on
    CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return groupnorm_silu_split_stats_plain(x, num_groups)
    _split_check(x, num_groups)
    b, h, w, c = x.shape
    plan = split_plan(b, h * w, c, x.dtype, _aligned(x))
    partial = torch.empty((b, plan.tiles, 2, c), device=x.device, dtype=torch.float32)
    stats = torch.empty((b, num_groups, 2), device=x.device, dtype=torch.float32)
    _split_launch("groupnorm_silu_split_stats", x, num_groups, [x, partial, stats], plan=plan)
    return stats


def split_apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, mean_g: torch.Tensor,
                inv_g: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``silu`` of the normalised, scaled and shifted ``x`` from the given
    ``[B, G]`` mean and inverse std: the kernel on CUDA, the plain version on
    the CPU."""
    if x.device.type == "cpu":
        return groupnorm_silu_split_apply_plain(x, scale, bias, mean_g, inv_g, num_groups)
    _split_check(x, num_groups, scale, bias, mean_g, inv_g)
    y = torch.empty_like(x)
    scale, bias, mean_g, inv_g = map(_f32, (scale, bias, mean_g, inv_g))
    _split_launch("groupnorm_silu_split_apply", x, num_groups,
                  [x, y, scale, bias, mean_g, inv_g])
    return y


def split_bwd_reduce(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mean_g: torch.Tensor, inv_g: torch.Tensor, num_groups: int) -> torch.Tensor:
    """``[B, 2, C]`` f32 sums of dn and dn * xhat over ``x``'s rows: the
    kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return groupnorm_silu_split_bwd_reduce_plain(x, g, scale, bias, mean_g, inv_g, num_groups)
    g = g.to(x.dtype).contiguous()
    _split_check(x, num_groups, g, scale, bias, mean_g, inv_g)
    b, h, w, c = x.shape
    plan = split_plan(b, h * w, c, x.dtype, _aligned(x, g))
    partial = torch.empty((b, plan.tiles, 2, c), device=x.device, dtype=torch.float32)
    r = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    scale, bias, mean_g, inv_g = map(_f32, (scale, bias, mean_g, inv_g))
    _split_launch("groupnorm_silu_split_bwd_reduce", x, num_groups,
                  [x, g, scale, bias, mean_g, inv_g, partial, r], plan=plan)
    return r


def split_bwd_dx(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 mean_g: torch.Tensor, inv_g: torch.Tensor, r: torch.Tensor, num_groups: int,
                 count: float) -> torch.Tensor:
    """``dx`` from the whole image's ``[B, 2, C]`` sums ``r`` and ``count``
    elements a group: the kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return groupnorm_silu_split_bwd_dx_plain(x, g, scale, bias, mean_g, inv_g, r, num_groups,
                                                 count)
    g = g.to(x.dtype).contiguous()
    _split_check(x, num_groups, g, scale, bias, mean_g, inv_g, r)
    dx = torch.empty_like(x)
    scale, bias, mean_g, inv_g, r = map(_f32, (scale, bias, mean_g, inv_g, r))
    _split_launch("groupnorm_silu_split_bwd_dx", x, num_groups,
                  [x, g, dx, scale, bias, mean_g, inv_g, r], extra=[float(count)])
    return dx


class _SplitGroupNormSiLU(torch.autograd.Function):
    """GroupNorm + SiLU of one shard of each image: the statistics and the
    backward's sums are this shard's, summed in place over the shards by
    ``allreduce_`` before they are used; ``count`` is a group's elements
    over the whole image."""

    @staticmethod
    def forward(x, scale, bias, num_groups, eps, allreduce_, count):
        stats = allreduce_(split_stats(x, num_groups))
        mean_g, inv_g = split_moments(stats, count, eps)
        return split_apply(x, scale, bias, mean_g, inv_g, num_groups), mean_g, inv_g

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, bias, num_groups, _, allreduce_, count = inputs
        _, mean_g, inv_g = output
        ctx.mark_non_differentiable(mean_g, inv_g)
        ctx.save_for_backward(x, scale, bias, mean_g, inv_g)
        ctx.num_groups, ctx.allreduce_, ctx.count = num_groups, allreduce_, count

    @staticmethod
    def backward(ctx, g, _g_mean, _g_inv):
        x, scale, bias, mean_g, inv_g = ctx.saved_tensors
        r = split_bwd_reduce(x, g, scale, bias, mean_g, inv_g, ctx.num_groups)
        r_all = ctx.allreduce_(r.clone())
        dx = split_bwd_dx(x, g, scale, bias, mean_g, inv_g, r_all, ctx.num_groups, ctx.count)
        r = r.sum(dim=0)  # this shard's partials: dbeta = sum_b r1, dgamma = sum_b r2
        return dx, r[1].to(scale.dtype), r[0].to(bias.dtype), None, None, None, None


def groupnorm_silu_split(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int, eps: float,
    allreduce_, hw_total: int,
) -> torch.Tensor:
    """``silu(group_norm(image))`` of an NHWC ``[B, h, W, C]`` shard of
    images of ``hw_total`` pixels, differentiable in ``x``, ``scale`` and
    ``bias``: ``allreduce_(t)`` sums ``t`` in place over the shards (and
    returns it). The split kernels for CUDA tensors, their plain versions for
    CPU tensors. ``scale`` and ``bias`` receive this shard's partial
    gradients; the caller sums them over the shards."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"groupnorm_silu runs on cuda or cpu, got {x.device}")
    count = float(hw_total * (x.shape[-1] // num_groups))
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        return _SplitGroupNormSiLU.apply(x, scale, bias, num_groups, eps, allreduce_, count)[0]
    with torch.no_grad():
        return _SplitGroupNormSiLU.forward(x, scale, bias, num_groups, eps, allreduce_, count)[0]


groupnorm_silu.split_launches = dict.fromkeys(SPLIT_ENTRIES, 0)
