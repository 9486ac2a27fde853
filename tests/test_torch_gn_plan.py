"""The GroupNorm+SiLU cluster kernels' cut and summation order, on the CPU.

``gn_plan`` (``ops/kernels/groupnorm_silu.py``) is the pure function that cuts
a call into (image, slice) clusters of blocks, and the CUDA kernels
(``csrc/groupnorm_silu_{fwd,bwd}.cu``) take every number from it. These tests
hold the plan to its rules (every (image, pixel, channel) covered exactly
once, slices of whole groups, shared memory within one block's 232,448 bytes,
row segments of at least one 32-byte sector) at the eight shapes of a
flagship pass in both types, at the seventeen shapes of a diffusion UNet pass
(32 groups), at the seven of a ``config/ar_vae_dente_kl1e3.json`` pass (32
groups) at b8 and b1, at the flagship's at b1 (PTI's decoder fine-tune), at
ragged shapes and at b32; and they run a
numpy model of the kernels that sums in the kernels' order (each thread's
rows, the unstaged ones first; the butterfly across a warp's lanes; the
warps' rows; the cluster's ranks in order 0..n-1; a group's channels)
against the plain versions (``_plain_forward``, ``groupnorm_silu_bwd_plain``)
and, at two small shapes, against the JAX package's Pallas kernels in
interpret mode. Bars: rtol 1e-4 / atol 1e-5, f32, as the other
GroupNorm+SiLU parity tests.
"""

import importlib
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pti_ldm_vae_tpu.ops.pallas import groupnorm_silu as jax_gns
from pti_ldm_vae_tpu_torch.ops.kernels import groupnorm_silu_bwd_plain
from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import (
    MIN_SEGMENT_BYTES,
    SMEM_LIMIT,
    STREAM_CLUSTERS,
    GnPlan,
    _plain_forward,
    gn_plan,
    gn_smem_bytes,
)

# the package re-exports the wrapper under the module's name
gn_mod = importlib.import_module("pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu")

TOL = dict(rtol=1e-4, atol=1e-5)
EPS = 1e-6
# the eight GroupNorm+SiLU shapes of a flagship pass at 256², batch 8 (16 groups)
PATH_SHAPES = [(8, 256, 256, 32), (8, 256, 256, 64), (8, 128, 128, 128), (8, 128, 128, 64),
               (8, 128, 128, 32), (8, 64, 64, 128), (8, 64, 64, 64), (8, 32, 32, 128)]
# (shape, groups): ragged pixel counts and channel counts, and one b32 shape
OTHER_SHAPES = [((1, 7, 9, 24), 4), ((3, 256, 256, 32), 16), ((32, 256, 256, 64), 16),
                ((3, 17, 9, 48), 4), ((2, 5, 3, 6), 3)]
DTYPES = [torch.float32, torch.bfloat16]
# the 17 GroupNorm+SiLU shapes of a UNet pass of config/ldm_dente.json on 32²
# latents, batch 8, 32 groups: 1 to 16 channels per group, down to 4² images
UNET_SHAPES = [(8, 32, 32, 96), (8, 32, 32, 64), (8, 16, 16, 192), (8, 32, 32, 32),
               (8, 16, 16, 128), (8, 8, 8, 384), (8, 16, 16, 96), (8, 16, 16, 64), (8, 8, 8, 256),
               (8, 8, 8, 192), (8, 16, 16, 32), (8, 8, 8, 128), (8, 4, 4, 512), (8, 4, 4, 384),
               (8, 8, 8, 64), (8, 4, 4, 256), (8, 4, 4, 128)]
UNET_GROUPS = 32
# the 7 GroupNorm+SiLU shapes of a pass of config/ar_vae_dente_kl1e3.json at 256²
# (channels 64-128-256, 32 groups: 2 to 8 channels per group), batch 8 (training)
KL1E3_SHAPES = [(8, 256, 256, 64), (8, 256, 256, 128), (8, 128, 128, 64), (8, 128, 128, 128),
                (8, 128, 128, 256), (8, 64, 64, 128), (8, 64, 64, 256)]
KL1E3_GROUPS = 32
# batch 1: the kl1e3 shapes, and the flagship's, which PTI's decoder fine-tune runs at
B1_SHAPES = ([((1, *s[1:]), KL1E3_GROUPS) for s in KL1E3_SHAPES]
             + [((1, *s[1:]), 16) for s in PATH_SHAPES])
# the space-to-depth forms' level-0 shapes (s2d_stem, 16 groups): 8x128²x128 (the 32-channel
# level, 8 channels per group) is a flagship path shape already; 8x128²x256 (the decoder's
# 64-channel upsample entering the domain, 16 channels per group) is theirs alone
S2D_SHAPES = [(8, 128, 128, 256)]
ALL = ([(s, 16, d, bwd) for s in PATH_SHAPES + S2D_SHAPES for d in DTYPES
        for bwd in (False, True)]
       + [(s, g, d, False) for s, g in OTHER_SHAPES for d in DTYPES]
       + [(s, UNET_GROUPS, d, bwd) for s in UNET_SHAPES for d in DTYPES for bwd in (False, True)]
       + [(s, KL1E3_GROUPS, d, bwd) for s in KL1E3_SHAPES for d in DTYPES
          for bwd in (False, True)]
       + [(s, g, d, bwd) for s, g in B1_SHAPES for d in DTYPES for bwd in (False, True)])


def _esize(dtype):
    return 4 if dtype == torch.float32 else 2


def _ids(case):
    shape, groups, dtype, backward = case
    return (f"{'x'.join(map(str, shape))}_g{groups}_{str(dtype).split('.')[1]}"
            f"{'_bwd' if backward else ''}")


def _thread_rows(plan: GnPlan, nrows: int, staged: int) -> list[list[int]]:
    """Local rows of each thread row ``tr``, in the order the kernels sum them:
    the rows past the staged ones first, then the staged ones."""
    rit = plan.threads // (plan.slice_channels // plan.vec)
    out = []
    for tr in range(rit):
        rows = list(range(tr, nrows, rit))
        k_st = sum(1 for r in rows if r < staged)
        out.append(rows[k_st:] + rows[:k_st])
    return out


def _blocks(b: int, c: int, plan: GnPlan):
    """(image, slice, rank) of every block of the grid, by the kernels' rule."""
    ns = c // plan.slice_channels
    for block in range(b * ns * plan.cluster_size):
        cluster, rank = divmod(block, plan.cluster_size)
        yield cluster // ns, cluster % ns, rank


@pytest.mark.parametrize("case", ALL, ids=_ids)
def test_plan_covers_every_element_once(case):
    (b, h, w, c), groups, dtype, backward = case
    plan = gn_plan(b, h, w, c, groups, dtype, backward)
    hw, sc = h * w, plan.slice_channels
    nv = sc // plan.vec
    assert plan.threads % nv == 0 and plan.threads <= 256
    seen_clusters = set()
    count = np.zeros((hw, c), np.int32)  # one image: every image is cut alike
    for img, sl, rank in _blocks(b, c, plan):
        seen_clusters.add((img, sl))
        if img:
            continue
        row0 = rank * plan.rows_per_block
        nrows = max(0, min(plan.rows_per_block, hw - row0))
        staged = min(plan.staged_rows, nrows)
        # every thread row's rows, each read as nv vectors of vec channels:
        # the slice's channels sl*sc .. sl*sc + nv*vec (np.add.at counts repeats)
        rows = [r for thread_rows in _thread_rows(plan, nrows, staged) for r in thread_rows]
        cols = sl * sc + np.arange(nv * plan.vec)
        np.add.at(count, (row0 + np.asarray(rows, dtype=np.int64)[:, None], cols[None, :]), 1)
    assert seen_clusters == {(i, s) for i in range(b) for s in range(c // sc)}
    assert (count == 1).all()


@pytest.mark.parametrize("case", ALL, ids=_ids)
def test_plan_slices_fit_and_read_whole_sectors(case):
    (b, h, w, c), groups, dtype, backward = case
    esize, cg = _esize(dtype), c // groups
    plans = [gn_plan(b, h, w, c, groups, dtype, backward)]
    plans += [gn_plan(b, h, w, c, groups, dtype, backward, staged=st) for st in ("x", "g", "xg", "")]
    for plan, staged in zip(plans, [None, "x", "g", "xg", ""]):
        sc = plan.slice_channels
        assert sc % cg == 0 and c % sc == 0  # whole groups, whole slices
        assert plan.smem_bytes <= SMEM_LIMIT
        assert sc * esize >= MIN_SEGMENT_BYTES or sc == c
        assert plan.cluster_size in (1, 2, 4, 8, 16)
        assert plan.cluster_size * plan.rows_per_block >= h * w
        assert plan.rows_per_block < h * w or plan.cluster_size == 1 or h * w < plan.cluster_size
        n_staged = len(plan.staged)
        want = gn_smem_bytes(sc, plan.cluster_size, plan.threads, plan.vec,
                             plan.staged_rows if "x" in plan.staged else 0,
                             plan.staged_rows if "g" in plan.staged else 0, esize)
        assert plan.smem_bytes == want
        assert 0 <= plan.staged_rows <= plan.rows_per_block
        if plan.vec > 1:
            assert plan.vec * esize == 16 and c * esize % 16 == 0 and sc * esize % 16 == 0
            if staged is not None:
                assert plan.staged == staged
        else:
            assert plan.staged_rows == 0 and plan.staged == ""


@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[1])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_flagship_plans_stage_whole_slices_or_stream(shape, dtype, backward):
    """On the flagship path a slice of 32-byte row segments is staged whole
    (x, and g in the backward: they cross HBM once) wherever a cluster holds
    it, which is every shape up to 128²; the 256² images stream both passes,
    cut into at most STREAM_CLUSTERS clusters of whole groups."""
    b, h, w, c = shape
    plan = gn_plan(b, h, w, c, 16, dtype, backward)
    assert plan.vec * _esize(dtype) == 16
    if h * w <= 128 * 128:
        assert plan.slice_channels * _esize(dtype) == 32
        assert plan.staged == ("xg" if backward else "x")
        assert plan.staged_rows == plan.rows_per_block
        assert b * (c // plan.slice_channels) * plan.cluster_size >= 132
    else:
        assert plan.staged == "" and plan.staged_rows == 0
        assert b * (c // plan.slice_channels) <= STREAM_CLUSTERS
        assert plan.cluster_size in (8, 16)


@pytest.mark.parametrize("shape", UNET_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[1])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_unet_plans_stage_whole_slices(shape, dtype, backward):
    """Every UNet shape is small enough to stage its slices whole on the
    16-byte route. With 3, 6 or 12 channels per group (C = 96, 192, 384) the
    fewest whole groups of 16-byte rows is 24 bf16 / 12 f32 channels: three
    vector columns, so 85 rows of threads and 255 threads, a partial last
    warp (the kernels' shuffle path for ``32 % nv != 0``); at 4² an image has
    16 rows, fewer than the rows of threads, so most threads own no row."""
    b, h, w, c = shape
    esize, cg = _esize(dtype), c // UNET_GROUPS
    plan = gn_plan(b, h, w, c, UNET_GROUPS, dtype, backward)
    nv = plan.slice_channels // plan.vec
    assert plan.vec * esize == 16 and plan.threads <= 256 and plan.threads % nv == 0
    assert plan.slice_channels % cg == 0 and plan.smem_bytes <= SMEM_LIMIT
    assert plan.staged == ("xg" if backward else "x")
    assert plan.staged_rows == plan.rows_per_block
    # the fewest whole groups whose row segment is whole 16-byte vectors, 32 bytes at least
    want_sc = next(k * cg for k in (1, 2, 4, 8, 16, 32)
                   if k * cg * esize >= 32 and k * cg * esize % 16 == 0)
    assert plan.slice_channels == want_sc and plan.threads == nv * (256 // nv)
    if cg % 3 == 0:
        assert plan.slice_channels * esize == 48 and nv == 3 and plan.threads == 255
    if h * w < plan.threads // nv:
        assert plan.cluster_size == 1 and plan.rows_per_block == h * w


def test_plan_off_alignment_takes_one_channel_and_stages_nothing():
    for backward in (False, True):
        plan = gn_plan(2, 64, 64, 32, 16, torch.bfloat16, backward, aligned=False)
        assert plan.vec == 1 and plan.staged_rows == 0 and plan.staged == ""
    plan = gn_plan(2, 5, 5, 6, 3, torch.bfloat16)  # rows of 12 bytes: never 16-byte vectors
    assert plan.vec == 1 and plan.slice_channels == 6


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        gn_plan(1, 4, 4, 30, 4, torch.float32)
    with pytest.raises(TypeError):
        gn_plan(1, 4, 4, 32, 4, torch.float16)
    with pytest.raises(ValueError):
        gn_plan(1, 4, 4, 32, 4, torch.float32, staged="y")
    with pytest.raises(ValueError):  # a group of 300 channels off 16 bytes: 300 threads a row
        gn_plan(1, 4, 4, 300, 1, torch.bfloat16, aligned=False)


def test_streamed_slices_widen_by_whole_groups():
    """A call whose slices no cluster holds widens them (doubling the row
    segment, whole groups) to at most STREAM_CLUSTERS clusters, and no
    further than all channels."""
    plan = gn_plan(8, 256, 256, 64, 16, torch.bfloat16)
    assert plan.slice_channels == 32 and plan.staged == ""
    plan = gn_plan(8, 256, 256, 64, 16, torch.float32, True)
    assert plan.slice_channels == 32 and plan.cluster_size == 16
    plan = gn_plan(32, 256, 256, 64, 16, torch.bfloat16)  # 32 images: still 32 clusters of all 64
    assert plan.slice_channels == 64 and plan.cluster_size == 8
    plan = gn_plan(8, 256, 256, 32, 16, torch.bfloat16, True)  # 16 clusters of 16: 14 fit at once
    assert plan.slice_channels == 16 and plan.cluster_size == 8


# ---- numpy model of the kernels' summation order -------------------------------------------

def _fold(q1, q2, plan: GnPlan, hw: int):
    """Per-channel sums of q1, q2 ([HW, SC] f32 of one (image, slice)) as the
    kernels form them; returns ([SC], [SC]) f32."""
    sc, vec = plan.slice_channels, plan.vec
    nv = sc // vec
    rit = plan.threads // nv
    ranks = []
    for rank in range(plan.cluster_size):
        row0 = rank * plan.rows_per_block
        nrows = max(0, min(plan.rows_per_block, hw - row0))
        staged = min(plan.staged_rows, nrows)
        # thread partials [rit, SC]: column j of thread row tr holds channels j*vec..
        part = np.zeros((2, rit, sc), np.float32)
        for tr, rows in enumerate(_thread_rows(plan, nrows, staged)):
            for r in rows:
                part[0, tr] += q1[row0 + r]
                part[1, tr] += q2[row0 + r]
        if 32 % nv == 0:  # butterfly across the lanes sharing a column, then one row per warp
            lanes = 32 // nv
            warps = part.reshape(2, rit // lanes, lanes, sc)
            off = 1
            while off < lanes:
                warps = warps + warps[:, :, np.arange(lanes) ^ off]
                off <<= 1
            rows_of = warps[:, :, 0]
        else:
            rows_of = part
        pub = np.zeros((2, sc), np.float32)
        for p in range(rows_of.shape[1]):
            pub += rows_of[:, p]
        ranks.append(pub)
    tot = np.zeros((2, sc), np.float32)
    for pub in ranks:  # rank order 0..n-1
        tot += pub
    return tot[0], tot[1]


def _model_forward(x, scale, bias, groups, plan: GnPlan):
    b, h, w, c = x.shape
    hw, sc, cg = h * w, plan.slice_channels, c // groups
    xs = x.reshape(b, hw, c).astype(np.float32)
    y = np.empty_like(xs)
    mean_g = np.empty((b, groups), np.float32)
    inv_g = np.empty((b, groups), np.float32)
    count = np.float32(hw * cg)
    for img in range(b):
        for sl in range(c // sc):
            cols = slice(sl * sc, (sl + 1) * sc)
            xv = xs[img, :, cols]
            t1, t2 = _fold(xv, xv * xv, plan, hw)
            mul = np.empty(sc, np.float32)
            add = np.empty(sc, np.float32)
            for gi in range(sc // cg):
                s1 = np.float32(0)
                s2 = np.float32(0)
                for k in range(cg):
                    s1 += t1[gi * cg + k]
                    s2 += t2[gi * cg + k]
                mean = s1 / count
                var = max(s2 / count - mean * mean, np.float32(0))
                inv = np.float32(1) / np.sqrt(var + np.float32(EPS))
                grp = sl * (sc // cg) + gi
                mean_g[img, grp], inv_g[img, grp] = mean, inv
                ch = slice(gi * cg, (gi + 1) * cg)
                mul[ch] = inv * scale[cols][ch]
                add[ch] = bias[cols][ch] - mean * mul[ch]
            n = xv * mul + add
            y[img, :, cols] = n / (np.float32(1) + np.exp(-n))
    return y.reshape(x.shape), mean_g, inv_g


def _model_backward(x, scale, bias, mean_g, inv_g, g, groups, plan: GnPlan):
    """(dx, r [B, 2, C]) as the backward kernel forms them."""
    b, h, w, c = x.shape
    hw, sc, cg = h * w, plan.slice_channels, c // groups
    xs = x.reshape(b, hw, c).astype(np.float32)
    gs = g.reshape(b, hw, c).astype(np.float32)
    dx = np.empty_like(xs)
    r = np.empty((b, 2, c), np.float32)
    count = np.float32(hw * cg)
    for img in range(b):
        for sl in range(c // sc):
            cols = slice(sl * sc, (sl + 1) * sc)
            gam, bet = scale[cols], bias[cols]
            grp = (np.arange(sc) + sl * sc) // cg
            mean, inv = mean_g[img, grp], inv_g[img, grp]
            xh = (xs[img, :, cols] - mean) * inv
            n = xh * gam + bet
            sig = np.float32(1) / (np.float32(1) + np.exp(-n))
            dn = gs[img, :, cols] * sig * (np.float32(1) + n * (np.float32(1) - sig))
            r1, r2 = _fold(dn, dn * xh, plan, hw)
            r[img, 0, cols], r[img, 1, cols] = r1, r2
            a_c = np.empty(sc, np.float32)
            b_c = np.empty(sc, np.float32)
            for gi in range(sc // cg):
                ag = np.float32(0)
                bg = np.float32(0)
                for k in range(cg):
                    ag += gam[gi * cg + k] * r1[gi * cg + k]
                    bg += gam[gi * cg + k] * r2[gi * cg + k]
                a_c[gi * cg:(gi + 1) * cg] = ag / count
                b_c[gi * cg:(gi + 1) * cg] = bg / count
            dx[img, :, cols] = inv * (dn * gam - a_c - xh * b_c)
    return dx.reshape(x.shape), r


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, g


def _small_plan(shape, groups, staged, smem_limit, max_cluster, aligned=True):
    """An f32 plan at a toy shape with the limits scaled down, so that clusters
    of several ranks and partly staged blocks occur as they do at full size."""
    b, h, w, c = shape
    with mock.patch.object(gn_mod, "SMEM_LIMIT", smem_limit), \
            mock.patch.object(gn_mod, "TARGET_BLOCKS", 10**6), \
            mock.patch.object(gn_mod, "MAX_CLUSTER", max_cluster), \
            mock.patch.object(gn_mod, "MIN_ROWS_PER_THREAD", 0):
        return gn_plan(b, h, w, c, groups, torch.float32, aligned=aligned, staged=staged)


# (shape, groups, staged, shared-memory limit, cluster cap, aligned): whole
# slices staged, partly staged (x; x and g; g), nothing staged, a slice of
# 12 channels (3 columns: no shuffles), ragged rows, the one-channel route
MODEL_CASES = [((2, 16, 16, 16), 4, "x", 10**6, 16, True), ((2, 16, 16, 16), 4, "x", 1400, 4, True),
               ((1, 9, 13, 32), 16, "xg", 1500, 8, True), ((2, 7, 9, 24), 4, "g", 9000, 2, True),
               ((2, 8, 8, 12), 4, "", 10**6, 16, True), ((1, 31, 3, 8), 2, "x", 1800, 16, True),
               ((2, 8, 8, 16), 4, "x", 10**6, 4, False),
               # UNet cuts: 3 channels per group (3 columns, 255 threads) on a 4² image
               # whose 16 rows leave most threads idle, and one channel per group
               ((2, 4, 4, 96), 32, "x", 10**6, 16, True), ((2, 4, 4, 32), 32, "x", 10**6, 16, True)]


@pytest.mark.parametrize("shape,groups,staged,limit,cap,aligned", MODEL_CASES,
                         ids=[f"{'x'.join(map(str, s))}_{st or 'none'}_{lim}_{cap}_{al}"
                              for s, _, st, lim, cap, al in MODEL_CASES])
def test_model_matches_plain_versions(shape, groups, staged, limit, cap, aligned):
    plan = _small_plan(shape, groups, staged, limit, cap, aligned)
    if limit < 10**6:  # the cases that stage part of a block's rows
        assert 0 < plan.staged_rows < plan.rows_per_block and plan.cluster_size > 1
    x, scale, bias, g = _inputs(1, shape)
    y, mean_g, inv_g = _model_forward(x, scale, bias, groups, plan)
    xt, st, bt, gt = (torch.from_numpy(a) for a in (x, scale, bias, g))
    want_y, want_mean, want_inv = _plain_forward(xt, st, bt, groups, EPS)
    np.testing.assert_allclose(y, want_y.numpy(), **TOL)
    np.testing.assert_allclose(mean_g, want_mean.numpy(), **TOL)
    np.testing.assert_allclose(inv_g, want_inv.numpy(), **TOL)

    dx, r = _model_backward(x, scale, bias, mean_g, inv_g, g, groups, plan)
    want_dx, want_dscale, want_dbias = groupnorm_silu_bwd_plain(
        xt, st, bt, torch.from_numpy(mean_g), torch.from_numpy(inv_g), gt, groups)
    np.testing.assert_allclose(dx, want_dx.numpy(), **TOL)
    np.testing.assert_allclose(r[:, 1].sum(axis=0), want_dscale.numpy(), **TOL)
    np.testing.assert_allclose(r[:, 0].sum(axis=0), want_dbias.numpy(), **TOL)
    # per image, against the definition in float64
    b, c = shape[0], shape[-1]
    cg = c // groups
    x64 = x.reshape(b, -1, c).astype(np.float64)
    mean_c = np.repeat(mean_g, cg, axis=1)[:, None, :]
    inv_c = np.repeat(inv_g, cg, axis=1)[:, None, :]
    xh = (x64 - mean_c) * inv_c
    n = xh * scale + bias
    sig = 1 / (1 + np.exp(-n))
    dn = g.reshape(b, -1, c) * sig * (1 + n * (1 - sig))
    np.testing.assert_allclose(r[:, 0], dn.sum(axis=1), **TOL)
    np.testing.assert_allclose(r[:, 1], (dn * xh).sum(axis=1), **TOL)


@pytest.mark.parametrize("shape,groups,limit", [((2, 8, 8, 16), 4, 1200), ((1, 8, 16, 8), 2, 1300)],
                         ids=["2x8x8x16", "1x8x16x8"])
def test_model_matches_pallas_interpret(shape, groups, limit):
    plan = _small_plan(shape, groups, "x", limit, 4)
    assert plan.cluster_size > 1 and 0 < plan.staged_rows < plan.rows_per_block
    x, scale, bias, g = _inputs(2, shape)
    y, mean_g, inv_g = _model_forward(x, scale, bias, groups, plan)
    dx, r = _model_backward(x, scale, bias, mean_g, inv_g, g, groups, plan)
    with pltpu.force_tpu_interpret_mode():
        xj, sj, bj, gj = (jnp.asarray(a) for a in (x, scale, bias, g))
        want_y, want_mean, want_inv = jax_gns._forward(xj, sj, bj, groups, EPS)
        want_dx, want_dscale, want_dbias = jax_gns._bwd_pallas(xj, sj, bj, want_mean, want_inv,
                                                               gj, groups)
    b = shape[0]
    np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
    np.testing.assert_allclose(mean_g, np.asarray(want_mean).reshape(b, groups), **TOL)
    np.testing.assert_allclose(inv_g, np.asarray(want_inv).reshape(b, groups), **TOL)
    np.testing.assert_allclose(dx, np.asarray(want_dx), **TOL)
    np.testing.assert_allclose(r[:, 1].sum(axis=0), np.asarray(want_dscale), **TOL)
    np.testing.assert_allclose(r[:, 0].sum(axis=0), np.asarray(want_dbias), **TOL)
