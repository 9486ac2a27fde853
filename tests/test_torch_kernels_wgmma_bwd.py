"""Host-side pieces of the port's tensor-core backward kernels, on the CPU:
the rules that send a flash-attention backward or a convolution filter
gradient to the ``wgmma`` kernel or to the f32-FMA one, the tile and slab
choosers and their shared-memory formulas, and numpy models of the two
kernels' data paths held to the plain versions and to the JAX package.

The kernels themselves run only on the card (``tests/test_torch_kernels_cuda.py``).
Bars:
- the filter-gradient model repeats the plain version's f32 arithmetic on
  bf16-valued operands (exact products) in another order of summation:
  rtol 1e-4 / atol 1e-5;
- the flash-backward model rounds ``p`` and ``ds`` to bf16 before the
  products they feed and its outputs to bf16, as the kernel does: against
  the plain f32 version on the same bf16 inputs the bf16 bar of the card
  checks, atol 2e-2; against the JAX package's ``_bwd_pallas`` in interpret
  mode on the same bf16 inputs, which rounds ``p`` and ``ds`` at the same
  places, rtol 1e-2 / atol 1e-2 (both outputs are bf16, one ulp is 2^-8 of
  the value; the two differ in the order of the f32 sums and in ``delta``,
  rowsum(dO * O) from the bf16 output against rowsum(dp * p) in f32, which
  may tip a rounding).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
import jax.numpy as jnp

from pti_ldm_vae_tpu.ops.pallas import flash_attention as jax_fa
from pti_ldm_vae_tpu_torch.ops.kernels import _build
from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import (
    SOURCES as CONV_SOURCES,
    WGRAD_SLAB_PIXELS,
    conv3x3_bwd_plain,
    pad_channels,
    unpad_wgrad,
    wgrad_kernel,
    wgrad_warpgroups,
    wgrad_wgmma_slabs,
    wgrad_wgmma_smem_bytes,
)
from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
    SOURCES as FLASH_SOURCES,
    SUPPORTED_HEAD_DIMS,
    backward_kernel,
    bwd_wgmma_smem_bytes,
    flash_attention_bwd_plain,
)

# (B, H, W, Cin, Cout) of the 47 3x3 convolutions of a flagship pass at 256², batch 8
PATH_SHAPES = [
    (8, 128, 128, 128, 128), (8, 256, 256, 64, 64), (8, 128, 128, 128, 64), (8, 256, 256, 64, 32),
    (8, 256, 256, 32, 32), (8, 128, 128, 64, 64), (8, 64, 64, 128, 128), (8, 128, 128, 32, 64),
    (8, 64, 64, 64, 128), (8, 32, 32, 128, 128),
]
THIN_SHAPES = [(8, 256, 256, 1, 32), (8, 256, 256, 32, 1), (8, 32, 32, 128, 4), (8, 32, 32, 4, 128)]
RAGGED_FMA = (1, 20, 12, 3, 5)
RAGGED_WGMMA = (2, 37, 70, 24, 40)
N_SM = 132  # an H100
SMEM_LIMIT = 232448  # bytes of shared memory a block may ask for on sm_90


def _id(shape):
    return "x".join(map(str, shape))


# ------------------------------------------------------------------ rules
@pytest.mark.parametrize("shape", PATH_SHAPES + THIN_SHAPES + [RAGGED_WGMMA, RAGGED_FMA], ids=_id)
def test_wgrad_kernel_rule(shape):
    cin, cout = shape[3], shape[4]
    # bf16: the tensor-core kernel at every channel count (thin sides padded to 8)
    assert wgrad_kernel(torch.bfloat16, cin, cout) == "wgmma"
    # f32 keeps the FMA kernel (the parity path), and so does an unaligned base address
    assert wgrad_kernel(torch.float32, cin, cout) == "fma"
    assert wgrad_kernel(torch.bfloat16, cin, cout, aligned=False) == "fma"


def test_wgrad_kernel_rule_on_the_path():
    # all 47 filter gradients of a pass take wgmma in bf16, the four thin calls padded
    per_pass = dict(zip(PATH_SHAPES + THIN_SHAPES, (1, 1, 1, 1, 7, 6, 8, 1, 1, 16, 1, 1, 1, 1)))
    assert sum(per_pass.values()) == 47
    assert {wgrad_kernel(torch.bfloat16, s[3], s[4]) for s in per_pass} == {"wgmma"}
    assert [pad_channels(torch.zeros(1, 1, 1, s[3])).shape[-1] for s in THIN_SHAPES] == [8, 32, 128, 8]
    assert wgrad_kernel(torch.float16, 32, 32) == "fma"  # (the wrapper refuses the dtype)


@pytest.mark.parametrize("shape", [(1, 9, 20, 1, 32), (2, 8, 17, 32, 1), (1, 10, 13, 3, 5),
                                   (1, 8, 8, 12, 4)], ids=_id)
def test_thin_wgrad_through_padding_matches_plain(shape):
    """The wrapper's route for thin channel counts: zero channels up to a
    multiple of 8 on either operand, the kernel's data path (the numpy
    model), the padding's rows and columns of dW dropped."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(10)
    x = torch.from_numpy(_bf16(rng.normal(size=(b, h, w, cin))))
    dy = torch.from_numpy(_bf16(rng.normal(size=(b, h, w, cout))))
    xp, dyp = pad_channels(x), pad_channels(dy)
    assert xp.shape[-1] % 8 == 0 and dyp.shape[-1] % 8 == 0 and not xp[..., cin:].any()
    got = unpad_wgrad(torch.from_numpy(_wgrad_model(xp.numpy(), dyp.numpy(), 1, 2)), cin, cout)
    _, want = conv3x3_bwd_plain(x, torch.zeros(9 * cin, cout), dy)
    assert got.shape == (9 * cin, cout)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert unpad_wgrad(want, cin, cout) is want  # nothing padded: dW as it is


@pytest.mark.parametrize("head_dim", SUPPORTED_HEAD_DIMS)
def test_flash_backward_kernel_rule(head_dim):
    # the path's [8, 1, 1024, 128] too; head dim 256 takes the FMA kernel in both types
    assert backward_kernel(torch.bfloat16, head_dim) == ("wgmma" if head_dim <= 128 else "fma")
    assert backward_kernel(torch.float32, head_dim) == "fma"
    assert backward_kernel(torch.bfloat16, head_dim, aligned=False) == "fma"
    assert backward_kernel(torch.bfloat16, 48) == "fma"  # (the wrapper refuses the head dim)


# ------------------------------------------------------------------ tiles, slabs, shared memory
def test_wgrad_smem_bytes_matches_the_kernel_formula():
    # 3 stages of 8 x-planes of 10 x 18 pixels (2880 bytes, padded to 128 * 23 + 16) and
    # wg * 4 dy-planes of 8 x 16 pixels (2048 + 16)
    x_plane, dy_plane = -(-10 * 18 * 16 // 128) * 128 + 16, 8 * 16 * 16 + 16
    assert (x_plane, dy_plane) == (2960, 2064)
    assert wgrad_wgmma_smem_bytes(1) == 3 * (8 * x_plane + 4 * dy_plane) == 95808
    assert wgrad_wgmma_smem_bytes(2) == 3 * (8 * x_plane + 8 * dy_plane) == 120576
    # two blocks of one warpgroup per SM (228 KB, 1 KB kept per block); one of two
    assert 2 * (wgrad_wgmma_smem_bytes(1) + 1024) <= 228 * 1024 < 2 * wgrad_wgmma_smem_bytes(2)


def test_flash_bwd_smem_bytes_matches_the_kernel_formula():
    # two warpgroups' resident slots and three ring slots, each two tiles of D/8 planes of
    # 1040 bytes and a row of statistics of 512
    assert bwd_wgmma_smem_bytes(128) == 5 * (2 * 16 * 1040 + 512) == 168960
    assert bwd_wgmma_smem_bytes(64) == 5 * (2 * 8 * 1040 + 512)
    assert bwd_wgmma_smem_bytes(16) == 5 * (2 * 2 * 1040 + 512)
    assert bwd_wgmma_smem_bytes(128) <= SMEM_LIMIT


@pytest.mark.parametrize("shape", PATH_SHAPES + [RAGGED_WGMMA], ids=_id)
def test_wgrad_slabs_cover_the_shape(shape):
    b, h, w, cin, cout = shape
    wg = wgrad_warpgroups(cout)
    n_slab = wgrad_wgmma_slabs(shape, wg, N_SM)
    n_tiles = b * -(-h // 8) * -(-w // 16)
    assert 1 <= n_slab <= n_tiles  # no slab without a tile: slab i holds tiles [i*n/n_slab, (i+1)*n/n_slab)
    groups = -(-cin // 64) * -(-cout // (32 * wg))
    # one wave of blocks where there are tiles enough (two per SM at wg 1, one at 2) ...
    assert n_slab * groups >= min(2 // wg * N_SM, n_tiles * groups)
    # ... in whole waves, and no accumulation chain longer than WGRAD_SLAB_PIXELS where there
    # are tiles enough
    assert n_slab % -(-(2 // wg * N_SM) // groups) == 0 or n_slab == n_tiles
    assert -(-b * h * w // n_slab) <= WGRAD_SLAB_PIXELS + 128 or n_slab == n_tiles


def test_wgrad_warpgroups_and_slabs_at_the_levels_of_the_flagship():
    assert [wgrad_warpgroups(c) for c in (8, 32, 40, 64, 128)] == [1, 1, 2, 2, 2]
    slabs = {s: wgrad_wgmma_slabs(s, wgrad_warpgroups(s[4]), N_SM) for s in PATH_SHAPES}
    assert slabs[(8, 256, 256, 32, 32)] == 528  # two waves of two blocks per SM: 993 pixels each
    assert slabs[(8, 256, 256, 64, 64)] == 528  # four waves of one block per SM
    assert slabs[(8, 128, 128, 128, 128)] == 132  # four waves of 4 output tiles x 33 slabs
    assert slabs[(8, 128, 128, 64, 64)] == 132  # one wave: 993 pixels a slab
    assert slabs[(8, 32, 32, 128, 128)] == 33  # 4 output tiles x 33 slabs, one wave


# ------------------------------------------------------------------ numpy model: filter gradient
def _mn_major_offsets(rows_mn, depth, lbo, sbo):
    """Byte offsets, from the descriptor's start, of element (mn, k) of an
    MN-major operand without swizzle: 8 consecutive MN indices are 16
    contiguous bytes, 8 consecutive depths are 8 such rows (one 128-byte core
    matrix), the next 8 depths lie LBO further, the next 8 MN indices SBO."""
    mn = np.arange(rows_mn)[:, None]
    k = np.arange(depth)[None, :]
    return (mn // 8) * sbo + (k // 8) * lbo + (k % 8) * 16 + (mn % 8) * 2


def _wgrad_model(x, dy, wg, n_slab):
    """The tensor-core filter gradient's data path in numpy: per block (slab,
    64-channel group of Cin, 32*wg-group of Cout) and per 8 x 16-pixel tile
    of its slab, the ring slot in shared memory (bf16 values kept as f32, one
    slot per 2 bytes) with the x halo as 8 planes [halo row][halo column][8]
    and the dy tile as wg*4 planes [row][column][8], dead planes zero; per
    warpgroup, tap, patch and k16 step one product whose A (x, MN-major) and
    B (the warpgroup's dy planes, MN-major) are read at the descriptors'
    strides from starts moved by the tap; the block's accumulators written as
    its slab's partials; the slabs folded in order."""
    b, h, w, cin = x.shape
    cout = dy.shape[-1]
    nt, mt = 32, 2
    hc, tw = 8 * mt + 2, 8 * mt
    xp = -(-10 * hc * 16 // 128) * 128 + 16
    dp = 64 * mt * 16 + 16
    stage = 8 * xp + wg * nt // 8 * dp
    tiles_h, tiles_w = -(-h // 8), -(-w // tw)
    n_tiles = b * tiles_h * tiles_w
    a_off = _mn_major_offsets(64, 16, hc * 16, xp)
    b_off = _mn_major_offsets(nt, 16, tw * 16, dp).T  # [depth, N]
    partials = np.zeros((n_slab, 9 * cin, cout), np.float32)
    for slab, ci0, co0 in np.ndindex(n_slab, -(-cin // 64), -(-cout // (wg * nt))):
        ci0, co0 = 64 * ci0, wg * nt * co0
        acc = np.zeros((wg, 9, 64, nt), np.float32)
        for t in range(slab * n_tiles // n_slab, (slab + 1) * n_tiles // n_slab):
            img, r = divmod(t, tiles_h * tiles_w)
            th0, tw0 = (r // tiles_w) * 8, (r % tiles_w) * tw
            smem = np.zeros(stage // 2, np.float32)
            for plane in range(min(8, (cin - ci0) // 8)):
                for p in range(10 * hc):
                    gh, gw = th0 + p // hc - 1, tw0 + p % hc - 1
                    if 0 <= gh < h and 0 <= gw < w:
                        at = (plane * xp + p * 16) // 2
                        smem[at:at + 8] = x[img, gh, gw, ci0 + 8 * plane:ci0 + 8 * plane + 8]
            for plane in range(min(wg * nt // 8, (cout - co0) // 8)):
                for p in range(8 * tw):
                    gh, gw = th0 + p // tw, tw0 + p % tw
                    if gh < h and gw < w:
                        at = (8 * xp + plane * dp + p * 16) // 2
                        smem[at:at + 8] = dy[img, gh, gw, co0 + 8 * plane:co0 + 8 * plane + 8]
            for g, m, kk in np.ndindex(wg, mt, 4):  # warpgroup g: its own dy planes
                b_start = 8 * xp + g * nt // 8 * dp + (2 * kk * tw + 8 * m) * 16
                b_mat = smem[(b_start + b_off) // 2]
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    start = ((2 * kk + ky) * hc + 8 * m + kx) * 16
                    acc[g, tap] += smem[(start + a_off) // 2] @ b_mat
        for g, tap in np.ndindex(wg, 9):
            c0 = co0 + g * nt
            rows, cols = min(64, cin - ci0), min(nt, cout - c0)
            if cols > 0:
                partials[slab, tap * cin + ci0:tap * cin + ci0 + rows, c0:c0 + cols] = \
                    acc[g, tap, :rows, :cols]
    out = partials[0].copy()
    for slab in range(1, n_slab):  # the fold: slabs in order
        out += partials[slab]
    return out


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


@pytest.mark.parametrize("shape,wg,n_slab", [
    ((1, 11, 19, 24, 40), 1, 2),   # ragged image, 24 -> 40 (dead planes on both sides)
    ((2, 9, 21, 32, 32), 1, 5),    # 32 -> 32, slabs of 1 and 2 tiles
    ((1, 10, 13, 16, 72), 1, 1),   # three N-groups, the last one 8 channels
    ((1, 8, 17, 72, 16), 1, 2),    # two Cin groups, the last one 8 channels
    ((1, 9, 20, 16, 104), 2, 2),   # two warpgroups: 64 + 40 channels, the second block's WG 1 idle
    ((2, 11, 8, 24, 40), 2, 3),    # two warpgroups, the second with 8 channels
], ids=["ragged_24to40", "32to32", "cout72", "cin72", "two_wg_cout104", "two_wg_24to40"])
def test_wgrad_kernel_model_matches_plain(shape, wg, n_slab):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(9)
    x = _bf16(rng.normal(size=(b, h, w, cin)))
    dy = _bf16(rng.normal(size=(b, h, w, cout)))
    wmat = torch.zeros(9 * cin, cout)
    _, want = conv3x3_bwd_plain(torch.from_numpy(x), wmat, torch.from_numpy(dy))
    np.testing.assert_allclose(_wgrad_model(x, dy, wg, n_slab), want.numpy(), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ numpy model: flash backward
def _round(t):
    return t.to(torch.bfloat16).float()


def _flash_bwd_model(q, k, v, g):
    """The tensor-core flash backward's tiled algorithm on bf16-valued f32
    tensors [B, H, S, D]: lse of the scaled scores (what the forward saves),
    delta = rowsum(dO * O) from the bf16 output, then per 64-row tile pair
    p = exp(s * scale - lse) with columns and rows past S masked, ds = p *
    (dp - delta), both rounded to bf16 before their products; dk/dv summed
    over q tiles in order, dq over kv tiles in order, outputs rounded to
    bf16."""
    b, h, s, d = q.shape
    scale = d**-0.5
    scores = q @ k.transpose(-1, -2) * scale
    lse = torch.logsumexp(scores, dim=-1)
    out = _round(torch.softmax(scores, dim=-1) @ v)
    delta = (g * out).sum(-1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    n = -(-s // 64)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 64 * n - s))  # zero-filled ragged rows
    qp, kp, vp, gp = map(pad, (q, k, v, g))
    lse_p = torch.nn.functional.pad(lse, (0, 64 * n - s))
    delta_p = torch.nn.functional.pad(delta, (0, 64 * n - s))
    dqp, dkp, dvp = torch.zeros_like(qp), torch.zeros_like(kp), torch.zeros_like(vp)
    live = torch.arange(64 * n) < s
    for j in range(n):  # dk/dv role: kv tile j, S^T = K Q^T
        kt, vt = kp[..., 64 * j:64 * j + 64, :], vp[..., 64 * j:64 * j + 64, :]
        for i in range(n):
            rows = slice(64 * i, 64 * i + 64)
            st = kt @ qp[..., rows, :].transpose(-1, -2)
            dpt = vt @ gp[..., rows, :].transpose(-1, -2)
            pt = torch.exp(st * scale - lse_p[..., None, rows]) * live[rows]
            dst = pt * (dpt - delta_p[..., None, rows])
            dvp[..., 64 * j:64 * j + 64, :] += _round(pt) @ gp[..., rows, :]
            dkp[..., 64 * j:64 * j + 64, :] += _round(dst) @ qp[..., rows, :]
    for i in range(n):  # dq role: q tile i, S = Q K^T
        qt, gt = qp[..., 64 * i:64 * i + 64, :], gp[..., 64 * i:64 * i + 64, :]
        for j in range(n):
            cols = slice(64 * j, 64 * j + 64)
            sc = qt @ kp[..., cols, :].transpose(-1, -2)
            dpm = gt @ vp[..., cols, :].transpose(-1, -2)
            p = torch.exp(sc * scale - lse_p[..., 64 * i:64 * i + 64, None]) * live[cols]
            ds = p * (dpm - delta_p[..., 64 * i:64 * i + 64, None])
            dqp[..., 64 * i:64 * i + 64, :] += _round(ds) @ kp[..., cols, :]
    dq, dk, dv = dqp[..., :s, :] * scale, dkp[..., :s, :] * scale, dvp[..., :s, :]
    return _round(dq), _round(dk), _round(dv)


def _bf16_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [_round(torch.from_numpy(rng.normal(size=shape).astype(np.float32))) for _ in range(4)]


@pytest.mark.parametrize("shape", [(1, 2, 77, 32), (2, 1, 128, 16), (1, 1, 100, 64)],
                         ids=["ragged_s77", "two_tiles", "ragged_d64"])
def test_flash_bwd_model_matches_plain(shape):
    q, k, v, g = _bf16_inputs(21, shape)
    got = _flash_bwd_model(q, k, v, g)
    want = flash_attention_bwd_plain(q, k, v, g)
    for ours, theirs in zip(got, want):
        torch.testing.assert_close(ours, theirs, rtol=0, atol=2e-2)


def test_flash_bwd_model_matches_pallas_interpret_bf16():
    q, k, v, g = _bf16_inputs(22, (1, 2, 77, 32))
    with pltpu.force_tpu_interpret_mode():
        want = jax_fa._bwd_pallas(*(jnp.asarray(t.numpy()).astype(jnp.bfloat16) for t in (q, k, v, g)))
    got = _flash_bwd_model(q, k, v, g)
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs.astype(jnp.float32)), rtol=1e-2,
                                   atol=1e-2)


# ------------------------------------------------------------------ sources
def test_new_backward_sources_are_built_with_the_rest():
    assert {"conv3x3_wgrad_wgmma.cu", "conv3x3_wgrad.cu"} <= set(CONV_SOURCES)
    assert {"flash_attention_bwd_wgmma.cu", "flash_attention_bwd.cu"} <= set(FLASH_SOURCES)
    for source in ("conv3x3_wgrad_wgmma.cu", "flash_attention_bwd_wgmma.cu"):
        assert [p.name for p in _build.source_files(source)] == [source, "hopper_mma.cuh"]
