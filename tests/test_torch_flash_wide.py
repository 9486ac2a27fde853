"""The wide-head flash-attention kernels' arithmetic and sizes, on the CPU.

``csrc/flash_attention_wide_wgmma.cu`` and ``csrc/flash_attention_bwd_wide_wgmma.cu``
serve bf16 at head dims above 128 by cutting the head dim two ways: output
slices of 256 columns (a grid dimension: the scores are recomputed for every
slice) and depth chunks of 64 columns (the first products summed chunk by
chunk, a slice's own chunks last in the backward). The kernels run only on
the card (``tests/test_torch_kernels_cuda.py``); here a plain-torch model of
that split, used by these tests only, is held to the plain versions:

- without rounding, the model repeats the plain version's f32 arithmetic in
  another order of summation: rtol 1e-4 / atol 1e-5 at D = 256, 512, 640;
- with ``p`` and ``ds`` rounded to bf16 before the products they feed, as the
  kernels round them, on bf16-valued inputs: the card's bf16 bars against the
  plain f32 version, atol 2e-2 and the error's rms within ``BF16_REL_BAR`` =
  1e-2 of the reference's rms (one bf16 rounding alone gives ~2.3e-3).

The relative bar must catch a kernel that is wrong by a little: at the path
shapes, outputs and gradients that leave out one 64-row tile, or that use a
padded head dim's scale, read above it here (one tile of 64 at S = 4096 is
~0.12 of the rms), while an absolute bar of 2e-2 sits near the size of the
values themselves (rms ~0.026 at S = 4096).

The shared-memory formulas of the wrapper (``wide_fwd_smem_bytes``,
``wide_bwd_smem_bytes``) are held to a block's 232,448 bytes; the card's side
(the libraries' own report, and ``ptxas``' registers and spills in
``chip_smoke.py``) is ``test_flash_wide_smem_matches_the_library`` in the
card tests.
"""

import math

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_plain,
    flash_attention_plain,
    wide_bwd_smem_bytes,
    wide_fwd_smem_bytes,
)

TOL = dict(rtol=1e-4, atol=1e-5)
BF16_BAR = dict(rtol=0.0, atol=2e-2)
BF16_REL_BAR = 1e-2  # rms of the error over rms of the reference
SLICE, CHUNK, ROWS = 256, 64, 64
LOG2E = 1.4426950408889634
SMEM_PER_BLOCK = 232_448


def _rel_rms(got, want):
    return float((got - want).norm() / want.norm())


def _keep(t, rounded):
    return t.to(torch.bfloat16).float() if rounded else t


def _chunk_order(d, col0):
    """The depth chunks of a backward block's tile in the order its items
    stream them (``chunk_of``): the chunks outside the slice, then the slice's
    units in order."""
    units = min(SLICE, d - col0) // CHUNK
    first, chunks = col0 // CHUNK, d // CHUNK
    return [c for c in range(chunks) if not first <= c < first + units] + \
        list(range(first, first + units))


def _scores(a, b, d, order):
    """a b^T summed over depth chunks of 64 columns, in ``order``."""
    out = torch.zeros(a.shape[0], b.shape[0])
    for c in order:
        cols = slice(CHUNK * c, CHUNK * c + CHUNK)
        out += a[:, cols] @ b[:, cols].T
    return out


def _wide_forward_model(q, k, v, rounded):
    """One head [S, D]: per 256-column output slice, the online softmax over
    64-row kv tiles with the scores recomputed from 64-column chunks; ``p``
    rounded to bf16 before ``p v`` when ``rounded`` (the sum ``l`` keeps it
    unrounded). Returns (out, lse)."""
    s, d = q.shape
    scale_log2e = d ** -0.5 * LOG2E
    out, lse = torch.zeros(s, d), None
    for col0 in range(0, d, SLICE):
        cols = slice(col0, min(col0 + SLICE, d))
        m = torch.full((s,), -math.inf)
        l, o = torch.zeros(s), torch.zeros(s, cols.stop - col0)
        for k0 in range(0, s, ROWS):
            kv = slice(k0, min(k0 + ROWS, s))
            x = _scores(q, k[kv], d, range(d // CHUNK)) * scale_log2e
            m_new = torch.maximum(m, x.max(dim=1).values)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[:, None])
            l = l * corr + p.sum(dim=1)
            o = o * corr[:, None] + _keep(p, rounded) @ v[kv, cols]
            m = m_new
        out[:, cols] = o / l[:, None]
        lse = m / LOG2E + torch.log(l)  # every slice computes the same statistics
    return out, lse


def _wide_backward_model(q, k, v, g, out, lse, rounded):
    """One head [S, D]: the backward's two roles per 256-column slice. dk / dv
    blocks own 64 kv rows and walk the q tiles (S^T and dP^T over the depth
    chunks in ``_chunk_order``, then dV += P^T dO and dK += dS^T Q over the
    slice); dq blocks own 64 q rows and walk the kv tiles (S, dP, then dQ +=
    dS K). ``p`` and ``ds`` are rounded to bf16 before those products when
    ``rounded``; delta = rowsum(dO * O) from the forward's output."""
    s, d = q.shape
    scale = d ** -0.5
    delta = (g * out).sum(dim=1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    tiles = [slice(t0, min(t0 + ROWS, s)) for t0 in range(0, s, ROWS)]
    for col0 in range(0, d, SLICE):
        cols = slice(col0, min(col0 + SLICE, d))
        order = _chunk_order(d, col0)
        for own in tiles:  # dk / dv role: own = the block's kv rows
            for qt in tiles:
                pt = torch.exp2(_scores(k[own], q[qt], d, order) * scale * LOG2E
                                - lse[qt][None, :] * LOG2E)
                dst = pt * (_scores(v[own], g[qt], d, order) - delta[qt][None, :])
                dv[own, cols] += _keep(pt, rounded) @ g[qt, cols]
                dk[own, cols] += _keep(dst, rounded) @ q[qt, cols]
        for own in tiles:  # dq role: own = the block's q rows
            for kt in tiles:
                p = torch.exp2(_scores(q[own], k[kt], d, order) * scale * LOG2E
                               - lse[own][:, None] * LOG2E)
                ds = p * (_scores(g[own], v[kt], d, order) - delta[own][:, None])
                dq[own, cols] += _keep(ds, rounded) @ k[kt, cols]
    return dq * scale, dk * scale, dv


def _inputs(seed, s, d, rounded):
    rng = np.random.default_rng(seed)
    return [_keep(torch.from_numpy(rng.normal(size=(s, d)).astype(np.float32)), rounded)
            for _ in range(4)]


@pytest.mark.parametrize("d", [640, 64 * 9, 1024])
def test_chunk_order_covers_every_chunk_once_with_the_slice_last(d):
    for col0 in range(0, d, SLICE):
        order = _chunk_order(d, col0)
        units = min(SLICE, d - col0) // CHUNK
        assert sorted(order) == list(range(d // CHUNK))
        assert order[-units:] == list(range(col0 // CHUNK, col0 // CHUNK + units))


@pytest.mark.parametrize("d", [256, 512, 640])
def test_wide_model_matches_plain(d):
    """The split's algebra, unrounded: slices, chunks, tiles (a ragged last
    one, S = 100) and the chunk order change only the order of f32 sums."""
    q, k, v, g = _inputs(30 + d, 100, d, rounded=False)
    out, lse = _wide_forward_model(q, k, v, rounded=False)
    b = lambda t: t[None, None]  # noqa: E731  [S, D] -> [1, 1, S, D]
    torch.testing.assert_close(out, flash_attention_plain(b(q), b(k), b(v))[0, 0], **TOL)
    scores = q @ k.T * d ** -0.5
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=1), **TOL)
    got = _wide_backward_model(q, k, v, g, out, lse, rounded=False)
    for ours, theirs in zip(got, flash_attention_bwd_plain(b(q), b(k), b(v), b(g))):
        torch.testing.assert_close(ours, theirs[0, 0], **TOL)


@pytest.mark.parametrize("d", [256, 512, 640])
def test_wide_model_with_bf16_p_and_ds_meets_the_bf16_bar(d):
    """As the kernels compute it: p and ds rounded to bf16 before the products
    they feed, outputs rounded to bf16, on bf16-valued inputs, against the plain
    f32 version on the same inputs."""
    q, k, v, g = _inputs(40 + d, 100, d, rounded=True)
    out, lse = _wide_forward_model(q, k, v, rounded=True)
    out = out.to(torch.bfloat16).float()
    b = lambda t: t[None, None]  # noqa: E731
    want = flash_attention_plain(b(q), b(k), b(v))[0, 0]
    torch.testing.assert_close(out, want, **BF16_BAR)
    assert _rel_rms(out, want) <= BF16_REL_BAR
    got = _wide_backward_model(q, k, v, g, out, lse, rounded=True)
    for ours, theirs in zip(got, flash_attention_bwd_plain(b(q), b(k), b(v), b(g))):
        ours = ours.to(torch.bfloat16).float()
        torch.testing.assert_close(ours, theirs[0, 0], **BF16_BAR)
        assert _rel_rms(ours, theirs[0, 0]) <= BF16_REL_BAR


def _faulty(q, k, v, g, scale, tile):
    """Plain outputs and gradients (one head, f32) of a kernel with one fault:
    it leaves out the 64-row tile ``tile`` (the forward skips those keys, the
    dq role those keys, the dk / dv role those queries), or, with ``tile`` None,
    it runs at softmax scale ``scale``."""
    p = torch.softmax(q @ k.T * scale, dim=-1)
    rows = slice(ROWS * tile, ROWS * tile + ROWS) if tile is not None else slice(0, 0)
    fwd = p.clone()
    fwd[:, rows] = 0
    out = fwd @ v / fwd.sum(dim=1, keepdim=True)
    dp = g @ v.T
    ds = p * (dp - (dp * p).sum(dim=1, keepdim=True))
    by_key, by_query = ds.clone(), ds.clone()
    by_key[:, rows] = 0
    by_query[rows] = 0
    p_q = p.clone()
    p_q[rows] = 0
    return out, by_key @ k * scale, by_query.T @ q * scale, p_q.T @ g


@pytest.mark.parametrize("s,d,d_run,tile", [(4096, 256, 256, 32), (1024, 512, 512, 8),
                                            (1024, 640, 640, 8), (1024, 96, 128, None),
                                            (512, 1000, 1024, None)])
def test_bf16_bar_catches_a_dropped_tile_and_the_padded_scale(s, d, d_run, tile):
    """At the card checks' shapes (one head of each), a fault that the
    absolute bar may miss reads well above the relative bar in the output and
    in every gradient: one 64-row tile of the 64 (S = 4096) or 16 left out, or
    the scale of the padded head dim (96 -> 128, 1000 -> 1024) in place of
    the caller's."""
    q, k, v, g = _inputs(50 + d, s, d, rounded=True)
    want = _faulty(q, k, v, g, d ** -0.5, None)
    b = lambda t: t[None, None]  # noqa: E731
    torch.testing.assert_close(want[0], flash_attention_plain(b(q), b(k), b(v))[0, 0], **TOL)
    for ours, theirs in zip(want[1:], flash_attention_bwd_plain(b(q), b(k), b(v), b(g))):
        torch.testing.assert_close(ours, theirs[0, 0], **TOL)
    got = _faulty(q, k, v, g, d_run ** -0.5, tile)
    for name, ours, theirs in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel_rms(ours.to(torch.bfloat16).float(), theirs) > 1.5 * BF16_REL_BAR, name


@pytest.mark.parametrize("d", [192, 256, 320, 512, 640, 1024, 4096])
def test_wide_shared_memory_fits_a_block(d):
    """One 64 x 64 bf16 chunk is 8 planes of 64 rows x 16 bytes, padded to
    1040 bytes a plane: 8,320 bytes. Forward: up to D = 512 both warpgroups'
    whole q tiles and 8 chunk slots, above it 8 slots of a k and two q chunks
    (199,680 bytes at any D). Backward: up to D = 256 the two whole A tiles,
    the 24 KB p / ds exchange and 8 slots of two chunks and 512 bytes of
    statistics, above it the exchange and 6 slots of four chunks."""
    chunk = 8 * (64 * 16 + 16)
    assert chunk == 8_320
    fwd, bwd = wide_fwd_smem_bytes(d), wide_bwd_smem_bytes(d)
    if d <= 512:
        assert fwd == 2 * (d // 8) * 1040 + 8 * chunk
    else:
        assert fwd == 8 * 3 * chunk == 199_680
    exchange = 128 * 32 * 4 + 128 * 16 * 4
    if d <= 256:
        assert bwd == 2 * (d // 8) * 1040 + exchange + 8 * (2 * chunk + 512)
    else:
        assert bwd == exchange + 6 * (4 * chunk + 512) == 227_328
    assert max(fwd, bwd) <= SMEM_PER_BLOCK
    if d == 256:
        assert (fwd, bwd) == (133_120, 228_352)
        # the narrow forward's ring of whole-D tiles, which the wide kernel replaces
        assert (1 + 2 * 3) * (256 // 8) * 1040 == 232_960 > SMEM_PER_BLOCK
    if d == 512:
        assert fwd == 199_680
