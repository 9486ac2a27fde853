"""The port's backward formulas and autograd bindings, held to the JAX package.

On the CPU ``groupnorm_silu`` and ``flash_attention`` run their plain forward
and their plain backward *formula* (the math the CUDA/Triton kernels
implement, not autograd of the plain forward). These tests hold that formula
to the JAX package's Pallas backward kernels run in interpret mode (as
``tests/test_pallas_kernels.py`` runs them), to ``jax.grad`` / ``jax.vjp`` of
the JAX package's plain path, and to torch autograd of the plain forward.

Bars, f32: rtol 1e-4 / atol 1e-5 for GroupNorm+SiLU (inputs are
non-degenerate: the analytic backward ignores the zero-gradient region of the
forward's variance clamp, which matters only for a constant group); rtol 2e-4
/ atol 2e-5 for attention (the bar of the JAX package's own backward test:
two chained [S, S] products).
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pti_ldm_vae_tpu.ops.attention import multi_head_attention as jax_mha
from pti_ldm_vae_tpu.ops.norm import group_norm as jax_group_norm
from pti_ldm_vae_tpu.ops.norm import group_norm_silu as jax_group_norm_silu
from pti_ldm_vae_tpu.ops.pallas import flash_attention as jax_fa
from pti_ldm_vae_tpu.ops.pallas import groupnorm_silu as jax_gns
from pti_ldm_vae_tpu_torch.ops.attention import multi_head_attention
from pti_ldm_vae_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    groupnorm_silu,
    groupnorm_silu_bwd_plain,
    groupnorm_silu_plain,
    launch_counts,
    reset_launch_counts,
)
from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _plain_forward
from pti_ldm_vae_tpu_torch.ops.norm import group_norm, group_norm_silu

GN_TOL = dict(rtol=1e-4, atol=1e-5)
FA_TOL = dict(rtol=2e-4, atol=2e-5)
EPS = 1e-6


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _gn_inputs(seed, shape):
    c = shape[-1]
    return _arrays(seed, shape, (c,), (c,), shape)  # x, scale, bias, g


def _port_gn_bwd(x, scale, bias, g, groups):
    xt, st, bt, gt = _t(x, scale, bias, g)
    _, mean_g, inv_g = _plain_forward(xt, st, bt, groups, EPS)
    return [a.numpy() for a in groupnorm_silu_bwd_plain(xt, st, bt, mean_g, inv_g, gt, groups)]


@pytest.mark.parametrize("shape,groups,chunk", [((2, 8, 8, 16), 4, None), ((1, 8, 16, 8), 2, 32)],
                         ids=["single_block", "multi_block"])
def test_groupnorm_silu_bwd_plain_matches_pallas_interpret(shape, groups, chunk):
    x, scale, bias, g = _gn_inputs(5, shape)
    patch = (mock.patch.object(jax_gns, "_row_chunk", lambda hw, cap=2048: min(hw, chunk))
             if chunk else mock.patch.object(jax_gns, "_row_chunk", jax_gns._row_chunk))
    with patch, pltpu.force_tpu_interpret_mode():
        xj, sj, bj, gj = _j(x, scale, bias, g)
        _, mean_g, inv_g = jax_gns._forward(xj, sj, bj, groups, EPS)
        want = jax_gns._bwd_pallas(xj, sj, bj, mean_g, inv_g, gj, groups)
    got = _port_gn_bwd(x, scale, bias, g, groups)
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours, np.asarray(theirs), **GN_TOL)


def test_groupnorm_silu_saved_stats_match_pallas_interpret():
    x, scale, bias, _ = _gn_inputs(6, (2, 8, 8, 16))
    with pltpu.force_tpu_interpret_mode():
        _, mean_g, inv_g = jax_gns._forward(*_j(x, scale, bias), 4, EPS)
    _, ours_mean, ours_inv = _plain_forward(*_t(x, scale, bias), 4, EPS)
    np.testing.assert_allclose(ours_mean.numpy(), np.asarray(mean_g).reshape(2, 4), **GN_TOL)
    np.testing.assert_allclose(ours_inv.numpy(), np.asarray(inv_g).reshape(2, 4), **GN_TOL)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 16), 4), ((3, 5, 7, 12), 3)])
def test_groupnorm_silu_bwd_plain_matches_jax_grad(shape, groups):
    x, scale, bias, g = _gn_inputs(7, shape)

    def f(xx, ss, bb):
        return jnp.sum(jax_group_norm_silu(xx, ss, bb, num_groups=groups, eps=EPS) * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(*_j(x, scale, bias))
    got = _port_gn_bwd(x, scale, bias, g, groups)
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours, np.asarray(theirs), **GN_TOL)


def test_groupnorm_silu_bwd_plain_matches_torch_autograd_of_plain_forward():
    x, scale, bias, g = _gn_inputs(8, (2, 6, 10, 16))
    leaves = [t.requires_grad_() for t in _t(x, scale, bias)]
    want = torch.autograd.grad(groupnorm_silu_plain(*leaves, 4, EPS), leaves, _t(g)[0])
    got = _port_gn_bwd(x, scale, bias, g, 4)
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours, theirs.numpy(), **GN_TOL)


@pytest.mark.parametrize("contiguous", [True, False], ids=["contiguous_g", "strided_g"])
def test_groupnorm_silu_function_backward_on_cpu(contiguous):
    """The autograd.Function on CPU tensors runs the plain backward formula,
    for contiguous and strided upstream gradients, and launches nothing."""
    x, scale, bias, _ = _gn_inputs(9, (2, 6, 10, 16))
    g = _arrays(10, (2, 10, 6, 16))[0]
    gt = _t(g)[0].transpose(1, 2)  # [2, 6, 10, 16], strided
    assert not gt.is_contiguous()
    if contiguous:
        gt = gt.contiguous()
    leaves = [t.requires_grad_() for t in _t(x, scale, bias)]
    reset_launch_counts()
    y = groupnorm_silu(*leaves, 4, EPS)
    assert type(y.grad_fn).__name__.startswith("_GroupNormSiLU")
    got = torch.autograd.grad(y, leaves, gt)
    assert not any(launch_counts().values())
    want = _port_gn_bwd(x, scale, bias, np.ascontiguousarray(g.transpose(0, 2, 1, 3)), 4)
    for ours, theirs in zip(got, want):
        np.testing.assert_array_equal(ours.numpy(), theirs)


def test_groupnorm_silu_saves_nothing_without_grad():
    x, scale, bias, _ = _gn_inputs(11, (1, 4, 4, 8))
    xt, st, bt = _t(x, scale, bias)
    st.requires_grad_()
    with torch.no_grad():
        assert groupnorm_silu(xt, st, bt, 2, EPS).grad_fn is None
    assert groupnorm_silu(xt, st.detach(), bt, 2, EPS).grad_fn is None


@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
@pytest.mark.parametrize("silu", [False, True], ids=["group_norm", "group_norm_silu"])
def test_group_norm_grads_match_jax(stats, silu):
    """``ops.norm`` values and gradients, both statistics forms."""
    x, scale, bias, g = _gn_inputs(12, (2, 8, 8, 16))
    x = x + 0.5
    jax_fn, fn = (jax_group_norm_silu, group_norm_silu) if silu else (jax_group_norm, group_norm)

    def f(xx, ss, bb):
        return jnp.sum(jax_fn(xx, ss, bb, num_groups=4, eps=EPS, stats=stats) * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(*_j(x, scale, bias))
    leaves = [t.requires_grad_() for t in _t(x, scale, bias)]
    got = torch.autograd.grad(fn(*leaves, num_groups=4, eps=EPS, stats=stats), leaves, _t(g)[0])
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **GN_TOL)


# ------------------------------------------------------------------ attention
def _qkvg(seed, shape):
    return _arrays(seed, shape, shape, shape, shape)


def test_flash_attention_bwd_plain_matches_pallas_interpret():
    q, k, v, g = _qkvg(13, (2, 2, 64, 32))
    assert jax_fa._bwd_pallas_supported(64, 32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fa._bwd_pallas(*_j(q, k, v, g))
    got = flash_attention_bwd_plain(*_t(q, k, v, g))
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **FA_TOL)


@pytest.mark.parametrize("s", [64, 77], ids=["s64", "ragged_s77"])
def test_flash_attention_bwd_plain_matches_xla_reference_vjp(s):
    q, k, v, g = _qkvg(14, (2, 1, s, 16))
    _, vjp = jax.vjp(jax_fa._xla_reference, *_j(q, k, v))
    want = vjp(jnp.asarray(g))
    got = flash_attention_bwd_plain(*_t(q, k, v, g))
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **FA_TOL)


def test_flash_attention_bwd_plain_matches_torch_autograd_of_plain_forward():
    q, k, v, g = _qkvg(15, (1, 2, 50, 16))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*leaves), leaves, _t(g)[0])
    got = flash_attention_bwd_plain(*_t(q, k, v, g))
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.numpy(), theirs.numpy(), **FA_TOL)


@pytest.mark.parametrize("contiguous", [True, False], ids=["contiguous_g", "strided_g"])
def test_flash_attention_function_backward_on_cpu(contiguous):
    q, k, v, _ = _qkvg(16, (2, 2, 40, 16))
    g = _arrays(17, (2, 40, 2, 16))[0]
    gt = _t(g)[0].transpose(1, 2)
    if contiguous:
        gt = gt.contiguous()
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    reset_launch_counts()
    out = flash_attention(*leaves)
    assert type(out.grad_fn).__name__.startswith("_FlashAttention")
    got = torch.autograd.grad(out, leaves, gt)
    assert not any(launch_counts().values())
    want = flash_attention_bwd_plain(*_t(q, k, v), gt.contiguous())
    for ours, theirs in zip(got, want):
        np.testing.assert_array_equal(ours.numpy(), theirs.numpy())


@pytest.mark.parametrize("heads", [1, 2])
def test_multi_head_attention_values_and_grads_match_jax(heads):
    q, k, v, g = _arrays(18, (2, 48, 16), (2, 48, 16), (2, 48, 16), (2, 48, 16))

    def f(qq, kk, vv):
        return jnp.sum(jax_mha(qq, kk, vv, num_heads=heads, use_pallas=False) * jnp.asarray(g))

    want_val = jax_mha(*_j(q, k, v), num_heads=heads, use_pallas=False)
    want = jax.grad(f, argnums=(0, 1, 2))(*_j(q, k, v))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = multi_head_attention(*leaves, num_heads=heads)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_val), **FA_TOL)
    got = torch.autograd.grad(out, leaves, _t(g)[0])
    for ours, theirs in zip(got, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **FA_TOL)
