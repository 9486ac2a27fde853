"""The PyTorch port's ops and kernel modules, held to the JAX package.

On the CPU each kernel wrapper runs its plain version; these tests hold that
version to the JAX package's plain path and to its Pallas kernel run in
interpret mode (as ``tests/test_pallas_kernels.py`` runs it). Bars: f32,
rtol 1e-4 / atol 1e-5. The kernels themselves are held to their plain
versions on the card by ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.ops.attention import multi_head_attention as jax_mha
from pti_ldm_vae_tpu.ops.norm import group_norm as jax_group_norm
from pti_ldm_vae_tpu.ops.norm import group_norm_silu as jax_group_norm_silu
from pti_ldm_vae_tpu.ops.pallas.flash_attention import _xla_reference
from pti_ldm_vae_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from pti_ldm_vae_tpu.ops.pallas.groupnorm_silu import groupnorm_silu_pallas
from pti_ldm_vae_tpu.ops.resize import upsample_nearest_2x as jax_upsample
from pti_ldm_vae_tpu_torch.ops.attention import multi_head_attention
from pti_ldm_vae_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_plain,
    groupnorm_silu,
    groupnorm_silu_plain,
    reset_launch_counts,
)
from pti_ldm_vae_tpu_torch.ops.norm import group_norm, group_norm_silu
from pti_ldm_vae_tpu_torch.ops.resize import upsample_nearest_2x

TOL = dict(rtol=1e-4, atol=1e-5)


def _arrays(seed, *shapes, loc=0.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) + loc).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_group_norm_matches_jax(stats):
    x, scale, bias = _arrays(0, (2, 8, 8, 16), (16,), (16,), loc=0.5)
    want = jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                          num_groups=4, stats=stats)
    got = group_norm(*_t(x, scale, bias), num_groups=4, stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_group_norm_silu_matches_jax(stats):
    x, scale, bias = _arrays(1, (2, 8, 8, 16), (16,), (16,), loc=0.5)
    want = jax_group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                               num_groups=4, stats=stats)
    got = group_norm_silu(*_t(x, scale, bias), num_groups=4, stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 16), 4), ((1, 16, 16, 32), 16)])
def test_groupnorm_silu_plain_matches_pallas_interpret(shape, groups):
    from jax.experimental.pallas import tpu as pltpu

    c = shape[-1]
    x, scale, bias = _arrays(2, shape, (c,), (c,))
    with pltpu.force_tpu_interpret_mode():
        want = groupnorm_silu_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                     groups, 1e-6)
    got = groupnorm_silu(*_t(x, scale, bias), groups, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(groupnorm_silu_plain(*_t(x, scale, bias), groups, 1e-6).numpy(),
                               got.numpy(), rtol=0, atol=0)


def test_flash_attention_plain_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    q, k, v = _arrays(3, *[(1, 1, 512, 16)] * 3)
    with pltpu.force_tpu_interpret_mode():
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("d", [256, 640])
def test_flash_attention_wide_head_dims_match_pallas_interpret(d):
    """Head dims the wide tensor-core kernels take in bf16 (256, the kl1e3 mid
    blocks) and one above 512 (640, the FMA split kernels in f32): the port's
    path on the CPU against the Pallas forward in interpret mode and, through
    ``jax.vjp``, its backward (the XLA-remat backward off the TPU)."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    q, k, v, g = _arrays(8, *[(1, 2, 48, d)] * 4)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax_flash, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want_grads = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    got = flash_attention(*leaves)
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for ours, theirs in zip(got_grads, want_grads):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


@pytest.mark.parametrize("s", [1000, 77])
def test_flash_attention_plain_matches_xla_reference_ragged(s):
    q, k, v = _arrays(4, *[(2, 2, s, 32)] * 3)
    want = _xla_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention_plain(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("heads", [1, 2])
def test_multi_head_attention_matches_jax(heads):
    q, k, v = _arrays(5, *[(2, 64, 32)] * 3)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=heads)
    got = multi_head_attention(*_t(q, k, v), num_heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_upsample_nearest_2x_matches_jax():
    (x,) = _arrays(6, (2, 5, 7, 3))
    want = jax_upsample(jnp.asarray(x))
    got = upsample_nearest_2x(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.is_contiguous()


def test_cpu_calls_run_the_plain_versions_and_count_no_launch():
    reset_launch_counts()
    x, scale, bias = _t(*_arrays(7, (1, 4, 4, 8), (8,), (8,)))
    groupnorm_silu(x, scale, bias, 2, 1e-6)
    q = torch.randn(1, 1, 16, 16)
    flash_attention(q, q, q)
    assert groupnorm_silu.launches == 0 and flash_attention.launches == 0


def test_wrappers_refuse_other_devices():
    x = torch.empty(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError):
        groupnorm_silu(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"), 2, 1e-6)
    q = torch.empty(1, 1, 16, 16, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    # two-pass statistics are plain tensor code on every device: no kernel to refuse them
    before = group_norm_silu.two_pass_calls
    y = group_norm_silu(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"),
                        num_groups=2, stats="two_pass")
    assert y.device.type == "meta" and y.shape == x.shape
    assert group_norm_silu.two_pass_calls == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_group_norm_silu_takes_the_counted_plain_route(dtype):
    """``"two_pass"`` runs the plain formulation, counted apart from the
    kernels, on a meta (non-CPU) tensor as on the CPU; ``"one_pass"`` never
    takes it, and no launch is counted for either on the CPU."""
    x, scale, bias = _t(*_arrays(11, (2, 4, 4, 8), (8,), (8,)))
    reset_launch_counts()
    start = group_norm_silu.two_pass_calls
    group_norm_silu(x.to(dtype), scale, bias, num_groups=2, stats="one_pass")
    assert group_norm_silu.two_pass_calls == start
    for device in ("cpu", "meta"):
        out = group_norm_silu(x.to(device, dtype), scale.to(device), bias.to(device),
                              num_groups=2, stats="two_pass")
        assert out.dtype == dtype and out.shape == x.shape
    assert group_norm_silu.two_pass_calls == start + 2
    assert groupnorm_silu.launches == 0 and groupnorm_silu.bwd_launches == 0


def test_two_pass_gradients_match_jax():
    """The JAX package's ``two_pass`` GroupNorm+SiLU and the port's: outputs and
    the gradients in x, scale and bias, on inputs whose mean dominates their
    spread (where one-pass statistics would lose digits)."""
    import jax

    x, scale, bias, g = _arrays(12, (2, 8, 8, 16), (16,), (16,), (2, 8, 8, 16))
    x = 3.0 + 0.05 * x

    def jax_loss(xx, ss, bb):
        return jnp.sum(jax_group_norm_silu(xx, ss, bb, num_groups=4, stats="two_pass") * g)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    leaves = [t.requires_grad_() for t in _t(x, scale, bias)]
    out = group_norm_silu(*leaves, num_groups=4, stats="two_pass")
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for name, ours, theirs in zip(("dx", "dscale", "dbias"), got, want):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(theirs).max())), err_msg=name)

