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
    with pytest.raises(NotImplementedError):  # no two-pass kernel off the CPU
        group_norm_silu(x, torch.ones(8), torch.zeros(8), num_groups=2, stats="two_pass")

