"""The port's losses and LPIPS, held to the JAX package.

Inputs are made with numpy and handed to both; the JAX package's random LPIPS
tree is carried across by ``lpips_params_from_jax`` (the two frameworks'
generators differ, so the port's own random tree has other values). Bars,
f32 on the CPU: rtol 1e-4 / atol 1e-5 per module; the seven-tap distance and
its gradient sum hundreds of thousands of terms through 18 convolutions, so
they are held to rtol 1e-3 with atol scaled to the tensor's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.losses import composite as jax_composite
from pti_ldm_vae_tpu.losses import kl as jax_kl
from pti_ldm_vae_tpu.models import lpips as jax_lpips
from pti_ldm_vae_tpu.utils.losses import ensure_three_channels as jax_three
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import (
    lpips_params_from_jax,
    lpips_params_from_npz,
)
from pti_ldm_vae_tpu_torch.losses import composite, kl
from pti_ldm_vae_tpu_torch.models import lpips
from pti_ldm_vae_tpu_torch.utils.losses import ensure_three_channels

TOL = dict(rtol=1e-4, atol=1e-5)


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["reference", "corrected"])
def test_kl_from_forward_matches_jax(mode):
    mu, sigma = _rand(0, (3, 4, 4, 3)), np.abs(_rand(1, (3, 4, 4, 3))) + 0.1
    want = jax_kl.kl_from_forward(jnp.asarray(mu), jnp.asarray(sigma), mode=mode)
    got = kl.kl_from_forward(torch.from_numpy(mu), torch.from_numpy(sigma), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kl_rejects_unknown_mode():
    with pytest.raises(ValueError, match="kl mode"):
        kl.kl_from_forward(torch.zeros(1, 2), torch.ones(1, 2), mode="other")


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_reconstruction_loss_matches_jax(kind):
    a, b = _rand(2, (2, 8, 8, 1)), _rand(3, (2, 8, 8, 1))
    want = jax_composite.reconstruction_loss(jnp.asarray(a), jnp.asarray(b), kind)
    got = composite.reconstruction_loss(torch.from_numpy(a), torch.from_numpy(b), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ar", [False, True])
def test_compute_total_loss_matches_jax(ar):
    terms = [0.3, 120.0, 0.05, 0.7, 0.2]
    kw = dict(kl_weight=1e-3, perceptual_weight=0.9, adv_weight=0.5, ar_gamma=2.0,
              ar_vae_enabled=ar)
    want = jax_composite.compute_total_loss(*terms, **kw)
    got = composite.compute_total_loss(*[torch.tensor(t) for t in terms], **kw)
    assert composite.compute_total_loss(*terms, **kw) == pytest.approx(want)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_ensure_three_channels_matches_jax():
    one, three = _rand(4, (2, 5, 5, 1)), _rand(5, (2, 5, 5, 3))
    np.testing.assert_array_equal(ensure_three_channels(torch.from_numpy(one)).numpy(),
                                  np.asarray(jax_three(jnp.asarray(one))))
    assert ensure_three_channels(torch.from_numpy(three)).shape == (2, 5, 5, 3)
    for bad in (torch.zeros(2, 5, 5, 2), torch.zeros(5, 5, 1)):
        with pytest.raises(ValueError):
            ensure_three_channels(bad)


# ------------------------------------------------------------------- LPIPS
@pytest.fixture(scope="module")
def trees():
    jax_tree = jax.tree_util.tree_map(np.asarray, jax_lpips.init_lpips_params(3))
    return jax_tree, lpips_params_from_jax(jax_tree)


def test_lpips_tree_layout(trees):
    jax_tree, port_tree = trees
    own = lpips.init_lpips_params(0)
    assert set(own) == set(port_tree) == set(jax_tree)
    for key, node in port_tree.items():
        if key.startswith("fire"):
            for part in ("squeeze", "expand1", "expand3"):
                assert own[key][part]["w"].shape == node[part]["w"].shape
                h, w, i, o = jax_tree[key][part]["w"].shape
                assert node[part]["w"].shape == (o, i, h, w)
    assert not lpips.lpips_is_pretrained(port_tree) and not lpips.lpips_is_pretrained(own)
    # the same seed gives the same tree; lin weights are non-negative and below 2/C
    again = lpips.init_lpips_params(0)
    assert torch.equal(own["fire3"]["expand3"]["w"], again["fire3"]["expand3"]["w"])
    assert float(own["lin2"]["w"].min()) >= 0 and float(own["lin2"]["w"].max()) < 2 / 256


def test_lpips_taps_match_jax(trees):
    jax_tree, port_tree = trees
    x = _rand(6, (2, 33, 40, 3))
    want = jax_lpips.lpips_features(jax_tree, jnp.asarray(x))
    got = lpips.lpips_features(port_tree, torch.from_numpy(x))
    assert len(got) == len(want) == 7
    for ours, theirs in zip(got, want):
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_lpips_distance_per_sample_matches_jax(trees, channels):
    jax_tree, port_tree = trees
    x, y = _rand(7, (3, 32, 32, channels)), _rand(8, (3, 32, 32, channels))
    want = np.asarray(jax_lpips.lpips_distance_per_sample(jax_tree, jnp.asarray(x), jnp.asarray(y)))
    got = lpips.lpips_distance_per_sample(port_tree, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    mean = lpips.lpips_distance(port_tree, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(mean), want.mean(), rtol=1e-3)


def test_lpips_gradient_matches_jax(trees):
    jax_tree, port_tree = trees
    x, y = _rand(9, (2, 32, 32, 1)), _rand(10, (2, 32, 32, 1))
    want = np.asarray(jax.grad(
        lambda xx: jnp.sum(jax_lpips.lpips_distance_per_sample(jax_tree, xx, jnp.asarray(y)))
    )(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    lpips.lpips_distance_per_sample(port_tree, xt, torch.from_numpy(y)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_lpips_needs_17_pixels(trees):
    with pytest.raises(ValueError, match=">= 17 px"):
        lpips.lpips_distance_per_sample(trees[1], torch.zeros(1, 16, 32, 1), torch.zeros(1, 16, 32, 1))


def test_lpips_npz_is_read_by_both_packages(trees, tmp_path, monkeypatch):
    """The ``.npz`` of converted weights (HWIO kernels) loads in both packages
    to the same function, is marked pretrained, and follows the search order."""
    jax_tree, port_tree = trees
    flat = {}
    for key, node in jax_tree.items():
        if key == "_pretrained":
            continue
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                for sub, arr in leaf.items():
                    flat[f"{key}/{name}/{sub}"] = arr
            else:
                flat[f"{key}/{name}"] = leaf
    path = tmp_path / "lpips_squeeze.npz"
    np.savez(path, **flat)
    from_file = lpips_params_from_npz(str(path))
    assert lpips.lpips_is_pretrained(from_file)
    assert torch.equal(from_file["fire2"]["expand3"]["w"], port_tree["fire2"]["expand3"]["w"])

    x, y = _rand(11, (1, 32, 32, 1)), _rand(12, (1, 32, 32, 1))
    jax_loaded = jax_lpips.load_lpips_params(str(path))
    assert jax_lpips.lpips_is_pretrained(jax_loaded)
    want = np.asarray(jax_lpips.lpips_distance_per_sample(jax_loaded, jnp.asarray(x), jnp.asarray(y)))
    explicit = lpips.load_lpips_params(str(path))  # explicit path wins even under "none"
    got = lpips.lpips_distance_per_sample(explicit, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3)

    monkeypatch.setenv("PTI_LPIPS_WEIGHTS", str(path))
    assert lpips.lpips_is_pretrained(lpips.load_lpips_params())
    monkeypatch.setenv("PTI_LPIPS_WEIGHTS", "none")
    assert not lpips.lpips_is_pretrained(lpips.load_lpips_params())


def test_lpips_fallback_warns_loudly(monkeypatch, caplog):
    monkeypatch.setenv("PTI_LPIPS_WEIGHTS", "none")
    with caplog.at_level("WARNING"):
        params = lpips.load_lpips_params()
    assert "RANDOM features" in caplog.text
    assert not lpips.lpips_is_pretrained(params)
