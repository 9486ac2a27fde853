"""The PyTorch port's AutoencoderKL and weight loading, held to the JAX package.

Weights come from the JAX model's init and cross through the port's
``state_dict_from_flax``; inputs and sampling noise are made with numpy and
handed to both. Bars (f32, CPU): per module rtol 1e-4 / atol 1e-5, full
reconstruction max abs error <= 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.checkpoint.torch_convert import to_torch_state_dict
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import (
    monai_layout,
    monai_state_dict,
    state_dict_from_flax,
)
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=3,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, True],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)
FLAGSHIP = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=4,
    channels=[32, 64, 128, 128], num_res_blocks=2, norm_num_groups=16,
    norm_eps=1e-6, attention_levels=[False, False, False, False],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)
TOL = dict(rtol=1e-4, atol=1e-5)


def _build(cfg, size, seed):
    jax_model = jax_from_config(cfg, use_pallas_attention=False)
    variables = jax.jit(jax_model.init)(
        jax.random.key(seed), jnp.zeros((1, size, size, 1)), jax.random.key(seed + 1)
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = autoencoder_from_config(cfg)
    port.load_state_dict(state_dict_from_flax(variables, cfg), strict=True)
    return jax_model, variables, port.eval()


@pytest.fixture(scope="module")
def toy():
    return _build(TOY, 32, 3)


def _nhwc(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def test_converter_matches_jax_export_key_for_key(toy):
    _, variables, port = toy
    ours = state_dict_from_flax(variables, TOY)
    theirs = to_torch_state_dict(variables, TOY)
    assert list(ours) == list(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    assert set(port.state_dict()) == set(ours)


def test_layout_copy_matches_jax_layout():
    from pti_ldm_vae_tpu.checkpoint.torch_convert import monai_layout as jax_layout

    for cfg in (TOY, FLAGSHIP):
        assert monai_layout(cfg) == jax_layout(cfg)


def test_reference_pth_loads_strict_raw_wrapped_and_fused(toy, tmp_path):
    _, variables, _ = toy
    sd = state_dict_from_flax(variables, TOY)
    fused = dict(sd)
    for prefix in {k.rsplit(".attn.", 1)[0] for k in sd if ".attn." in k}:
        ws = [fused.pop(f"{prefix}.attn.{n}.weight") for n in ("to_q", "to_k", "to_v")]
        bs = [fused.pop(f"{prefix}.attn.{n}.bias") for n in ("to_q", "to_k", "to_v")]
        fused[f"{prefix}.attn.qkv.weight"] = torch.cat(ws)
        fused[f"{prefix}.attn.qkv.bias"] = torch.cat(bs)
    for payload in (sd, {"autoencoder_state_dict": sd}, fused):
        path = tmp_path / "w.pth"
        torch.save(payload, path)
        loaded = monai_state_dict(torch.load(path, weights_only=True))
        model = autoencoder_from_config(TOY)
        model.load_state_dict(loaded, strict=True)
        for key, value in sd.items():
            torch.testing.assert_close(model.state_dict()[key], value, rtol=0, atol=0)


def test_encoder_parity(toy):
    jax_model, variables, port = toy
    x = _nhwc(np.random.default_rng(0), (2, 32, 32, 1))
    want = jax_model.apply(variables, jnp.asarray(x), method=lambda m, x: m.encoder(x))
    with torch.inference_mode():
        got = port.encoder(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decoder_parity(toy):
    jax_model, variables, port = toy
    z = _nhwc(np.random.default_rng(1), (2, 16, 16, TOY["latent_channels"]))
    want = jax_model.apply(variables, jnp.asarray(z), method=lambda m, z: m.decoder(z))
    with torch.inference_mode():
        got = port.decoder(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_mu_sigma_parity(toy):
    jax_model, variables, port = toy
    x = _nhwc(np.random.default_rng(2), (2, 32, 32, 1))
    mu_j, sigma_j = jax_model.apply(variables, jnp.asarray(x), method=jax_model.encode)
    with torch.inference_mode():
        mu_t, sigma_t = port.encode(torch.from_numpy(x))
    assert mu_t.dtype == sigma_t.dtype == torch.float32
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(sigma_t.numpy(), np.asarray(sigma_j), **TOL)


def test_sampling_with_injected_eps(toy):
    jax_model, variables, port = toy
    rng = np.random.default_rng(3)
    x = _nhwc(rng, (2, 32, 32, 1))
    eps = _nhwc(rng, (2, 16, 16, TOY["latent_channels"]))
    mu_j, sigma_j = jax_model.apply(variables, jnp.asarray(x), method=jax_model.encode)
    want = np.asarray(mu_j) + eps * np.asarray(sigma_j)
    with torch.inference_mode():
        got = port.encode_stage_2_inputs(torch.from_numpy(x), eps=torch.from_numpy(eps))
        recon, _, _ = port(torch.from_numpy(x), eps=torch.from_numpy(eps))
        z = port.sampling(*port.encode(torch.from_numpy(x)), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(z.numpy(), want, **TOL)
    want_recon = jax_model.apply(variables, jnp.asarray(want), method=jax_model.decode)
    np.testing.assert_allclose(recon.numpy(), np.asarray(want_recon), **TOL)


def test_sampling_draws_from_generator(toy):
    _, _, port = toy
    mu, sigma = torch.zeros(1, 4, 4, 3), torch.ones(1, 4, 4, 3)
    a = port.sampling(mu, sigma, generator=torch.Generator().manual_seed(5))
    b = port.sampling(mu, sigma, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.std()) > 0.1


def test_reconstruct_deterministic_parity(toy):
    jax_model, variables, port = toy
    x = _nhwc(np.random.default_rng(4), (2, 32, 32, 1))
    want = jax_model.apply(variables, jnp.asarray(x), method=jax_model.reconstruct_deterministic)
    with torch.inference_mode():
        got = port.reconstruct_deterministic(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3


def test_two_pass_norm_stats_parity():
    cfg = dict(TOY, attention_levels=[False, False])
    jax_model = jax_from_config(cfg, use_pallas_attention=False, norm_stats="two_pass")
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jax_model.init)(
        jax.random.key(9), jnp.zeros((1, 16, 16, 1)), jax.random.key(10)))
    port = autoencoder_from_config(cfg, norm_stats="two_pass")
    port.load_state_dict(state_dict_from_flax(variables, cfg), strict=True)
    x = _nhwc(np.random.default_rng(5), (1, 16, 16, 1))
    want = jax_model.apply(variables, jnp.asarray(x), method=jax_model.reconstruct_deterministic)
    with torch.inference_mode():
        got = port.reconstruct_deterministic(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kwargs", [
    dict(s2d_stem=True), dict(s2d_stem="encoder"), dict(s2d_stem="decoder"),
])
def test_unported_s2d_forms_raise(kwargs):
    with pytest.raises(NotImplementedError):
        autoencoder_from_config(TOY, **kwargs)


@pytest.mark.parametrize("spatial_dims", [1, 3])
def test_unported_spatial_dims_raise(spatial_dims):
    with pytest.raises(NotImplementedError):
        autoencoder_from_config(dict(TOY, spatial_dims=spatial_dims))


def test_auto_s2d_takes_standard_path(toy):
    _, variables, port = toy
    auto = autoencoder_from_config(TOY, s2d_stem="auto")
    auto.load_state_dict(port.state_dict(), strict=True)
    x = torch.from_numpy(_nhwc(np.random.default_rng(6), (1, 32, 32, 1)))
    with torch.inference_mode():
        torch.testing.assert_close(auto.reconstruct_deterministic(x),
                                   port.reconstruct_deterministic(x), rtol=0, atol=0)


@pytest.mark.slow
def test_flagship_reconstruct_parity_64():
    """The flagship architecture (config/vae_dente_no_adv.json) at 64²."""
    jax_model, variables, port = _build(FLAGSHIP, 64, 7)
    x = _nhwc(np.random.default_rng(12), (1, 64, 64, 1))
    mu_j, sigma_j = jax_model.apply(variables, jnp.asarray(x), method=jax_model.encode)
    want = jax_model.apply(variables, jnp.asarray(x), method=jax_model.reconstruct_deterministic)
    with torch.inference_mode():
        mu_t, sigma_t = port.encode(torch.from_numpy(x))
        got = port.reconstruct_deterministic(torch.from_numpy(x))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(sigma_t.numpy(), np.asarray(sigma_j), **TOL)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-3
