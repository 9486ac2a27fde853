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


# --- the apply-time knobs: s2d_stem and remat, each held to the JAX package's same form ---

S2D_FORMS = [True, "encoder", "decoder"]


def _port_form(port, **knobs):
    """A port model in another form, loaded strict from ``port``'s state dict."""
    model = autoencoder_from_config(TOY, **knobs)
    model.load_state_dict(port.state_dict(), strict=True)
    return model.eval()


def _jax_outputs_and_grads(cfg, variables, x, r, **knobs):
    """JAX reconstruct_deterministic in the form ``knobs`` and the gradients of
    ``sum(recon * r)`` in the input and the parameters (MONAI-keyed)."""
    jax_model = jax_from_config(cfg, use_pallas_attention=False, **knobs)

    def loss(v, xx):
        out = jax_model.apply(v, xx, method=jax_model.reconstruct_deterministic)
        return jnp.sum(out * r), out

    with jax.default_matmul_precision("highest"):
        (_, out), (g_vars, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            variables, jnp.asarray(x))
    g_vars = jax.tree_util.tree_map(np.asarray, g_vars)
    return np.asarray(out), np.asarray(g_x), state_dict_from_flax(g_vars, cfg)


def _port_outputs_and_grads(model, x, r):
    xx = torch.from_numpy(x).requires_grad_()
    out = model.reconstruct_deterministic(xx)
    (out * torch.from_numpy(r)).sum().backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
             for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out.detach(), xx.grad, grads


def _assert_same(got, want, tol=TOL):
    """Outputs at ``tol``; each gradient tensor at ``tol`` with its atol in
    units of the larger of 1 and the tensor's largest entry (the gradients of
    ``sum(recon * r)`` reach ~20, where f32 sums in another order differ by
    ~1e-6 of that; the attention's ``to_k.bias`` gradients are 0 in exact
    arithmetic and hold ~1e-7 of rounding on both sides)."""
    out_g, gx_g, grads_g = got
    out_w, gx_w, grads_w = want
    np.testing.assert_allclose(np.asarray(out_g), np.asarray(out_w), **tol)
    assert set(grads_g) == set(grads_w)
    for key, (g, w) in {"x": (gx_g, gx_w), **{k: (grads_g[k], v) for k, v in grads_w.items()}}.items():
        g, w = np.asarray(g), np.asarray(w)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=tol["rtol"], atol=tol["atol"] * scale, err_msg=key)


def _knob_inputs(seed):
    rng = np.random.default_rng(seed)
    return _nhwc(rng, (2, 32, 32, 1)), _nhwc(rng, (2, 32, 32, 1))


@pytest.mark.parametrize("form", S2D_FORMS, ids=["s2d_true", "s2d_encoder", "s2d_decoder"])
def test_s2d_form_matches_jax(toy, form):
    """Each s2d form: outputs, input gradient and every parameter gradient
    against the JAX model in the same form on the same weights."""
    _, variables, port = toy
    x, r = _knob_inputs(20)
    want = _jax_outputs_and_grads(TOY, variables, x, r, s2d_stem=form)
    _assert_same(_port_outputs_and_grads(_port_form(port, s2d_stem=form), x, r), want)


@pytest.mark.parametrize("form", S2D_FORMS, ids=["s2d_true", "s2d_encoder", "s2d_decoder"])
def test_s2d_form_matches_the_standard_form(toy, form):
    """Each s2d form against the port's own standard form: the same math on
    another schedule, so the same outputs and gradients."""
    _, _, port = toy
    x, r = _knob_inputs(21)
    want = _port_outputs_and_grads(port, x, r)
    _assert_same(_port_outputs_and_grads(_port_form(port, s2d_stem=form), x, r), want)


def test_remat_matches_jax(toy):
    _, variables, port = toy
    x, r = _knob_inputs(22)
    want = _jax_outputs_and_grads(TOY, variables, x, r, remat=True)
    _assert_same(_port_outputs_and_grads(_port_form(port, remat=True), x, r), want)


@pytest.mark.parametrize("s2d_stem", [False, True], ids=["standard", "s2d_true"])
def test_remat_gradients_are_bit_equal(toy, s2d_stem):
    """Recomputing a block's forward in the backward gives the same bits on
    the CPU: remat changes what is kept, not what is computed."""
    _, _, port = toy
    x, r = _knob_inputs(23)
    want = _port_outputs_and_grads(_port_form(port, s2d_stem=s2d_stem), x, r)
    got = _port_outputs_and_grads(_port_form(port, s2d_stem=s2d_stem, remat=True), x, r)
    _assert_same(got, want, dict(rtol=0, atol=0))


def test_remat_is_inert_without_a_gradient(toy, monkeypatch):
    """Under ``inference_mode`` no block is checkpointed."""
    import pti_ldm_vae_tpu_torch.models.autoencoder_kl as ae_mod

    _, _, port = toy
    model = _port_form(port, remat=True)
    calls = []
    monkeypatch.setattr(ae_mod, "checkpoint", lambda *a, **k: calls.append(1))
    x = torch.from_numpy(_knob_inputs(24)[0])
    with torch.inference_mode():
        model.reconstruct_deterministic(x)
    assert calls == []


@pytest.mark.parametrize("knobs", [dict(s2d_stem=True), dict(s2d_stem="encoder"),
                                   dict(s2d_stem="decoder"), dict(remat=True),
                                   dict(s2d_stem=True, remat=True), dict(s2d_stem="auto")],
                         ids=["s2d_true", "s2d_encoder", "s2d_decoder", "remat", "both", "auto"])
def test_one_state_dict_loads_strict_into_every_form(toy, knobs):
    _, variables, port = toy
    model = autoencoder_from_config(TOY, **knobs)
    assert list(model.state_dict()) == list(port.state_dict())
    model.load_state_dict(state_dict_from_flax(variables, TOY), strict=True)
    for key, value in model.state_dict().items():
        assert value.shape == port.state_dict()[key].shape


@pytest.mark.parametrize("cfg,x_shape,match", [
    (dict(TOY, attention_levels=[True, False]), (1, 32, 32, 1), "level-0 attention"),
    (dict(TOY, channels=[8], attention_levels=[False]), (1, 32, 32, 1), ">= 2 levels"),
    (dict(TOY, attention_levels=[False, False]), (1, 33, 32, 1), "even H, W"),
], ids=["level0_attention", "one_level", "odd_height"])
def test_s2d_eligibility_errors_match_jax(cfg, x_shape, match):
    """An explicit form on an ineligible model or input raises the JAX
    package's ValueError, word for word; "auto" takes the standard path."""
    jax_model = jax_from_config(cfg, use_pallas_attention=False, s2d_stem=True)
    x = np.zeros(x_shape, np.float32)
    with pytest.raises(ValueError) as jax_err:
        jax_model.init(jax.random.key(0), jnp.asarray(x), jax.random.key(1))
    model = autoencoder_from_config(cfg, s2d_stem=True)
    with pytest.raises(ValueError) as port_err, torch.inference_mode():
        model(torch.from_numpy(x), eps=torch.zeros(1))
    assert str(port_err.value) == str(jax_err.value) and match in str(port_err.value)
    auto = autoencoder_from_config(cfg, s2d_stem="auto")
    with torch.inference_mode():
        auto.reconstruct_deterministic(torch.from_numpy(x))


def test_auto_gates_each_side_on_the_batch(toy, monkeypatch):
    """``"auto"`` takes each side's s2d form at batches within its inference
    threshold (the JAX package's v5e ones set here; the port's H100 ones are
    0): at b2 both sides, at b4 the encoder alone, then neither."""
    from pti_ldm_vae_tpu_torch.ops import space_to_depth as s2d_policy

    _, _, port = toy
    monkeypatch.setattr(s2d_policy, "S2D_AUTO_INFER_ENCODER_MAX_BATCH", 4)
    monkeypatch.setattr(s2d_policy, "S2D_AUTO_INFER_DECODER_MAX_BATCH", 2)
    auto = _port_form(port, s2d_stem="auto")
    for batch, enc, dec in ((2, True, True), (4, True, False), (6, False, False)):
        x = torch.zeros(batch, 32, 32, 1)
        assert (auto.encoder._use_s2d(x), auto.decoder._use_s2d(torch.zeros(batch, 16, 16, 3))) == (
            enc, dec)
    x = torch.from_numpy(_nhwc(np.random.default_rng(25), (2, 32, 32, 1)))
    with torch.inference_mode():
        torch.testing.assert_close(auto.reconstruct_deterministic(x),
                                   _port_form(port, s2d_stem=True).reconstruct_deterministic(x),
                                   rtol=0, atol=0)


def test_s2d_on_other_spatial_dims_is_a_value_error():
    with pytest.raises(ValueError, match="s2d_stem requires spatial_dims == 2"):
        autoencoder_from_config(dict(TOY, spatial_dims=3), s2d_stem="encoder")


@pytest.mark.parametrize("spatial_dims", [1, 3])
def test_spatial_dims_1_and_3_reconstruct(spatial_dims):
    """The toy model at rank 1 and 3 builds and runs end to end (held to the
    JAX package in ``tests/test_torch_spatial_dims.py``); the convolution
    kernels stay 2-D."""
    port = autoencoder_from_config(dict(TOY, spatial_dims=spatial_dims))
    x = torch.from_numpy(_nhwc(np.random.default_rng(26), (2, *(16,) * spatial_dims, 1)))
    with torch.inference_mode():
        recon, z_mu, z_sigma = port(x, eps=torch.zeros(2, *(8,) * spatial_dims, 3))
    assert recon.shape == x.shape and z_mu.shape == z_sigma.shape == (2, *(8,) * spatial_dims, 3)
    assert torch.isfinite(recon).all()
    with pytest.raises(ValueError, match="conv_kernel requires spatial_dims == 2"):
        autoencoder_from_config(dict(TOY, spatial_dims=spatial_dims), conv_kernel=True)


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
