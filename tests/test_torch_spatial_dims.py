"""``spatial_dims`` 1 and 3 in the port, held to the JAX package on the CPU
(the cases of the JAX package's ``tests/test_spatial_dims3.py``, at both
ranks where the JAX package takes both).

Weights: the JAX modules' variables from ``jax.eval_shape`` of their
``init`` (no trace of the model), filled from a seeded numpy generator,
carried across by ``state_dict_from_flax`` / ``disc_state_dict_from_flax``
/ ``unet_state_dict_from_flax`` and loaded with ``strict=True``. Inputs and
posterior noise are numpy arrays (the noise drawn as the JAX step draws
it). On the port's side the GroupNorm+SiLU and flash-attention wrappers run
their plain versions, GroupNorm+SiLU on the rank-4 view of the tensor.

Bars: rtol 1e-4 / atol 1e-5 per op, module and metric; train-step loss
terms rtol 1e-4 and gradients within 2e-3 of each tensor's largest entry
(2e-2 through the discriminator's LeakyReLU kinks, ROADMAP C). The JAX
fake-3D LPIPS and the step with it are ``slow``; their cheap counterparts
hold the port's fake-3D LPIPS to its own 2-D distance per slice and the
step without the perceptual term.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.checkpoint.torch_convert import disc_to_torch_state_dict, to_torch_state_dict
from pti_ldm_vae_tpu.cli.evaluate_vae import evaluate as jax_evaluate
from pti_ldm_vae_tpu.models import lpips as jax_lpips
from pti_ldm_vae_tpu.models import unet as jax_unet
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from pti_ldm_vae_tpu.models.regressor import flatten_latent as jax_flatten_latent
from pti_ldm_vae_tpu.ops import norm as jax_norm
from pti_ldm_vae_tpu.ops.resize import upsample_nearest_2x as jax_upsample
from pti_ldm_vae_tpu.train import steps as jax_steps
from pti_ldm_vae_tpu.utils import eval_metrics as jax_metrics
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import (
    disc_state_dict_from_flax,
    lpips_params_from_jax,
    state_dict_from_flax,
)
from pti_ldm_vae_tpu_torch.checkpoint.unet_convert import unet_state_dict_from_flax
from pti_ldm_vae_tpu_torch.cli.evaluate_vae import evaluate, evaluate_batch
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
from pti_ldm_vae_tpu_torch.models.lpips import (
    init_lpips_params,
    lpips_distance_per_sample,
    lpips_distance_per_sample_3d,
)
from pti_ldm_vae_tpu_torch.models.regressor import flatten_latent, infer_flat_dim_from_patch
from pti_ldm_vae_tpu_torch.models.unet import diffusion_unet_from_config
from pti_ldm_vae_tpu_torch.ops import kernels
from pti_ldm_vae_tpu_torch.ops.norm import group_norm, group_norm_silu, instance_norm, rank4_view
from pti_ldm_vae_tpu_torch.ops.resize import upsample_nearest_2x
from pti_ldm_vae_tpu_torch.train.state import create_train_state
from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_train_step
from pti_ldm_vae_tpu_torch.utils.eval_metrics import compute_ssim

TOL = dict(rtol=1e-4, atol=1e-5)
DIMS = pytest.mark.parametrize("sd", [1, 3], ids=["1d", "3d"])


def _cfg(sd):
    """The JAX 3-D test's toy model (channels [4, 8]) with both mid-block attentions on."""
    return dict(spatial_dims=sd, in_channels=1, out_channels=1, latent_channels=2,
                channels=[4, 8], num_res_blocks=1, norm_num_groups=2, norm_eps=1e-6,
                attention_levels=[False, False],
                with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True)


SIDE = {1: 32, 3: 8}  # the toy input's side at each rank


def _shape(sd, b=2, side=None, c=1):
    return (b, *(side or SIDE[sd],) * sd, c)


def _filled(init, args, seed, gain=1.0):
    """``init``'s variables from their shapes (``jax.eval_shape``, no trace of
    the model) filled from a seeded generator: kernels normal / sqrt(fan-in),
    norm scales 1 + 0.1 n, everything else 0.05 n."""
    shapes = jax.eval_shape(init, *args)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("kernel"):
            scale = gain / math.sqrt(max(1, math.prod(leaf.shape[:-1])))
            return (rng.normal(size=leaf.shape) * scale).astype(np.float32)
        if name.endswith("scale"):
            return (1.0 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        return (0.05 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


_MODELS: dict = {}


def _vae(sd):
    """(JAX model, variables, port model) of the toy at rank ``sd``, built once."""
    if sd not in _MODELS:
        cfg = _cfg(sd)
        jax_model = jax_from_config(cfg, use_pallas_attention=False, s2d_stem=False)
        variables = _filled(jax_model.init, (jax.random.key(0), jax.ShapeDtypeStruct(
            _shape(sd, 1), jnp.float32), jax.random.key(1)), seed=10 + sd)
        port = autoencoder_from_config(cfg)
        port.load_state_dict(state_dict_from_flax(variables, cfg), strict=True)
        _MODELS[sd] = (jax_model, variables, port.eval())
    return _MODELS[sd]


def _x(shape, seed, low=None):
    rng = np.random.default_rng(seed)
    if low is not None:
        return rng.uniform(low, 1.0, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


# ---- ops ---------------------------------------------------------------------------------

OP_SHAPES = {1: (2, 37, 8), 3: (2, 5, 6, 7, 8)}


@DIMS
@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_group_norm_matches_jax(sd, stats):
    x, scale, bias = _x(OP_SHAPES[sd], sd), _x((8,), 1), _x((8,), 2)
    want = jax_norm.group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), num_groups=4,
                               eps=1e-6, stats=stats)
    got = group_norm(*map(torch.from_numpy, (x, scale, bias)), num_groups=4, eps=1e-6, stats=stats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@DIMS
@pytest.mark.parametrize("stats", ["one_pass", "two_pass"])
def test_group_norm_silu_matches_jax(sd, stats):
    """Value and gradients; ``one_pass`` runs the kernel's plain version on
    the rank-4 view (counted as no launch on the CPU)."""
    x, scale, bias, g = _x(OP_SHAPES[sd], sd + 3), _x((8,), 4), _x((8,), 5), _x(OP_SHAPES[sd], 6)

    def jax_loss(a, s, b):
        y = jax_norm.group_norm_silu(a, s, b, num_groups=4, eps=1e-6, stats=stats)
        return jnp.sum(y * jnp.asarray(g)), y

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (x, scale, bias)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    got = group_norm_silu(*ts, num_groups=4, eps=1e-6, stats=stats)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, want_grad in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-4)


@DIMS
def test_rank4_view_keeps_each_images_elements(sd):
    x = torch.from_numpy(_x(OP_SHAPES[sd], 7))
    view = rank4_view(x)
    assert view.dim() == 4 and view.is_contiguous() and view.shape[-1] == 8
    assert torch.equal(view.reshape(x.shape), x)
    assert view.shape[1] == (1 if sd == 1 else 5 * 6)  # [B, 1, L, C] / [B, D*H, W, C]


@DIMS
def test_instance_norm_and_upsample_match_jax(sd):
    x = _x(OP_SHAPES[sd], 8) * 3.0 + 1.5
    np.testing.assert_allclose(instance_norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_norm.instance_norm(jnp.asarray(x))), **TOL)
    got = upsample_nearest_2x(torch.from_numpy(x))
    assert got.shape == (x.shape[0], *(2 * s for s in x.shape[1:-1]), x.shape[-1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_upsample(jnp.asarray(x))))


# ---- the autoencoder -----------------------------------------------------------------------

@DIMS
def test_converter_keys_load_strict(sd):
    _, variables, port = _vae(sd)
    want = to_torch_state_dict(jax.tree_util.tree_map(np.asarray, variables), _cfg(sd))
    got = state_dict_from_flax(variables, _cfg(sd))
    assert list(got) == list(want) and set(port.state_dict()) == set(got)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    assert port.encoder.blocks[0].conv.weight.dim() == sd + 2


@DIMS
def test_encode_decode_reconstruct_match_jax(sd):
    jax_model, variables, port = _vae(sd)
    x = _x(_shape(sd), 20 + sd)
    mu, sigma = jax.jit(lambda a: jax_model.apply(variables, a, method=jax_model.encode))(
        jnp.asarray(x))
    recon = jax.jit(lambda z: jax_model.apply(variables, z, method=jax_model.decode_stage_2_outputs))(
        mu)
    with torch.inference_mode():
        got_mu, got_sigma = port.encode(torch.from_numpy(x))
        got_recon = port.decode(torch.from_numpy(np.array(mu)))
        got_det = port.reconstruct_deterministic(torch.from_numpy(x))
    assert got_mu.shape == (2, *(SIDE[sd] // 2,) * sd, 2)
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(mu), **TOL)
    np.testing.assert_allclose(got_sigma.numpy(), np.asarray(sigma), **TOL)
    np.testing.assert_allclose(got_recon.numpy(), np.asarray(recon), **TOL)
    assert float(np.abs(got_det.numpy() - np.asarray(recon)).max()) <= 1e-3


@DIMS
def test_gradients_through_the_model_match_jax(sd):
    """d(loss)/d(input) through encoder and decoder, mid-block attention and
    GroupNorm+SiLU backward on the rank-4 view included."""
    jax_model, variables, port = _vae(sd)
    x, g = _x(_shape(sd), 30 + sd), _x(_shape(sd), 40 + sd)

    def loss(a):
        return jnp.sum(jax_model.apply(variables, a, method=jax_model.reconstruct_deterministic)
                       * jnp.asarray(g))

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (port.reconstruct_deterministic(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_conv_kernel_and_s2d_need_2d():
    for sd in (1, 3):
        with pytest.raises(ValueError, match="conv_kernel requires spatial_dims == 2"):
            autoencoder_from_config(_cfg(sd), conv_kernel=True)
        with pytest.raises(ValueError, match="s2d_stem requires spatial_dims == 2"):
            autoencoder_from_config(_cfg(sd), s2d_stem="encoder")
        # "auto" takes the standard path
        assert not autoencoder_from_config(_cfg(sd), s2d_stem="auto").encoder._use_s2d(
            torch.zeros(_shape(sd)))


# ---- discriminator and UNet ----------------------------------------------------------------

DISC_SIDE = {1: 16, 3: 16}


@DIMS
def test_discriminator_matches_jax(sd):
    jax_disc = JaxPatchDiscriminator(spatial_dims=sd, num_layers_d=2, channels=4)
    x = _x(_shape(sd, side=DISC_SIDE[sd]), 50 + sd)
    variables = _filled(jax_disc.init, (jax.random.key(0), jax.ShapeDtypeStruct(x.shape, jnp.float32)),
                        seed=60 + sd)
    disc = PatchDiscriminator(spatial_dims=sd, num_layers_d=2, channels=4)
    disc.load_state_dict(disc_state_dict_from_flax(variables, num_layers_d=2), strict=True)
    want = jax_disc.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = disc(torch.from_numpy(x))
    assert got[-1].shape == (2, *(2,) * sd, 1) and len(got) == len(want) == 4
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=str(i))


UNET = dict(in_channels=2, out_channels=2, channels=[4, 8], attention_levels=[False, True],
            num_head_channels=[0, 4], num_res_blocks=1, with_conditioning=True,
            cross_attention_dim=4, norm_num_groups=2)


@DIMS
def test_unet_forward_matches_jax(sd):
    cfg = dict(UNET, spatial_dims=sd)
    jm = jax_unet.diffusion_unet_from_config(cfg)
    rng = np.random.default_rng(70 + sd)
    x = rng.normal(size=(2, *(8 if sd == 1 else 4,) * sd, 2)).astype(np.float32)
    t = np.array([7, 423], dtype=np.int32)
    ctx = rng.normal(size=(2, 3, 4)).astype(np.float32)
    variables = _filled(jm.init, (jax.random.key(0), *(jax.ShapeDtypeStruct(a.shape, a.dtype)
                                                        for a in (x, t, ctx))), seed=80 + sd)
    model = diffusion_unet_from_config(cfg)
    model.load_state_dict(unet_state_dict_from_flax(variables, cfg), strict=True)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jm.apply)(variables, *map(jnp.asarray, (x, t, ctx))))
    with torch.inference_mode():
        got = model(*map(torch.from_numpy, (x, t, ctx)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---- fake-3D LPIPS ---------------------------------------------------------------------------

def test_lpips_3d_is_the_sum_over_axes_of_mean_slice_distances():
    params = init_lpips_params(seed=0)
    x, y = _x((2, 17, 18, 19, 1), 90), _x((2, 17, 18, 19, 1), 91)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = lpips_distance_per_sample_3d(params, xt, yt)
    assert got.shape == (2,) and got.dtype == torch.float32
    for i in range(2):
        manual = sum(float(lpips_distance_per_sample(params, xt[i].movedim(axis - 1, 0),
                                                     yt[i].movedim(axis - 1, 0)).mean())
                     for axis in (1, 2, 3))
        assert float(got[i]) == pytest.approx(manual, rel=1e-5)
    with pytest.raises(ValueError, match="NDHWC"):
        lpips_distance_per_sample_3d(params, xt[0], yt[0])


@pytest.mark.slow
def test_lpips_3d_matches_jax():
    tree = jax.tree_util.tree_map(np.asarray, jax_lpips.init_lpips_params(1))
    x, y = _x((1, 17, 18, 19, 1), 92), _x((1, 17, 18, 19, 1), 93)
    want = jax_lpips.lpips_distance_per_sample_3d(tree, jnp.asarray(x), jnp.asarray(y))
    got = lpips_distance_per_sample_3d(lpips_params_from_jax(tree), torch.from_numpy(x),
                                       torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- the train steps -------------------------------------------------------------------------

def _step_world(sd, side, use_perceptual):
    """The JAX generator and discriminator gradients and loss terms of one
    adversarial step at rank ``sd`` (``_generator_losses``, the loss
    ``make_train_step`` differentiates), and the posterior noise it drew."""
    jax_model, variables, _ = _vae(sd)
    cfg = _cfg(sd)
    jax_disc = JaxPatchDiscriminator(spatial_dims=sd, num_layers_d=2, channels=4)
    dummy = jax.ShapeDtypeStruct((1, *(side,) * sd, 1), jnp.float32)
    params_g = _filled(jax_model.init, (jax.random.key(0), dummy, jax.random.key(1)), seed=100)
    params_d = _filled(jax_disc.init, (jax.random.key(2), dummy), seed=101, gain=2.0)
    tree = jax.tree_util.tree_map(np.asarray, jax_lpips.init_lpips_params(1))
    images = _x((2, *(side,) * sd, 1), 102, low=0.1)
    mask = np.array([1.0, 1.0], np.float32)
    lcfg = jax_steps.LossConfig(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0,
                                adv_weight=0.5, use_perceptual=use_perceptual)
    key = jax.random.key(11)
    jimages, jmask = jnp.asarray(images), jnp.asarray(mask)

    @jax.jit
    def grads_of(pg, pd):
        def g_loss(p):
            return jax_steps._generator_losses(jax_model, jax_disc, lcfg, p, pd, tree, jimages,
                                               jmask, {}, key, True)
        (total, aux), grads_g = jax.value_and_grad(g_loss, has_aux=True)(pg)
        recon = jax.lax.stop_gradient(aux["recon"])

        def d_loss(p):
            fake = jax_steps._masked_mean(
                jax_steps._per_sample_lsgan(jax_disc.apply(p, recon)[-1], 0.0), jmask)
            real = jax_steps._masked_mean(
                jax_steps._per_sample_lsgan(jax_disc.apply(p, jimages)[-1], 1.0), jmask)
            return lcfg.adv_weight * 0.5 * (fake + real)

        d_total, grads_d = jax.value_and_grad(d_loss)(pd)
        terms = {k: aux[k] for k in ("recon_loss", "kl_loss", "perceptual_loss", "adv_gen_loss")}
        return total, terms, grads_g, d_total, grads_d

    total, terms, grads_g, d_total, grads_d = grads_of(params_g, params_d)
    rng_sample, _ = jax.random.split(key)
    latent = (2, *(side // 2,) * sd, cfg["latent_channels"])
    eps = np.array(jax.random.normal(rng_sample, latent, dtype=jnp.float32))
    as_np = lambda tree_: jax.tree_util.tree_map(np.asarray, tree_)
    return dict(
        sd_g=state_dict_from_flax(params_g, cfg), sd_d=disc_state_dict_from_flax(params_d, 2),
        lpips=lpips_params_from_jax(tree), images=torch.from_numpy(images),
        mask=torch.from_numpy(mask), eps=torch.from_numpy(eps), total=float(total),
        terms={k: float(v) for k, v in terms.items()}, d_total=float(d_total),
        grads_g=to_torch_state_dict(as_np(grads_g), cfg),
        grads_d=disc_to_torch_state_dict(as_np(grads_d), num_layers_d=2),
        lcfg=LossConfig(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0, adv_weight=0.5,
                        use_perceptual=use_perceptual), sd=sd)


def _port_step(world):
    """One adversarial step of the port's ``make_train_step``; each model's
    gradients are captured just before its Adam update."""
    model = autoencoder_from_config(_cfg(world["sd"]))
    model.load_state_dict(world["sd_g"], strict=True)
    disc = PatchDiscriminator(spatial_dims=world["sd"], num_layers_d=2, channels=4)
    disc.load_state_dict(world["sd_d"], strict=True)
    state = create_train_state(model, lr=1e-3, model_d=disc)
    seen = {}
    real_g, real_d = state.optimizer_g.step, state.optimizer_d.step

    def capture_g(*a, **kw):
        seen["grads_g"] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        return real_g(*a, **kw)

    def capture_d(*a, **kw):
        seen["grads_d"] = {k: p.grad.detach().clone() for k, p in disc.named_parameters()}
        return real_d(*a, **kw)

    state.optimizer_g.step, state.optimizer_d.step = capture_g, capture_d
    step = make_train_step(model, disc, world["lcfg"], adv_active=True)
    _, metrics = step(state, world["images"], world["mask"], None, world["lpips"], eps=world["eps"])
    return {k: float(v) for k, v in metrics.items()}, seen


def _assert_step_matches(world):
    metrics, seen = _port_step(world)
    for name in ("recon_loss", "kl_loss", "perceptual_loss"):
        assert metrics[f"train/{name}"] == pytest.approx(world["terms"][name], rel=1e-4, abs=1e-7)
    assert metrics["train/adv_gen_loss"] == pytest.approx(0.5 * world["terms"]["adv_gen_loss"], rel=1e-4)
    assert metrics["train/adv_disc_loss"] == pytest.approx(world["d_total"], rel=1e-4)
    assert metrics["train/loss_total"] == pytest.approx(world["total"], rel=1e-4)
    for which, bar in (("grads_g", 2e-3), ("grads_d", 2e-2)):
        want, got = world[which], seen[which]
        assert set(got) == set(want)
        for key, theirs in want.items():
            if key.endswith("to_k.bias"):  # gradient 0 in exact arithmetic (ROADMAP C)
                continue
            np.testing.assert_allclose(got[key].numpy(), theirs, rtol=0,
                                       atol=bar * float(np.abs(theirs).max()), err_msg=key)


@DIMS
def test_adversarial_step_matches_jax(sd):
    """L1 + KL + LSGAN generator term, then the PatchGAN's step, at 16 per
    side (the perceptual term takes 2-D slices of 17 or more: below)."""
    world = _step_world(sd, 16, use_perceptual=False)
    assert world["terms"]["perceptual_loss"] == 0.0
    _assert_step_matches(world)


@pytest.mark.slow
def test_3d_step_with_fake_3d_lpips_matches_jax():
    world = _step_world(3, 32, use_perceptual=True)
    assert world["terms"]["perceptual_loss"] > 0.0
    _assert_step_matches(world)


def test_perceptual_loss_refuses_rank_3_as_jax_does():
    model = autoencoder_from_config(_cfg(1))
    state = create_train_state(model, lr=1e-3)
    step = make_train_step(model, None, LossConfig(use_perceptual=True), adv_active=False)
    with pytest.raises(ValueError, match="spatial_dims=1"):
        step(state, torch.rand(2, 32, 1), torch.ones(2), None, init_lpips_params(seed=0),
             eps=torch.zeros(2, 16, 2))
    jax_model, variables, _ = _vae(1)
    with pytest.raises(ValueError, match="spatial_dims=1"):  # traced only: no FLOP
        jax.eval_shape(lambda v: jax_steps._generator_losses(
            jax_model, None, jax_steps.LossConfig(use_perceptual=True), v, None,
            jax_lpips.init_lpips_params(1), jnp.ones((2, 32, 1)), jnp.ones(2), {},
            jax.random.key(0), False), variables)


# ---- metrics, evaluation, regressor ------------------------------------------------------------

def test_ssim_on_volumes_matches_jax():
    rng = np.random.default_rng(110)
    target = rng.uniform(0.0, 1.0, size=(2, 5, 24, 20, 1)).astype(np.float32)
    pred = np.clip(target + 0.1 * rng.normal(size=target.shape), 0.0, 1.0).astype(np.float32)
    want = np.asarray(jax_metrics.compute_ssim(jnp.asarray(pred), jnp.asarray(target)))
    got = compute_ssim(torch.from_numpy(pred), torch.from_numpy(target))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="rank 3"):
        compute_ssim(torch.zeros(2, 16, 1), torch.zeros(2, 16, 1))


def _eval_world():
    """A one-level 3-D model (no downsample, so a 17³ volume, the LPIPS
    trunk's floor, round-trips) and two batches with a padded row."""
    cfg = dict(_cfg(3), channels=[4], attention_levels=[False])
    jax_model = jax_from_config(cfg, use_pallas_attention=False, s2d_stem=False)
    variables = _filled(jax_model.init, (jax.random.key(0), jax.ShapeDtypeStruct(
        (1, 17, 17, 17, 1), jnp.float32), jax.random.key(1)), seed=120)
    port = autoencoder_from_config(cfg)
    port.load_state_dict(state_dict_from_flax(variables, cfg), strict=True)
    images = _x((2, 2, 17, 17, 17, 1), 121, low=0.0)
    images[1, 1] = 0.0
    batches = [{"image": images[0], "mask": np.ones(2, np.float32)},
               {"image": images[1], "mask": np.array([1, 0], np.float32)}]
    # the JAX loop's noise: key = key(seed); per batch key, sub = split(key); eps ~ normal(sub)
    key, eps = jax.random.key(42), []
    for _ in batches:
        key, sub = jax.random.split(key)
        eps.append(torch.from_numpy(np.array(jax.random.normal(sub, (2, 17, 17, 17, 2)))))
    return jax_model, variables, port.eval(), batches, eps


@pytest.mark.slow
def test_evaluate_vae_metrics_on_volumes_match_jax():
    """``evaluate_vae``'s summary on a 3-D model: fake-3D LPIPS and SSIM over
    depth slices, a padded row masked out."""
    jax_model, variables, port, batches, eps = _eval_world()
    tree = jax.tree_util.tree_map(np.asarray, jax_lpips.init_lpips_params(1))
    want = jax_evaluate(jax_model, variables, batches, recon_kind="l1", perceptual_weight=0.5,
                        lpips_params=tree, seed=42)
    got = evaluate(port, batches, recon_kind="l1", perceptual_weight=0.5,
                   lpips_params=lpips_params_from_jax(tree), eps=eps)
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name] == pytest.approx(value, rel=1e-4, abs=1e-6), name


def test_evaluate_vae_metrics_on_volumes():
    """The cheap counterpart: the port's per-batch metrics on a 3-D model are
    its fake-3D LPIPS and its depth-slice SSIM of the reconstruction."""
    _, _, port, batches, eps = _eval_world()
    params = init_lpips_params(seed=0)
    images = torch.from_numpy(batches[1]["image"])
    mask = torch.from_numpy(batches[1]["mask"])
    out = evaluate_batch(port, images, mask, recon_kind="l1", perceptual_weight=0.5,
                         lpips_params=params, eps=eps[1])
    with torch.inference_mode():
        recon = port(images, eps[1])[0]
    perc = lpips_distance_per_sample_3d(params, recon, images)[0]
    assert float(out["perceptual_loss"]) == pytest.approx(float(perc), rel=1e-5)
    ssim = compute_ssim(recon.clamp(0, 1), images.clamp(0, 1))
    np.testing.assert_allclose(out["ssim"].numpy(), ssim.numpy(), rtol=1e-6)
    assert out["ssim"].shape == (2,)


def test_regressor_flatten_order_and_flat_dim():
    lat = _x((2, 3, 4, 5, 6), 130)
    np.testing.assert_array_equal(flatten_latent(torch.from_numpy(lat)).numpy(),
                                  np.asarray(jax_flatten_latent(jnp.asarray(lat))))
    for sd, patch in ((3, (16, 16, 16)), (1, (40,))):
        _, _, port = _vae(sd)
        flat = infer_flat_dim_from_patch(port, patch)
        with torch.inference_mode():
            z = port.encode_deterministic(torch.zeros(1, *patch, 1))
        assert flat == z.numel() == math.prod(s // 2 for s in patch) * 2
        with pytest.raises(ValueError, match="spatial axes"):
            infer_flat_dim_from_patch(port, (16, 16))


def test_no_kernel_launches_on_the_cpu():
    """The CPU runs the plain versions: no launch is counted."""
    kernels.reset_launch_counts()
    _, _, port = _vae(3)
    with torch.inference_mode():
        port.reconstruct_deterministic(torch.zeros(_shape(3)))
    assert not any(kernels.launch_counts().values())


def test_sample_diffusion_refuses_a_3d_vae_as_jax_does(tmp_path):
    """The diffusion models load a 3-D VAE (``load_ldm_models``; the JAX
    ``train_diffusion`` has no check either), and ``sample_diffusion``
    refuses it, as JAX ``cli/sample_diffusion.py`` does."""
    import json

    from pti_ldm_vae_tpu_torch.cli.sample_diffusion import main as sample_main
    from pti_ldm_vae_tpu_torch.config import load_config
    from pti_ldm_vae_tpu_torch.utils.cli_common import load_ldm_models

    torch.save(autoencoder_from_config(_cfg(3)).state_dict(), tmp_path / "vae.pth")
    (tmp_path / "vae.json").write_text(json.dumps({
        "autoencoder_def": _cfg(3), "autoencoder_train": {"patch_size": [16, 16, 16]}}))
    (tmp_path / "ldm.json").write_text(json.dumps({
        "vae": {"config_file": str(tmp_path / "vae.json"), "checkpoint": str(tmp_path / "vae.pth")},
        "diffusion_def": dict(UNET, spatial_dims=3, cross_attention_dim=8),
        "diffusion_train": {"num_train_timesteps": 50}}))
    m = load_ldm_models(load_config(str(tmp_path / "ldm.json")), device=torch.device("cpu"))
    assert m.latent_shape == (8, 8, 8, 2) and m.vae.spatial_dims == 3
    torch.save({"unet": m.unet.state_dict(), "projector": m.projector.state_dict()},
               tmp_path / "diffusion.pth")
    with pytest.raises(NotImplementedError, match="spatial_dims=2"):
        sample_main(["-c", str(tmp_path / "ldm.json"), "--checkpoint", str(tmp_path / "diffusion.pth"),
                     "--output-dir", str(tmp_path / "samples"), "--num-images", "1",
                     "--device", "cpu"])
