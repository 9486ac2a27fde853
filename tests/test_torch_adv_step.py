"""The adversarial slice as a whole: train steps of the port with the GAN
branch active against the JAX package's ``make_train_step(adv_active=True)``
(L1 + KL + LPIPS + LSGAN generator term, Adam; then the discriminator's
LSGAN step on the detached reconstruction, Adam), f32 on the CPU, with the
port's 3x3 convolutions going through the convolution kernels' plain versions
(``conv_kernel=True``).

Both sides start from the same parameters (the JAX inits, perturbed, carried
across by ``state_dict_from_flax`` and ``disc_state_dict_from_flax``), the
same LPIPS tree, the same batch (numpy, with a zero-padded last row masked
out) and the same posterior noise: ``eps`` is drawn on the JAX side with the
step's own ``jax.random.split`` and handed to the port.

Bars, those of the generator-only step test: loss terms rtol 1e-4; gradients
(by MONAI key) rtol 1e-3 with atol 1e-4 x the gradient's max; parameters
after Adam: where ``|g| > 1e-6 * max(1, max|g| of the tensor)`` the updates
agree within 2% of lr, and every entry within 2 lr per step (an Adam update
is about ``lr * sign(g)``, so an entry whose gradient is below the f32
rounding of its tensor's sums can take the other sign).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.checkpoint.torch_convert import disc_to_torch_state_dict, to_torch_state_dict
from pti_ldm_vae_tpu.models import lpips as jax_lpips
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from pti_ldm_vae_tpu.train import steps as jax_steps
from pti_ldm_vae_tpu.train.state import create_train_state as jax_create_state
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import (
    disc_state_dict_from_flax,
    lpips_params_from_jax,
    state_dict_from_flax,
)
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.models.discriminator import PatchDiscriminator
from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
from pti_ldm_vae_tpu_torch.train.state import create_train_state
from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_eval_step, make_train_step

TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=3,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, True],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)
DISC = dict(spatial_dims=2, num_layers_d=3, channels=8)
LR = 1e-3
LOSS = dict(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0, adv_weight=3.0)
GRAD_FLOOR = 1e-6
TERMS = ("recon_loss", "kl_loss", "perceptual_loss", "adv_gen_loss")


def _zero_gradient_in_exact_arithmetic(key: str) -> bool:
    """Softmax is invariant to a constant added along the keys, so a key
    projection's bias has gradient 0; both frameworks hold rounding noise."""
    return key.endswith("to_k.bias")


def _perturbed(variables, rng, gain=1.0):
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    leaves = [np.asarray(a) * gain + 0.05 * rng.normal(size=a.shape).astype(np.float32)
              for a in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    jax_model = jax_from_config(TOY, use_pallas_attention=False, s2d_stem=False)
    jax_disc = JaxPatchDiscriminator(**DISC)
    dummy = jnp.zeros((1, 32, 32, 1))
    params_g = _perturbed(jax.jit(jax_model.init)(jax.random.key(0), dummy, jax.random.key(1)), rng)
    # 0.02-scale weights give logits near 0: scale them up so the discriminator matters
    params_d = _perturbed(jax.jit(jax_disc.init)(jax.random.key(2), dummy), rng, gain=2.0)
    lpips_tree = jax.tree_util.tree_map(np.asarray, jax_lpips.init_lpips_params(1))

    images = rng.normal(size=(4, 32, 32, 1)).astype(np.float32)
    images[3] = 0.0
    mask = np.array([1.0, 1.0, 1.0, 0.0], dtype=np.float32)
    keys = [jax.random.key(11), jax.random.key(12)]
    eps = []
    for k in keys:
        rng_sample, _ = jax.random.split(k)
        eps.append(np.array(jax.random.normal(rng_sample, (4, 16, 16, 3), dtype=jnp.float32)))

    lcfg = jax_steps.LossConfig(**LOSS)
    step = jax_steps.make_train_step(jax_model, jax_disc, lcfg, adv_active=True, donate=False)
    eval_step = jax_steps.make_eval_step(jax_model, jax_disc, lcfg, adv_active=True)
    jimages, jmask = jnp.asarray(images), jnp.asarray(mask)

    @jax.jit
    def grads_of(pg, pd, rng_key):
        def g_loss(p):
            return jax_steps._generator_losses(jax_model, jax_disc, lcfg, p, pd, lpips_tree,
                                               jimages, jmask, {}, rng_key, True)
        (total, aux), grads_g = jax.value_and_grad(g_loss, has_aux=True)(pg)
        recon = jax.lax.stop_gradient(aux["recon"])

        def d_loss(p):
            fake = jax_steps._masked_mean(
                jax_steps._per_sample_lsgan(jax_disc.apply(p, recon)[-1], 0.0), jmask)
            real = jax_steps._masked_mean(
                jax_steps._per_sample_lsgan(jax_disc.apply(p, jimages)[-1], 1.0), jmask)
            return lcfg.adv_weight * 0.5 * (fake + real)

        d_total, grads_d = jax.value_and_grad(d_loss)(pd)
        return total, {k: aux[k] for k in TERMS}, grads_g, d_total, grads_d

    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    state = jax_create_state(params_g, lr=LR, params_d=params_d)
    eval_metrics, _ = eval_step(state, jimages, jmask, {}, lpips_tree, keys[0])
    jax_out = []
    for key in keys:
        total, terms, grads_g, d_total, grads_d = grads_of(state.params_g, state.params_d, key)
        state, metrics = step(state, jimages, jmask, {}, lpips_tree, key)
        jax_out.append(dict(
            total=float(total), terms={k: float(v) for k, v in terms.items()},
            d_total=float(d_total),
            grads_g=to_torch_state_dict(as_np(grads_g), TOY),
            grads_d=disc_to_torch_state_dict(as_np(grads_d)),
            params_g=to_torch_state_dict(as_np(state.params_g), TOY),
            params_d=disc_to_torch_state_dict(as_np(state.params_d)),
            metrics={k: float(v) for k, v in metrics.items()},
        ))
    return dict(
        sd_g=state_dict_from_flax(as_np(params_g), TOY), sd_d=disc_state_dict_from_flax(as_np(params_d)),
        start_g=to_torch_state_dict(as_np(params_g), TOY), start_d=disc_to_torch_state_dict(as_np(params_d)),
        lpips=lpips_params_from_jax(lpips_tree), images=torch.from_numpy(images),
        mask=torch.from_numpy(mask), eps=[torch.from_numpy(e) for e in eps], jax=jax_out,
        jax_eval={k: float(v) for k, v in eval_metrics.items()},
    )


def _models(world):
    model = autoencoder_from_config(TOY, conv_kernel=True)
    model.load_state_dict(world["sd_g"], strict=True)
    disc = PatchDiscriminator(**DISC)
    disc.load_state_dict(world["sd_d"], strict=True)
    return model, disc


@pytest.fixture(scope="module")
def port_run(world):
    """Two port steps; each model's gradients are captured just before its Adam update."""
    model, disc = _models(world)
    state = create_train_state(model, lr=LR, model_d=disc)
    step = make_train_step(model, disc, LossConfig(**LOSS), adv_active=True)
    out = []
    for eps in world["eps"]:
        seen = {}
        real_g, real_d = state.optimizer_g.step, state.optimizer_d.step

        def capture_g(*a, _real=real_g, **kw):
            seen["grads_g"] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
            # the generator pass leaves nothing on the discriminator
            seen["disc_clean_at_g_step"] = all(p.grad is None for p in disc.parameters())
            return _real(*a, **kw)

        def capture_d(*a, _real=real_d, **kw):
            seen["grads_d"] = {k: p.grad.detach().clone() for k, p in disc.named_parameters()}
            # and the discriminator pass nothing on the generator (its recon is detached)
            seen["gen_clean_at_d_step"] = all(p.grad is None for p in model.parameters())
            return _real(*a, **kw)

        state.optimizer_g.step, state.optimizer_d.step = capture_g, capture_d
        _, metrics = step(state, world["images"], world["mask"], None, world["lpips"], eps=eps)
        state.optimizer_g.step, state.optimizer_d.step = real_g, real_d
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()}, **seen,
                        params_g={k: v.detach().clone() for k, v in model.state_dict().items()},
                        params_d={k: v.detach().clone() for k, v in disc.state_dict().items()}))
    assert state.step == 2
    assert all(p.grad is None for p in model.parameters())
    assert all(p.grad is None for p in disc.parameters())
    return out


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_loss_terms_match(world, port_run, i):
    want, got = world["jax"][i], port_run[i]["metrics"]
    assert set(got) == set(want["metrics"])
    for name, value in want["metrics"].items():
        # the debug stats are means of signed O(1) latents: an absolute bar
        tol = dict(abs=1e-4) if name.startswith("debug/") else dict(rel=1e-4, abs=1e-6)
        assert got[name] == pytest.approx(value, **tol), name
    for name in ("recon_loss", "kl_loss", "perceptual_loss"):
        assert got[f"train/{name}"] == pytest.approx(want["terms"][name], rel=1e-4), name
    # the adversarial metrics carry adv_weight; the discriminator's is its whole objective
    assert got["train/adv_gen_loss"] == pytest.approx(3.0 * want["terms"]["adv_gen_loss"], rel=1e-4)
    assert got["train/adv_disc_loss"] == pytest.approx(want["d_total"], rel=1e-4)
    assert got["train/adv_gen_loss"] > 0 and got["train/adv_disc_loss"] > 0
    assert got["train/loss_total"] == pytest.approx(want["total"], rel=1e-4)


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
@pytest.mark.parametrize("which", ["grads_g", "grads_d"], ids=["generator", "discriminator"])
def test_gradients_match_by_monai_key(world, port_run, i, which):
    want, got = world["jax"][i][which], port_run[i][which]
    assert set(got) == set(want)
    assert port_run[i]["disc_clean_at_g_step"] and port_run[i]["gen_clean_at_d_step"]
    for key, theirs in want.items():
        if _zero_gradient_in_exact_arithmetic(key):
            assert np.abs(theirs).max() < 1e-6 and float(got[key].abs().max()) < 1e-6, key
            continue
        np.testing.assert_allclose(got[key].numpy(), theirs, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(theirs).max()), err_msg=key)


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
@pytest.mark.parametrize("which", ["g", "d"], ids=["generator", "discriminator"])
def test_parameters_after_adam_match(world, port_run, i, which):
    want, got = world["jax"][i][f"params_{which}"], port_run[i][f"params_{which}"]
    n_firm = 0
    for key, theirs in want.items():
        diff = np.abs(got[key].numpy() - theirs)
        assert diff.max() <= 2 * LR * (i + 1), key
        firm = np.ones_like(theirs, dtype=bool)
        for j in range(i + 1):
            g = np.abs(world["jax"][j][f"grads_{which}"][key])
            firm &= g > GRAD_FLOOR * max(1.0, float(g.max()))
        n_firm += int(firm.sum())
        if firm.any():
            assert diff[firm].max() <= 0.02 * LR, key
        moved = np.abs(theirs - world[f"start_{which}"][key])
        if not _zero_gradient_in_exact_arithmetic(key):
            assert moved.max() > 0.5 * LR, key  # Adam really moved this tensor
    assert n_firm > 0.9 * sum(v.size for v in want.values())


def test_eval_step_matches_jax(world):
    model, disc = _models(world)
    step = make_eval_step(model, disc, LossConfig(**LOSS), adv_active=True)
    metrics, recon = step(None, world["images"], world["mask"], None, world["lpips"],
                          eps=world["eps"][0])
    assert recon.shape == (4, 32, 32, 1) and not recon.requires_grad
    assert set(metrics) == set(world["jax_eval"])
    for name, value in world["jax_eval"].items():
        assert float(metrics[name]) == pytest.approx(value, rel=1e-4, abs=1e-6), name
    # unscaled here (the trainer applies adv_weight when it logs val/adv_*)
    assert float(metrics["adv_disc_loss"]) == pytest.approx(world["jax"][0]["d_total"] / 3.0, rel=1e-4)
    assert all(p.grad is None for p in list(model.parameters()) + list(disc.parameters()))


def test_warm_up_phase_step_leaves_the_discriminator_alone(world):
    """``adv_active=False`` with a discriminator present (the warm-up epochs):
    no adversarial term, no discriminator update."""
    model, disc = _models(world)
    state = create_train_state(model, lr=LR, model_d=disc)
    step = make_train_step(model, disc, LossConfig(**LOSS), adv_active=False)
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    _, metrics = step(state, world["images"], world["mask"], None, world["lpips"], eps=world["eps"][0])
    assert float(metrics["train/adv_gen_loss"]) == 0.0 and float(metrics["train/adv_disc_loss"]) == 0.0
    assert all(torch.equal(before[k], v) for k, v in disc.state_dict().items())
    assert state.optimizer_d.state_dict()["state"] == {}
    want = world["jax"][0]
    plain_total = want["total"] - 3.0 * want["terms"]["adv_gen_loss"]
    assert float(metrics["train/loss_total"]) == pytest.approx(plain_total, rel=1e-4)


def test_padded_row_does_not_leak_into_the_adversarial_terms(world):
    model, disc = _models(world)
    step = make_eval_step(model, disc, LossConfig(**LOSS), adv_active=True)
    other = world["images"].clone()
    other[3] = 7.0
    a, _ = step(None, world["images"], world["mask"], None, world["lpips"], eps=world["eps"][0])
    b, _ = step(None, other, world["mask"], None, world["lpips"], eps=world["eps"][0])
    for key in a:
        assert float(a[key]) == pytest.approx(float(b[key]), rel=1e-6), key


def test_bf16_adversarial_step_is_finite_and_updates_both_models():
    torch.manual_seed(0)
    model = autoencoder_from_config(TOY, compute_dtype=torch.bfloat16, conv_kernel=True)
    disc = PatchDiscriminator(**DISC, compute_dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(1))
    state = create_train_state(model, lr=LR, model_d=disc)
    step = make_train_step(model, disc, LossConfig(**LOSS), adv_active=True)
    before = {k: v.clone() for k, v in {**model.state_dict(), **disc.state_dict()}.items()}
    _, metrics = step(state, torch.randn(2, 32, 32, 1), torch.ones(2), None, init_lpips_params(0),
                      generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = {**model.state_dict(), **disc.state_dict()}
    assert all(v.dtype == torch.float32 for v in after.values())
    assert all(not torch.equal(before[k], after[k]) for k in before)
