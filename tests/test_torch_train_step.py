"""The slice as a whole: generator train steps of the port against the JAX
package's ``make_train_step`` (L1 + KL + LPIPS, then Adam), f32 on the CPU.

Both sides start from the same parameters (the JAX init, carried across by
``state_dict_from_flax``), the same LPIPS tree, the same batch (numpy, with a
zero-padded last row masked out) and the same posterior noise: ``eps`` is
drawn on the JAX side with the step's own ``jax.random.split`` and handed to
the port. The JAX side runs its exact-parity form (standard stem, XLA
attention). One compiled JAX step and one compiled JAX gradient serve every
test of the module.

Bars: loss terms rtol 1e-4; gradients (by MONAI key) rtol 1e-3 with atol
1e-4 x the gradient's max; parameters after Adam: an Adam update is
``lr * m / (sqrt(v) + 1e-8)``, about ``lr * sign(g)``, so entries with a tiny
gradient amplify rounding — where ``|g| > 1e-6`` the updates agree within
2% of lr, and every entry within 2 lr per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.checkpoint.torch_convert import to_torch_state_dict
from pti_ldm_vae_tpu.models import lpips as jax_lpips
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu.train import steps as jax_steps
from pti_ldm_vae_tpu.train.state import create_train_state as jax_create_state
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import lpips_params_from_jax, state_dict_from_flax
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.models.lpips import init_lpips_params
from pti_ldm_vae_tpu_torch.train.state import create_train_state
from pti_ldm_vae_tpu_torch.train.steps import LossConfig, make_eval_step, make_train_step

TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=3,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, True],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)
LR = 1e-3
LOSS = dict(recon_loss="l1", kl_weight=1e-3, perceptual_weight=1.0)
GRAD_FLOOR = 1e-6


def _zero_gradient_in_exact_arithmetic(key: str) -> bool:
    """Softmax is invariant to a constant added along the keys, so a key
    projection's bias has gradient 0; both frameworks hold rounding noise."""
    return key.endswith("to_k.bias")


def _eps_like_the_jax_step(rng, shape):
    rng_sample, _ = jax.random.split(rng)
    return np.array(jax.random.normal(rng_sample, shape, dtype=jnp.float32))


@pytest.fixture(scope="module")
def world():
    jax_model = jax_from_config(TOY, use_pallas_attention=False, s2d_stem=False)
    variables = jax.jit(jax_model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 1)),
                                        jax.random.key(1))
    # non-trivial norm affines and biases, so every parameter's gradient is exercised
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(0)
    leaves = [np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32) for a in leaves]
    variables = jax.tree_util.tree_unflatten(treedef, leaves)
    lpips_tree = jax.tree_util.tree_map(np.asarray, jax_lpips.init_lpips_params(1))

    images = rng.normal(size=(4, 32, 32, 1)).astype(np.float32)
    images[3] = 0.0
    mask = np.array([1.0, 1.0, 1.0, 0.0], dtype=np.float32)
    keys = [jax.random.key(11), jax.random.key(12)]
    eps = [_eps_like_the_jax_step(k, (4, 16, 16, 3)) for k in keys]

    lcfg = jax_steps.LossConfig(**LOSS)
    step = jax_steps.make_train_step(jax_model, None, lcfg, adv_active=False, donate=False)

    @jax.jit
    def loss_and_grads(params, rng_key):
        def f(p):
            return jax_steps._generator_losses(jax_model, None, lcfg, p, {}, lpips_tree,
                                               jnp.asarray(images), jnp.asarray(mask), {},
                                               rng_key, False)
        (total, aux), grads = jax.value_and_grad(f, has_aux=True)(params)
        return total, {k: aux[k] for k in ("recon_loss", "kl_loss", "perceptual_loss")}, grads

    state = jax_create_state(variables, lr=LR)
    jax_out = []
    for key in keys:
        total, terms, grads = loss_and_grads(state.params_g, key)
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(mask), {}, lpips_tree, key)
        jax_out.append(dict(
            total=float(total), terms={k: float(v) for k, v in terms.items()},
            grads=to_torch_state_dict(jax.tree_util.tree_map(np.asarray, grads), TOY),
            params=to_torch_state_dict(jax.tree_util.tree_map(np.asarray, state.params_g), TOY),
            metrics={k: float(v) for k, v in metrics.items()},
        ))

    port = autoencoder_from_config(TOY)
    port.load_state_dict(state_dict_from_flax(variables, TOY), strict=True)
    return dict(port=port, lpips=lpips_params_from_jax(lpips_tree), images=torch.from_numpy(images),
                mask=torch.from_numpy(mask), eps=[torch.from_numpy(e) for e in eps],
                jax=jax_out, start=to_torch_state_dict(variables, TOY))


@pytest.fixture(scope="module")
def port_run(world):
    """Two port steps; gradients are captured just before each Adam update."""
    model = world["port"]
    state = create_train_state(model, lr=LR)
    step = make_train_step(model, None, LossConfig(**LOSS), adv_active=False)
    out = []
    for eps in world["eps"]:
        grads = {}
        real_step = state.optimizer_g.step

        def capture(*a, _real=real_step, _grads=grads, **kw):
            _grads.update({k: p.grad.detach().clone() for k, p in model.named_parameters()})
            return _real(*a, **kw)

        state.optimizer_g.step = capture
        _, metrics = step(state, world["images"], world["mask"], None, world["lpips"], eps=eps)
        state.optimizer_g.step = real_step
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                        params={k: v.detach().clone() for k, v in model.state_dict().items()}))
    assert state.step == 2 and all(p.grad is None for p in model.parameters())
    return out


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_loss_terms_match(world, port_run, i):
    want, got = world["jax"][i], port_run[i]["metrics"]
    assert set(got) == set(want["metrics"])
    for name in ("recon_loss", "kl_loss", "perceptual_loss"):
        assert got[f"train/{name}"] == pytest.approx(want["terms"][name], rel=1e-4), name
    assert got["train/loss_total"] == pytest.approx(want["total"], rel=1e-4)
    for name, value in want["metrics"].items():
        # the debug stats are means of signed O(1) latents: an absolute bar
        tol = dict(abs=1e-4) if name.startswith("debug/") else dict(rel=1e-4, abs=1e-6)
        assert got[name] == pytest.approx(value, **tol), name
    assert got["train/adv_gen_loss"] == 0.0 and got["train/adv_disc_loss"] == 0.0


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_gradients_match_by_monai_key(world, port_run, i):
    want, got = world["jax"][i]["grads"], port_run[i]["grads"]
    assert set(got) == set(want)
    for key, theirs in want.items():
        if _zero_gradient_in_exact_arithmetic(key):
            assert np.abs(theirs).max() < 1e-7 and float(got[key].abs().max()) < 1e-7, key
            continue
        np.testing.assert_allclose(got[key].numpy(), theirs, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(theirs).max()), err_msg=key)


@pytest.mark.parametrize("i", [0, 1], ids=["step1", "step2"])
def test_parameters_after_adam_match(world, port_run, i):
    want, got = world["jax"][i]["params"], port_run[i]["params"]
    n_firm = 0
    for key, theirs in want.items():
        diff = np.abs(got[key].numpy() - theirs)
        assert diff.max() <= 2 * LR * (i + 1), key
        firm = np.ones_like(theirs, dtype=bool)
        for j in range(i + 1):
            firm &= np.abs(world["jax"][j]["grads"][key]) > GRAD_FLOOR
        n_firm += int(firm.sum())
        if firm.any():
            assert diff[firm].max() <= 0.02 * LR, key
        moved = np.abs(theirs - world["start"][key])
        if not _zero_gradient_in_exact_arithmetic(key):
            assert moved.max() > 0.5 * LR, key  # Adam really moved this tensor
    assert n_firm > 0.9 * sum(v.size for v in want.values())


def state_dict_from_flax_params(world):
    return {k: torch.from_numpy(np.array(v)) for k, v in world["start"].items()}


def test_padded_row_does_not_leak(world):
    """Changing the masked-out row changes neither a loss term nor a gradient."""
    model = autoencoder_from_config(TOY)
    model.load_state_dict(state_dict_from_flax_params(world), strict=True)
    step = make_eval_step(model, None, LossConfig(**LOSS), adv_active=False)
    other = world["images"].clone()
    other[3] = 7.0
    a, _ = step(None, world["images"], world["mask"], None, world["lpips"], eps=world["eps"][0])
    b, _ = step(None, other, world["mask"], None, world["lpips"], eps=world["eps"][0])
    for key in a:
        assert float(a[key]) == pytest.approx(float(b[key]), rel=1e-6), key


def test_eval_step_matches_first_train_step_losses(world, port_run):
    model = autoencoder_from_config(TOY)
    model.load_state_dict(state_dict_from_flax_params(world), strict=True)
    step = make_eval_step(model, None, LossConfig(**LOSS), adv_active=False)
    metrics, recon = step(None, world["images"], world["mask"], None, world["lpips"],
                          eps=world["eps"][0])
    assert recon.shape == (4, 32, 32, 1) and not recon.requires_grad
    assert set(metrics) == {"recon_loss", "kl_loss", "perceptual_loss", "adv_gen_loss",
                            "adv_disc_loss", "ar_loss", "loss_total"}
    assert float(metrics["loss_total"]) == pytest.approx(world["jax"][0]["total"], rel=1e-4)


def test_step_draws_eps_from_generator(world):
    model = autoencoder_from_config(TOY)
    step = make_eval_step(model, None, LossConfig(**LOSS, use_perceptual=False), adv_active=False)
    args = (None, world["images"], world["mask"], None, world["lpips"])
    a, _ = step(*args, generator=torch.Generator().manual_seed(3))
    b, _ = step(*args, generator=torch.Generator().manual_seed(3))
    c, _ = step(*args, generator=torch.Generator().manual_seed(4))
    assert float(a["recon_loss"]) == float(b["recon_loss"]) != float(c["recon_loss"])
    assert float(a["perceptual_loss"]) == 0.0


@pytest.mark.parametrize("kwargs,lcfg,error,match", [
    # the adversarial branch is ported; without a discriminator it has nothing to run
    (dict(adv_active=True), LossConfig(), ValueError, "needs a discriminator"),
    # the AR-VAE term is ported; switched on without a spec it has no attributes to regularize
    (dict(adv_active=False), LossConfig(ar_vae_enabled=True), ValueError, "needs an ar_spec"),
], ids=["adversarial", "ar_vae"])
def test_unported_branches_raise(kwargs, lcfg, error, match):
    model = autoencoder_from_config(TOY)
    for make in (make_train_step, make_eval_step):
        with pytest.raises(error, match=match):
            make(model, None, lcfg, **kwargs)


def test_bf16_train_step_is_finite_and_differentiable():
    """Every op of the training forward differentiates in bf16 compute too
    (per-call weight casts, the downsample's pad, the nearest upsample)."""
    torch.manual_seed(0)
    model = autoencoder_from_config(TOY, compute_dtype=torch.bfloat16)
    state = create_train_state(model, lr=LR)
    step = make_train_step(model, None, LossConfig(**LOSS), adv_active=False)
    x = torch.randn(2, 32, 32, 1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, metrics = step(state, x, torch.ones(2), None, init_lpips_params(0),
                      generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = model.state_dict()
    assert all(v.dtype == torch.float32 for v in after.values())
    assert all(not torch.equal(before[k], after[k]) for k in before)
