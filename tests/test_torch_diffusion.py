"""The port's latent-diffusion core (``pti_ldm_vae_tpu_torch/train/diffusion.py``)
against the JAX package's (``pti_ldm_vae_tpu/train/diffusion.py``), f32 on the
CPU: the noise schedule, ``add_noise``, the DDIM loop at eta 0 and eta > 0,
and one epsilon-MSE train step with Adam.

The UNet is the toy one of ``tests/test_torch_unet.py`` (channels [8, 16]),
its weights the JAX init with every leaf perturbed, carried across by
``unet_state_dict_from_flax``. Noise cannot come from a shared PRNG, so every
draw is made on the JAX side with the key splits the JAX function itself
makes and handed to the port: the initial DDIM noise, each DDIM step's noise
at eta > 0 (``ddim_sample``: ``rng, init = split(rng)``, then per step
``rng, noise = split(rng)``), the train step's timesteps and noise
(``rng_t, rng_noise = split(rng)``). JAX runs at its highest matmul
precision.

Bars: schedule rtol 1e-6 (``alphas_cumprod`` of 1000 f32 products);
``add_noise``, the UNet-carrying checks and the train step rtol 1e-4 / atol
1e-5; DDIM final latents within 1e-4 (5 steps over a 100-step schedule,
latents of size ~1: x0 predictions divide by sqrt(a_t) >= 0.6 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pti_ldm_vae_tpu.models import unet as jax_unet
from pti_ldm_vae_tpu.train import diffusion as jax_diffusion
from pti_ldm_vae_tpu_torch.checkpoint.unet_convert import (
    projector_state_dict_from_flax,
    unet_state_dict_from_flax,
)
from pti_ldm_vae_tpu_torch.models.unet import ConditionProjector, diffusion_unet_from_config
from pti_ldm_vae_tpu_torch.train.diffusion import (
    NoiseSchedule,
    add_noise,
    ddim_sample,
    ddim_timesteps,
    diffusion_loss,
    make_diffusion_train_step,
)
from pti_ldm_vae_tpu_torch.train.state import create_train_state

TOL = dict(rtol=1e-4, atol=1e-5)
TOY = dict(spatial_dims=2, in_channels=2, out_channels=2, channels=[8, 16],
           attention_levels=[False, True], num_head_channels=[0, 8], num_res_blocks=1,
           with_conditioning=True, cross_attention_dim=12, norm_num_groups=4)
SHAPE = (2, 8, 8, 2)
T = 100
LR = 1e-4


def _perturbed(variables, seed):
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32) for a in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    x = rng.normal(size=SHAPE).astype(np.float32)
    cond = rng.normal(size=(2, 4, 4, 2)).astype(np.float32)
    jm = jax_unet.diffusion_unet_from_config(TOY)
    proj = jax_unet.ConditionProjector(cross_attention_dim=12)
    unet_vars = _perturbed(jm.init(jax.random.key(0), x, np.zeros(2, np.int32),
                                   np.zeros((2, 16, 12), np.float32)), 0)
    proj_vars = _perturbed(proj.init(jax.random.key(1), np.zeros((1, 16, 2), np.float32)), 1)
    np_unet = jax.tree_util.tree_map(np.asarray, unet_vars)
    np_proj = jax.tree_util.tree_map(np.asarray, proj_vars)
    return {"jm": jm, "proj": proj, "params": {"unet": unet_vars, "projector": proj_vars},
            "unet_sd": unet_state_dict_from_flax(np_unet, TOY),
            "proj_sd": projector_state_dict_from_flax(np_proj), "x": x, "cond": cond}


def _port_models(world):
    unet = diffusion_unet_from_config(TOY)
    unet.load_state_dict(world["unet_sd"], strict=True)
    proj = ConditionProjector(2, 12)
    proj.load_state_dict(world["proj_sd"], strict=True)
    return unet, proj


def _context_jax(world):
    tokens = jnp.asarray(world["cond"]).reshape(2, 16, 2)
    return world["proj"].apply(world["params"]["projector"], tokens)


@pytest.mark.parametrize("steps", [1000, 100, 50])
def test_schedule_matches_jax(steps):
    want = jax_diffusion.NoiseSchedule.linear_beta(steps)
    got = NoiseSchedule.linear_beta(steps)
    assert got.num_train_timesteps == steps and got.alphas_cumprod.dtype == torch.float32
    np.testing.assert_allclose(got.betas.numpy(), np.asarray(want.betas), rtol=1e-6)
    np.testing.assert_allclose(got.alphas_cumprod.numpy(), np.asarray(want.alphas_cumprod), rtol=1e-6)


def test_add_noise_matches_jax():
    rng = np.random.default_rng(1)
    x0, noise = (rng.normal(size=(4, 8, 8, 2)).astype(np.float32) for _ in range(2))
    t = np.array([0, 17, 500, 999], dtype=np.int32)
    want = jax_diffusion.add_noise(jax_diffusion.NoiseSchedule.linear_beta(1000), jnp.asarray(x0),
                                   jnp.asarray(noise), jnp.asarray(t))
    got = add_noise(NoiseSchedule.linear_beta(1000), torch.from_numpy(x0), torch.from_numpy(noise),
                    torch.from_numpy(t).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("steps", [50, 7, 1])
def test_ddim_timesteps_descend_as_in_jax(steps):
    ratio = 1000 // steps
    assert ddim_timesteps(1000, steps) == list(np.arange(steps)[::-1] * ratio)


def _jax_ddim(world, x_t, eta, rng):
    jm = world["jm"]
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_diffusion.ddim_sample(
            lambda p, x, t, c: jm.apply(p, x, t, c), world["params"]["unet"],
            jax_diffusion.NoiseSchedule.linear_beta(T), SHAPE, rng, num_inference_steps=5,
            context=_context_jax(world), eta=eta, initial_noise=jnp.asarray(x_t)))


def _port_ddim(world, x_t, eta, step_noise=None):
    unet, proj = _port_models(world)
    with torch.no_grad():
        ctx = proj(torch.from_numpy(world["cond"]).reshape(2, 16, 2))
        return ddim_sample(unet.eval(), NoiseSchedule.linear_beta(T), torch.from_numpy(x_t),
                           num_inference_steps=5, context=ctx, eta=eta,
                           step_noise=step_noise).numpy()


def test_ddim_eta0_matches_jax(world):
    x_t = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
    want = _jax_ddim(world, x_t, 0.0, jax.random.key(3))
    got = _port_ddim(world, x_t, 0.0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_ddim_eta_positive_matches_jax_with_its_noise(world):
    x_t = np.random.default_rng(4).normal(size=SHAPE).astype(np.float32)
    rng = jax.random.key(5)
    want = _jax_ddim(world, x_t, 0.5, rng)
    # the noise ddim_sample draws at each step, from its own key splits
    rng, _ = jax.random.split(rng)
    step_noise = []
    for _ in range(5):
        rng, noise_rng = jax.random.split(rng)
        step_noise.append(torch.from_numpy(np.array(
            jax.random.normal(noise_rng, SHAPE, dtype=jnp.float32))))
    got = _port_ddim(world, x_t, 0.5, step_noise)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert not np.allclose(got, _port_ddim(world, x_t, 0.0), atol=1e-3)  # the noise mattered


def test_ddim_eta_positive_draws_from_the_generator(world):
    unet, _ = _port_models(world)
    x_t = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))

    def run(seed):
        with torch.no_grad():
            return ddim_sample(unet.eval(), NoiseSchedule.linear_beta(T), x_t, num_inference_steps=3,
                               context=torch.zeros(2, 16, 12), eta=1.0,
                               generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def _jax_step_draws(rng, b):
    """The timesteps and noise ``make_diffusion_train_step`` draws from ``rng``."""
    rng_t, rng_noise = jax.random.split(rng)
    t = jax.random.randint(rng_t, (b,), 0, T)
    noise = jax.random.normal(rng_noise, SHAPE, dtype=jnp.float32)
    return np.array(t), np.array(noise)


def test_train_step_matches_jax(world):
    """Loss and gradients of one step, then the parameters after JAX's own
    jitted step (``optax.adam``) and the port's (``torch.optim.Adam``)."""
    jm, proj = world["jm"], world["proj"]
    sched = jax_diffusion.NoiseSchedule.linear_beta(T)
    rng = jax.random.key(7)
    t, noise = _jax_step_draws(rng, 2)
    x, cond = jnp.asarray(world["x"]), jnp.asarray(world["cond"])

    def loss_fn(params):
        noisy = jax_diffusion.add_noise(sched, x, jnp.asarray(noise), jnp.asarray(t))
        ctx = proj.apply(params["projector"], cond.reshape(2, 16, 2))
        eps = jm.apply(params["unet"], noisy, jnp.asarray(t), ctx)
        return jnp.mean(jnp.square(eps - jnp.asarray(noise)))

    tx = optax.adam(LR)
    params = world["params"]
    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
        step = jax_diffusion.make_diffusion_train_step(jm, sched, tx, projector=proj)
        new_params, _, step_loss = step(params, tx.init(params), x, cond, rng)
    np.testing.assert_allclose(float(step_loss), float(want_loss), rtol=1e-6)

    unet, port_proj = _port_models(world)
    schedule = NoiseSchedule.linear_beta(T)
    args = (torch.from_numpy(world["x"]), torch.from_numpy(t).long(), torch.from_numpy(noise))
    ctx = port_proj(torch.from_numpy(world["cond"]).reshape(2, 16, 2))
    loss = diffusion_loss(unet, schedule, args[0], args[1], args[2], ctx)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    want_unet = unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want_grads["unet"]), TOY)
    for key, p in unet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_unet[key].numpy(), **TOL, err_msg=key)
    want_proj = projector_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                      want_grads["projector"]))
    for key, p in port_proj.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_proj[key].numpy(), **TOL, err_msg=key)

    unet, port_proj = _port_models(world)
    state = create_train_state(torch.nn.ModuleDict({"unet": unet, "projector": port_proj}), lr=LR)
    port_step = make_diffusion_train_step(unet, schedule, state, projector=port_proj)
    got_loss = port_step(args[0], torch.from_numpy(world["cond"]), timesteps=args[1], noise=args[2])
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)
    assert state.step == 1
    want_unet = unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, new_params["unet"]), TOY)
    for key, value in unet.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_unet[key].numpy(), **TOL, err_msg=key)
    want_proj = projector_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                      new_params["projector"]))
    for key, value in port_proj.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_proj[key].numpy(), **TOL, err_msg=key)


def test_masked_loss_matches_the_jax_cli(world):
    """The CLI's loss: the per-sample MSE averaged over the rows the mask keeps
    (``cli/train_diffusion.py:128-134``); a padded row changes nothing."""
    jm = world["jm"]
    sched = jax_diffusion.NoiseSchedule.linear_beta(T)
    t, noise = _jax_step_draws(jax.random.key(8), 2)
    mask = np.array([1.0, 0.0], np.float32)
    with jax.default_matmul_precision("highest"):
        noisy = jax_diffusion.add_noise(sched, jnp.asarray(world["x"]), jnp.asarray(noise),
                                        jnp.asarray(t))
        eps = jm.apply(world["params"]["unet"], noisy, jnp.asarray(t), _context_jax(world))
        per = jnp.mean(jnp.square(eps - jnp.asarray(noise)), axis=(1, 2, 3))
        want = float(jnp.sum(per * mask) / jnp.maximum(jnp.sum(mask), 1.0))
    unet, proj = _port_models(world)
    with torch.no_grad():
        ctx = proj(torch.from_numpy(world["cond"]).reshape(2, 16, 2))
        got = diffusion_loss(unet, NoiseSchedule.linear_beta(T), torch.from_numpy(world["x"]),
                             torch.from_numpy(t).long(), torch.from_numpy(noise), ctx,
                             torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), want, **TOL)


def test_train_step_draws_from_the_generator(world):
    unet, proj = _port_models(world)
    state = create_train_state(torch.nn.ModuleDict({"unet": unet, "projector": proj}), lr=LR)
    step = make_diffusion_train_step(unet, NoiseSchedule.linear_beta(T), state, projector=proj)
    x, cond = torch.from_numpy(world["x"]), torch.from_numpy(world["cond"])
    losses = [float(step(x, cond, torch.ones(2), generator=torch.Generator().manual_seed(s)))
              for s in (0, 0, 1)]
    assert all(np.isfinite(losses)) and state.step == 3
    assert losses[2] != losses[1]
