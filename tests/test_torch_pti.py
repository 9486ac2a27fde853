"""Pivotal-tuning inversion of the port (``train/diffusion.py``) against the
JAX package's ``pivotal_tuning_inversion`` and
``make_pivotal_tuning_inversion_batched`` on the CPU: the linear-decoder
cases of ``tests/test_diffusion.py``, then a toy ``AutoencoderKL`` (weights
carried across by ``state_dict_from_flax``) for a few steps of both stages:
pivots, per-step losses and tuned decoder tensors; the batched program
against the sequential one; the ``vmap`` form's refusal.

Bars: pivots and losses rtol 1e-4 / atol 1e-5 (of the pivot's largest entry
for the toy model); tuned tensors within 2e-3 of each tensor's largest
change, and every entry within 2 lr per tune step. The key projection's bias
(``to_k.bias``) has gradient 0 in exact arithmetic, so its Adam updates are
rounding noise in both frameworks and are held to the 2 lr bound alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pti_ldm_vae_tpu.checkpoint.torch_convert import to_torch_state_dict
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu.train import diffusion as jax_diffusion
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import state_dict_from_flax
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.train.diffusion import (
    decoder_parameters,
    make_pivotal_tuning_inversion_batched,
    pivotal_tuning_inversion,
    pivotal_tuning_inversion_batched,
    swapped_decoder,
)

TOL = dict(rtol=1e-4, atol=1e-5)


class LinearDecoder(nn.Module):
    """``z @ w + b`` as a model: the parameters stage 2 tunes sit under ``decoder.``."""

    def __init__(self, w: np.ndarray, b: np.ndarray):
        super().__init__()
        self.decoder = nn.ParameterDict({"w": nn.Parameter(torch.from_numpy(w)),
                                         "b": nn.Parameter(torch.from_numpy(b))})

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return z @ self.decoder["w"] + self.decoder["b"]


def _linear_world(seed, batch):
    rng = np.random.default_rng(seed)
    true_w = rng.normal(size=(3, 6)).astype(np.float32)
    w, b = true_w * np.float32(0.9), np.zeros((6,), np.float32)
    z_true = rng.normal(size=(batch, 3)).astype(np.float32)
    return w, b, z_true @ true_w, np.zeros((batch, 3), np.float32)


def _jax_linear(params, z):
    return z @ params["w"] + params["b"]


@pytest.mark.parametrize("steps", [(300, 200), (60, 40)])
def test_linear_decoder_pti_matches_jax(steps):
    latent_steps, tune_steps = steps
    w, b, target, z0 = _linear_world(5, 1)
    hyper = dict(latent_steps=latent_steps, latent_lr=5e-2, tune_steps=tune_steps, tune_lr=1e-2)
    pivot, tuned, losses = jax_diffusion.pivotal_tuning_inversion(
        _jax_linear, {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(target),
        jnp.asarray(z0), **hyper)
    model = LinearDecoder(w, b)
    got_pivot, got_tuned, got_losses = pivotal_tuning_inversion(
        model, torch.from_numpy(target), torch.from_numpy(z0), **hyper)
    np.testing.assert_allclose(got_pivot.numpy(), np.asarray(pivot), **TOL)
    np.testing.assert_allclose(got_losses["latent"].numpy(), np.asarray(losses["latent"]), **TOL)
    assert got_losses["tune"].shape == (tune_steps,)
    # After 300 steps the pivot solves this linear problem to a loss of ~1e-14:
    # the tune stage's gradients are then f32 rounding, whose signs Adam's
    # normalized step follows, so each framework walks its own noise. The tune
    # stage is compared from the 60-step pivot, which leaves a real residual.
    if latent_steps == 60:
        np.testing.assert_allclose(got_losses["tune"].numpy(), np.asarray(losses["tune"]), **TOL)
        for name in ("w", "b"):
            np.testing.assert_allclose(got_tuned[f"decoder.{name}"].numpy(),
                                       np.asarray(tuned[name]), **TOL)
    # as in the JAX test: both stages reduce the error, the tuned decoder reproduces the target
    assert float(got_losses["latent"][-1]) < float(got_losses["latent"][0])
    if latent_steps == 300:
        assert float(got_losses["tune"][-1]) < 1e-3
        with swapped_decoder(model, got_tuned), torch.no_grad():
            np.testing.assert_allclose(model.decode(got_pivot).numpy(), target, atol=0.1)
    # the model's own decoder is unchanged
    np.testing.assert_array_equal(model.decoder["w"].detach().numpy(), w)


def test_linear_decoder_batched_matches_jax_and_sequential():
    w, b, targets, z0 = _linear_world(6, 8)
    hyper = dict(latent_steps=60, latent_lr=5e-2, tune_steps=40, tune_lr=1e-2)
    program = jax_diffusion.make_pivotal_tuning_inversion_batched(_jax_linear, **hyper)
    pivots, tuned, losses = program({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                    jnp.asarray(targets), jnp.asarray(z0))
    model = LinearDecoder(w, b)
    got_pivots, got_tuned, got_losses = pivotal_tuning_inversion_batched(
        model, torch.from_numpy(targets), torch.from_numpy(z0), **hyper)
    assert got_pivots.shape == (8, 3) and got_tuned["decoder.w"].shape == (8, 3, 6)
    assert got_losses["latent"].shape == (8, 60) and got_losses["tune"].shape == (8, 40)
    np.testing.assert_allclose(got_pivots.numpy(), np.asarray(pivots), **TOL)
    for key in ("latent", "tune"):
        np.testing.assert_allclose(got_losses[key].numpy(), np.asarray(losses[key]), **TOL)
    for name in ("w", "b"):
        np.testing.assert_allclose(got_tuned[f"decoder.{name}"].numpy(), np.asarray(tuned[name]),
                                   **TOL)
    for i in (0, 3, 7):
        pivot_i, tuned_i, losses_i = pivotal_tuning_inversion(
            model, torch.from_numpy(targets[i:i + 1]), torch.from_numpy(z0[i:i + 1]), **hyper)
        np.testing.assert_allclose(got_pivots[i].numpy(), pivot_i[0].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_tuned["decoder.w"][i].numpy(), tuned_i["decoder.w"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_losses["latent"][i].numpy(), losses_i["latent"].numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_vmap_formulation_runs_and_others_are_refused():
    """The ``vmap`` form gives the ``scan`` form's results on the linear
    decoder (held to both JAX forms in ``tests/test_torch_pti_vmap.py``); an
    unknown form is a ``ValueError``."""
    w, b, target, z0 = _linear_world(0, 3)
    hyper = dict(latent_steps=20, latent_lr=5e-2, tune_steps=10, tune_lr=1e-2)
    args = (torch.from_numpy(target), torch.from_numpy(z0))
    scan = make_pivotal_tuning_inversion_batched(LinearDecoder(w, b), **hyper)(*args)
    vmap = make_pivotal_tuning_inversion_batched(LinearDecoder(w, b), tune_formulation="vmap",
                                                 **hyper)(*args)
    for got, want in zip(jax.tree_util.tree_leaves(vmap), jax.tree_util.tree_leaves(scan)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    with pytest.raises(ValueError, match="tune_formulation"):
        make_pivotal_tuning_inversion_batched(LinearDecoder(w, b), tune_formulation="grouped")


# ---- a toy AutoencoderKL ---------------------------------------------------------------------

TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=3,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, True],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)
HYPER = dict(latent_steps=4, latent_lr=1e-1, tune_steps=3, tune_lr=1e-3)


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(2)
    jax_model = jax_from_config(TOY, use_pallas_attention=False, s2d_stem=False)
    variables = jax.jit(jax_model.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 1)),
                                        jax.random.key(1))
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    variables = jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32) for a in leaves])
    targets = rng.uniform(0.0, 1.0, size=(2, 16, 16, 1)).astype(np.float32)
    z_init = np.asarray(jax_model.apply(variables, jnp.asarray(targets),
                                        method=jax_model.encode_deterministic))

    def decode_fn(params, z):
        return jax_model.apply(params, z, method=jax_model.decode_stage_2_outputs)

    model = autoencoder_from_config(TOY)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables), TOY), strict=True)
    return dict(jax_model=jax_model, variables=variables, targets=targets, z_init=z_init,
                decode_fn=decode_fn, model=model)


def _assert_tuned_close(got: dict, want_tree, start: dict, steps: int, lr: float):
    """Tuned decoder tensors (MONAI keys) against the JAX tree's."""
    want = to_torch_state_dict(jax.tree_util.tree_map(np.asarray, want_tree), TOY)
    assert set(got) == {k for k in want if k.startswith(("decoder.", "post_quant_conv."))}
    for key, value in got.items():
        ours, theirs = value.detach().numpy(), want[key]
        diff = np.abs(ours - theirs).max()
        assert diff <= 2 * lr * steps, key
        if key.endswith("to_k.bias"):
            continue
        change = np.abs(theirs - start[key]).max()
        assert change > 0.5 * lr, key  # Adam really moved the tensor
        assert diff <= 2e-3 * change, (key, diff, change)
    # the JAX side's encoder takes zero gradients, hence no Adam updates
    for key, value in want.items():
        if key.startswith(("encoder.", "quant_conv")):
            np.testing.assert_array_equal(value, start[key])


def test_toy_autoencoder_pti_matches_jax(toy):
    target, z0 = toy["targets"][:1], toy["z_init"][:1]
    pivot, tuned, losses = jax_diffusion.pivotal_tuning_inversion(
        toy["decode_fn"], toy["variables"], jnp.asarray(target), jnp.asarray(z0), **HYPER)
    model = toy["model"]
    start = {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}
    got_pivot, got_tuned, got_losses = pivotal_tuning_inversion(
        model, torch.from_numpy(target), torch.from_numpy(z0), **HYPER)
    scale = float(np.abs(np.asarray(pivot)).max())
    np.testing.assert_allclose(got_pivot.numpy(), np.asarray(pivot), rtol=1e-4, atol=1e-4 * scale)
    for key in ("latent", "tune"):
        np.testing.assert_allclose(got_losses[key].numpy(), np.asarray(losses[key]), **TOL)
        assert float(got_losses[key][-1]) < float(got_losses[key][0])  # both stages descend
    _assert_tuned_close(got_tuned, tuned, start, HYPER["tune_steps"], HYPER["tune_lr"])
    assert all(torch.equal(v, torch.from_numpy(start[k])) for k, v in model.state_dict().items())
    assert all(p.requires_grad for p in model.parameters())  # flags restored


def test_toy_autoencoder_batched_pti_matches_jax(toy):
    program = jax_diffusion.make_pivotal_tuning_inversion_batched(toy["decode_fn"], **HYPER)
    pivots, tuned, losses = program(toy["variables"], jnp.asarray(toy["targets"]),
                                    jnp.asarray(toy["z_init"]))
    model = toy["model"]
    start = {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}
    got_pivots, got_tuned, got_losses = make_pivotal_tuning_inversion_batched(model, **HYPER)(
        torch.from_numpy(toy["targets"]), torch.from_numpy(toy["z_init"]))
    scale = float(np.abs(np.asarray(pivots)).max())
    np.testing.assert_allclose(got_pivots.numpy(), np.asarray(pivots), rtol=1e-4,
                               atol=1e-4 * scale)
    for key in ("latent", "tune"):
        assert got_losses[key].shape == (2, HYPER[f"{key}_steps"])
        np.testing.assert_allclose(got_losses[key].numpy(), np.asarray(losses[key]), **TOL)
    for i in range(2):
        _assert_tuned_close({k: v[i] for k, v in got_tuned.items()},
                            jax.tree_util.tree_map(lambda leaf, i=i: leaf[i], tuned), start,
                            HYPER["tune_steps"], HYPER["tune_lr"])


def test_toy_autoencoder_batched_equals_sequential(toy):
    model = toy["model"]
    targets, z_init = torch.from_numpy(toy["targets"]), torch.from_numpy(toy["z_init"])
    pivots, tuned, losses = pivotal_tuning_inversion_batched(model, targets, z_init, **HYPER)
    for i in range(2):
        pivot_i, tuned_i, losses_i = pivotal_tuning_inversion(
            model, targets[i:i + 1], z_init[i:i + 1], **HYPER)
        scale = float(pivot_i.abs().max())
        np.testing.assert_allclose(pivots[i:i + 1].numpy(), pivot_i.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)
        for key in ("latent", "tune"):
            np.testing.assert_allclose(losses[key][i].numpy(), losses_i[key].numpy(), rtol=1e-5)
        for key, value in tuned_i.items():
            if key.endswith("to_k.bias"):
                continue
            np.testing.assert_allclose(tuned[key][i].numpy(), value.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    assert set(tuned) == set(decoder_parameters(model))


def test_toy_autoencoder_remat_pti_is_bit_equal(toy):
    """PTI differentiates the decoder of a ``remat`` model (the VAE loader
    keeps the key): the blocks are recomputed in each backward under the
    in-place parameter swap of stage 2, and the pivots, losses and tuned
    tensors are the plain model's bits on the CPU."""
    model = toy["model"]
    remat = autoencoder_from_config(TOY, remat=True)
    remat.load_state_dict(model.state_dict(), strict=True)
    targets, z_init = torch.from_numpy(toy["targets"]), torch.from_numpy(toy["z_init"])
    want = pivotal_tuning_inversion_batched(model, targets, z_init, **HYPER)
    got = pivotal_tuning_inversion_batched(remat, targets, z_init, **HYPER)
    assert torch.equal(got[0], want[0])
    for key in ("latent", "tune"):
        assert torch.equal(got[2][key], want[2][key]), key
    for key, value in want[1].items():
        assert torch.equal(got[1][key], value), key
    tuned = {k: v[0] for k, v in want[1].items()}
    pivot = want[0][:1].clone().requires_grad_()
    grads = []
    for m in (model, remat):
        with swapped_decoder(m, tuned):
            grads.append(torch.autograd.grad(m.decode(pivot).square().sum(), pivot)[0])
    assert torch.equal(grads[0], grads[1])
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in remat.state_dict().items())
