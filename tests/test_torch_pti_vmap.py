"""PTI's ``vmap`` tune form (``make_pivotal_tuning_inversion_batched(
tune_formulation="vmap")``) and the kernels' ``torch.func.vmap`` rules, on
the CPU.

* The form against the port's ``scan`` form and against the JAX package's
  ``vmap`` form on a toy ``AutoencoderKL`` decoder (a conv decoder with
  GroupNorm+SiLU and a mid-block attention; weights carried across by
  ``state_dict_from_flax``), as the JAX package's
  ``test_pti_scan_tune_matches_vmap_on_conv_decoder`` holds its two forms to
  each other: pivots, both loss curves, tuned tensors; also with the
  convolution kernels' plain versions (``conv_kernel``) and a ``remat``
  model.
* Each kernel Function's ``vmap`` rule, the shared-weight (fold) branch and
  the per-image branch, against a Python loop over the images on the plain
  versions, forward and gradient; the rules launch nothing on the CPU.

Bars: pivots and losses rtol 1e-4 / atol 1e-5 (of the pivot's largest entry);
tuned tensors within 2e-3 of each tensor's largest change where the first
gradient is outside its rounding, every entry within 2 lr per tune step
(Adam's sign step, ROADMAP C); the vmap rules against the
loop rtol 1e-5 / atol 1e-6 (the same plain arithmetic on the same rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from pti_ldm_vae_tpu.checkpoint.torch_convert import to_torch_state_dict
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu.train import diffusion as jax_diffusion
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import state_dict_from_flax
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
from pti_ldm_vae_tpu_torch.ops import kernels
from pti_ldm_vae_tpu_torch.ops.kernels import conv3x3, flash_attention, groupnorm_silu
from pti_ldm_vae_tpu_torch.train.diffusion import make_pivotal_tuning_inversion_batched

TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=3,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, True],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)
HYPER = dict(latent_steps=4, latent_lr=1e-1, tune_steps=3, tune_lr=1e-3)
TOL = dict(rtol=1e-4, atol=1e-5)
N = 3  # images


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(4)
    jax_model = jax_from_config(TOY, use_pallas_attention=False, s2d_stem=False)
    variables = jax.jit(jax_model.init)(jax.random.key(0), jnp.zeros((1, 16, 16, 1)),
                                        jax.random.key(1))
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    variables = jax.tree_util.tree_unflatten(treedef, [
        np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32) for a in leaves])
    targets = rng.uniform(0.0, 1.0, size=(N, 16, 16, 1)).astype(np.float32)
    z_init = np.asarray(jax_model.apply(variables, jnp.asarray(targets),
                                        method=jax_model.encode_deterministic))

    def decode_fn(params, z):
        return jax_model.apply(params, z, method=jax_model.decode_stage_2_outputs)

    jax_out = jax_diffusion.make_pivotal_tuning_inversion_batched(
        decode_fn, tune_formulation="vmap", **HYPER)(variables, jnp.asarray(targets),
                                                     jnp.asarray(z_init))
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables), TOY)
    return dict(sd=sd, targets=torch.from_numpy(targets), z_init=torch.from_numpy(z_init),
                jax=jax_out)


def _model(toy, **knobs):
    model = autoencoder_from_config(TOY, **knobs)
    model.load_state_dict(toy["sd"], strict=True)
    return model


def _run(model, toy, form):
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = make_pivotal_tuning_inversion_batched(model, tune_formulation=form, **HYPER)(
        toy["targets"], toy["z_init"])
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert all(p.requires_grad for p in model.parameters())  # flags restored
    return out


def _first_gradients(toy, pivots) -> list[dict]:
    """Each image's first tune-step gradient of the decoder at its pivot."""
    from pti_ldm_vae_tpu_torch.train.diffusion import decoder_parameters

    model = _model(toy)
    params = decoder_parameters(model)
    out = []
    for i in range(N):
        loss = (model.decode(pivots[i:i + 1]) - toy["targets"][i:i + 1]).square().mean()
        out.append(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
    return out


def _assert_tuned_close(got: dict, want: dict, start: dict, grads: list[dict]):
    """Every entry within Adam's bound, 2 lr a step; the entries whose first
    gradient is above 2e-3 of its tensor's largest (outside the rounding,
    where Adam's first step is ``lr * sign(g)`` on either side) within 2e-3
    of the tensor's largest change (``chip_smoke.py``'s PTI bars)."""
    steps, lr = HYPER["tune_steps"], HYPER["tune_lr"]
    assert set(got) == {k for k in start if k.startswith(("decoder.", "post_quant_conv."))}
    n_firm = n_all = 0
    for key, value in got.items():
        assert value.shape == (N, *start[key].shape), key
        for i in range(N):
            ours, theirs = value[i].detach().numpy(), np.asarray(want[key][i])
            diff = np.abs(ours - theirs)
            assert diff.max() <= 2 * lr * steps, key
            if key.endswith("to_k.bias"):  # gradient 0 in exact arithmetic: Adam on noise
                continue
            change = np.abs(theirs - start[key]).max()
            assert change > 0.5 * lr, key  # Adam really moved the tensor
            g = grads[i][key].abs().numpy()
            firm = g > 2e-3 * g.max()
            n_firm, n_all = n_firm + int(firm.sum()), n_all + firm.size
            assert diff[firm].max() <= 2e-3 * change, (key, i, diff[firm].max(), change)
    assert n_firm > 0.9 * n_all


def test_vmap_form_matches_the_jax_vmap_form(toy):
    pivots, tuned, losses = _run(_model(toy), toy, "vmap")
    want_pivots, want_tuned, want_losses = toy["jax"]
    scale = float(np.abs(np.asarray(want_pivots)).max())
    np.testing.assert_allclose(pivots.numpy(), np.asarray(want_pivots), rtol=1e-4, atol=1e-4 * scale)
    for key in ("latent", "tune"):
        assert losses[key].shape == (N, HYPER[f"{key}_steps"])
        np.testing.assert_allclose(losses[key].numpy(), np.asarray(want_losses[key]), **TOL)
        assert bool((losses[key][:, -1] < losses[key][:, 0]).all())  # both stages descend
    per_image = [to_torch_state_dict(jax.tree_util.tree_map(lambda leaf, i=i: np.asarray(leaf)[i],
                                                            want_tuned), TOY) for i in range(N)]
    start = {k: v.numpy() for k, v in toy["sd"].items()}
    _assert_tuned_close(tuned, {k: np.stack([w[k] for w in per_image]) for k in tuned}, start,
                        _first_gradients(toy, pivots))


@pytest.mark.parametrize("knobs", [{}, {"conv_kernel": True}, {"remat": True}],
                         ids=["cudnn", "conv_kernel", "remat"])
def test_vmap_form_matches_the_scan_form(toy, knobs):
    model = _model(toy, **knobs)
    scan_pivots, scan_tuned, scan_losses = _run(model, toy, "scan")
    pivots, tuned, losses = _run(model, toy, "vmap")
    np.testing.assert_array_equal(pivots.numpy(), scan_pivots.numpy())  # one stage-1 program
    np.testing.assert_array_equal(losses["latent"].numpy(), scan_losses["latent"].numpy())
    np.testing.assert_allclose(losses["tune"].numpy(), scan_losses["tune"].numpy(), **TOL)
    start = {k: v.numpy() for k, v in toy["sd"].items()}
    _assert_tuned_close(tuned, {k: v.numpy() for k, v in scan_tuned.items()}, start,
                        _first_gradients(toy, pivots))


def test_vmap_form_launches_nothing_on_the_cpu(toy):
    kernels.reset_launch_counts()
    _run(_model(toy, conv_kernel=True), toy, "vmap")
    assert not any(kernels.launch_counts().values())


# ---- the kernels' vmap rules -------------------------------------------------------------------

V = 3


def _loop_grads(fn, args, in_dims):
    """Per image: the gradient of ``fn`` in every argument, by plain autograd."""
    out = []
    for i in range(V):
        ts = [(a if d is None else a[i]).clone().requires_grad_() for a, d in zip(args, in_dims)]
        out.append(torch.autograd.grad(fn(*ts), ts))
    return [torch.stack([o[j] for o in out]) for j in range(len(args))]


def _check_rule(fn, args, in_dims):
    """vmap(fn) and vmap(grad(sum(fn * g))) against the loop over images."""
    got = vmap(fn, in_dims=in_dims)(*args)
    want = torch.stack([fn(*(a if d is None else a[i] for a, d in zip(args, in_dims)))
                        for i in range(V)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=tuple(want.shape)).astype(np.float32))

    def loss(*a):
        return (fn(*a) * g[0]).sum()

    got_grads = vmap(grad(loss, argnums=tuple(range(len(args)))), in_dims=in_dims)(*args)
    for got_g, want_g in zip(got_grads, _loop_grads(loss, args, in_dims)):
        torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-6)


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed + len(shape)).normal(size=shape)
                            .astype(np.float32))


@pytest.mark.parametrize("shared", [True, False], ids=["fold", "per_image"])
def test_groupnorm_silu_vmap_rule(shared):
    x = _rand(V, 2, 5, 6, 8)
    scale, bias = (_rand(8, seed=1), _rand(8, seed=2)) if shared else (_rand(V, 8, seed=1),
                                                                       _rand(V, 8, seed=2))
    dims = (0, None, None) if shared else (0, 0, 0)
    kernels.reset_launch_counts()
    _check_rule(lambda a, s, b: groupnorm_silu(a, s, b, 4, 1e-6), (x, scale, bias), dims)
    assert not any(kernels.launch_counts().values())


def test_flash_attention_vmap_rule():
    q, k, v = _rand(V, 2, 1, 16, 8, seed=3), _rand(V, 2, 1, 16, 8, seed=4), _rand(V, 2, 1, 16, 8, seed=5)
    _check_rule(flash_attention, (q, k, v), (0, 0, 0))
    # a query shared by every image broadcasts
    _check_rule(flash_attention, (q[0], k, v), (None, 0, 0))


@pytest.mark.parametrize("shared", [True, False], ids=["fold", "per_image"])
def test_conv3x3_vmap_rule(shared):
    x = _rand(V, 2, 6, 7, 4, seed=6)
    wmat = _rand(36, 5, seed=7) if shared else _rand(V, 36, 5, seed=7)
    _check_rule(conv3x3, (x, wmat), (0, None if shared else 0))


def test_vmap_rules_take_other_axes():
    """The vmapped axis anywhere (moved to the front by the rules)."""
    x = _rand(2, V, 5, 6, 8, seed=8)
    got = vmap(lambda a: groupnorm_silu(a, torch.ones(8), torch.zeros(8), 4, 1e-6), in_dims=1)(x)
    want = torch.stack([groupnorm_silu(x[:, i], torch.ones(8), torch.zeros(8), 4, 1e-6)
                        for i in range(V)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    xc, w = _rand(2, 6, 7, 4, V, seed=9), _rand(36, V, 5, seed=10)
    got = vmap(conv3x3, in_dims=(4, 1))(xc, w)
    want = torch.stack([conv3x3(xc[..., i], w[:, i]) for i in range(V)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
