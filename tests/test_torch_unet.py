"""The port's diffusion UNet (``pti_ldm_vae_tpu_torch/models/unet.py``) against
the JAX package's, f32 on the CPU.

Both sides start from the same weights: the JAX init with every leaf
perturbed (so that norm affines and biases matter), carried across by
``unet_state_dict_from_flax`` into MONAI keys and loaded with
``strict=True``. Inputs are numpy arrays from a seed. JAX runs at its highest
matmul precision; on the port's side the GroupNorm+SiLU and flash-attention
wrappers run their plain versions (CPU tensors). Bars: rtol 1e-4, atol 1e-5
for the embedding, each block and the whole toy UNet (channels [8, 16], the
toy size of the JAX package's diffusion CLI tests); the ``slow`` tier holds
the ``config/ldm_dente.json`` architecture at a 16² latent to rtol 1e-4,
atol 1e-4, the bars of the JAX package's own flagship-depth UNet check.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu.checkpoint.unet_convert import unet_expected_torch_keys as jax_expected_keys
from pti_ldm_vae_tpu.checkpoint.unet_convert import unet_from_torch_state_dict
from pti_ldm_vae_tpu.models import unet as jax_unet
from pti_ldm_vae_tpu_torch.checkpoint.unet_convert import (
    canonicalize_torch_key,
    load_diffusion_checkpoint,
    projector_state_dict_from_flax,
    unet_expected_torch_keys,
    unet_monai_layout,
    unet_state_dict_from_flax,
)
from pti_ldm_vae_tpu_torch.models.unet import (
    ConditionProjector,
    DiffusionUNet,
    diffusion_unet_from_config,
    project_latent_condition,
    timestep_embedding,
)

TOL = dict(rtol=1e-4, atol=1e-5)
TOY = dict(spatial_dims=2, in_channels=2, out_channels=2, channels=[8, 16],
           attention_levels=[False, True], num_head_channels=[0, 8], num_res_blocks=1,
           with_conditioning=True, cross_attention_dim=12, norm_num_groups=4)
LDM_DEF = json.loads(open("config/ldm_dente.json").read())["diffusion_def"]


def _perturbed(variables, seed):
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32) for a in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _inputs(cfg, hw, b=2, seq=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, hw, hw, cfg["in_channels"])).astype(np.float32)
    t = np.array([7, 423][:b], dtype=np.int32)
    ctx = rng.normal(size=(b, seq, cfg["cross_attention_dim"])).astype(np.float32)
    return x, t, ctx


def _jax_apply(module, variables, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(module.apply(variables, *(None if a is None else jnp.asarray(a)
                                                    for a in args)))


def _world(cfg, hw, seq, seed):
    jm = jax_unet.diffusion_unet_from_config(cfg)
    x, t, ctx = _inputs(cfg, hw, seq=seq, seed=seed)
    variables = _perturbed(jax.jit(jm.init)(jax.random.key(seed), x, t, ctx), seed)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = diffusion_unet_from_config(cfg)
    model.load_state_dict(unet_state_dict_from_flax(variables, cfg), strict=True)
    return jm, variables, model.eval(), (x, t, ctx)


@pytest.fixture(scope="module")
def toy():
    return _world(TOY, 8, 5, 0)


def _torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("dim", [16, 15, 32], ids=["even", "odd", "ldm"])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 10, 423, 999], dtype=np.int32)
    want = np.asarray(jax_unet.timestep_embedding(jnp.asarray(t), dim))
    got = timestep_embedding(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and got.shape == (5, dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_unet_forward(toy):
    jm, variables, model, (x, t, ctx) = toy
    want = _jax_apply(jm, variables, x, t, ctx)
    with torch.no_grad():
        got = model(*_torch(x, t, ctx))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("t_value", [0, 999])
def test_unet_forward_at_other_timesteps(toy, t_value):
    jm, variables, model, (x, _, ctx) = toy
    t = np.full((2,), t_value, dtype=np.int32)
    want = _jax_apply(jm, variables, x, t, ctx)
    with torch.no_grad():
        got = model(*_torch(x, t, ctx))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _temb(variables, t, ch0):
    """The UNet's time embedding after its MLP, computed in JAX."""
    p = variables["params"]
    e = np.asarray(jax_unet.timestep_embedding(jnp.asarray(t), ch0))
    h = e @ p["time_mlp_1"]["kernel"] + p["time_mlp_1"]["bias"]
    h = h / (1 + np.exp(-h))
    return (h @ p["time_mlp_2"]["kernel"] + p["time_mlp_2"]["bias"]).astype(np.float32)


# (JAX module name, port submodule path, channels in, channels out)
RES_BLOCKS = [("down_0_res_0", ("down_blocks", 0, "resnets", 0), 8, 8),
              ("down_1_res_0", ("down_blocks", 1, "resnets", 0), 8, 16),
              ("up_0_res_1", ("up_blocks", 1, "resnets", 1), 16, 8)]


def _submodule(model, path):
    node = model
    for part in path:
        node = node[part] if isinstance(part, int) else getattr(node, part)
    return node


@pytest.mark.parametrize("name,path,cin,cout", RES_BLOCKS, ids=[r[0] for r in RES_BLOCKS])
def test_time_res_block(toy, name, path, cin, cout):
    _, variables, model, (_, t, _) = toy
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 8, 8, cin)).astype(np.float32)
    temb = _temb(variables, t, TOY["channels"][0])
    block = jax_unet.TimeResBlock(cout, TOY["norm_num_groups"])
    want = _jax_apply(block, {"params": variables["params"][name]}, h, temb)
    with torch.no_grad():
        got = _submodule(model, path)(*_torch(h, temb))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_spatial_transformer(toy):
    _, variables, model, (_, _, ctx) = toy
    h = np.random.default_rng(4).normal(size=(2, 4, 4, 16)).astype(np.float32)
    block = jax_unet.SpatialTransformer(num_heads=2, norm_num_groups=4, cross_attention_dim=12)
    want = _jax_apply(block, {"params": variables["params"]["down_1_attn_0"]}, h, ctx)
    with torch.no_grad():
        got = model.down_blocks[1].attentions[0](*_torch(h, ctx))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("with_context", [True, False], ids=["context", "no_context"])
def test_transformer_block(toy, with_context):
    _, variables, model, (_, _, ctx) = toy
    tokens = np.random.default_rng(5).normal(size=(2, 4, 16)).astype(np.float32)
    block = jax_unet.TransformerBlock(num_heads=2, cross_attention_dim=12)
    params = {"params": variables["params"]["mid_attn"]["block"]}
    context = ctx if with_context else None
    with jax.default_matmul_precision("highest"):
        want = np.asarray(block.apply(params, jnp.asarray(tokens),
                                      None if context is None else jnp.asarray(context)))
    with torch.no_grad():
        got = model.middle_block.attention.transformer_blocks[0](
            torch.from_numpy(tokens), None if context is None else torch.from_numpy(context))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_layer_norm_eps_is_flax_default(toy):
    _, _, model, _ = toy
    norms = [m for m in model.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert norms and all(m.eps == 1e-6 for m in norms)


def _unconditioned_state_dict(variables, cfg):
    """MONAI-keyed state dict of an unconditioned UNet: the conditioned
    layout's tensors without the cross-attention and its norm (the JAX and the
    port's converters both cover conditioned configs only)."""
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    c_of = {}
    for name, sub in params.items():
        if "block" in sub:
            c = sub["block"]["norm1"]["scale"].shape[0]
            c_of[name] = c
            sub["block"].update(
                norm2={"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)},
                attn2_out={"kernel": np.zeros((c, c), np.float32), "bias": np.zeros(c, np.float32)},
                **{f"attn2_{k}": {"kernel": np.zeros((1, c), np.float32)} for k in "qkv"})
    sd = unet_state_dict_from_flax({"params": params}, {**cfg, "with_conditioning": True})
    return {k: v for k, v in sd.items() if ".attn2." not in k and ".transformer_blocks.0.norm2." not in k}


def test_unconditioned_unet():
    cfg = {**TOY, "with_conditioning": False}
    jm = jax_unet.diffusion_unet_from_config(cfg)
    x, t, _ = _inputs(TOY, 8)
    variables = _perturbed(jm.init(jax.random.key(1), x, t, None), 1)
    want = _jax_apply(jm, variables, x, t, None)
    model = diffusion_unet_from_config(cfg).eval()
    model.load_state_dict(_unconditioned_state_dict(variables, cfg), strict=True)
    with torch.no_grad():
        got = model(*_torch(x, t), None)
        ignored = model(*_torch(x, t), torch.ones(2, 3, 12))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, ignored)  # no conditioning: the context is not read


@pytest.mark.parametrize("cfg", [TOY, LDM_DEF], ids=["toy", "ldm_dente"])
def test_state_dict_keys_are_the_layout(cfg):
    keys = unet_expected_torch_keys(cfg)
    assert set(diffusion_unet_from_config(cfg).state_dict()) == set(keys)
    assert keys == jax_expected_keys(cfg)  # the port's copy of the layout is the JAX package's
    assert len(keys) == len(set(keys))


def test_layout_refuses_unconditioned_configs():
    with pytest.raises(NotImplementedError, match="with_conditioning"):
        unet_monai_layout({**TOY, "with_conditioning": False})


def test_condition_projector(toy):
    proj = jax_unet.ConditionProjector(cross_attention_dim=12)
    latent = np.random.default_rng(6).normal(size=(2, 4, 4, 2)).astype(np.float32)
    variables = _perturbed(proj.init(jax.random.key(2), jnp.zeros((1, 16, 2))), 2)
    want = np.asarray(jax_unet.project_latent_condition(
        lambda tokens: proj.apply(variables, tokens), jnp.asarray(latent)))
    port = ConditionProjector(2, 12)
    port.load_state_dict(projector_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables)),
                         strict=True)
    with torch.no_grad():
        got = project_latent_condition(port, torch.from_numpy(latent))
    assert got.shape == (2, 16, 12)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_port_checkpoint_reads_back_in_the_jax_package(toy, tmp_path):
    """A ``.pth`` the port writes (the ``train_diffusion`` layout) loads in
    the JAX package through ``unet_from_torch_state_dict`` and gives the
    same noise prediction."""
    jm, _, model, (x, t, ctx) = toy
    path = tmp_path / "diffusion_last.pth"
    torch.save({"unet": model.state_dict(), "projector": None}, path)
    raw = torch.load(path, map_location="cpu", weights_only=True)["unet"]
    variables = unet_from_torch_state_dict({k: v.numpy() for k, v in raw.items()}, TOY)
    want = _jax_apply(jm, variables, x, t, ctx)
    with torch.no_grad():
        got = model(*_torch(x, t, ctx))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_checkpoint_loader_takes_alternate_spellings_and_refuses_directories(toy, tmp_path):
    _, _, model, _ = toy
    sd = model.state_dict()
    renamed = {k.replace(".to_out.0", ".out_proj").replace(".downsampler.op.conv", ".downsamplers.0.op.conv"): v
               for k, v in sd.items()}
    assert set(renamed) != set(sd)
    assert {canonicalize_torch_key(k) for k in renamed} == set(sd)
    torch.save({"unet": renamed, "projector": {"weight": torch.zeros(12, 2), "bias": torch.zeros(12)}},
               tmp_path / "alt.pth")
    unet_sd, projector_sd = load_diffusion_checkpoint(str(tmp_path / "alt.pth"))
    fresh = diffusion_unet_from_config(TOY)
    fresh.load_state_dict(unet_sd, strict=True)
    assert set(projector_sd) == {"weight", "bias"}
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        load_diffusion_checkpoint(str(tmp_path / "orbax_dir"))


def test_bf16_compute_runs_and_returns_f32(toy):
    _, _, model, (x, t, ctx) = toy
    bf = diffusion_unet_from_config(TOY, compute_dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = bf(*_torch(x, t, ctx))
        want = model(*_torch(x, t, ctx))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 0.1 * float(want.abs().max())


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="spatial_dims"):
        diffusion_unet_from_config({**TOY, "spatial_dims": 3})


def _port_grads(model, x, t, ctx, r):
    xx = torch.from_numpy(x).requires_grad_()
    out = model(xx, *_torch(t, ctx))
    (out * torch.from_numpy(r)).sum().backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return {"out": out.detach(), "x": xx.grad, **grads}


def test_remat_unet_matches_jax(toy):
    """``remat=True`` on both sides: outputs, the input gradient and every
    parameter gradient (atol in units of the larger of 1 and each tensor's
    largest entry)."""
    jm, variables, model, (x, t, ctx) = toy
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    jm_remat = jax_unet.diffusion_unet_from_config(TOY, remat=True)

    def loss(v, xx):
        out = jm_remat.apply(v, xx, jnp.asarray(t), jnp.asarray(ctx))
        return jnp.sum(out * r), out

    with jax.default_matmul_precision("highest"):
        (_, out), (g_vars, g_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            variables, jnp.asarray(x))
    want = {"out": np.asarray(out), "x": np.asarray(g_x),
            **unet_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g_vars), TOY)}
    remat = diffusion_unet_from_config(TOY, remat=True)
    remat.load_state_dict(model.state_dict(), strict=True)
    got = _port_grads(remat, x, t, ctx, r)
    assert set(got) == set(want)
    for key, theirs in want.items():
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(got[key].numpy(), theirs, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(theirs).max())), err_msg=key)


def test_remat_unet_gradients_are_bit_equal(toy, monkeypatch):
    """The checkpointed UNet gives the non-checkpointed one's bits on the CPU,
    its TimeResBlocks and SpatialTransformers recomputed in the backward."""
    import pti_ldm_vae_tpu_torch.models.unet as unet_mod

    _, _, model, (x, t, ctx) = toy
    r = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    want = _port_grads(model, x, t, ctx, r)
    remat = diffusion_unet_from_config(TOY, remat=True)
    remat.load_state_dict(model.state_dict(), strict=True)
    wrapped = []
    real = unet_mod.checkpoint
    monkeypatch.setattr(unet_mod, "checkpoint",
                        lambda block, *a, **k: wrapped.append(type(block).__name__) or real(block, *a, **k))
    got = _port_grads(remat, x, t, ctx, r)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    n_res = sum(len(b.resnets) for b in model.down_blocks) + sum(len(b.resnets) for b in model.up_blocks) + 2
    n_attn = sum(len(b.attentions or []) for b in (*model.down_blocks, *model.up_blocks)) + 1
    assert wrapped.count("TimeResBlock") == n_res and wrapped.count("SpatialTransformer") == n_attn
    with torch.no_grad():
        wrapped.clear()
        remat(*_torch(x, t, ctx))
    assert wrapped == []


@pytest.mark.slow
def test_ldm_dente_architecture_at_16():
    jm, variables, model, (x, t, ctx) = _world(LDM_DEF, 16, 6, 9)
    want = _jax_apply(jm, variables, x, t, ctx)
    with torch.no_grad():
        got = model(*_torch(x, t, ctx))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
