"""The port's 3x3 convolution (``ops/conv.py`` over ``ops/kernels/conv3x3.py``)
on the CPU, where the wrappers run the kernels' plain versions, against the
JAX package's Pallas ``conv3x3`` run in TPU interpret mode, and a model built
with ``conv_kernel=True`` against the same model on ``F.conv2d`` and against
the JAX model.

Inputs come from a numpy seed. Bars: values and ``dx`` rtol 1e-4 / atol 1e-5,
``dW`` rtol 1e-3 / atol 1e-4 (the bars of the JAX package's own kernel test);
model outputs rtol 1e-4 / atol 1e-5, parameter gradients rtol 1e-3 with atol
1e-4 x the gradient's max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from pti_ldm_vae_tpu.checkpoint.torch_convert import to_torch_state_dict
from pti_ldm_vae_tpu.models.autoencoder_kl import autoencoder_from_config as jax_from_config
from pti_ldm_vae_tpu.ops.pallas.conv2d import conv3x3 as jax_conv3x3
from pti_ldm_vae_tpu_torch.checkpoint.torch_convert import state_dict_from_flax
from pti_ldm_vae_tpu_torch.models.autoencoder_kl import Convolution, autoencoder_from_config
from pti_ldm_vae_tpu_torch.ops import kernels
from pti_ldm_vae_tpu_torch.ops.conv import conv3x3, conv3x3_supported, pack_weight
from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import (
    WGRAD_FMA_SLAB_PIXELS,
    conv3x3_bwd_plain,
    conv3x3_plain,
    flip_transpose,
    wgrad_slabs,
)

# (B, H, W, Cin, Cout): the JAX test's shape, a ragged one, the thin ends
SHAPES = [(2, 32, 32, 8, 16), (1, 20, 12, 3, 5), (2, 16, 16, 1, 8), (2, 16, 16, 8, 1)]
IDS = ["8to16", "ragged_3to5", "cin1", "cout1"]


def _inputs(shape, seed=0):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)  # HWIO
    bias = rng.normal(size=(cout,)).astype(np.float32)
    return x, k, bias


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_conv3x3_matches_jax_pallas_kernel(shape):
    x, k, _ = _inputs(shape)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(k)))
    got = conv3x3(torch.from_numpy(x), _oihw(k))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_conv3x3_gradients_match_jax_pallas_kernel(shape):
    x, k, _ = _inputs(shape, seed=1)

    def loss(xa, ka):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jnp.sin(jax_conv3x3(xa, ka)))

    with pltpu.force_tpu_interpret_mode():
        gx, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_()
    wt = _oihw(k).requires_grad_()
    torch.sin(conv3x3(xt, wt)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    # the filter gradient arrives at the OIHW parameter through the repacking
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(gk),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_conv3x3_with_bias_matches_torch_conv2d(shape):
    x, k, bias = _inputs(shape, seed=2)
    leaves = [torch.from_numpy(x).requires_grad_(), _oihw(k).requires_grad_(),
              torch.from_numpy(bias).requires_grad_()]
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(*x.shape[:3], k.shape[3]))
                         .astype(np.float32))
    got = conv3x3(*leaves)
    want = F.conv2d(leaves[0].permute(0, 3, 1, 2), leaves[1], leaves[2], padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    ours, theirs = torch.autograd.grad(got, leaves, g), torch.autograd.grad(want, leaves, g)
    torch.testing.assert_close(ours[0], theirs[0], rtol=1e-4, atol=1e-5)
    # sums over B*H*W pixels: the filter gradient's bars, and the bias gradient's too
    torch.testing.assert_close(ours[1], theirs[1], rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(ours[2], theirs[2], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_backward_plain_formulas_match_autograd_of_the_plain_forward(shape):
    b, h, w, cin, cout = shape
    x, k, _ = _inputs(shape, seed=4)
    xt = torch.from_numpy(x).requires_grad_()
    wmat = pack_weight(_oihw(k)).contiguous().requires_grad_()
    g = torch.from_numpy(np.random.default_rng(5).normal(size=(b, h, w, cout)).astype(np.float32))
    want_dx, want_dw = torch.autograd.grad(conv3x3_plain(xt, wmat), (xt, wmat), g)
    dx, dw = conv3x3_bwd_plain(xt.detach(), wmat.detach(), g)
    torch.testing.assert_close(dx, want_dx, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4, atol=1e-4)
    # flipping and transposing twice gives the matrix back
    again = flip_transpose(flip_transpose(wmat.detach(), cin, cout), cout, cin)
    assert torch.equal(again, wmat.detach())


def test_bf16_rounds_operands_once_and_keeps_the_filter_gradient_in_f32():
    x, k, _ = _inputs((2, 16, 16, 8, 16), seed=6)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = _oihw(k).requires_grad_()
    y = conv3x3(xt, wt)
    assert y.dtype == torch.bfloat16
    want = F.conv2d(xt.detach().float().permute(0, 3, 1, 2), wt.detach().bfloat16().float(),
                    padding=1).permute(0, 2, 3, 1)
    # one bf16 rounding of outputs of size ~1
    torch.testing.assert_close(y.float(), want, rtol=0, atol=2e-2)
    y.float().sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    assert torch.isfinite(wt.grad).all() and float(wt.grad.abs().max()) > 0


def test_plain_versions_count_no_launch_and_strided_inputs_are_taken():
    kernels.reset_launch_counts()
    x = torch.randn(2, 12, 10, 4).transpose(1, 2)  # a strided [2, 10, 12, 4] view
    w = torch.randn(6, 4, 3, 3, requires_grad=True)
    y = conv3x3(x, w)
    y.sum().backward()
    want = F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)
    counts = kernels.launch_counts()
    assert counts["conv3x3"] == 0 and counts["conv3x3_wgrad"] == 0
    assert set(counts) == {"groupnorm_silu", "groupnorm_silu_bwd", "flash_attention",
                           "flash_attention_bwd", "conv3x3", "conv3x3_wgrad"}


@pytest.mark.parametrize("x_shape,w_shape,ok", [
    ((2, 8, 8, 4), (6, 4, 3, 3), True),
    ((1, 3, 300, 1), (32, 1, 3, 3), True),     # no size limit: the kernels tile the image
    ((2, 8, 8, 4), (6, 4, 1, 1), False),       # 1x1
    ((2, 8, 8, 4), (6, 4, 4, 4), False),       # 4x4
    ((2, 8, 8, 8, 4), (6, 4, 3, 3), False),    # 3-D input
    ((2, 8, 8, 5), (6, 4, 3, 3), False),       # channel mismatch
], ids=["3x3", "huge_thin", "1x1", "4x4", "rank5", "channels"])
def test_conv3x3_supported(x_shape, w_shape, ok):
    assert conv3x3_supported(x_shape, w_shape) is ok
    if not ok:
        with pytest.raises(ValueError, match="conv3x3 takes"):
            conv3x3(torch.zeros(x_shape), torch.zeros(w_shape))


def test_wrapper_refuses_what_the_kernels_do_not_take():
    from pti_ldm_vae_tpu_torch.ops.kernels import conv3x3 as kernel_conv3x3

    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernel_conv3x3(torch.zeros(1, 4, 4, 2, dtype=torch.float64), torch.zeros(18, 3))
    with pytest.raises(ValueError, match=r"wmat \[9\*Cin, Cout\]"):
        kernel_conv3x3(torch.zeros(1, 4, 4, 2), torch.zeros(9, 3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel_conv3x3(torch.zeros(1, 4, 4, 2, device="meta"), torch.zeros(18, 3, device="meta"))


@pytest.mark.parametrize("x_shape,cout", [
    ((8, 256, 256, 32), 32), ((8, 256, 256, 1), 32), ((8, 256, 256, 32), 1),
    ((8, 32, 32, 128), 128), ((8, 32, 32, 4), 128), ((1, 20, 12, 3), 5), ((1, 4, 4, 1), 1),
])
def test_wgrad_slabs_fill_the_card_within_the_partials_budget(x_shape, cout):
    b, h, w, cin = x_shape
    n_tiles = b * -(-h // 4) * -(-w // 32)
    n_slab = wgrad_slabs(x_shape, cout, 132)
    assert 1 <= n_slab <= n_tiles
    assert n_slab * 9 * cin * cout * 4 <= 16 * 2**20
    per = -(-n_tiles // n_slab)
    assert (n_slab - 1) * per < n_tiles <= n_slab * per  # every slab holds a tile


@pytest.mark.parametrize("x_shape,cout", [
    ((8, 128, 128, 256), 256), ((8, 64, 64, 256), 256), ((8, 256, 256, 128), 128),
    ((8, 256, 256, 64), 64), ((8, 128, 128, 128), 128), ((8, 64, 64, 10), 256),
    ((1, 256, 256, 64), 64),
])
def test_wgrad_slabs_keep_f32_chains_within_the_pixel_cap(x_shape, cout):
    """The f32-FMA filter gradient sums a slab's pixels one after another: at
    the 64-128-256 AR model's shapes (and the flagship's) no slab holds more
    than WGRAD_FMA_SLAB_PIXELS pixels, whatever the partial sums then take."""
    b, h, w, cin = x_shape
    n_slab = wgrad_slabs(x_shape, cout, 132)
    n_tiles = b * -(-h // 4) * -(-w // 32)
    per_slab = -(-n_tiles // n_slab) * 4 * 32  # whole 4 x 32 tiles a slab
    assert per_slab <= WGRAD_FMA_SLAB_PIXELS or n_slab == n_tiles
    assert n_slab <= n_tiles


# ------------------------------------------------------------------ the model
TOY = dict(
    spatial_dims=2, in_channels=1, out_channels=1, latent_channels=3,
    channels=[8, 16], num_res_blocks=1, norm_num_groups=4, norm_eps=1e-6,
    attention_levels=[False, True],
    with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True,
)


@pytest.fixture(scope="module")
def toy():
    jax_model = jax_from_config(TOY, use_pallas_attention=False, s2d_stem=False)
    variables = jax.jit(jax_model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 1)),
                                        jax.random.key(1))
    rng = np.random.default_rng(7)
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    leaves = [np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32) for a in leaves]
    variables = jax.tree_util.tree_unflatten(treedef, leaves)
    x = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    eps = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    g = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)

    def jax_loss(params):
        z_mu, z_sigma = jax_model.apply(params, jnp.asarray(x), method=jax_model.encode)
        recon = jax_model.apply(params, z_mu + jnp.asarray(eps) * z_sigma, method=jax_model.decode)
        return jnp.sum(recon * jnp.asarray(g)), recon

    (_, recon), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables)
    sd = state_dict_from_flax(variables, TOY)
    return dict(sd=sd, x=torch.from_numpy(x), eps=torch.from_numpy(eps), g=torch.from_numpy(g),
                jax_recon=np.asarray(recon),
                jax_grads=to_torch_state_dict(jax.tree_util.tree_map(np.asarray, grads), TOY))


def _run(toy, conv_kernel):
    model = autoencoder_from_config(TOY, conv_kernel=conv_kernel)
    model.load_state_dict(toy["sd"], strict=True)
    recon, _, _ = model(toy["x"], toy["eps"])
    (recon * toy["g"]).sum().backward()
    return model, recon.detach(), {k: p.grad for k, p in model.named_parameters()}


def test_model_with_conv_kernel_has_the_same_state_dict_and_routes_the_3x3_convs(toy):
    plain = autoencoder_from_config(TOY)
    ours = autoencoder_from_config(TOY, conv_kernel=True)
    assert list(plain.state_dict()) == list(ours.state_dict())
    assert set(ours.state_dict()) == set(toy["sd"])
    routed = {name for name, m in ours.named_modules() if isinstance(m, Convolution) and m.conv_kernel}
    every = {name: m for name, m in ours.named_modules() if isinstance(m, Convolution)}
    for name, m in every.items():
        is_3x3_same = (m.conv.kernel_size, m.conv.stride, m.conv.padding) == ((3, 3), (1, 1), (1, 1))
        assert (name in routed) is is_3x3_same, name
    # the 1x1 skips, the stride-2 downsample and the quant convolutions stay with the library
    assert {"quant_conv_mu", "post_quant_conv", "encoder.blocks.2.conv"} <= set(every) - routed
    assert not any(m.conv_kernel for m in plain.modules() if isinstance(m, Convolution))


def test_flagship_routes_47_convolutions():
    flagship = dict(TOY, latent_channels=4, channels=[32, 64, 128, 128], num_res_blocks=2,
                    norm_num_groups=16, attention_levels=[False] * 4)
    with torch.device("meta"):
        model = autoencoder_from_config(flagship, conv_kernel=True)
    count = lambda part: sum(m.conv_kernel for m in part.modules() if isinstance(m, Convolution))
    assert (count(model.encoder), count(model.decoder)) == (22, 25)


def test_model_forward_matches_with_and_without_conv_kernel_and_jax(toy):
    _, with_kernel, _ = _run(toy, True)
    _, without, _ = _run(toy, False)
    torch.testing.assert_close(with_kernel, without, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(with_kernel.numpy(), toy["jax_recon"], rtol=1e-4, atol=1e-5)


def test_model_parameter_gradients_match_with_and_without_conv_kernel_and_jax(toy):
    _, _, with_kernel = _run(toy, True)
    _, _, without = _run(toy, False)
    assert set(with_kernel) == set(without) == set(toy["jax_grads"])
    for key, theirs in toy["jax_grads"].items():
        if key.endswith("to_k.bias"):  # gradient 0 in exact arithmetic: rounding noise
            continue
        atol = 1e-4 * float(np.abs(theirs).max())
        np.testing.assert_allclose(with_kernel[key].numpy(), theirs, rtol=1e-3, atol=atol,
                                   err_msg=key)
        np.testing.assert_allclose(with_kernel[key].numpy(), without[key].numpy(), rtol=1e-3,
                                   atol=atol, err_msg=key)


def test_inference_cli_and_loader_pass_the_field_through(tmp_path):
    from pti_ldm_vae_tpu_torch.cli.inference_vae import parse_args
    from pti_ldm_vae_tpu_torch.utils.vae_loader import load_vae_model

    model = autoencoder_from_config(TOY)
    torch.save(model.state_dict(), tmp_path / "w.pth")
    loaded = load_vae_model({"autoencoder_def": TOY}, str(tmp_path / "w.pth"), device="cpu",
                            conv_kernel=True)
    assert loaded.conv_kernel and loaded.encoder.blocks[0].conv_kernel
    assert not load_vae_model({"autoencoder_def": TOY}, str(tmp_path / "w.pth"),
                              device="cpu").conv_kernel
    args = parse_args(["-c", "x", "--checkpoint", "y", "--input-dir", "z", "--conv-kernel"])
    assert args.conv_kernel


@pytest.mark.slow
def test_flagship_depth_conv_kernel_matches_library_convs_at_64():
    """Flagship depth and width at a 64x64 input: the reconstruction and a
    few parameter gradients agree between the two convolution paths."""
    flagship = dict(TOY, latent_channels=4, channels=[32, 64, 128, 128], num_res_blocks=2,
                    norm_num_groups=16, attention_levels=[False] * 4)
    torch.manual_seed(0)
    plain = autoencoder_from_config(flagship)
    ours = autoencoder_from_config(flagship, conv_kernel=True)
    ours.load_state_dict(plain.state_dict(), strict=True)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(1, 64, 64, 1)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
    outs = []
    for model in (plain, ours):
        recon, _, _ = model(x, eps)
        recon.square().mean().backward()
        outs.append(recon.detach())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-5)
    for key in ("encoder.blocks.0.conv.weight", "decoder.blocks.0.conv.weight",
                "decoder.blocks.8.conv1.conv.weight"):
        a, b = dict(ours.named_parameters())[key].grad, dict(plain.named_parameters())[key].grad
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4 * float(b.abs().max()))
