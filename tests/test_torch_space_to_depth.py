"""The port's space-to-depth transforms (``pti_ldm_vae_tpu_torch/ops/space_to_depth.py``)
against the JAX package's (``pti_ldm_vae_tpu/ops/space_to_depth.py``), the
cases of ``tests/test_space_to_depth.py`` on the port's layouts (NHWC tensors,
OIHW weights), f32 on the CPU: the phase layout and its roundtrip, each
weight transform against the JAX one (HWIO <-> OIHW), the 3x3 / 1x1 /
downsample equivalences, the phase repeat as nearest upsampling, GroupNorm
with repeated affines, a whole level-0 stack, the filter gradient reaching
the canonical weight, and the port's own ``"auto"`` policy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pti_ldm_vae_tpu.ops import space_to_depth as jax_s2d
from pti_ldm_vae_tpu_torch.ops import space_to_depth as s2d
from pti_ldm_vae_tpu_torch.ops.conv import conv3x3
from pti_ldm_vae_tpu_torch.ops.norm import group_norm, group_norm_silu

TOL = dict(rtol=1e-4, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _conv(x, w, *, stride=1, padding):
    """NHWC ``x``, OIHW ``w`` -> NHWC, through ``F.conv2d``."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=padding).permute(0, 2, 3, 1)


def _hwio(w: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(w.transpose(2, 3, 1, 0))


def _oihw(w) -> np.ndarray:
    return np.asarray(w).transpose(3, 2, 0, 1)


def test_roundtrip_and_layout_match_the_jax_package():
    x = _rand(np.random.default_rng(0), 2, 8, 6, 3)
    got = s2d.space_to_depth(torch.from_numpy(x))
    assert got.shape == (2, 4, 3, 12) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_s2d.space_to_depth(jnp.asarray(x))))
    # channel c*4 + (2a+b) holds pixel (2i+a, 2j+b) of channel c
    assert got[0, 1, 1, 2 * 4 + 2 * 1 + 0] == x[0, 3, 2, 2]
    back = s2d.depth_to_space(got)
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), x)
    y = _rand(np.random.default_rng(1), 2, 4, 3, 12)
    np.testing.assert_array_equal(s2d.depth_to_space(torch.from_numpy(y)).numpy(),
                                  np.asarray(jax_s2d.depth_to_space(jnp.asarray(y))))


def test_odd_sizes_are_refused():
    with pytest.raises(ValueError, match="even H, W"):
        s2d.space_to_depth(torch.zeros(1, 5, 4, 2))
    with pytest.raises(ValueError, match="% 4"):
        s2d.depth_to_space(torch.zeros(1, 2, 2, 6))


@pytest.mark.parametrize("kind,shape", [("3x3", (7, 5, 3, 3)), ("1x1", (4, 6, 1, 1)),
                                        ("down", (7, 5, 3, 3))])
def test_weight_transform_matches_the_jax_one(kind, shape):
    w = _rand(np.random.default_rng(2), *shape)
    port_fn, jax_fn = {
        "3x3": (s2d.s2d_conv3x3_kernel, jax_s2d.s2d_conv3x3_kernel),
        "1x1": (s2d.s2d_conv1x1_kernel, jax_s2d.s2d_conv1x1_kernel),
        "down": (s2d.s2d_downsample_kernel, jax_s2d.s2d_downsample_kernel),
    }[kind]
    got = port_fn(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), _oihw(jax_fn(_hwio(w))))


def test_conv3x3_equivalence():
    rng = np.random.default_rng(3)
    x, w = torch.from_numpy(_rand(rng, 2, 16, 12, 5)), torch.from_numpy(_rand(rng, 7, 5, 3, 3))
    want = _conv(x, w, padding=1)
    got = s2d.depth_to_space(_conv(s2d.space_to_depth(x), s2d.s2d_conv3x3_kernel(w), padding=1))
    torch.testing.assert_close(got, want, **TOL)


def test_conv1x1_equivalence():
    rng = np.random.default_rng(4)
    x, w = torch.from_numpy(_rand(rng, 2, 8, 8, 6)), torch.from_numpy(_rand(rng, 4, 6, 1, 1))
    got = s2d.depth_to_space(_conv(s2d.space_to_depth(x), s2d.s2d_conv1x1_kernel(w), padding=0))
    torch.testing.assert_close(got, _conv(x, w, padding=0), **TOL)


def test_downsample_equivalence_leaves_the_domain():
    """pad (0,1) + VALID 3x3 stride 2 == pad (0,1) + VALID 2x2 stride 1 on the
    s2d tensor, at half resolution and the canonical channel count."""
    rng = np.random.default_rng(5)
    x, w = torch.from_numpy(_rand(rng, 2, 16, 12, 5)), torch.from_numpy(_rand(rng, 7, 5, 3, 3))
    want = _conv(F.pad(x, (0, 0, 0, 1, 0, 1)), w, stride=2, padding=0)
    got = _conv(F.pad(s2d.space_to_depth(x), (0, 0, 0, 1, 0, 1)), s2d.s2d_downsample_kernel(w),
                padding=0)
    assert got.shape == want.shape == (2, 8, 6, 7)
    torch.testing.assert_close(got, want, **TOL)


def test_repeat_channels_is_nearest_upsample():
    x = torch.from_numpy(_rand(np.random.default_rng(6), 2, 4, 4, 3))
    up = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    np.testing.assert_array_equal(s2d.depth_to_space(s2d.s2d_repeat_channels(x)).numpy(), up.numpy())
    np.testing.assert_array_equal(s2d.s2d_repeat_channels(x).numpy(),
                                  np.asarray(jax_s2d.s2d_repeat_channels(jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("silu", [False, True], ids=["group_norm", "group_norm_silu"])
def test_groupnorm_equivalence(silu):
    """The same ``num_groups`` on the s2d tensor, affines repeated 4x,
    reproduces full-resolution GroupNorm (the plain versions of the kernel on
    the CPU for ``group_norm_silu``)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_rand(rng, 2, 8, 8, 8))
    scale, bias = torch.from_numpy(_rand(rng, 8)), torch.from_numpy(_rand(rng, 8))
    fn = group_norm_silu if silu else group_norm
    want = fn(x, scale, bias, num_groups=4, eps=1e-6)
    got = s2d.depth_to_space(fn(s2d.space_to_depth(x), s2d.s2d_repeat_channels(scale),
                                s2d.s2d_repeat_channels(bias), num_groups=4, eps=1e-6))
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("size", [(16, 12), (8, 8)])
def test_stacked_level_equivalence(size):
    """conv_in -> [GN+SiLU -> conv3x3] x2 + skip -> downsample, all in the
    s2d domain, against the full-resolution stack."""
    rng = np.random.default_rng(8)
    h, w = size
    x = torch.from_numpy(_rand(rng, 2, h, w, 1))
    w_in, w1, w2, wd = (torch.from_numpy(_rand(rng, 8, cin, 3, 3, scale=0.3))
                        for cin in (1, 8, 8, 8))
    g, b = torch.ones(8), torch.zeros(8)

    def full(x):
        h0 = _conv(x, w_in, padding=1)
        h1 = _conv(group_norm_silu(h0, g, b, num_groups=4), w1, padding=1)
        h1 = _conv(group_norm_silu(h1, g, b, num_groups=4), w2, padding=1)
        return _conv(F.pad(h0 + h1, (0, 0, 0, 1, 0, 1)), wd, stride=2, padding=0)

    def s2d_form(x):
        g4, b4 = s2d.s2d_repeat_channels(g), s2d.s2d_repeat_channels(b)
        h0 = _conv(s2d.space_to_depth(x), s2d.s2d_conv3x3_kernel(w_in), padding=1)
        h1 = _conv(group_norm_silu(h0, g4, b4, num_groups=4), s2d.s2d_conv3x3_kernel(w1), padding=1)
        h1 = _conv(group_norm_silu(h1, g4, b4, num_groups=4), s2d.s2d_conv3x3_kernel(w2), padding=1)
        return _conv(F.pad(h0 + h1, (0, 0, 0, 1, 0, 1)), s2d.s2d_downsample_kernel(wd), padding=0)

    torch.testing.assert_close(s2d_form(x), full(x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["3x3", "1x1", "down"])
def test_canonical_weight_gradient_equals_the_standard_ones(kind):
    """The gather's backward hands the canonical OIHW parameter the filter
    gradient of the standard convolution (the structural zeros take none)."""
    rng = np.random.default_rng(9)
    k = 1 if kind == "1x1" else 3
    x = torch.from_numpy(_rand(rng, 2, 8, 10, 5))
    w = torch.from_numpy(_rand(rng, 6, 5, k, k)).requires_grad_()
    if kind == "down":
        out_std = _conv(F.pad(x, (0, 0, 0, 1, 0, 1)), w, stride=2, padding=0)
        out_s2d = _conv(F.pad(s2d.space_to_depth(x), (0, 0, 0, 1, 0, 1)),
                        s2d.s2d_downsample_kernel(w), padding=0)
    else:
        fn, pad = (s2d.s2d_conv3x3_kernel, 1) if kind == "3x3" else (s2d.s2d_conv1x1_kernel, 0)
        out_std = _conv(x, w, padding=pad)
        out_s2d = s2d.depth_to_space(_conv(s2d.space_to_depth(x), fn(w), padding=pad))
    g = torch.from_numpy(_rand(rng, *out_std.shape))
    (want,) = torch.autograd.grad(out_std, w, g)
    (got,) = torch.autograd.grad(out_s2d, w, g)
    torch.testing.assert_close(got, want, **TOL)


def test_s2d_convolution_through_the_kernel_wrapper():
    """``ops/conv.py:conv3x3`` (the convolution kernels' plain versions on the
    CPU) takes the transformed weight and bias as it takes a standard one."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(_rand(rng, 2, 8, 8, 3))
    w, bias = torch.from_numpy(_rand(rng, 5, 3, 3, 3)), torch.from_numpy(_rand(rng, 5))
    want = _conv(x, w, padding=1) + bias
    got = conv3x3(s2d.space_to_depth(x), s2d.s2d_conv3x3_kernel(w), s2d.s2d_repeat_channels(bias))
    torch.testing.assert_close(s2d.depth_to_space(got), want, **TOL)


def test_auto_mode_policy_takes_the_standard_path_on_the_h100():
    """The port's ``"auto"``: the JAX rules on the H100 thresholds, which are
    0 until an H100 A/B sets them (the JAX package's v5e thresholds stay its
    own: ``tests/test_space_to_depth.py``)."""
    assert (s2d.S2D_AUTO_TRAIN_ENCODER_MAX_BATCH, s2d.S2D_AUTO_INFER_ENCODER_MAX_BATCH,
            s2d.S2D_AUTO_INFER_DECODER_MAX_BATCH) == (0, 0, 0)
    for batch in (None, 1, 8, 32, 64, 128):
        assert s2d.s2d_auto_mode("train", batch) is False
        assert s2d.s2d_auto_mode("inference", batch) is False
    with pytest.raises(ValueError):
        s2d.s2d_auto_mode("sampling", 8)


@pytest.mark.parametrize("thresholds,batch,want", [
    ((64, 64, 32), 8, (("train", "encoder"), ("inference", True))),
    ((64, 64, 32), 64, (("train", "encoder"), ("inference", "encoder"))),
    ((64, 64, 32), 128, (("train", False), ("inference", False))),
    ((64, 64, 32), None, (("train", False), ("inference", "encoder"))),
    ((0, 0, 16), 8, (("train", False), ("inference", "decoder"))),
], ids=["v5e_b8", "v5e_b64", "v5e_b128", "v5e_unknown", "decoder_only"])
def test_auto_mode_rules_match_the_jax_function(monkeypatch, thresholds, batch, want):
    """With the JAX package's v5e thresholds set, the port's rules give the
    JAX function's answers (and the one-side forms where thresholds differ)."""
    names = ("S2D_AUTO_TRAIN_ENCODER_MAX_BATCH", "S2D_AUTO_INFER_ENCODER_MAX_BATCH",
             "S2D_AUTO_INFER_DECODER_MAX_BATCH")
    for name, value in zip(names, thresholds):
        monkeypatch.setattr(s2d, name, value)
    for workload, mode in want:
        assert s2d.s2d_auto_mode(workload, batch) == mode
        if thresholds == (64, 64, 32):
            assert jax_s2d.s2d_auto_mode(workload, batch) == mode


def test_index_built_under_inference_mode_serves_autograd_later():
    """The first transform of a process may run under ``inference_mode`` (an
    inference CLI, a reconstruct) and a train step after it: the cached gather
    index must be a normal tensor."""
    s2d._s2d_index.cache_clear()
    w = torch.from_numpy(_rand(np.random.default_rng(11), 4, 3, 3, 3))
    with torch.inference_mode():
        s2d.s2d_conv3x3_kernel(w)
    w.requires_grad_()
    s2d.s2d_conv3x3_kernel(w).sum().backward()
    assert w.grad is not None and float(w.grad.abs().sum()) > 0
