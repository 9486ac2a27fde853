"""Flash attention at head dims the kernels are not built for (CPU).

On CUDA a head dim outside ``SUPPORTED_HEAD_DIMS`` is zero-padded along D to
the next instantiated one, the kernel runs with the softmax scale of the
UNPADDED head dim, and the output is sliced back. Here the same arithmetic
runs through the plain versions (pad, unpadded scale, slice), forward and
through autograd, against the plain versions at D itself; random q, k and v,
because a padded call that kept the padded D's scale would still be right on
zero inputs. Tolerance rtol 1e-4 / atol 1e-5: the same f32 sums in another
order (the padded products add exact zeros).
"""

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
    SUPPORTED_HEAD_DIMS,
    WGMMA_HEAD_DIMS,
    _check,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    forward_kernel,
    pad_head_dim,
    padded_head_dim,
)

TOL = dict(rtol=1e-4, atol=1e-5)


def _qkvg(d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(2, 2, 33, d)), dtype=torch.float32) for _ in range(4)]


def _padded_forward(q, k, v):
    d = q.shape[-1]
    d_pad = padded_head_dim(d)
    out = flash_attention_plain(*(pad_head_dim(t, d_pad) for t in (q, k, v)), scale=d**-0.5)
    return out[..., :d]


@pytest.mark.parametrize("d", [8, 96, 200, 512])
def test_padded_forward_equals_plain_at_d(d):
    q, k, v, _ = _qkvg(d)
    want = flash_attention_plain(q, k, v)
    torch.testing.assert_close(_padded_forward(q, k, v), want, **TOL)
    # the padded D's own scale would be wrong (unless D is instantiated)
    d_pad = padded_head_dim(d)
    if d_pad != d:
        wrong = flash_attention_plain(*(pad_head_dim(t, d_pad) for t in (q, k, v)))[..., :d]
        assert not torch.allclose(wrong, want, **TOL)


@pytest.mark.parametrize("d", [8, 96, 200, 512])
def test_padded_backward_equals_plain_at_d(d):
    q, k, v, g = _qkvg(d, seed=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(_padded_forward(*leaves), leaves, g)
    want = flash_attention_bwd_plain(q, k, v, g)
    for ours, theirs in zip(got, want):
        assert ours.shape == theirs.shape == q.shape  # autograd slices the padded columns
        torch.testing.assert_close(ours, theirs, **TOL)
    # the backward formula at the padded D, unpadded scale, sliced: the kernels' path
    d_pad = padded_head_dim(d)
    padded = flash_attention_bwd_plain(*(pad_head_dim(t, d_pad) for t in (q, k, v, g)),
                                       scale=d**-0.5)
    for ours, theirs in zip(padded, want):
        torch.testing.assert_close(ours[..., :d], theirs, **TOL)
        assert not ours[..., d:].any()  # the zero columns get zero gradients


@pytest.mark.parametrize("d,d_pad", [(1, 16), (8, 16), (16, 16), (17, 32), (96, 128),
                                     (128, 128), (129, 256), (200, 256), (257, 512), (512, 512)])
def test_padded_head_dim_rule(d, d_pad):
    assert padded_head_dim(d) == d_pad and d_pad in SUPPORTED_HEAD_DIMS


def test_head_dims_above_512_raise():
    with pytest.raises(ValueError, match="head dim 513"):
        padded_head_dim(513)


def test_head_dim_96_takes_the_tensor_core_kernels_in_bf16():
    """D = 96 pads to 128, which the bf16 ``wgmma`` kernels take; 512 the FMA ones."""
    assert padded_head_dim(96) in WGMMA_HEAD_DIMS
    assert forward_kernel(torch.bfloat16, padded_head_dim(96)) == "wgmma"
    assert forward_kernel(torch.bfloat16, padded_head_dim(512)) == "fma"
    q = torch.zeros(1, 1, 4, 96)
    with pytest.raises(ValueError, match="pad it first"):
        _check(q, q, q)  # the launch itself takes instantiated head dims only


@pytest.mark.parametrize("d", [8, 96])
def test_cpu_wrapper_runs_the_plain_version_at_d(d):
    """On CPU tensors the wrapper neither pads nor counts a padded launch."""
    q, k, v, g = _qkvg(d, seed=2)
    flash_attention.padded_launches = 0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves)
    torch.testing.assert_close(out, flash_attention_plain(q, k, v), rtol=0, atol=0)
    for ours, theirs in zip(torch.autograd.grad(out, leaves, g),
                            flash_attention_bwd_plain(q, k, v, g)):
        torch.testing.assert_close(ours, theirs, rtol=0, atol=0)
    assert flash_attention.padded_launches == 0
