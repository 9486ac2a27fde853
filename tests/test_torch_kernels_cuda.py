"""The port's hand-written kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; they skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so it also runs on a CUDA machine without
them, from the repository root:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda

Tolerances: f32 atol 1e-5 / rtol 1e-4 (summation order); bf16 against the
plain f32 version on the same bf16-rounded inputs, atol 2e-2 (one bf16
rounding of outputs up to ~6). Backward: the same bars for ``dx``, ``dq``,
``dk`` and ``dv``; ``dscale`` and ``dbias`` are f32 sums over B*H*W terms of
size ~1, held to rtol 1e-4 with atol 1e-5 * sqrt(B*H*W) (rounding of a sum
grows with the root of its length), and so is the convolution's filter
gradient ``dW``. Every backward runs twice and must give the same bits: the
kernels use no float atomics. The convolution's weights are scaled by
(9*Cin)^-0.5, as an initializer would, and its upstream gradient by
(Cin/Cout)^0.5, so that outputs and input gradients are of size ~1 (one bf16
rounding of a value of 16 is already 0.06). bf16 inputs take the tensor-core
kernels (``wgmma``) wherever the wrappers' rules send them there, and the
f32-FMA kernels otherwise; the tensor-core flash forward also rounds ``p`` to
bf16 between its products, which the same bf16 bar covers.
"""

import pytest
import torch

from pti_ldm_vae_tpu_torch.ops.kernels import (
    conv3x3,
    conv3x3_bwd_plain,
    conv3x3_plain,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    groupnorm_silu,
    groupnorm_silu_bwd_plain,
    groupnorm_silu_plain,
    launch_counts,
    reset_launch_counts,
)
from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import forward_kernel as conv_forward_kernel
from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _plain_forward

# every head dim at a whole and a ragged number of tiles, and the two older shapes
FLASH_SHAPES = [(2, 1, 1024, 128), (2, 2, 1000, 64), (1, 3, 77, 32), (1, 1, 5, 16),
                *((2, 1, s, d) for d in (16, 32, 64, 128) for s in (1024, 200))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    # the plain versions are the f32 yardstick: cuDNN would run their f32
    # convolutions in TF32 (about three decimal digits) unless told not to
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_silu_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for b, h, w, c in [(2, 64, 64, 32), (3, 17, 9, 48), (8, 32, 32, 128)]:
        x = torch.randn(b, h, w, c, device=cuda, generator=gen).to(dtype)
        # affine near identity, as in a trained GroupNorm: outputs stay below ~6,
        # where one bf16 rounding is within the 2e-2 bar
        scale = 1.0 + 0.1 * torch.randn(c, device=cuda, generator=gen)
        bias = 0.1 * torch.randn(c, device=cuda, generator=gen)
        got = groupnorm_silu(x, scale, bias, 16 if c % 16 == 0 else 4, 1e-6)
        want = groupnorm_silu_plain(x.float(), scale, bias, 16 if c % 16 == 0 else 4, 1e-6)
        tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=0, atol=2e-2)
        torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    for shape in FLASH_SHAPES:
        q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype) for _ in range(3))
        got = flash_attention(q, k, v)
        assert torch.equal(got, flash_attention(q, k, v))  # two runs, the same bits
        want = flash_attention_plain(q.float(), k.float(), v.float())
        tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=0, atol=2e-2)
        torch.testing.assert_close(got.float(), want, **tol)


def _tol(dtype):
    return dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=0, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_silu_backward_kernels_match_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    for b, h, w, c in [(2, 64, 64, 32), (3, 17, 9, 48), (8, 32, 32, 128)]:
        groups = 16 if c % 16 == 0 else 4
        x = torch.randn(b, h, w, c, device=cuda, generator=gen).to(dtype).requires_grad_()
        scale = (1.0 + 0.1 * torch.randn(c, device=cuda, generator=gen)).requires_grad_()
        bias = (0.1 * torch.randn(c, device=cuda, generator=gen)).requires_grad_()
        # a strided upstream gradient, as autograd hands one over after a permute
        g = torch.randn(b, w, h, c, device=cuda, generator=gen).to(dtype).transpose(1, 2)
        reset_launch_counts()
        y = groupnorm_silu(x, scale, bias, groups, 1e-6)
        dx, dscale, dbias = torch.autograd.grad(y, (x, scale, bias), g)
        counts = launch_counts()
        assert (counts["groupnorm_silu"], counts["groupnorm_silu_bwd_reduce"],
                counts["groupnorm_silu_bwd_dx"]) == (1, 1, 1)
        _, mean_g, inv_g = _plain_forward(x.detach().float(), scale.detach(), bias.detach(),
                                          groups, 1e-6)
        want = groupnorm_silu_bwd_plain(x.detach().float(), scale.detach(), bias.detach(),
                                        mean_g, inv_g, g.float(), groups)
        torch.testing.assert_close(dx.float(), want[0], **_tol(dtype))
        sum_tol = dict(rtol=1e-4, atol=1e-5 * (b * h * w) ** 0.5)
        torch.testing.assert_close(dscale, want[1], **sum_tol)
        torch.testing.assert_close(dbias, want[2], **sum_tol)
        again = torch.autograd.grad(groupnorm_silu(x, scale, bias, groups, 1e-6),
                                    (x, scale, bias), g)
        for first, second in zip((dx, dscale, dbias), again):
            assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    for shape in FLASH_SHAPES:  # the backward reads the logsumexp the forward kernel wrote
        q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype).requires_grad_()
                   for _ in range(3))
        b, h, s, d = shape
        g = torch.randn(b, s, h, d, device=cuda, generator=gen).to(dtype).transpose(1, 2)
        reset_launch_counts()
        got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
        counts = launch_counts()
        assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (1, 1)
        want = flash_attention_bwd_plain(q.detach().float(), k.detach().float(),
                                         v.detach().float(), g.float())
        for ours, theirs in zip(got, want):
            torch.testing.assert_close(ours.float(), theirs, **_tol(dtype))
        again = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
        for first, second in zip(got, again):
            assert torch.equal(first, second)


@pytest.mark.cuda
def test_no_gradient_saves_nothing_and_counts_no_backward(cuda):
    x = torch.randn(2, 16, 16, 32, device=cuda)
    scale, bias = torch.ones(32, device=cuda, requires_grad=True), torch.zeros(32, device=cuda)
    reset_launch_counts()
    with torch.no_grad():
        y = groupnorm_silu(x, scale, bias, 16, 1e-6)
    assert not y.requires_grad and y.grad_fn is None
    assert launch_counts()["groupnorm_silu"] == 1


# (B, H, W, Cin, Cout): a res-block conv, a ragged image with odd channel
# counts (the FMA kernel in bf16 too), the thin ends (Cin=1, Cout=1, Cout=4 /
# Cin=4), a wide bottleneck conv, and a ragged image whose channels (24 -> 40)
# the tensor-core kernel takes, at batch 8 (its widest tile) and batch 1
CONV_SHAPES = [(2, 64, 64, 32, 32), (1, 20, 12, 3, 5), (2, 40, 70, 1, 32), (2, 33, 31, 32, 1),
               (3, 32, 32, 128, 4), (2, 32, 32, 4, 128), (2, 32, 32, 128, 128), (1, 16, 48, 64, 96),
               (2, 37, 70, 24, 40), (8, 37, 70, 24, 40), (8, 64, 64, 64, 128)]


def _conv_inputs(shape, dtype, device, gen):
    b, h, w, cin, cout = shape
    x = torch.randn(b, h, w, cin, device=device, generator=gen).to(dtype)
    wmat = torch.randn(9 * cin, cout, device=device, generator=gen) * (9 * cin) ** -0.5
    return x, wmat


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(4)
    for shape in CONV_SHAPES:
        x, wmat = _conv_inputs(shape, dtype, cuda, gen)
        reset_launch_counts()
        # a strided input, as the nearest upsample hands one over
        got = conv3x3(x.transpose(1, 2).contiguous().transpose(1, 2), wmat)
        assert launch_counts()["conv3x3"] == 1 and got.dtype == dtype and got.is_contiguous()
        assert torch.equal(got, conv3x3(x, wmat))  # two runs, the same bits
        want = conv3x3_plain(x.float(), wmat.to(dtype).float())
        torch.testing.assert_close(got.float(), want, **_tol(dtype), msg=lambda m: f"{shape}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_backward_kernels_match_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    for shape in CONV_SHAPES:
        b, h, w, cin, cout = shape
        x, wmat = _conv_inputs(shape, dtype, cuda, gen)
        x.requires_grad_()
        wmat.requires_grad_()
        g = (torch.randn(b, w, h, cout, device=cuda, generator=gen) * (cin / cout) ** 0.5
             ).to(dtype).transpose(1, 2)
        reset_launch_counts()
        dx, dw = torch.autograd.grad(conv3x3(x, wmat), (x, wmat), g)
        counts = launch_counts()
        assert (counts["conv3x3"], counts["conv3x3_wgrad"]) == (2, 1)  # forward + dgrad, wgrad
        assert dx.dtype == dtype and dw.dtype == torch.float32 and dw.shape == wmat.shape
        want_dx, want_dw = conv3x3_bwd_plain(x.detach().float(), wmat.detach().to(dtype).float(),
                                             g.float())
        torch.testing.assert_close(dx.float(), want_dx, **_tol(dtype), msg=lambda m: f"{shape}: {m}")
        torch.testing.assert_close(dw, want_dw, rtol=1e-4, atol=1e-5 * (b * h * w) ** 0.5,
                                   msg=lambda m: f"{shape}: {m}")
        again = torch.autograd.grad(conv3x3(x, wmat), (x, wmat), g)
        assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


@pytest.mark.cuda
def test_conv3x3_skips_the_gradients_nobody_wants(cuda):
    x = torch.randn(2, 16, 16, 8, device=cuda)
    wmat = (torch.randn(72, 8, device=cuda) / 8).requires_grad_()
    reset_launch_counts()
    conv3x3(x, wmat).sum().backward()
    counts = launch_counts()
    assert (counts["conv3x3"], counts["conv3x3_wgrad"]) == (1, 1)  # no input gradient
    with torch.no_grad():
        assert conv3x3(x, wmat).grad_fn is None


@pytest.mark.cuda
def test_bf16_routes_follow_the_rules(cuda):
    assert conv_forward_kernel(torch.bfloat16, 24) == "wgmma"
    assert conv_forward_kernel(torch.bfloat16, 3) == "fma"
    assert conv_forward_kernel(torch.float32, 24) == "fma"
    # an unaligned bf16 view goes to the FMA kernel and still agrees
    gen = torch.Generator(device=cuda).manual_seed(6)
    flat = torch.randn(2 * 16 * 16 * 16 + 1, device=cuda, generator=gen).bfloat16()
    x = flat[1:].view(2, 16, 16, 16)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    wmat = torch.randn(144, 8, device=cuda, generator=gen) / 12
    reset_launch_counts()
    got = conv3x3(x, wmat)
    assert launch_counts()["conv3x3"] == 1
    want = conv3x3_plain(x.float(), wmat.bfloat16().float())
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-2)
