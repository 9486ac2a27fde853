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
grows with the root of its length). Every backward runs twice and must give
the same bits: the kernels use no float atomics.
"""

import pytest
import torch

from pti_ldm_vae_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    groupnorm_silu,
    groupnorm_silu_bwd_plain,
    groupnorm_silu_plain,
    launch_counts,
    reset_launch_counts,
)
from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _plain_forward


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
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
    for shape in [(2, 1, 1024, 128), (2, 2, 1000, 64), (1, 3, 77, 32), (1, 1, 5, 16)]:
        q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype) for _ in range(3))
        got = flash_attention(q, k, v)
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
    for shape in [(2, 1, 1024, 128), (2, 2, 1000, 64), (1, 3, 77, 32), (1, 1, 5, 16)]:
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
