"""The port's hand-written kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; they skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so it also runs on a CUDA machine without
them, from the repository root:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda

Tolerances: f32 atol 1e-5 / rtol 1e-4 (summation order); bf16 against the
plain f32 version on the same bf16-rounded inputs, atol 2e-2 (one bf16
rounding of outputs up to ~6).
"""

import pytest
import torch

from pti_ldm_vae_tpu_torch.ops.kernels import (
    flash_attention,
    flash_attention_plain,
    groupnorm_silu,
    groupnorm_silu_plain,
)


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
