"""The port's hand-written kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; they skip where there is no CUDA device. This file imports
neither JAX nor the JAX package, so it also runs on a CUDA machine without
them, from the repository root:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda

Tolerances: f32 atol 1e-5 / rtol 1e-4 (summation order); bf16 against the
plain f32 version on the same bf16-rounded inputs, atol 2e-2 (one bf16
rounding of outputs up to ~6). Flash attention in bf16 is also held to the
rms of its error within ``FLASH_REL_BAR`` = 1e-2 of the reference's rms: its
outputs and gradients shrink with the sequence length (rms ~0.026 at S =
4096), where 2e-2 alone would pass a kernel that leaves out a tile or runs at
a padded head dim's scale (``tests/test_torch_flash_wide.py``); one bf16
rounding reads ~2.3e-3. Backward: the same bars for ``dx``, ``dq``,
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
bf16 between its products, which the same bf16 bar covers, and the
tensor-core attention backward rounds ``p`` and ``ds`` to bf16 before the
products they feed, under the same bar. The tensor-core filter gradient
sums exact products in f32 and keeps the ``dW`` bar.
"""

import importlib

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
from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import (
    WGMMA_MAX_CIN,
    _launch_wgrad,
    wgmma_smem_bytes,
    wgmma_tile,
    wgrad_kernel,
)
from pti_ldm_vae_tpu_torch.ops.kernels.conv3x3 import forward_kernel as conv_forward_kernel
from pti_ldm_vae_tpu_torch.ops.kernels.flash_attention import (
    SUPPORTED_HEAD_DIMS,
    backward_kernel,
    bwd_fma_smem_bytes,
    bwd_fma_smem_of_library,
    bwd_fma_tile,
    forward_kernel,
    fwd_fma_smem_bytes,
    fwd_fma_smem_of_library,
    fwd_fma_tile,
    padded_head_dim,
    wide_bwd_smem_bytes,
    wide_fwd_smem_bytes,
    wide_smem_of_library,
)
from pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu import _plain_forward, gn_plan

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
        _flash_close(got, want, dtype, msg=lambda m: f"{shape}: {m}")


def _tol(dtype):
    return dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=0, atol=2e-2)


FLASH_REL_BAR = 1e-2


def _flash_close(got, want, dtype, msg=None):
    """A flash kernel's output or gradient against the plain f32 version:
    ``_tol(dtype)``, and in bf16 also the relative rms bar."""
    got = got.detach().float()
    torch.testing.assert_close(got, want, **_tol(dtype), msg=msg)
    if dtype == torch.bfloat16:
        rel = float((got - want).norm() / want.norm())
        assert rel <= FLASH_REL_BAR, f"{msg('') if msg else ''} rms error {rel:.3e} of the reference's"


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
        assert (counts["groupnorm_silu"], counts["groupnorm_silu_bwd"]) == (1, 1)
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


# the eight GroupNorm+SiLU shapes of a flagship pass at 256², batch 8, then
# ragged ones (4 groups), a batch of 3 and the b32 shape of the largest slices
GN_SHAPES = [(8, 256, 256, 32), (8, 256, 256, 64), (8, 128, 128, 128), (8, 128, 128, 64),
             (8, 128, 128, 32), (8, 64, 64, 128), (8, 64, 64, 64), (8, 32, 32, 128),
             (1, 7, 9, 24), (3, 17, 9, 48), (3, 256, 256, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_silu_cluster_kernels_at_path_shapes(cuda, dtype, monkeypatch):
    """Forward and backward of the cluster kernels at every path shape, ragged
    shapes, b32 (bf16) and a view off 16 bytes: one launch each, on the cut
    ``gn_plan`` gives (16-byte vectors when aligned, one channel per access
    when not), within the bars, the same bits twice."""
    gn = importlib.import_module("pti_ldm_vae_tpu_torch.ops.kernels.groupnorm_silu")
    plans = []
    monkeypatch.setattr(gn, "gn_plan", lambda *a, **k: plans.append(gn_plan(*a, **k)) or plans[-1])
    gn._plan.cache_clear()  # the wrappers keep one plan per shape
    gen = torch.Generator(device=cuda).manual_seed(6)
    shapes = GN_SHAPES + ([(32, 256, 256, 64)] if dtype == torch.bfloat16 else [])
    for shape, aligned in [(s, True) for s in shapes] + [((2, 64, 64, 32), False)]:
        b, h, w, c = shape
        groups = 16 if c % 16 == 0 else 4
        flat = torch.randn(b * h * w * c + 1, device=cuda, generator=gen).to(dtype)
        x = (flat[:-1] if aligned else flat[1:]).view(shape).requires_grad_()
        scale = (1.0 + 0.1 * torch.randn(c, device=cuda, generator=gen)).requires_grad_()
        bias = (0.1 * torch.randn(c, device=cuda, generator=gen)).requires_grad_()
        g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
        plans.clear()
        reset_launch_counts()
        y = groupnorm_silu(x, scale, bias, groups, 1e-6)
        got = torch.autograd.grad(y, (x, scale, bias), g)
        counts = launch_counts()
        assert (counts["groupnorm_silu"], counts["groupnorm_silu_bwd"]) == (1, 1), shape
        vec = 16 // x.element_size() if aligned else 1
        assert [p.vec for p in plans] == [vec, vec], (shape, plans)
        assert plans == [gn_plan(b, h, w, c, groups, dtype, bwd, aligned) for bwd in (False, True)]
        xf, sf, bf = x.detach().float(), scale.detach(), bias.detach()
        want_y, mean_g, inv_g = _plain_forward(xf, sf, bf, groups, 1e-6)
        want = groupnorm_silu_bwd_plain(xf, sf, bf, mean_g, inv_g, g.float(), groups)
        msg = lambda m: f"{shape} {dtype}: {m}"  # noqa: E731
        torch.testing.assert_close(y.detach().float(), want_y, **_tol(dtype), msg=msg)
        torch.testing.assert_close(got[0].float(), want[0], **_tol(dtype), msg=msg)
        sum_tol = dict(rtol=1e-4, atol=1e-5 * (b * h * w) ** 0.5)
        torch.testing.assert_close(got[1], want[1], **sum_tol, msg=msg)
        torch.testing.assert_close(got[2], want[2], **sum_tol, msg=msg)
        y2 = groupnorm_silu(x, scale, bias, groups, 1e-6)
        assert torch.equal(y, y2)
        again = torch.autograd.grad(y2, (x, scale, bias), g)
        for first, second in zip(got, again):
            assert torch.equal(first, second)
        del x, flat, g, y, y2, got, again, want
        torch.cuda.empty_cache()


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
            _flash_close(ours, theirs, dtype, msg=lambda m: f"{shape}: {m}")
        again = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
        for first, second in zip(got, again):
            assert torch.equal(first, second)


# one head over a 256-channel mid block (config/ar_vae_dente_kl1e3.json at 256²:
# 64² tokens) at batch 1, and a ragged length with two heads; bf16 takes the
# wide tensor-core kernels, f32 the f32-FMA kernels (32-row tiles in the backward)
FLASH_D256_SHAPES = [(1, 1, 4096, 256), (1, 2, 300, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_256_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(10)
    for shape in FLASH_D256_SHAPES:
        q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype).requires_grad_()
                   for _ in range(3))
        g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
        reset_launch_counts()
        out = flash_attention(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), g)
        counts = launch_counts()
        assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (1, 1)
        wide = int(dtype == torch.bfloat16)
        assert (flash_attention.wide_launches, flash_attention.wide_bwd_launches) == (wide, wide)
        msg = lambda m: f"{shape} {dtype}: {m}"  # noqa: E731
        qf, kf, vf = q.detach().float(), k.detach().float(), v.detach().float()
        _flash_close(out, flash_attention_plain(qf, kf, vf), dtype, msg)
        for ours, theirs in zip(got, flash_attention_bwd_plain(qf, kf, vf, g.float())):
            _flash_close(ours, theirs, dtype, msg)
        again = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
        for first, second in zip(got, again):
            assert torch.equal(first, second)


# head dims the kernels are not built for: 96 pads to 128 (the tensor-core
# kernels in bf16), 200 to 256, 520 to 576 (the wide tensor-core kernels in
# bf16, the FMA split kernels in f32); 512 (a [128, 256, 512, 512] VAE's mid
# block at 256²) is built, on the wide kernels in bf16 and on the f32-FMA
# kernels with 32-row forward and 16-row backward tiles in f32; unit-variance inputs
FLASH_HEAD_DIM_SHAPES = [(2, 1, 1024, 96), (1, 2, 300, 200), (2, 1, 1024, 512), (1, 1, 77, 512),
                         (1, 1, 8, 520)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_other_head_dims_match_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(11)
    for shape in FLASH_HEAD_DIM_SHAPES:
        q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype).requires_grad_()
                   for _ in range(3))
        g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
        reset_launch_counts()
        out = flash_attention(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), g)
        counts = launch_counts()
        assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (1, 1)
        padded = padded_head_dim(shape[-1], dtype) != shape[-1]
        assert padded == (shape[-1] not in SUPPORTED_HEAD_DIMS)
        assert flash_attention.padded_launches == (2 if padded else 0)
        assert out.shape == shape and all(t.shape == shape for t in got)
        msg = lambda m: f"{shape} {dtype}: {m}"  # noqa: E731
        qf, kf, vf = q.detach().float(), k.detach().float(), v.detach().float()
        _flash_close(out, flash_attention_plain(qf, kf, vf), dtype, msg)
        for ours, theirs in zip(got, flash_attention_bwd_plain(qf, kf, vf, g.float())):
            _flash_close(ours, theirs, dtype, msg)
        again = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
        for first, second in zip(got, again):
            assert torch.equal(first, second)


# the wide tensor-core kernels' shapes: the kl1e3 mid blocks at b8 (whole A tiles in
# the backward), a [128, 256, 512, 512] VAE's at b8 (two slices, A streamed), and a
# head dim above 512 (q streamed in the forward too; f32 on the FMA split kernels)
FLASH_WIDE_SHAPES = [(8, 1, 4096, 256), (8, 1, 1024, 512), (2, 1, 1024, 640)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wide_kernels_at_path_shapes(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(12)
    for shape in FLASH_WIDE_SHAPES:
        d = shape[-1]
        route = "wgmma_wide" if dtype == torch.bfloat16 else "fma"
        assert forward_kernel(dtype, d) == backward_kernel(dtype, d) == route
        q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype).requires_grad_()
                   for _ in range(3))
        g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
        reset_launch_counts()
        out = flash_attention(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), g)
        counts = launch_counts()
        assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (1, 1)
        wide = int(route == "wgmma_wide")
        assert (flash_attention.wide_launches, flash_attention.wide_bwd_launches) == (wide, wide)
        assert flash_attention.padded_launches == 0
        msg = lambda m: f"{shape} {dtype}: {m}"  # noqa: E731
        qf, kf, vf = q.detach().float(), k.detach().float(), v.detach().float()
        _flash_close(out, flash_attention_plain(qf, kf, vf), dtype, msg)
        for ours, theirs in zip(got, flash_attention_bwd_plain(qf, kf, vf, g.float())):
            _flash_close(ours, theirs, dtype, msg)
        assert torch.equal(out, flash_attention(q, k, v))
        again = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
        for first, second in zip(got, again):
            assert torch.equal(first, second)
        del q, k, v, g, out, got, again
        torch.cuda.empty_cache()


# bf16 views 2 bytes past a 16-byte boundary: the wrapper copies them, so they take the
# tensor-core routes (narrow at 64, wide at 256 and 640) and agree with the plain version
FLASH_UNALIGNED_SHAPES = [(2, 1, 200, 64), (2, 1, 1024, 256), (2, 1, 1024, 640)]


@pytest.mark.cuda
def test_flash_attention_unaligned_bf16_takes_the_tensor_core_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(13)
    for shape in FLASH_UNALIGNED_SHAPES:
        n = shape[0] * shape[1] * shape[2] * shape[3]
        q, k, v = (torch.randn(n + 1, device=cuda, generator=gen).bfloat16()[1:].view(shape)
                   .requires_grad_() for _ in range(3))
        g = torch.randn(n + 1, device=cuda, generator=gen).bfloat16()[1:].view(shape)
        assert all(t.data_ptr() % 16 and t.is_contiguous() for t in (q, k, v, g))
        reset_launch_counts()
        out = flash_attention(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), g)
        counts = launch_counts()
        assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (1, 1)
        wide = int(shape[-1] > 128)
        assert (flash_attention.wide_launches, flash_attention.wide_bwd_launches) == (wide, wide)
        assert forward_kernel(torch.bfloat16, shape[-1]) == ("wgmma_wide" if wide else "wgmma")
        msg = lambda m: f"{shape}: {m}"  # noqa: E731
        qf, kf, vf = q.detach().float(), k.detach().float(), v.detach().float()
        _flash_close(out, flash_attention_plain(qf, kf, vf), torch.bfloat16, msg)
        for ours, theirs in zip(got, flash_attention_bwd_plain(qf, kf, vf, g.float())):
            _flash_close(ours, theirs, torch.bfloat16, msg)
        again = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
        for first, second in zip(got, again):
            assert torch.equal(first, second)


@pytest.mark.cuda
def test_flash_wide_smem_matches_the_library(cuda):
    for d in (192, 256, 320, 512, 640, 1024):
        got = wide_smem_of_library(d)
        assert got["forward"][0] == wide_fwd_smem_bytes(d) and got["forward"][1] >= 1
        assert got["backward"][0] == wide_bwd_smem_bytes(d) and got["backward"][1] >= 1


@pytest.mark.cuda
def test_flash_attention_empty_padded_call_launches_nothing(cuda):
    """A call with no elements launches no kernel, so it counts neither a
    launch nor a padded launch, forward or backward."""
    q, k, v = (torch.zeros(2, 1, 0, 96, device=cuda, requires_grad=True) for _ in range(3))
    reset_launch_counts()
    out = flash_attention(q, k, v)
    torch.autograd.grad(out, (q, k, v), torch.zeros_like(out))
    counts = launch_counts()
    assert out.shape == q.shape
    assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (0, 0)
    assert flash_attention.padded_launches == 0


@pytest.mark.cuda
def test_flash_fma_backward_smem_matches_the_library(cuda):
    for d in (*SUPPORTED_HEAD_DIMS, 640, 1024):  # the split kernels above 512
        assert bwd_fma_smem_of_library(d) == (bwd_fma_tile(d), *bwd_fma_smem_bytes(d))
        assert fwd_fma_smem_of_library(d) == (fwd_fma_tile(d), fwd_fma_smem_bytes(d))
    with pytest.raises(ValueError, match="head dim 48"):
        bwd_fma_smem_of_library(48)
    with pytest.raises(ValueError, match="head dim 48"):
        fwd_fma_smem_of_library(48)


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
# counts, the thin ends (Cin=1, Cout=1, Cout=4 / Cin=4), a wide bottleneck
# conv, a ragged image whose channels (24 -> 40) the tensor-core kernel takes,
# at batch 8 (its widest tile) and batch 1; then the AR models' widths: the
# kl1e3 model's 256-channel convs (32 output columns a block), its latent
# convs (Cin 10, and Cout 10 whose input gradient reads 10 channels), a
# 20-channel conv_out's input gradient, Cin 512 (16 columns a block), and Cin
# 1528, just above WGMMA_MAX_CIN, which stays on the FMA kernel in bf16 too.
# bf16 takes the tensor-core kernel at every other shape, a thin or ragged
# Cin (1, 3, 4, 10, 20) through zero channels up to a multiple of 8
CONV_SHAPES = [(2, 64, 64, 32, 32), (1, 20, 12, 3, 5), (2, 40, 70, 1, 32), (2, 33, 31, 32, 1),
               (3, 32, 32, 128, 4), (2, 32, 32, 4, 128), (2, 32, 32, 128, 128), (1, 16, 48, 64, 96),
               (2, 37, 70, 24, 40), (8, 37, 70, 24, 40), (8, 64, 64, 64, 128),
               (2, 64, 64, 256, 256), (1, 128, 128, 256, 128), (2, 64, 64, 256, 10),
               (2, 32, 32, 10, 256), (2, 32, 32, 20, 128), (1, 32, 32, 512, 64),
               (1, 16, 16, WGMMA_MAX_CIN + 8, 8)]


def _conv_launches(dtype, *cins):
    """(launches, FMA launches, padded launches) of forward-kernel calls whose
    Cin are ``cins``: bf16 on the tensor cores up to WGMMA_MAX_CIN, a Cin that
    is no multiple of 8 padded; f32 on the FMA kernel."""
    fma = sum(conv_forward_kernel(dtype, c) == "fma" for c in cins)
    padded = sum(conv_forward_kernel(dtype, c) == "wgmma" and c % 8 != 0 for c in cins)
    return len(cins), fma, padded


def _conv_counts():
    return launch_counts()["conv3x3"], conv3x3.fma_launches, conv3x3.padded_launches


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
        assert _conv_counts() == _conv_launches(dtype, shape[3]), shape
        assert got.dtype == dtype and got.is_contiguous()
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
        # the input gradient runs the forward kernel with Cout in Cin's place, padded alike
        assert _conv_counts() == _conv_launches(dtype, cin, cout), shape
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_at_vgg16_shapes(cuda, dtype):
    """The comparison suite's VGG16 with ``conv_kernel=True``: its 9 distinct
    convolution shapes at 224², from the 3-channel input to 14² x 512."""
    from pti_ldm_vae_tpu_torch.analysis.metrics import vgg16_conv_shapes

    gen = torch.Generator(device=cuda).manual_seed(8)
    shapes = sorted(set(vgg16_conv_shapes()), key=vgg16_conv_shapes().index)
    assert len(shapes) == 9
    for shape in shapes:
        x, wmat = _conv_inputs(shape, dtype, cuda, gen)
        reset_launch_counts()
        got = conv3x3(x, wmat)
        assert _conv_counts() == _conv_launches(dtype, shape[3]), shape
        want = conv3x3_plain(x.float(), wmat.to(dtype).float())
        torch.testing.assert_close(got.float(), want, **_tol(dtype), msg=lambda m: f"{shape}: {m}")


@pytest.mark.cuda
def test_vgg16_features_on_the_card(cuda, monkeypatch):
    """VGG16 features of one image on the card, cuDNN's and the kernel's (13
    launches), against the CPU's, within 1e-4 of the largest magnitude, with
    TF32 allowed as PyTorch allows it by default (the model turns it off for
    its own convolutions and back on after them)."""
    from pti_ldm_vae_tpu_torch.analysis.metrics import vgg16_features_fn

    monkeypatch.setenv("PTI_VGG16_WEIGHTS", "none")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(1, 224, 224, 3, generator=gen).numpy()
    want = vgg16_features_fn("cpu")(x)
    bar = 1e-4 * abs(want).max()
    assert abs(vgg16_features_fn("cuda")(x) - want).max() <= bar
    assert torch.backends.cudnn.allow_tf32
    with_kernel = vgg16_features_fn("cuda", conv_kernel=True)
    reset_launch_counts()
    got = with_kernel(x)
    assert launch_counts()["conv3x3"] == 13 and abs(got - want).max() <= bar


@pytest.mark.cuda
def test_bf16_routes_follow_the_rules(cuda):
    assert conv_forward_kernel(torch.bfloat16, 24) == "wgmma"
    # a thin Cin is padded with zero channels onto the tensor cores, up to the widest Cin whose
    # weight slab fits; f32 stays on the FMA kernel
    assert conv_forward_kernel(torch.bfloat16, 3) == "wgmma"
    assert conv_forward_kernel(torch.bfloat16, 256) == conv_forward_kernel(torch.bfloat16, 10) == "wgmma"
    assert conv_forward_kernel(torch.bfloat16, WGMMA_MAX_CIN) == "wgmma"
    assert conv_forward_kernel(torch.bfloat16, WGMMA_MAX_CIN + 8) == "fma"
    assert conv_forward_kernel(torch.float32, 24) == "fma"
    # an unaligned bf16 view goes to the FMA kernel and still agrees
    gen = torch.Generator(device=cuda).manual_seed(6)
    flat = torch.randn(2 * 16 * 16 * 16 + 1, device=cuda, generator=gen).bfloat16()
    x = flat[1:].view(2, 16, 16, 16)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    wmat = torch.randn(144, 8, device=cuda, generator=gen) / 12
    reset_launch_counts()
    got = conv3x3(x, wmat)
    assert _conv_counts() == (1, 1, 0)
    want = conv3x3_plain(x.float(), wmat.bfloat16().float())
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_conv3x3_wgmma_occupancy_matches_the_formula(cuda):
    """The tensor-core kernel's shared memory and resident blocks per SM, as
    the CUDA runtime reports them, at the tile each wide or padded shape
    takes: the wrapper's formula, and at least one block."""
    import ctypes

    from pti_ldm_vae_tpu_torch.ops.kernels import _build

    lib = _build.load("conv3x3_wgmma.cu")
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    for b, h, w, cin, cout in [(8, 64, 64, 256, 256), (8, 64, 64, 256, 10), (8, 64, 64, 16, 256),
                               (8, 32, 32, 512, 512), (8, 32, 32, WGMMA_MAX_CIN, 64),
                               (8, 256, 256, 8, 64)]:
        mt, tn, kc = wgmma_tile(b, h, w, cin, cout, n_sm)
        err = lib.conv3x3_wgmma_occupancy(mt, tn, kc, cin, ctypes.byref(smem), ctypes.byref(blocks))
        assert err == 0 and smem.value == wgmma_smem_bytes(cin, mt, tn, kc) and blocks.value >= 1
    # a Cin past the limit is refused
    assert lib.conv3x3_wgmma_occupancy(1, 8, 16, WGMMA_MAX_CIN + 8, ctypes.byref(smem),
                                       ctypes.byref(blocks)) != 0


# the filter gradient's bf16 shapes of a flagship pass (all on the tensor-core kernel, the
# thin ones padded) and ragged ones: 24 -> 40 at two batch sizes, a Cin that leaves a group
# of 8 channels, thin odd channel counts
WGRAD_SHAPES = [(8, 256, 256, 32, 32), (8, 256, 256, 64, 32), (8, 256, 256, 64, 64),
                (8, 128, 128, 32, 64), (8, 128, 128, 64, 64), (8, 128, 128, 128, 64),
                (8, 128, 128, 128, 128), (8, 64, 64, 64, 128), (8, 64, 64, 128, 128),
                (8, 32, 32, 128, 128), (8, 256, 256, 1, 32), (8, 256, 256, 32, 1),
                (8, 32, 32, 128, 4), (8, 32, 32, 4, 128), (2, 37, 70, 24, 40), (8, 37, 70, 24, 40),
                (1, 11, 19, 72, 16), (1, 20, 12, 3, 5)]


@pytest.mark.cuda
def test_backward_routes_follow_the_rules(cuda):
    for shape in FLASH_SHAPES + [(8, 1, 1024, 128)]:
        assert backward_kernel(torch.bfloat16, shape[-1]) == "wgmma"
        assert backward_kernel(torch.float32, shape[-1]) == "fma"
    for b, h, w, cin, cout in CONV_SHAPES + WGRAD_SHAPES:  # thin channel counts padded to 8
        assert wgrad_kernel(torch.bfloat16, cin, cout) == "wgmma"
        assert wgrad_kernel(torch.float32, cin, cout) == "fma"


@pytest.mark.cuda
def test_conv3x3_wgrad_wgmma_matches_plain_at_path_shapes(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    for shape in WGRAD_SHAPES:
        b, h, w, cin, cout = shape
        x = torch.randn(b, h, w, cin, device=cuda, generator=gen).bfloat16()
        g = (torch.randn(b, h, w, cout, device=cuda, generator=gen) * (cin / cout) ** 0.5).bfloat16()
        reset_launch_counts()
        got = _launch_wgrad(x, g)
        assert launch_counts()["conv3x3_wgrad"] == 1 and got.dtype == torch.float32
        assert torch.equal(got, _launch_wgrad(x, g))  # two runs, the same bits
        _, want = conv3x3_bwd_plain(x.float(), torch.zeros(9 * cin, cout, device=cuda), g.float())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * (b * h * w) ** 0.5,
                                   msg=lambda m: f"{shape}: {m}")


@pytest.mark.cuda
def test_flash_attention_backward_wgmma_at_the_path_shape(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    for shape in [(8, 1, 1024, 128), (2, 2, 1000, 64)]:
        q, k, v, g = (torch.randn(shape, device=cuda, generator=gen).bfloat16() for _ in range(4))
        leaves = tuple(t.clone().requires_grad_() for t in (q, k, v))
        got = torch.autograd.grad(flash_attention(*leaves), leaves, g)
        again = torch.autograd.grad(flash_attention(*leaves), leaves, g)
        want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float())
        for ours, twice, theirs in zip(got, again, want):
            assert torch.equal(ours, twice)
            _flash_close(ours, theirs, torch.bfloat16, msg=lambda m: f"{shape}: {m}")


@pytest.mark.cuda
def test_unaligned_bf16_backward_takes_the_fma_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    flat = torch.randn(2 * 16 * 16 * 16 + 1, device=cuda, generator=gen).bfloat16()
    x = flat[1:].view(2, 16, 16, 16)
    g = torch.randn(2, 16, 16, 8, device=cuda, generator=gen).bfloat16()
    assert x.data_ptr() % 16 != 0
    assert wgrad_kernel(x.dtype, 16, 8, aligned=False) == "fma"
    got = _launch_wgrad(x, g)
    _, want = conv3x3_bwd_plain(x.float(), torch.zeros(144, 8, device=cuda), g.float())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * 512 ** 0.5)


# the 17 GroupNorm+SiLU shapes of a UNet pass of config/ldm_dente.json (32²
# latents, batch 8, 32 groups: 1 to 16 channels per group, 3 vector columns at
# C = 96, 192, 384, images of 16 rows at 4²) and its three attention shapes
UNET_GN_SHAPES = [(8, 32, 32, 96), (8, 32, 32, 64), (8, 16, 16, 192), (8, 32, 32, 32),
                  (8, 16, 16, 128), (8, 8, 8, 384), (8, 16, 16, 96), (8, 16, 16, 64),
                  (8, 8, 8, 256), (8, 8, 8, 192), (8, 16, 16, 32), (8, 8, 8, 128),
                  (8, 4, 4, 512), (8, 4, 4, 384), (8, 8, 8, 64), (8, 4, 4, 256), (8, 4, 4, 128)]
UNET_FLASH_SHAPES = [(8, 2, 256, 32), (8, 4, 64, 32), (8, 8, 16, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_silu_kernels_at_unet_shapes(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(8)
    for shape in UNET_GN_SHAPES:
        b, h, w, c = shape
        x = torch.randn(shape, device=cuda, generator=gen).to(dtype).requires_grad_()
        scale = (1.0 + 0.1 * torch.randn(c, device=cuda, generator=gen)).requires_grad_()
        bias = (0.1 * torch.randn(c, device=cuda, generator=gen)).requires_grad_()
        g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
        reset_launch_counts()
        y = groupnorm_silu(x, scale, bias, 32, 1e-6)
        got = torch.autograd.grad(y, (x, scale, bias), g)
        counts = launch_counts()
        assert (counts["groupnorm_silu"], counts["groupnorm_silu_bwd"]) == (1, 1), shape
        xf, sf, bf = x.detach().float(), scale.detach(), bias.detach()
        want_y, mean_g, inv_g = _plain_forward(xf, sf, bf, 32, 1e-6)
        want = groupnorm_silu_bwd_plain(xf, sf, bf, mean_g, inv_g, g.float(), 32)
        msg = lambda m: f"{shape} {dtype}: {m}"  # noqa: E731
        torch.testing.assert_close(y.detach().float(), want_y, **_tol(dtype), msg=msg)
        torch.testing.assert_close(got[0].float(), want[0], **_tol(dtype), msg=msg)
        sum_tol = dict(rtol=1e-4, atol=1e-5 * (b * h * w) ** 0.5)
        torch.testing.assert_close(got[1], want[1], **sum_tol, msg=msg)
        torch.testing.assert_close(got[2], want[2], **sum_tol, msg=msg)
        again = torch.autograd.grad(groupnorm_silu(x, scale, bias, 32, 1e-6), (x, scale, bias), g)
        for first, second in zip(got, again):
            assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_at_unet_shapes(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(9)
    for shape in UNET_FLASH_SHAPES:
        q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype).requires_grad_()
                   for _ in range(3))
        g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
        out = flash_attention(q, k, v)
        msg = lambda m: f"{shape}: {m}"  # noqa: E731
        _flash_close(out, flash_attention_plain(
            q.detach().float(), k.detach().float(), v.detach().float()), dtype, msg)
        got = torch.autograd.grad(out, (q, k, v), g)
        want = flash_attention_bwd_plain(q.detach().float(), k.detach().float(),
                                         v.detach().float(), g.float())
        for ours, theirs in zip(got, want):
            _flash_close(ours, theirs, dtype, msg)


@pytest.mark.cuda
def test_diffusion_unet_on_the_card_matches_the_cpu(cuda):
    """A toy-width UNet (head dim 16, 4 groups) in f32 on the card against
    the CPU plain path, forward (1e-4 of the largest entry) with the launch
    counts of one pass."""
    from pti_ldm_vae_tpu_torch.models.unet import diffusion_unet_from_config

    cfg = dict(spatial_dims=2, in_channels=4, out_channels=4, channels=[16, 32],
               attention_levels=[False, True], num_head_channels=[0, 16], num_res_blocks=1,
               with_conditioning=True, cross_attention_dim=24, norm_num_groups=4)
    torch.manual_seed(0)
    cpu = diffusion_unet_from_config(cfg).eval()
    card = diffusion_unet_from_config(cfg).to(cuda).eval()
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    x, ctx = torch.randn(2, 16, 16, 4, generator=gen), torch.randn(2, 9, 24, generator=gen)
    t = torch.tensor([3, 900])
    with torch.no_grad():
        want = cpu(x, t, ctx)
        reset_launch_counts()
        got = card(x.to(cuda), t.to(cuda), ctx.to(cuda)).cpu()
    counts = launch_counts()
    assert (counts["groupnorm_silu"], counts["flash_attention"]) == (17, 4)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# the space-to-depth forms' new kernel shapes at the flagship's b8 (s2d_stem, 16 groups):
# GroupNorm+SiLU on 128² with 128 and 256 channels (8 and 16 per group); the convolution's
# 4 -> 128 (conv_in, Cin padded to 8), 128 -> 4 (conv_out) and 256 -> 256 (the upsample)
S2D_GN_SHAPES = [(8, 128, 128, 128), (8, 128, 128, 256)]
S2D_CONV_SHAPES = [(8, 128, 128, 4, 128), (8, 128, 128, 128, 4), (2, 128, 128, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_the_s2d_shapes(cuda, dtype):
    """GroupNorm+SiLU and the convolution, forward and backward, at the shapes
    the s2d forms give them: within the bars, bf16 on the tensor cores."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    for shape in S2D_GN_SHAPES:
        b, h, w, c = shape
        x = torch.randn(shape, device=cuda, generator=gen).to(dtype).requires_grad_()
        scale = (1.0 + 0.1 * torch.randn(c, device=cuda, generator=gen)).requires_grad_()
        bias = (0.1 * torch.randn(c, device=cuda, generator=gen)).requires_grad_()
        g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
        y = groupnorm_silu(x, scale, bias, 16, 1e-6)
        got = torch.autograd.grad(y, (x, scale, bias), g)
        xf = x.detach().float()
        want_y, mean_g, inv_g = _plain_forward(xf, scale.detach(), bias.detach(), 16, 1e-6)
        want = groupnorm_silu_bwd_plain(xf, scale.detach(), bias.detach(), mean_g, inv_g,
                                        g.float(), 16)
        torch.testing.assert_close(y.detach().float(), want_y, **_tol(dtype))
        torch.testing.assert_close(got[0].float(), want[0], **_tol(dtype))
        sum_tol = dict(rtol=1e-4, atol=1e-5 * (b * h * w) ** 0.5)
        torch.testing.assert_close(got[1], want[1], **sum_tol)
        torch.testing.assert_close(got[2], want[2], **sum_tol)
        del x, g, y, got, want
    for shape in S2D_CONV_SHAPES:
        b, h, w, cin, cout = shape
        x, wmat = _conv_inputs(shape, dtype, cuda, gen)
        x.requires_grad_()
        wmat.requires_grad_()
        # dx from an upstream gradient scaled to give it size ~1; dW from a unit-size one, since
        # its bar counts terms x*g of size ~1 (at Cin 128 -> Cout 4 the scaling would make them ~6)
        g_unit = torch.randn(b, h, w, cout, device=cuda, generator=gen)
        g = (g_unit * (cin / cout) ** 0.5).to(dtype)
        reset_launch_counts()
        y = conv3x3(x, wmat)
        dx, _ = torch.autograd.grad(y, (x, wmat), g, retain_graph=True)
        assert _conv_counts() == _conv_launches(dtype, cin, cout), shape
        (dw,) = torch.autograd.grad(y, wmat, g_unit.to(dtype))
        wd = wmat.detach().to(dtype).float()
        torch.testing.assert_close(y.detach().float(), conv3x3_plain(x.detach().float(), wd),
                                   **_tol(dtype), msg=lambda m: f"{shape}: {m}")
        want_dx = conv3x3_bwd_plain(x.detach().float(), wd, g.float())[0]
        want_dw = conv3x3_bwd_plain(x.detach().float(), wd, g_unit.to(dtype).float())[1]
        torch.testing.assert_close(dx.float(), want_dx, **_tol(dtype), msg=lambda m: f"{shape}: {m}")
        torch.testing.assert_close(dw, want_dw, rtol=1e-4, atol=1e-5 * (b * h * w) ** 0.5,
                                   msg=lambda m: f"{shape}: {m}")
        del x, wmat, g, g_unit, y, dx, dw
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_s2d_and_remat_forms_on_the_card(cuda):
    """A small VAE (channels [32, 64], 16 groups) at 64² with the convolution
    kernels: in f32 every s2d form reconstructs as the standard form does
    (1e-4 of the largest entry); in bf16 the s2d train step's gradients with
    ``remat`` are the bits of the step without it, and no convolution goes to
    the FMA kernel."""
    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config

    arch = dict(spatial_dims=2, in_channels=1, out_channels=1, latent_channels=4,
                channels=[32, 64], num_res_blocks=1, norm_num_groups=16, norm_eps=1e-6,
                attention_levels=[False, False], with_encoder_nonlocal_attn=True,
                with_decoder_nonlocal_attn=True)
    torch.manual_seed(0)
    state = autoencoder_from_config(arch).state_dict()
    x = torch.randn(2, 64, 64, 1, generator=torch.Generator().manual_seed(1)).to(cuda)

    def build(dtype, **knobs):
        model = autoencoder_from_config(arch, compute_dtype=dtype, conv_kernel=True, **knobs)
        model.load_state_dict(state, strict=True)
        return model.to(device=cuda, memory_format=torch.channels_last)

    with torch.no_grad():
        want = build(torch.float32).reconstruct_deterministic(x)
        for form in (True, "encoder", "decoder"):
            got = build(torch.float32, s2d_stem=form).reconstruct_deterministic(x)
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), form

    def grads(model):
        out = model.reconstruct_deterministic(x)
        out.square().mean().backward()
        return [p.grad.clone() for p in model.parameters() if p.grad is not None]

    # the 1x1 shortcuts and the downsample stay on cuDNN, whose filter gradients may sum in
    # another order run to run unless asked not to
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        reset_launch_counts()
        plain = grads(build(torch.bfloat16, s2d_stem=True))
        remat = grads(build(torch.bfloat16, s2d_stem=True, remat=True))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert len(plain) == len(remat) and all(torch.equal(a, b) for a, b in zip(plain, remat))
    assert conv3x3.fma_launches == 0 and launch_counts()["conv3x3"] > 0


@pytest.mark.cuda
def test_flat_gradient_allreduce_under_a_world_one_nccl_group(cuda):
    """The data-parallel gradient all-reduce (one flat buffer per optimizer,
    ``parallel/mesh.py``) under a one-rank NCCL group leaves every gradient
    bit for bit as it was, channels-last ones included."""
    import socket

    import torch.distributed as dist

    from pti_ldm_vae_tpu_torch.models.autoencoder_kl import autoencoder_from_config
    from pti_ldm_vae_tpu_torch.parallel import allreduce_gradients

    if dist.is_initialized():
        pytest.skip("a process group is already active in this process")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    model = autoencoder_from_config(
        dict(spatial_dims=2, in_channels=1, out_channels=1, latent_channels=3, channels=[8, 16],
             num_res_blocks=1, norm_num_groups=4, attention_levels=[False, False],
             with_encoder_nonlocal_attn=True, with_decoder_nonlocal_attn=True),
        compute_dtype=torch.bfloat16).to(device=cuda, memory_format=torch.channels_last)
    x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(3)).to(cuda)
    model.reconstruct_deterministic(x).square().mean().backward()
    params = [p for p in model.parameters() if p.grad is not None]
    before = [p.grad.clone() for p in params]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        allreduce_gradients(params)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(p.grad, b) for p, b in zip(params, before))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16, 32), (2, 4096, 64)], ids=["ndhwc", "nlc"])
def test_group_norm_silu_on_1d_and_3d_tensors_launches_on_the_rank4_view(cuda, dtype, shape):
    """A 3-D (NDHWC) or 1-D (NLC) tensor reaches the GroupNorm+SiLU kernels as
    its rank-4 view, forward and backward: one launch each way, the kernels'
    bits on the view, within the bars of the plain version."""
    from pti_ldm_vae_tpu_torch.ops.norm import group_norm_silu, rank4_view

    gen = torch.Generator(device=cuda).manual_seed(11)
    c = shape[-1]
    x = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    g = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, device=cuda, generator=gen)
    bias = 0.1 * torch.randn(c, device=cuda, generator=gen)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    reset_launch_counts()
    y = group_norm_silu(*leaves, num_groups=16, eps=1e-6)
    dx, dscale, dbias = torch.autograd.grad(y, leaves, g)
    counts = launch_counts()
    assert (counts["groupnorm_silu"], counts["groupnorm_silu_bwd"]) == (1, 1)
    view = rank4_view(x)
    assert view.dim() == 4
    want, mean_g, inv_g = _plain_forward(view.float(), scale, bias, 16, 1e-6)
    want_dx, want_dscale, want_dbias = groupnorm_silu_bwd_plain(
        view.float(), scale, bias, mean_g, inv_g, rank4_view(g).float(), 16)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=0, atol=2e-2)
    n = view.shape[0] * view.shape[1] * view.shape[2]
    sum_tol = dict(rtol=1e-4, atol=1e-5 * n ** 0.5)
    torch.testing.assert_close(y.float(), want.reshape(shape), **tol)
    torch.testing.assert_close(dx.float(), want_dx.reshape(shape), **tol)
    torch.testing.assert_close(dscale, want_dscale, **sum_tol)
    torch.testing.assert_close(dbias, want_dbias, **sum_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["groupnorm_silu_fold", "groupnorm_silu_per_image",
                                  "flash_attention_fold", "conv3x3_fold", "conv3x3_per_image"])
def test_vmap_rules_launch_the_kernels(cuda, case):
    """Each Function's ``torch.func.vmap`` rule on the card, forward and
    ``vmap(grad)``, against a loop over the images through the same
    wrappers (f32): the shared-weight branch folds the images into one
    launch, the per-image branch launches once per image and gives the
    loop's bits; the filter gradient launches once per image."""
    from torch.func import grad, vmap

    v = 3
    gen = torch.Generator(device=cuda).manual_seed(12)

    def rnd(*shape):
        return torch.randn(shape, device=cuda, generator=gen)

    def gn(a, s, b):
        return groupnorm_silu(a, s, b, 16, 1e-6)

    x = rnd(v, 2, 32, 32, 64)
    fn, args, dims, want = {
        "groupnorm_silu_fold": (gn, (x, 1 + 0.1 * rnd(64), 0.1 * rnd(64)), (0, None, None),
                                {"groupnorm_silu": 2, "groupnorm_silu_bwd": 1}),
        "groupnorm_silu_per_image": (gn, (x, 1 + 0.1 * rnd(v, 64), 0.1 * rnd(v, 64)), (0, 0, 0),
                                     {"groupnorm_silu": 2 * v, "groupnorm_silu_bwd": v}),
        "flash_attention_fold": (flash_attention, tuple(rnd(v, 2, 1, 256, 64) for _ in range(3)),
                                 (0, 0, 0), {"flash_attention": 2, "flash_attention_bwd": 1}),
        "conv3x3_fold": (conv3x3, (x, 0.05 * rnd(576, 64)), (0, None),
                         {"conv3x3": 3, "conv3x3_wgrad": v}),
        "conv3x3_per_image": (conv3x3, (x, 0.05 * rnd(v, 576, 64)), (0, 0),
                              {"conv3x3": 3 * v, "conv3x3_wgrad": v}),
    }[case]
    g = rnd(v, *fn(*(a if d is None else a[0] for a, d in zip(args, dims))).shape)

    def loss(*a):
        return (fn(*a[:-1]) * a[-1]).sum()

    reset_launch_counts()
    got = vmap(fn, in_dims=dims)(*args)
    got_grads = vmap(grad(loss, argnums=tuple(range(len(args)))), in_dims=(*dims, 0))(*args, g)
    torch.cuda.synchronize()
    assert {k: n for k, n in launch_counts().items() if n} == want
    loop = []
    for i in range(v):
        leaves = [(a if d is None else a[i]).clone().requires_grad_() for a, d in zip(args, dims)]
        loop.append((fn(*leaves).detach(), torch.autograd.grad(loss(*leaves, g[i]), leaves)))
    want_out = torch.stack([o for o, _ in loop])
    if "per_image" in case:
        assert torch.equal(got, want_out)
    torch.testing.assert_close(got, want_out, rtol=1e-4, atol=1e-5)
    for j, got_g in enumerate(got_grads):
        want_g = torch.stack([gr[j] for _, gr in loop])
        torch.testing.assert_close(got_g, want_g, rtol=1e-4,
                                   atol=1e-4 * float(want_g.abs().max()))
