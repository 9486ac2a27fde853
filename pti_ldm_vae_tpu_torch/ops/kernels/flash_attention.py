"""Flash attention, forward and backward: hand-written CUDA kernels beside
their plain PyTorch versions, bound to autograd.

Replaces ``pti_ldm_vae_tpu/ops/pallas/flash_attention.py``: ``_forward``
(body ``_kernel``), ``softmax(q k^T * d^-0.5) v`` over ``[B, H, S, D]``
tensors, self-attention only, softmax statistics in f32; and ``_bwd_pallas``
(body ``_bwd_kernel``), which recomputes ``p`` and gives ``dv = p^T g``,
``dp = g v^T``, ``ds = p * (dp - rowsum(dp * p))``, ``dq = ds k * d^-0.5``,
``dk = ds^T q * d^-0.5``.

Kernels: ``csrc/flash_attention_wgmma.cu`` and ``csrc/flash_attention.cu``
(forward; either also writes the row logsumexp ``[B, H, S]`` f32 when a
backward will follow; ``forward_kernel`` picks by dtype alone: bf16 inputs go
to the tensor-core kernel, ``wgmma`` for both products with ``p`` rounded to
bf16 between them, f32 inputs, and bf16 tensors whose base address is not
16-byte aligned, to the f32-FMA kernel; neither stands in for the other when
a build or a launch fails) and
``csrc/flash_attention_bwd.cu`` (a tiled backward in three launches: the
``delta = rowsum(dO * O)`` pre-pass, one kernel for ``dk`` and ``dv``, one for
``dq``; no float atomics, so gradients are bit-identical run to run), built
with nvcc for ``sm_90a`` into shared libraries and called through ctypes (see
those files for the designs). On the VAE's main path attention runs twice
per step (encoder and decoder mid blocks) at ``[B, 1, 1024, 128]``: 4.3 GFLOP
forward and 10.7 GFLOP backward per call at B=8, hundreds of FLOP per input
byte, so the bound on an H100 is arithmetic. The backward kernels and the f32
forward do their products with f32 FMAs, not the tensor cores, and keep ``p``
and ``ds`` in f32 (the TPU backward rounds them to the input dtype before its
products).

``flash_attention`` launches the kernels for CUDA tensors (or raises) and
runs the plain versions, forward and backward formula, for CPU tensors;
nothing falls back from one to the other. ``flash_attention.launches`` counts
forward launches, ``flash_attention.bwd_launches`` backward calls that
launched the backward kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd_plain",
           "forward_kernel", "SUPPORTED_HEAD_DIMS", "SOURCES"]

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_SOURCE = "flash_attention.cu"
_WGMMA_SOURCE = "flash_attention_wgmma.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
SOURCES = (_WGMMA_SOURCE, _FWD_SOURCE, _BWD_SOURCE)


def forward_kernel(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> str:
    """Which kernel computes the forward: ``"wgmma"`` (the tensor-core kernel,
    ``csrc/flash_attention_wgmma.cu``) for bf16 inputs of a supported head dim
    (all are multiples of 16, one ``wgmma`` depth step) at 16-byte aligned
    base addresses, any sequence length; else ``"fma"``
    (``csrc/flash_attention.cu``)."""
    if dtype == torch.bfloat16 and head_dim in SUPPORTED_HEAD_DIMS and aligned:
        return "wgmma"
    return "fma"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernels: f32 scores, f32 softmax,
    f32 weighted sum, result in the input dtype. The tensor-core kernel rounds
    the unnormalized weights ``p`` (in [0, 1]) to bf16 before its second
    product, which this version does not; the bf16 bar (atol 2e-2 against this
    version in f32 on the same rounded inputs) covers that rounding."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: ``(dq, dk, dv)`` for the
    upstream gradient ``g``, by the formulas in the module docstring with
    everything in f32, results in the input dtypes."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _forward_library() -> ctypes.CDLL:
    from ._build import load

    lib = load(_FWD_SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _wgmma_library() -> ctypes.CDLL:
    from ._build import load

    lib = load(_WGMMA_SOURCE)
    fn = lib.flash_attention_wgmma_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _backward_library() -> ctypes.CDLL:
    from ._build import load

    lib = load(_BWD_SOURCE)
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape; got {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def _launch_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, save_lse: bool
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The forward launch on CUDA tensors: (out, lse [B, H, S] f32 or None)."""
    _check(q, k, v)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32) if save_lse else None
    if q.numel() == 0:
        return out, lse
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    kernel = forward_kernel(q.dtype, d, aligned)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if save_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == "wgmma":
            err = _wgmma_library().flash_attention_wgmma_fwd(*pointers, b * h, s, d, d**-0.5, stream)
        else:
            err = _forward_library().flash_attention_fwd(
                *pointers, b * h, s, d, _DTYPE_CODES[q.dtype], d**-0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention forward ({kernel} kernel) launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def _launch_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward launches on CUDA tensors: (dq, dk, dv)."""
    _check(q, k, v)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"upstream gradient {tuple(g.shape)} on {g.device} does not match q")
    g = g.to(q.dtype).contiguous()  # autograd often hands over a strided view
    b, h, s, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    lib = _backward_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, s, d, _DTYPE_CODES[q.dtype], d**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA) or their plain versions (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v)
            ctx.save_for_backward(q, k, v)
        else:
            out, lse = _launch_forward(q, k, v, save_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cpu":
            return flash_attention_bwd_plain(*ctx.saved_tensors, g)
        return _launch_backward(*ctx.saved_tensors, g)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over [B, H, S, D] tensors, differentiable in q, k and
    v: the CUDA kernels for CUDA tensors, the plain versions for CPU tensors.
    With no gradient wanted nothing is saved and no logsumexp is written."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type == "cuda":
            _check(q, k, v)
        return _FlashAttention.apply(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    return _launch_forward(q, k, v, save_lse=False)[0]


flash_attention.launches = 0
flash_attention.bwd_launches = 0
