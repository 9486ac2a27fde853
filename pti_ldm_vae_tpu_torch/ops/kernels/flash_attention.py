"""Flash-attention forward: hand-written CUDA kernel + its plain PyTorch version.

Replaces ``pti_ldm_vae_tpu/ops/pallas/flash_attention.py`` (``_forward``,
body ``_kernel``): ``softmax(q k^T * d^-0.5) v`` over ``[B, H, S, D]``
tensors, self-attention only, softmax statistics in f32.

Kernel: ``csrc/flash_attention.cu``, built with nvcc for ``sm_90a`` into a
shared library and called through ctypes (see that file for the design). On
the VAE's main path it runs twice per reconstruct (encoder and decoder mid
blocks) at ``[B, 1, 1024, 128]``: 4.3 GFLOP per call at B=8, ~540 FLOP per
input byte in bf16, so its bound on an H100 is arithmetic. This first kernel
does its products with f32 FMAs, not the tensor cores.

``flash_attention`` launches the kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors; nothing falls back from one to the other.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["flash_attention", "flash_attention_plain", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "flash_attention.cu"


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 scores, f32 softmax, f32
    weighted sum, result in the input dtype."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    from ._build import load

    lib = load(_SOURCE)
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("flash_attention has no backward kernel yet")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over [B, H, S, D] tensors: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    _check(q, k, v)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, s, d, _DTYPE_CODES[q.dtype], d**-0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
