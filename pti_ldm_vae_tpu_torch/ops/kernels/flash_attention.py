"""Flash attention, forward and backward: hand-written CUDA kernels beside
their plain PyTorch versions, bound to autograd.

Replaces ``pti_ldm_vae_tpu/ops/pallas/flash_attention.py``: ``_forward``
(body ``_kernel``), ``softmax(q k^T * d^-0.5) v`` over ``[B, H, S, D]``
tensors, self-attention only, softmax statistics in f32; and ``_bwd_pallas``
(body ``_bwd_kernel``), which recomputes ``p`` and gives ``dv = p^T g``,
``dp = g v^T``, ``ds = p * (dp - rowsum(dp * p))``, ``dq = ds k * d^-0.5``,
``dk = ds^T q * d^-0.5``.

Kernels, two routes each way, picked by a pure function of dtype, head dim
and alignment (``forward_kernel``, ``backward_kernel``; no flag, and neither
stands in for the other when a build or a launch fails):

- forward: ``csrc/flash_attention_wgmma.cu`` for bf16 (``wgmma`` for both
  products, ``p`` rounded to bf16 between them) and ``csrc/flash_attention.cu``
  for f32 and for bf16 tensors whose base address is not 16-byte aligned
  (f32 FMAs); either also writes the row logsumexp ``[B, H, S]`` f32 when a
  backward will follow;
- backward: ``csrc/flash_attention_bwd_wgmma.cu`` for bf16 (the
  ``delta = rowsum(dO * O)`` pre-pass, then one launch whose blocks compute
  ``dk``/``dv`` per kv tile or ``dq`` per q tile, every product on ``wgmma``,
  ``p`` and ``ds`` rounded to bf16 before the products they feed, as the TPU
  kernel rounds them to the input dtype) and ``csrc/flash_attention_bwd.cu``
  for f32 and unaligned bf16 (three launches: pre-pass, ``dk``/``dv``
  kernel, ``dq`` kernel, f32 FMAs, ``p`` and ``ds`` kept in f32). Neither
  uses float atomics, so gradients are bit-identical run to run.

All are built with nvcc for ``sm_90a`` into shared libraries and called
through ctypes (see the sources for the designs). On the VAE's main path
attention runs twice per step (encoder and decoder mid blocks) at ``[B, 1,
1024, 128]``: 4.3 GFLOP forward and 10.7 GFLOP backward per call at B=8,
hundreds of FLOP per input byte, so the bound on an H100 is arithmetic. The
64-128-256 AR-VAE (``config/ar_vae_dente_kl1e3.json``) has one head of 256
over 64² tokens, ``[B, 1, 4096, 256]``: 137.4 GFLOP forward and 343.6
backward at B=8, on the f32-FMA kernels in both types (the tensor-core ones
stop at head dim 128; the backward's tiles shrink to 32 rows there).

Head dims: the kernels are instantiated at 16, 32, 64, 128, 256 and 512
(``SUPPORTED_HEAD_DIMS``). On CUDA any other head dim up to 512 is zero-padded
along D to the next of them (``padded_head_dim``) with ``F.pad``, and the
output is sliced back: zero columns leave ``q k^T`` and the first D output
columns exact, and autograd slices the gradients. The launch gets the
softmax scale of the unpadded D, ``D^-0.5``, explicitly. So a [128, 256, 512,
512] VAE's mid block (head dim 512) takes the f32-FMA kernels at D = 512, and
head dim 96 pads to 128 and takes the tensor-core kernels in bf16. A head dim
above 512 raises. The JAX package's Pallas kernel takes any head dim, so D >
512 is the one gap left against it.

``flash_attention`` launches the kernels for CUDA tensors (or raises) and
runs the plain versions, forward and backward formula, for CPU tensors;
nothing falls back from one to the other. ``flash_attention.launches`` counts
forward launches, ``flash_attention.bwd_launches`` backward calls that
launched the backward kernels, and ``flash_attention.padded_launches`` the
forward and backward launches among those that ran on padded tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd_plain",
           "forward_kernel", "backward_kernel", "padded_head_dim", "pad_head_dim",
           "bwd_wgmma_smem_bytes", "bwd_fma_tile", "bwd_fma_smem_bytes",
           "bwd_fma_smem_of_library", "fwd_fma_tile", "fwd_fma_smem_bytes",
           "fwd_fma_smem_of_library", "SUPPORTED_HEAD_DIMS", "WGMMA_HEAD_DIMS", "SOURCES"]

# the head dims the kernels are instantiated at; others pad up to the next one
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256, 512)
# the tensor-core kernels' head dims; D = 256 and 512 (one head over a 256- or
# 512-channel mid block) take the f32-FMA kernels in both types
WGMMA_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_SOURCE = "flash_attention.cu"
_WGMMA_SOURCE = "flash_attention_wgmma.cu"
_BWD_SOURCE = "flash_attention_bwd.cu"
_BWD_WGMMA_SOURCE = "flash_attention_bwd_wgmma.cu"
SOURCES = (_WGMMA_SOURCE, _FWD_SOURCE, _BWD_WGMMA_SOURCE, _BWD_SOURCE)


def forward_kernel(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> str:
    """Which kernel computes the forward: ``"wgmma"`` (the tensor-core kernel,
    ``csrc/flash_attention_wgmma.cu``) for bf16 inputs of a head dim up to
    128 (all are multiples of 16, one ``wgmma`` depth step) at 16-byte aligned
    base addresses, any sequence length; else ``"fma"``
    (``csrc/flash_attention.cu``): f32, unaligned bf16, and head dim 256 in
    both types."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS and aligned:
        return "wgmma"
    return "fma"


def backward_kernel(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> str:
    """Which kernel computes the backward: ``"wgmma"`` (the tensor-core
    kernel, ``csrc/flash_attention_bwd_wgmma.cu``) for bf16 inputs of a head
    dim up to 128 whose tensors (q, k, v, out, the upstream gradient and the
    three gradients) start 16-byte aligned, any sequence length (ragged tiles
    are masked); else ``"fma"`` (``csrc/flash_attention_bwd.cu``): f32
    inputs, which keep f32 ``p`` and ``ds``, unaligned bf16 views, which
    16-byte copies cannot read, and head dim 256 in both types."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS and aligned:
        return "wgmma"
    return "fma"


def padded_head_dim(head_dim: int) -> int:
    """The instantiated head dim a call at ``head_dim`` runs at: the smallest
    of ``SUPPORTED_HEAD_DIMS`` not below it. Raises above 512."""
    for d in SUPPORTED_HEAD_DIMS:
        if head_dim <= d:
            return d
    raise ValueError(f"flash_attention: head dim {head_dim} is above {SUPPORTED_HEAD_DIMS[-1]}, "
                     "the largest the kernels are built for")


def pad_head_dim(t: torch.Tensor, head_dim: int) -> torch.Tensor:
    """``t`` [..., D] zero-padded along its last dim to ``head_dim`` columns."""
    return F.pad(t, (0, head_dim - t.shape[-1]))


def fwd_fma_tile(head_dim: int) -> int:
    """Rows of a q tile and of a kv tile in the f32-FMA forward
    (``block_rows`` of ``csrc/flash_attention.cu``): 64 up to head dim 256,
    32 at 512, where 64-row f32 tiles would not fit a block's shared memory."""
    return 64 if head_dim <= 256 else 32


def fwd_fma_smem_bytes(head_dim: int) -> int:
    """Shared memory per block (bytes) of the f32-FMA forward
    (``smem_floats``): the q [t][D], k [t][D+1] and v [t][D] f32 tiles, the
    [t][t+1] p tile and the rows' m, l and correction."""
    t = fwd_fma_tile(head_dim)
    return 4 * (t * head_dim + t * (head_dim + 1) + t * head_dim + t * (t + 1) + 3 * t)


def bwd_fma_tile(head_dim: int) -> int:
    """Rows of a q tile and of a kv tile in the f32-FMA backward
    (``tile_rows`` of ``csrc/flash_attention_bwd.cu``): 64 up to head dim
    128, 32 at 256 and 16 at 512, where four staged f32 tiles of more rows
    would not fit a block's shared memory."""
    return 64 if head_dim <= 128 else 32 if head_dim <= 256 else 16


def bwd_fma_smem_bytes(head_dim: int) -> tuple[int, int]:
    """Shared memory per block (bytes) of the f32-FMA backward's dk/dv and dq
    kernels (``dkdv_smem_floats`` / ``dq_smem_floats``): four [tile][D+1] f32
    tiles (k, v, q, dO), the [tile][tile+1] p and ds tiles (dq: ds only) and
    the rows' lse and delta."""
    t = bwd_fma_tile(head_dim)
    tiles = 4 * t * (head_dim + 1) + 2 * t
    return 4 * (tiles + 2 * t * (t + 1)), 4 * (tiles + t * (t + 1))


def bwd_wgmma_smem_bytes(head_dim: int) -> int:
    """Shared memory per block of the tensor-core backward (``smem_bytes`` of
    ``csrc/flash_attention_bwd_wgmma.cu``): a resident slot for each of the
    block's two warpgroups and a ring of three streamed slots, each slot two
    64-row tiles (``head_dim / 8`` planes of 1040 bytes) and a row of
    statistics (512 bytes)."""
    slot = 2 * (head_dim // 8 * (64 * 16 + 16)) + 512
    return (2 + 3) * slot


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernels: f32 scores, f32 softmax,
    f32 weighted sum, result in the input dtype; ``scale`` defaults to
    ``D^-0.5``. The tensor-core kernel rounds the unnormalized weights ``p``
    (in [0, 1]) to bf16 before its second product, which this version does
    not; the bf16 bar (atol 2e-2 against this version in f32 on the same
    rounded inputs) covers that rounding."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: ``(dq, dk, dv)`` for the
    upstream gradient ``g``, by the formulas in the module docstring with
    everything in f32, results in the input dtypes; ``scale`` defaults to
    ``D^-0.5``. The tensor-core kernel rounds ``p`` and ``ds`` to bf16 before
    the products they feed, which this version does not; the bf16 bar (atol
    2e-2 against this version in f32 on the same rounded inputs) covers that
    rounding."""
    if scale is None:
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
    lib.flash_attention_fwd_smem.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.flash_attention_fwd_smem.restype = ctypes.c_int
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
def _bwd_wgmma_library() -> ctypes.CDLL:
    from ._build import load

    lib = load(_BWD_WGMMA_SOURCE)
    fn = lib.flash_attention_bwd_wgmma
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _backward_library() -> ctypes.CDLL:
    from ._build import load

    lib = load(_BWD_SOURCE)
    fn = lib.flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_smem.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.flash_attention_bwd_smem.restype = ctypes.c_int
    return lib


def bwd_fma_smem_of_library(head_dim: int) -> tuple[int, int, int]:
    """(tile rows, dk/dv bytes, dq bytes) of the f32-FMA backward at
    ``head_dim`` as the built library reports them (``flash_attention_bwd_smem``);
    raises for a head dim it does not instantiate. Needs nvcc: the card's side
    of ``bwd_fma_tile`` / ``bwd_fma_smem_bytes``."""
    tile, dkdv, dq = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _backward_library().flash_attention_bwd_smem(
        head_dim, ctypes.byref(tile), ctypes.byref(dkdv), ctypes.byref(dq))
    if err != 0:
        raise ValueError(f"the FMA backward has no head dim {head_dim} (CUDA error {err})")
    return tile.value, dkdv.value, dq.value


def fwd_fma_smem_of_library(head_dim: int) -> tuple[int, int]:
    """(tile rows, bytes) of the f32-FMA forward at ``head_dim`` as the built
    library reports them (``flash_attention_fwd_smem``); raises for a head dim
    it does not instantiate. Needs nvcc: the card's side of ``fwd_fma_tile`` /
    ``fwd_fma_smem_bytes``."""
    rows, nbytes = ctypes.c_int(), ctypes.c_int()
    err = _forward_library().flash_attention_fwd_smem(head_dim, ctypes.byref(rows),
                                                       ctypes.byref(nbytes))
    if err != 0:
        raise ValueError(f"the FMA forward has no head dim {head_dim} (CUDA error {err})")
    return rows.value, nbytes.value


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape; got {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS} (pad it first)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def _launch_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, save_lse: bool, scale: float,
    padded: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The forward launch on CUDA tensors of an instantiated head dim, with
    softmax scale ``scale`` (the caller's ``D^-0.5``, which a padded call's D
    does not give): (out, lse [B, H, S] f32 or None). ``padded`` says that q,
    k and v carry zero columns past the caller's head dim."""
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
            err = _wgmma_library().flash_attention_wgmma_fwd(*pointers, b * h, s, d, scale, stream)
        else:
            err = _forward_library().flash_attention_fwd(
                *pointers, b * h, s, d, _DTYPE_CODES[q.dtype], scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention forward ({kernel} kernel) launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.padded_launches += int(padded)
    return out, lse


def _launch_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
    g: torch.Tensor, scale: float, padded: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward launches on CUDA tensors of an instantiated head dim, with
    softmax scale ``scale`` and ``padded`` as for ``_launch_forward``: (dq,
    dk, dv)."""
    _check(q, k, v)
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"upstream gradient {tuple(g.shape)} on {g.device} does not match q")
    g = g.to(q.dtype).contiguous()  # autograd often hands over a strided view
    b, h, s, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, out, g, dq, dk, dv))
    kernel = backward_kernel(q.dtype, d, aligned)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if kernel == "wgmma":
            err = _bwd_wgmma_library().flash_attention_bwd_wgmma(
                *pointers, b * h, s, d, scale, stream)
        else:
            err = _backward_library().flash_attention_bwd(
                *pointers, b * h, s, d, _DTYPE_CODES[q.dtype], scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward ({kernel} kernel) launch failed: CUDA error {err}")
    flash_attention.bwd_launches += 1
    flash_attention.padded_launches += int(padded)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA) or their plain versions
    (CPU), at softmax scale ``scale``; ``padded`` says that q, k and v carry
    zero columns past the caller's head dim (counted in ``padded_launches``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, padded):
        ctx.scale, ctx.padded = scale, padded
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, scale)
            ctx.save_for_backward(q, k, v)
        else:
            out, lse = _launch_forward(q, k, v, True, scale, padded)
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cpu":
            return (*flash_attention_bwd_plain(*ctx.saved_tensors, g, ctx.scale), None, None)
        return (*_launch_backward(*ctx.saved_tensors, g, ctx.scale, ctx.padded), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention over [B, H, S, D] tensors, scale ``D^-0.5``,
    differentiable in q, k and v: the CUDA kernels for CUDA tensors (a head dim
    they are not built for zero-padded to the next one, see the module
    docstring), the plain versions for CPU tensors. With no gradient wanted
    nothing is saved and no logsumexp is written."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    d = q.shape[-1]
    scale = d**-0.5
    padded = False
    if q.device.type == "cuda" and d not in SUPPORTED_HEAD_DIMS:
        d_pad = padded_head_dim(d)
        q, k, v = (pad_head_dim(t, d_pad) for t in (q, k, v))
        padded = True
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type == "cuda":
            _check(q, k, v)
        out = _FlashAttention.apply(q, k, v, scale, padded)
    elif q.device.type == "cpu":
        out = flash_attention_plain(q, k, v)
    else:
        out = _launch_forward(q, k, v, False, scale, padded)[0]
    return out[..., :d] if padded else out


flash_attention.launches = 0
flash_attention.bwd_launches = 0
flash_attention.padded_launches = 0
