"""3x3 stride-1 SAME convolution on NHWC tensors: hand-written CUDA kernels
(forward / input gradient, and filter gradient) beside their plain PyTorch
versions, bound to autograd.

Replaces ``pti_ldm_vae_tpu/ops/pallas/conv2d.py``: ``_conv3x3_fwd_pallas``
(body ``_fwd_kernel``), ``y = patches(x) @ wmat`` for the tap-major weight
matrix ``wmat [9*Cin, Cout]`` (row ``(ky*3+kx)*Cin + ci``), f32 products and
sums, output in ``x``'s dtype, no bias — and, on ``dy`` with the spatially
flipped, channel-transposed matrix, the input gradient; and
``_conv3x3_dw_pallas`` (body ``_dw_kernel``), ``dW = patches(x)^T @ dy`` in
f32.

Kernels: ``csrc/conv3x3_wgmma.cu``, ``csrc/conv3x3.cu`` and
``csrc/conv3x3_wgrad.cu`` (see those files for the designs and what bounds
them), built with nvcc for ``sm_90a`` into shared libraries and called through
ctypes. The forward / input gradient has two kernels, picked by
``forward_kernel`` from the dtype and the shape alone: bf16 operands with
``Cin`` a multiple of 8 up to 128 go to the tensor-core kernel (``wgmma`` on bf16 tiles,
f32 sums, asynchronous staging; the matrix's columns padded with zeros to a
multiple of 8 by ``pad_columns``); f32 operands, and bf16 operands with any
other ``Cin`` (the 1-channel stem, the 4-channel latent, wider than 128) or a base address
that is not 16-byte aligned, go to the f32-FMA kernel, which takes every
shape. Nothing chooses between them at run time and neither stands in for the
other when a build or a launch fails. The filter gradient is written as
f32 partial sums over pixel slabs, ``[n_slab, 9*Cin, Cout]``, and folded by
one ``torch.sum`` over the slab axis: no float atomics, so two runs give the
same bits; it does its products as f32 FMAs, for bf16 inputs too. All kernels
compute on the operands as given (bf16 products are exact in f32), sum in f32
and round the output once.

``conv3x3(x, wmat)`` takes the weight matrix in any float dtype (the f32
parameter, repacked), rounds it to ``x``'s dtype for the kernels as the TPU
wrapper does, and hands back ``dW`` in the matrix's own dtype, unrounded. It
launches the kernels for CUDA tensors (or raises) and runs the plain versions
for CPU tensors; nothing falls back from one to the other.
``conv3x3.launches`` counts launches of the forward kernels (forward and input
gradient, tensor-core and FMA alike), ``conv3x3.wgrad_launches`` those of the
filter-gradient kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = ["conv3x3", "conv3x3_plain", "conv3x3_bwd_plain", "flip_transpose", "forward_kernel",
           "pad_columns", "wgmma_smem_bytes", "wgmma_tile", "SOURCES"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_SOURCE = "conv3x3.cu"
_WGMMA_SOURCE = "conv3x3_wgmma.cu"
_WGRAD_SOURCE = "conv3x3_wgrad.cu"
SOURCES = (_WGMMA_SOURCE, _FWD_SOURCE, _WGRAD_SOURCE)

# the kernels' tiling (csrc/conv3x3_wgrad.cu), which sizes the partial sums
_TILE_H, _TILE_W, _WGRAD_CI = 4, 32, 16
_WGRAD_BLOCKS_PER_SM = 4
_WGRAD_PARTIALS_BYTES = 16 * 2**20


def flip_transpose(wmat: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """The matrix ``[9*Cout, Cin]`` with which the forward computes the input
    gradient: taps flipped in both directions, channels swapped."""
    return wmat.reshape(3, 3, cin, cout).flip(0, 1).transpose(2, 3).reshape(9 * cout, cin)


WGMMA_MAX_CIN = 128  # kMaxCin of csrc/conv3x3_wgmma.cu


def forward_kernel(dtype: torch.dtype, cin: int, aligned: bool = True) -> str:
    """Which kernel computes the forward / input gradient: ``"wgmma"`` (the
    tensor-core kernel, ``csrc/conv3x3_wgmma.cu``) for bf16 operands whose
    ``Cin`` is a multiple of 8 (its 16-byte pieces hold 8 channels) up to 128
    (a block keeps its ``[9, Cin, 64]`` weight slab in shared memory) and
    whose base addresses are 16-byte aligned, else ``"fma"``
    (``csrc/conv3x3.cu``)."""
    if dtype == torch.bfloat16 and 8 <= cin <= WGMMA_MAX_CIN and cin % 8 == 0 and aligned:
        return "wgmma"
    return "fma"


def pad_columns(wmat: torch.Tensor) -> torch.Tensor:
    """The weight matrix with zero columns appended up to a multiple of 8, as
    the tensor-core kernel reads it (``wmat`` itself when it already is)."""
    pad = -wmat.shape[1] % 8
    return wmat if pad == 0 else F.pad(wmat, (0, pad))


_WGMMA_MAX_SMEM = 232448  # bytes of shared memory a block may ask for on sm_90


def wgmma_smem_bytes(cin: int, mt: int, tn: int, kc: int) -> int:
    """Shared memory per block of the tensor-core kernel (``smem_bytes`` of
    ``csrc/conv3x3_wgmma.cu``): the block's weight slab, a ring of three halo
    stages of ``kc`` channels, the epilogue buffers."""
    group = _ceil_div(cin, kc) * kc * 16 + 16
    plane = _ceil_div(10 * (8 * mt + 2) * 16, 128) * 128 + 16
    return 9 * (tn // 8) * group + 3 * (kc // 8) * plane + 64 * (2 * tn + 16)


def _resident_blocks(smem: int) -> int:
    """Blocks of that much shared memory an sm_90 SM holds (228 KB, 1 KB kept per block)."""
    return (228 * 1024) // (smem + 1024)


def wgmma_tile(b: int, h: int, w: int, cin: int, cout: int, n_sm: int) -> tuple[int, int, int]:
    """The tensor-core kernel's tile for a shape, ``(mt, tn, kc)``: a tile is
    ``mt`` patches of 8 x 8 pixels side by side by ``tn`` output channels, and
    a step stages ``kc`` input channels. ``tn`` is the smallest of 8, 32, 64
    that covers ``Cout`` (else 64); ``mt`` the widest of 4, 2, 1 that still
    cuts the work into at least one tile per two SMs (wider tiles reread less
    halo and reuse a weight slab longer; fewer tiles than that leave too much
    of the card idle); ``kc`` the largest of 64, 32, 16 that ``Cin`` fills,
    that fits in shared memory beside the slab and that does not leave an SM
    with a single resident block where two would fit (deeper steps copy longer
    runs of contiguous bytes per pixel and pass fewer barriers, but their
    larger ring costs occupancy). Measured on an H100 at the flagship's
    shapes with ``tools/check_wgmma_kernels.py --tiles``."""
    tn = 8 if cout <= 8 else 32 if cout <= 32 else 64
    per_column = b * _ceil_div(h, 8) * _ceil_div(cout, tn)
    mt = 1
    for wide in (4, 2):
        if 2 * per_column * _ceil_div(w, 8 * wide) >= n_sm:
            mt = wide
            break
    keep = min(2, _resident_blocks(wgmma_smem_bytes(cin, mt, tn, 16)))
    for kc in (64, 32):
        smem = wgmma_smem_bytes(cin, mt, tn, kc)
        if cin >= kc and smem <= _WGMMA_MAX_SMEM and _resident_blocks(smem) >= keep:
            return mt, tn, kc
    return mt, tn, 16


def _as_oihw(wmat: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    return wmat.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def conv3x3_plain(x: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the convolution in f32 on
    the operands as given, rounded once to ``x``'s dtype."""
    cin, cout = x.shape[-1], wmat.shape[1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), _as_oihw(wmat.float(), cin, cout), padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def conv3x3_bwd_plain(
    x: torch.Tensor, wmat: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: ``dx`` is the forward on ``g``
    with the flipped, transposed matrix (in ``g``'s dtype); ``dW [9*Cin,
    Cout]`` is, tap by tap, the product of the shifted ``x`` with ``g`` over
    all pixels, in f32."""
    b, h, w, cin = x.shape
    cout = wmat.shape[1]
    dx = conv3x3_plain(g, flip_transpose(wmat, cin, cout))
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float().reshape(-1, cout)
    taps = [xp[:, ky:ky + h, kx:kx + w, :].reshape(-1, cin).t() @ gf
            for ky in range(3) for kx in range(3)]
    return dx, torch.cat(taps, dim=0)


@functools.cache
def _forward_library() -> ctypes.CDLL:
    from ._build import load

    lib = load(_FWD_SOURCE)
    fn = lib.conv3x3_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _wgmma_library() -> ctypes.CDLL:
    from ._build import load

    lib = load(_WGMMA_SOURCE)
    fn = lib.conv3x3_wgmma_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _wgrad_library() -> ctypes.CDLL:
    from ._build import load

    lib = load(_WGRAD_SOURCE)
    fn = lib.conv3x3_wgrad
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, wmat: torch.Tensor) -> None:
    if x.dim() != 4 or wmat.dim() != 2 or wmat.shape[0] != 9 * x.shape[-1]:
        raise ValueError(f"conv3x3 takes x [B, H, W, Cin] and wmat [9*Cin, Cout]; got "
                         f"{tuple(x.shape)} and {tuple(wmat.shape)}")
    if x.dtype not in _DTYPE_CODES or not wmat.is_floating_point():
        raise TypeError(f"conv3x3 takes float32 or bfloat16 x and a float wmat; got {x.dtype}, "
                        f"{wmat.dtype}")
    if x.device != wmat.device:
        raise ValueError(f"x on {x.device} but wmat on {wmat.device}")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the kernel's grid (65535)")


def _launch_forward(x: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """The forward launch on contiguous CUDA tensors of one dtype."""
    b, h, w, cin = x.shape
    cout = wmat.shape[1]
    y = torch.empty((b, h, w, cout), device=x.device, dtype=x.dtype)
    if y.numel() == 0:
        return y
    aligned = x.data_ptr() % 16 == 0 and wmat.data_ptr() % 16 == 0
    kernel = forward_kernel(x.dtype, cin, aligned)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if kernel == "wgmma":
            wpad = pad_columns(wmat)
            mt, tn, kc = wgmma_tile(b, h, w, cin, cout, _sm_count(x.device))
            err = _wgmma_library().conv3x3_wgmma_fwd(
                x.data_ptr(), wpad.data_ptr(), y.data_ptr(), b, h, w, cin, cout, wpad.shape[1],
                mt, tn, kc, stream)
        else:
            err = _forward_library().conv3x3_fwd(
                x.data_ptr(), wmat.data_ptr(), y.data_ptr(), b, h, w, cin, cout,
                _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 forward ({kernel} kernel) launch failed: CUDA error {err}")
    conv3x3.launches += 1
    return y


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def wgrad_slabs(x_shape: tuple[int, ...], cout: int, n_sm: int) -> int:
    """How many pixel slabs the filter gradient is cut into: enough blocks to
    fill the card a few times over, partial sums within a few MiB."""
    b, h, w, cin = x_shape
    n_tiles = b * _ceil_div(h, _TILE_H) * _ceil_div(w, _TILE_W)
    tile_c = 64 if cout > 32 else 32 if cout > 16 else 16
    groups = _ceil_div(cin, _WGRAD_CI) * _ceil_div(cout, tile_c)
    want = _ceil_div(_WGRAD_BLOCKS_PER_SM * n_sm, groups)
    cap = max(1, _WGRAD_PARTIALS_BYTES // (9 * cin * cout * 4))
    n_slab = max(1, min(n_tiles, want, cap))
    return _ceil_div(n_tiles, _ceil_div(n_tiles, n_slab))  # no slab without a tile


def _launch_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The filter-gradient launch on contiguous CUDA tensors of one dtype:
    ``dW [9*Cin, Cout]`` in f32."""
    b, h, w, cin = x.shape
    cout = g.shape[-1]
    if x.numel() == 0 or g.numel() == 0:
        return torch.zeros((9 * cin, cout), device=x.device, dtype=torch.float32)
    n_sm = _sm_count(x.device)
    n_slab = wgrad_slabs(tuple(x.shape), cout, n_sm)
    partials = torch.empty((n_slab, 9 * cin, cout), device=x.device, dtype=torch.float32)
    lib = _wgrad_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_wgrad(x.data_ptr(), g.data_ptr(), partials.data_ptr(), b, h, w, cin,
                                cout, n_slab, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad launch failed: CUDA error {err}")
    conv3x3.wgrad_launches += 1
    return partials.sum(dim=0) if n_slab > 1 else partials[0]


class _Conv3x3(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA) or their plain versions (CPU)."""

    @staticmethod
    def forward(ctx, x, wmat):
        wk = wmat.to(x.dtype).contiguous()  # the kernels' operand, rounded as x is
        ctx.save_for_backward(x, wk)
        ctx.wmat_dtype = wmat.dtype
        return conv3x3_plain(x, wk) if x.device.type == "cpu" else _launch_forward(x, wk)

    @staticmethod
    def backward(ctx, g):
        x, wk = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad
        cin, cout = x.shape[-1], wk.shape[1]
        g = g.to(x.dtype).contiguous()  # autograd often hands over a strided view
        dx = dw = None
        if g.device.type == "cpu":
            got_dx, got_dw = conv3x3_bwd_plain(x, wk, g)
            dx = got_dx if need_dx else None
            dw = got_dw.to(ctx.wmat_dtype) if need_dw else None
            return dx, dw
        if need_dx:
            dx = _launch_forward(g, flip_transpose(wk, cin, cout).contiguous())
        if need_dw:
            dw = _launch_wgrad(x, g).to(ctx.wmat_dtype)
        return dx, dw


def conv3x3(x: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME convolution of NHWC ``x`` with the tap-major matrix
    ``wmat [9*Cin, Cout]``, differentiable in both: the CUDA kernels for CUDA
    tensors, the plain versions for CPU tensors. ``x`` is made contiguous
    here (upsampled or permuted views arrive strided)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"conv3x3 runs on cuda or cpu, got {x.device}")
    _check(x, wmat)
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or wmat.requires_grad):
        return _Conv3x3.apply(x, wmat)
    wk = wmat.detach().to(x.dtype).contiguous()
    return conv3x3_plain(x, wk) if x.device.type == "cpu" else _launch_forward(x, wk)


conv3x3.launches = 0
conv3x3.wgrad_launches = 0
