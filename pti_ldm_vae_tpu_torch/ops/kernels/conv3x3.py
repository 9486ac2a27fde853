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

Kernels, built with nvcc for ``sm_90a`` into shared libraries and called
through ctypes (see the sources for the designs and what bounds them); two
routes for each function, picked by pure functions of dtype, shape and
alignment (``forward_kernel``, ``wgrad_kernel``). Nothing chooses between
them at run time and neither stands in for the other when a build or a
launch fails.

- forward / input gradient: ``csrc/conv3x3_wgmma.cu`` for bf16 operands with
  any ``Cin`` up to ``WGMMA_MAX_CIN`` = 1520 (``wgmma`` on bf16 tiles, f32
  sums, asynchronous staging; the matrix's columns padded with zeros to a
  multiple of 8 by ``pad_columns``; a ``Cin`` that is no multiple of 8 — the
  1-channel stem, the 4- and 10-channel latents, a 20-channel ``conv_out``'s
  input gradient — padded with zero channels by ``pad_channels`` and
  ``pad_weight_channels``); ``csrc/conv3x3.cu`` (f32 FMAs, every shape) for
  f32 operands, for bf16 operands whose base address is not 16-byte aligned,
  and for a bf16 ``Cin`` above 1520;
- filter gradient: ``csrc/conv3x3_wgrad_wgmma.cu`` for bf16 operands
  (``wgmma`` with both operands read MN-major from staged tiles; a thin side,
  ``Cin`` or ``Cout`` no multiple of 8, padded with zero channels by
  ``pad_channels``); ``csrc/conv3x3_wgrad.cu`` (f32 FMAs) for f32 operands
  and unaligned bf16 ones. Both write f32 partial sums over pixel slabs,
  ``[n_slab, 9*Cin, Cout]``, folded by one ``torch.sum`` over the slab axis:
  no float atomics, so two runs give the same bits.

All kernels compute on the operands as given (bf16 products are exact in
f32), sum in f32 and round the output once.

``conv3x3(x, wmat)`` takes the weight matrix in any float dtype (the f32
parameter, repacked), rounds it to ``x``'s dtype for the kernels as the TPU
wrapper does, and hands back ``dW`` in the matrix's own dtype, unrounded. It
launches the kernels for CUDA tensors (or raises) and runs the plain versions
for CPU tensors; nothing falls back from one to the other.
``conv3x3.launches`` counts launches of the forward kernels (forward and input
gradient, tensor-core and FMA alike), ``conv3x3.wgrad_launches`` those of the
filter-gradient kernel; of ``launches``, ``conv3x3.fma_launches`` went to the
FMA kernel and ``conv3x3.padded_launches`` to the tensor-core kernel on
zero-padded channels.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = ["conv3x3", "conv3x3_plain", "conv3x3_bwd_plain", "flip_transpose", "forward_kernel",
           "pad_channels", "pad_columns", "pad_weight_channels", "unpad_wgrad", "WGMMA_MAX_CIN",
           "wgmma_smem_bytes", "wgmma_tile",
           "wgrad_kernel", "wgrad_slabs", "WGRAD_FMA_SLAB_PIXELS",
           "wgrad_warpgroups", "wgrad_wgmma_slabs", "wgrad_wgmma_smem_bytes", "SOURCES"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_SOURCE = "conv3x3.cu"
_WGMMA_SOURCE = "conv3x3_wgmma.cu"
_WGRAD_SOURCE = "conv3x3_wgrad.cu"
_WGRAD_WGMMA_SOURCE = "conv3x3_wgrad_wgmma.cu"
SOURCES = (_WGMMA_SOURCE, _FWD_SOURCE, _WGRAD_WGMMA_SOURCE, _WGRAD_SOURCE)

# the FMA filter gradient's tiling (csrc/conv3x3_wgrad.cu), which sizes the partial sums
_TILE_H, _TILE_W, _WGRAD_CI = 4, 32, 16
_WGRAD_BLOCKS_PER_SM = 4
_WGRAD_PARTIALS_BYTES = 16 * 2**20
# the f32-FMA filter gradient adds a slab's pixels one after another in f32, so
# its rounding grows with the slab: at 8 x 128² x 256 -> 256 the memory budget
# alone left 7 slabs of 18,724 pixels, and the worst dW error reached 1.9x the
# bar chip_smoke.py holds it to (an H100); slabs of at most this many pixels
# take precedence over the budget
WGRAD_FMA_SLAB_PIXELS = 4096


def flip_transpose(wmat: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """The matrix ``[9*Cout, Cin]`` with which the forward computes the input
    gradient: taps flipped in both directions, channels swapped."""
    return wmat.reshape(3, 3, cin, cout).flip(0, 1).transpose(2, 3).reshape(9 * cout, cin)


# kMaxCin of csrc/conv3x3_wgmma.cu: the widest Cin whose [9, Cin, 8] weight slab fits in a
# block's shared memory beside the smallest halo ring (wgmma_smem_bytes(1520, 1, 8, 16) =
# 231,152 bytes; 1528 would need 233,456)
WGMMA_MAX_CIN = 1520


def forward_kernel(dtype: torch.dtype, cin: int, aligned: bool = True) -> str:
    """Which kernel computes the forward / input gradient: ``"wgmma"`` (the
    tensor-core kernel, ``csrc/conv3x3_wgmma.cu``) for bf16 operands whose
    base addresses are 16-byte aligned and whose ``Cin`` is at most
    ``WGMMA_MAX_CIN`` (a block keeps its ``[9, Cin, TN]`` weight slab in
    shared memory, ``TN`` narrowed down to 8 as ``Cin`` grows: ``wgmma_tile``),
    else ``"fma"`` (``csrc/conv3x3.cu``): f32 operands, unaligned bf16 views,
    which 16-byte copies cannot read, and a wider ``Cin``.

    The kernel reads 8 channels per 16-byte piece, so a ``Cin`` that is no
    multiple of 8 (the 1-channel stem and the output conv's input gradient,
    the 4- and 10-channel latents, the 20-channel ``conv_out``'s input
    gradient) is padded with zero channels by the wrapper: ``x`` (or ``dy``)
    by ``pad_channels``, each tap's rows of the matrix by
    ``pad_weight_channels``; products with zero channels add nothing. The copy
    is one pass over the thin tensor, as in the filter gradient
    (``wgrad_kernel``)."""
    if dtype == torch.bfloat16 and aligned and cin <= WGMMA_MAX_CIN:
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
    a step stages ``kc`` input channels; ``cin`` is the kernel's (a multiple
    of 8, up to ``WGMMA_MAX_CIN``). ``tn`` is the widest of 64, 32, 16, 8 that
    is no wider than the smallest of them that covers ``Cout`` (else 64) and
    whose ``[9, Cin, tn]`` weight slab fits in shared memory beside the
    smallest ring (``mt`` 1, ``kc`` 16): 64 up to ``Cin`` 176, 32 up to 368,
    16 up to 752, 8 up to 1520 (a block keeps its slab and streams pixels;
    narrower blocks stage each halo tile for more N-groups); ``mt`` the
    widest of 4, 2, 1 that fits beside that slab and still cuts the work into
    at least one tile per two SMs (wider tiles reread less halo and reuse a
    weight slab longer; fewer tiles than that leave too much of the card
    idle); ``kc`` the largest of 64, 32, 16 that ``Cin`` fills, that fits in
    shared memory beside the slab and that does not leave an SM with a single
    resident block where two would fit (deeper steps copy longer runs of
    contiguous bytes per pixel and pass fewer barriers, but their larger ring
    costs occupancy). Measured on an H100 at the flagship's and the kl1e3
    model's shapes with ``tools/check_wgmma_kernels.py --tiles``."""
    cover = next((tn for tn in (8, 16, 32) if cout <= tn), 64)
    tn = next(tn for tn in (64, 32, 16, 8)
              if tn <= cover and wgmma_smem_bytes(cin, 1, tn, 16) <= _WGMMA_MAX_SMEM)
    per_column = b * _ceil_div(h, 8) * _ceil_div(cout, tn)
    mt = 1
    for wide in (4, 2):
        if (2 * per_column * _ceil_div(w, 8 * wide) >= n_sm
                and wgmma_smem_bytes(cin, wide, tn, 16) <= _WGMMA_MAX_SMEM):
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
    padded = kernel == "wgmma" and cin % 8 != 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if kernel == "wgmma":
            x, wmat = pad_channels(x), pad_weight_channels(wmat, cin)
            wpad = pad_columns(wmat)
            cin_k = x.shape[-1]
            mt, tn, kc = wgmma_tile(b, h, w, cin_k, cout, _sm_count(x.device))
            err = _wgmma_library().conv3x3_wgmma_fwd(
                x.data_ptr(), wpad.data_ptr(), y.data_ptr(), b, h, w, cin_k, cout, wpad.shape[1],
                mt, tn, kc, stream)
        else:
            err = _forward_library().conv3x3_fwd(
                x.data_ptr(), wmat.data_ptr(), y.data_ptr(), b, h, w, cin, cout,
                _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 forward ({kernel} kernel) launch failed: CUDA error {err}")
    conv3x3.launches += 1
    conv3x3.fma_launches += kernel == "fma"
    conv3x3.padded_launches += padded
    return y


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def wgrad_slabs(x_shape: tuple[int, ...], cout: int, n_sm: int) -> int:
    """How many pixel slabs the f32-FMA filter gradient is cut into: enough
    blocks to fill the card a few times over, partial sums within a few MiB,
    but no slab above ``WGRAD_FMA_SLAB_PIXELS`` pixels (the accuracy of its
    f32 chains) even where the partial sums then take more (75 MB at 8 x 128²
    x 256 -> 256)."""
    b, h, w, cin = x_shape
    n_tiles = b * _ceil_div(h, _TILE_H) * _ceil_div(w, _TILE_W)
    tile_c = 64 if cout > 32 else 32 if cout > 16 else 16
    groups = _ceil_div(cin, _WGRAD_CI) * _ceil_div(cout, tile_c)
    want = _ceil_div(_WGRAD_BLOCKS_PER_SM * n_sm, groups)
    cap = max(1, _WGRAD_PARTIALS_BYTES // (9 * cin * cout * 4))
    short = _ceil_div(b * h * w, WGRAD_FMA_SLAB_PIXELS)
    n_slab = max(1, min(n_tiles, max(min(want, cap), short)))
    return _ceil_div(n_tiles, _ceil_div(n_tiles, n_slab))  # no slab without a tile


def wgrad_kernel(dtype: torch.dtype, cin: int, cout: int, aligned: bool = True) -> str:
    """Which kernel computes the filter gradient: ``"wgmma"`` (the
    tensor-core kernel, ``csrc/conv3x3_wgrad_wgmma.cu``) for bf16 operands
    whose base addresses are 16-byte aligned, any image size and channel
    count (``cin`` and ``cout`` do not decide the route); else ``"fma"``
    (``csrc/conv3x3_wgrad.cu``): f32 operands, and unaligned bf16 views,
    which 16-byte copies cannot read.

    The kernel reads 8 channels per 16-byte piece, so a thin side (``Cin``
    or ``Cout`` no multiple of 8: the flagship's 1-channel stem and output
    convs and its 4-channel latent convs) is padded with zero channels by the
    wrapper (``pad_channels``) and the padded rows or columns of ``dW`` are
    dropped. The copy is one pass over the thin tensor. On an H100 the padded
    route is 3x faster than the FMA kernel at 32->1 and 1.5x at 128->4, and
    within a tenth of it at 1->32 and 4->128 (``PERF.md``, the filter
    gradient's per-shape table), so every bf16 call takes one route."""
    if dtype == torch.bfloat16 and aligned:
        return "wgmma"
    return "fma"


def pad_channels(t: torch.Tensor) -> torch.Tensor:
    """``t`` with zero channels appended up to a multiple of 8 on its last
    axis, as the tensor-core kernels read it (``t`` itself when it already
    is)."""
    pad = -t.shape[-1] % 8
    return t if pad == 0 else F.pad(t, (0, pad))


def pad_weight_channels(wmat: torch.Tensor, cin: int) -> torch.Tensor:
    """The matrix ``[9*Cin, Cout]`` with zero rows appended to each tap's
    ``Cin`` rows up to a multiple of 8, ``[9*Cin8, Cout]``: the weights of
    ``pad_channels(x)``, whose extra channels meet zero rows (``wmat`` itself
    when ``Cin`` already is a multiple of 8)."""
    pad = -cin % 8
    if pad == 0:
        return wmat
    cout = wmat.shape[1]
    return F.pad(wmat.reshape(9, cin, cout), (0, 0, 0, pad)).reshape(9 * (cin + pad), cout)


def wgrad_wgmma_smem_bytes(wg: int) -> int:
    """Shared memory per block of the tensor-core filter gradient with ``wg``
    warpgroups (``smem_bytes`` of ``csrc/conv3x3_wgrad_wgmma.cu``): three
    stages of the x halo (8 planes of 10 x 18 pixels, 2960 bytes each with
    padding) and of the dy tile (``wg`` * 4 planes of 8 x 16 pixels, 2064
    bytes each)."""
    return 3 * (8 * 2960 + wg * 4 * 2064)


def wgrad_warpgroups(cout: int) -> int:
    """Warpgroups per block of the tensor-core filter gradient: a warpgroup
    owns all nine taps x 64 input channels x 32 output channels; at ``Cout``
    up to 32 a block is one (two blocks per SM), wider ``Cout`` takes two on
    64 output channels, which share each staged x halo (the kernel is bound
    by its copies, and this halves the x it copies). Measured on an H100 at
    every flagship shape with ``tools/check_wgmma_kernels.py --tiles``."""
    return 1 if cout <= 32 else 2


# the longest run of pixels one accumulator sums before its partial is written: wgmma's f32
# accumulation rounds more coarsely than one f32 add per product, and the error grows with
# the run (tools/check_wgmma_kernels.py --tiles measures it against float64): over the
# flagship's shapes the worst dW error reached 0.71 of the bar chip_smoke.py holds it to at
# 2048 pixels, 0.32 at 1024 (an H100, tools/check_wgmma_kernels.py)
WGRAD_SLAB_PIXELS = 1024


def wgrad_wgmma_slabs(shape: tuple[int, ...], wg: int, n_sm: int) -> int:
    """How many pixel slabs the tensor-core filter gradient cuts ``shape`` =
    ``(B, H, W, Cin, Cout)`` into. The blocks of a slab are its output tiles
    (64-channel groups of ``Cin`` x ``32*wg``-groups of ``Cout``); slabs
    multiply them by whole waves of the blocks the card holds at once (two
    per SM at ``wg`` 1, one at 2: registers and shared memory), as few waves
    as keep a slab within ``WGRAD_SLAB_PIXELS`` pixels; at most one slab per
    pixel tile of 8 x 16 (the kernel hands slab ``i`` the tiles ``[i * n /
    n_slab, (i + 1) * n / n_slab)``). Fewer slabs, so that the partial sums
    stay within a quarter of the input bytes, were slower at the 32² and 64²
    levels, where the card then idles."""
    b, h, w, cin, cout = shape
    n_tiles = b * _ceil_div(h, 8) * _ceil_div(w, 16)
    groups = _ceil_div(cin, 64) * _ceil_div(cout, 32 * wg)
    one_wave = _ceil_div(2 // wg * n_sm, groups)
    waves = _ceil_div(_ceil_div(b * h * w, WGRAD_SLAB_PIXELS), one_wave)
    return min(n_tiles, waves * one_wave)


@functools.cache
def _wgrad_wgmma_library() -> ctypes.CDLL:
    from ._build import load

    lib = load(_WGRAD_WGMMA_SOURCE)
    fn = lib.conv3x3_wgrad_wgmma
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The filter-gradient launch on contiguous CUDA tensors of one dtype:
    ``dW [9*Cin, Cout]`` in f32."""
    b, h, w, cin = x.shape
    cout = g.shape[-1]
    if x.numel() == 0 or g.numel() == 0:
        return torch.zeros((9 * cin, cout), device=x.device, dtype=torch.float32)
    n_sm = _sm_count(x.device)
    kernel = wgrad_kernel(x.dtype, cin, cout, x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)
    if kernel == "wgmma":
        x, g = pad_channels(x), pad_channels(g)
        wg = wgrad_warpgroups(g.shape[-1])
        n_slab = wgrad_wgmma_slabs(tuple(x.shape) + (g.shape[-1],), wg, n_sm)
    else:
        n_slab = wgrad_slabs(tuple(x.shape), cout, n_sm)
    cin_k, cout_k = x.shape[-1], g.shape[-1]
    partials = torch.empty((n_slab, 9 * cin_k, cout_k), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if kernel == "wgmma":
            err = _wgrad_wgmma_library().conv3x3_wgrad_wgmma(
                x.data_ptr(), g.data_ptr(), partials.data_ptr(), b, h, w, cin_k, cout_k, n_slab, wg,
                stream)
        else:
            err = _wgrad_library().conv3x3_wgrad(
                x.data_ptr(), g.data_ptr(), partials.data_ptr(), b, h, w, cin, cout, n_slab,
                _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad ({kernel} kernel) launch failed: CUDA error {err}")
    conv3x3.wgrad_launches += 1
    dw = partials.sum(dim=0) if n_slab > 1 else partials[0]
    return unpad_wgrad(dw, cin, cout)


def unpad_wgrad(dw: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """``dW [9*Cin, Cout]`` out of the filter gradient of channel-padded
    operands, ``[9*cin_k, cout_k]``: the rows and columns of the padding
    dropped (``dw`` itself when nothing was padded)."""
    cin_k, cout_k = dw.shape[0] // 9, dw.shape[1]
    if (cin_k, cout_k) == (cin, cout):
        return dw
    return dw.reshape(9, cin_k, cout_k)[:, :cin, :cout].reshape(9 * cin, cout)


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
conv3x3.fma_launches = 0
conv3x3.padded_launches = 0
