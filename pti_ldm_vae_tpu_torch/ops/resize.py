"""Image resizing ops (counterpart of ``pti_ldm_vae_tpu/ops/resize.py``).

``_area_matrix_np`` is the averaging matrix of PyTorch/MONAI *area*
interpolation (adaptive average pooling: output cell ``i`` averages input
rows ``[floor(i*In/Out), ceil((i+1)*In/Out))``); the host preprocessing in
``data/transforms.py`` applies it along H and W, and ``resize_area`` applies
the same matrices to tensors on any device (two f32 ``torch.matmul``
products, as the JAX package leaves its two einsums to XLA outside any
kernel). ``upsample_nearest_2x`` is the decoder's nearest-neighbour x2
upsample on channel-last tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["area_resize_matrix", "resize_area", "upsample_nearest_2x"]


@functools.lru_cache(maxsize=128)
def _area_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """Averaging matrix R [out, in]: R @ x == adaptive_avg_pool1d(x, out)."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)  # ceil
        mat[i, start:end] = 1.0 / (end - start)
    return mat


def area_resize_matrix(in_size: int, out_size: int, *, device: torch.device | str = "cpu",
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Constant [out, in] averaging matrix for area interpolation along one axis."""
    return torch.as_tensor(_area_matrix_np(in_size, out_size), dtype=dtype, device=device)


def resize_area(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Area-resize NHWC (or HWC / HW) images to ``out_hw`` on their device
    (JAX ``ops/resize.py:resize_area``): the averaging matrix along H, then
    along W, in f32 (f64 inputs stay f64; TF32 is not used: a caller that
    wants the host path's digits keeps ``torch.backends.cuda.matmul.allow_tf32``
    off, its default), result in the input dtype."""
    squeeze_batch = squeeze_chan = False
    if x.dim() == 2:  # HW
        x = x[None, :, :, None]
        squeeze_batch = squeeze_chan = True
    elif x.dim() == 3:  # HWC
        x = x[None]
        squeeze_batch = True
    if x.dim() != 4:
        raise ValueError(f"expected HW/HWC/NHWC input, got shape {tuple(x.shape)}")
    h_in, w_in = x.shape[1], x.shape[2]
    h_out, w_out = out_hw
    compute_dtype = x.dtype if x.dtype == torch.float64 else torch.float32
    out = x.to(compute_dtype)
    if h_in != h_out:
        rh = area_resize_matrix(h_in, h_out, device=x.device, dtype=compute_dtype)
        out = torch.matmul(rh, out.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # [B, C, Ho, W]
    if w_in != w_out:
        rw = area_resize_matrix(w_in, w_out, device=x.device, dtype=compute_dtype)
        out = torch.matmul(out.permute(0, 1, 3, 2), rw.T).permute(0, 1, 3, 2)  # [B, Ho, C, Wo]
    out = out.to(x.dtype)
    if squeeze_chan:
        out = out[..., 0]
    if squeeze_batch:
        out = out[0]
    return out


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling of a channel-last [B, *spatial, C]
    tensor, matching ``F.interpolate(scale_factor=2, mode="nearest")``.
    Returns a contiguous channel-last tensor."""
    spatial = x.shape[1:-1]
    idx: list = [slice(None)]
    expand = [x.shape[0]]
    for s in spatial:
        idx += [slice(None), None]
        expand += [s, 2]
    idx.append(slice(None))
    expand.append(x.shape[-1])
    out = x[tuple(idx)].expand(*expand)
    return out.reshape(x.shape[0], *(2 * s for s in spatial), x.shape[-1])
