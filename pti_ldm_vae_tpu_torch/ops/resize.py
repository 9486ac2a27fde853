"""Image resizing ops (counterpart of ``pti_ldm_vae_tpu/ops/resize.py``).

``_area_matrix_np`` is the averaging matrix of PyTorch/MONAI *area*
interpolation (adaptive average pooling: output cell ``i`` averages input
rows ``[floor(i*In/Out), ceil((i+1)*In/Out))``); the host preprocessing in
``data/transforms.py`` applies it along H and W. ``upsample_nearest_2x`` is
the decoder's nearest-neighbour x2 upsample on channel-last tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["upsample_nearest_2x"]


@functools.lru_cache(maxsize=128)
def _area_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """Averaging matrix R [out, in]: R @ x == adaptive_avg_pool1d(x, out)."""
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-((i + 1) * in_size) // out_size)  # ceil
        mat[i, start:end] = 1.0 / (end - start)
    return mat


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
