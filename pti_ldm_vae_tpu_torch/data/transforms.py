"""Preprocessing transforms: mask-aware z-scoring + area resize.

Counterpart of ``pti_ldm_vae_tpu/data/transforms.py``: the numpy host path
(bit-identical to the JAX package's numpy functions) and the device path
(``local_normalize_by_mask``, ``preprocess_batch_device``: torch on the
tensor's device, for uniform-size raw batches already on the card).
Canonical pipeline (reference ``dataloaders.py:319-329``): Load ->
EnsureChannelFirst -> Resize(patch, mode=area) -> LocalNormalizeByMask ->
float32.

``LocalNormalizeByMask`` semantics (reference ``transforms.py:8-32``):
statistics over *non-zero* pixels only; background stays exactly 0; std floor:
if std <= 1e-5 use 1.0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import _area_matrix_np, resize_area

__all__ = ["local_normalize_by_mask_np", "local_normalize_by_mask", "resize_area_np",
           "preprocess_image_np", "preprocess_batch_device"]


def local_normalize_by_mask_np(img: np.ndarray) -> np.ndarray:
    """Numpy LocalNormalizeByMask, numerics identical to the reference."""
    img = np.asarray(img)
    mask = img != 0
    pixels = img[mask]
    if pixels.size == 0:
        return np.zeros_like(img, dtype=np.float32)
    mean = pixels.mean()
    std = pixels.std() if pixels.std() > 1e-5 else 1.0
    out = (img - mean) / std
    out[~mask] = 0.0
    return out.astype(np.float32)


def local_normalize_by_mask(img: torch.Tensor) -> torch.Tensor:
    """Torch LocalNormalizeByMask over the trailing spatial dims of one image,
    or per image of a 4-D NHWC batch (JAX ``transforms.py:45-60``): f32
    statistics over the non-zero pixels (mean, then the mean squared
    deviation), std floored to 1.0 at or below 1e-5, background kept at 0."""
    x = img.to(torch.float32)
    axes = (1, 2, 3) if x.dim() == 4 else tuple(range(x.dim()))
    mask = x != 0
    count = mask.sum(dim=axes, keepdim=True).clamp_min(1).to(torch.float32)
    mean = torch.where(mask, x, 0.0).sum(dim=axes, keepdim=True) / count
    var = torch.where(mask, (x - mean).square(), 0.0).sum(dim=axes, keepdim=True) / count
    std = var.sqrt()
    std = torch.where(std > 1e-5, std, 1.0)
    return torch.where(mask, (x - mean) / std, 0.0)


def preprocess_batch_device(raw: torch.Tensor, patch_size: tuple[int, int]) -> torch.Tensor:
    """Preprocessing of a uniform-size raw NHWC batch on its device: area
    resize, then per-image mask normalization (JAX ``transforms.py:93``)."""
    return local_normalize_by_mask(resize_area(raw, tuple(patch_size)))


def resize_area_np(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Host-side area resize: the averaging matrix along H, then along W."""
    img = np.asarray(img, dtype=np.float32)
    squeeze = False
    if img.ndim == 2:
        img = img[..., None]
        squeeze = True
    h_in, w_in, _ = img.shape
    h_out, w_out = out_hw
    if h_in != h_out:
        img = np.einsum("oh,hwc->owc", _area_matrix_np(h_in, h_out), img)
    if w_in != w_out:
        img = np.einsum("ow,hwc->hoc", _area_matrix_np(w_in, w_out), img)
    img = img.astype(np.float32)
    return img[..., 0] if squeeze else img


def preprocess_image_np(img: np.ndarray, patch_size: tuple[int, int]) -> np.ndarray:
    """Full reference preprocessing for one raw image -> [H, W, 1] float32."""
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None]
    elif img.ndim == 3 and img.shape[-1] not in (1, 3):
        # channel-first input; move channels last
        img = np.moveaxis(img, 0, -1)
    img = resize_area_np(img, tuple(patch_size))
    img = local_normalize_by_mask_np(img)
    return img.astype(np.float32)
