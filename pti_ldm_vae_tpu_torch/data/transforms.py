"""Preprocessing transforms: mask-aware z-scoring + area resize (numpy host path).

Counterpart of the numpy functions of ``pti_ldm_vae_tpu/data/transforms.py``
and bit-identical to them. Canonical pipeline (reference
``dataloaders.py:319-329``): Load -> EnsureChannelFirst -> Resize(patch,
mode=area) -> LocalNormalizeByMask -> float32.

``LocalNormalizeByMask`` semantics (reference ``transforms.py:8-32``):
statistics over *non-zero* pixels only; background stays exactly 0; std floor:
if std <= 1e-5 use 1.0.
"""

from __future__ import annotations

import numpy as np

from ..ops.resize import _area_matrix_np

__all__ = ["local_normalize_by_mask_np", "resize_area_np", "preprocess_image_np"]


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
