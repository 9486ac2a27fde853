"""Display normalization for dumps (counterpart of
``pti_ldm_vae_tpu/utils/visualization.py:normalize_batch_for_display``).

Reference ``src/pti_ldm_vae/utils/visualization.py:6-40``: percentile [2, 98]
mask-aware display normalization (background stays black, sub-1e-3 values
suppressed). Host-side numpy."""

from __future__ import annotations

import numpy as np

__all__ = ["normalize_batch_for_display"]


def normalize_batch_for_display(
    batch: np.ndarray, low: int = 2, high: int = 98
) -> np.ndarray:
    """Percentile display normalization of an NHWC batch to [0, 1];
    per-image per-channel stats over non-zero pixels."""
    arr = np.asarray(batch, dtype=np.float32)
    if arr.ndim != 4:
        raise ValueError(f"expected 4-D batch, got {arr.shape}")
    out = np.zeros_like(arr)
    for b in range(arr.shape[0]):
        for c in range(arr.shape[-1]):
            plane = arr[b, :, :, c]
            mask = plane != 0
            normed = np.zeros_like(plane)
            if np.any(mask):
                pixels = plane[mask]
                lo = np.percentile(pixels, low)
                hi = np.percentile(pixels, high)
                normed[mask] = np.clip((pixels - lo) / (hi - lo + 1e-8), 0, 1)
            normed[normed < 1e-3] = 0.0  # suppress background noise
            out[b, :, :, c] = normed
    return out
