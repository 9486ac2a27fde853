"""Regression metrics: MAE/MSE per target + aggregates (the port's copy of
``pti_ldm_vae_tpu/utils/metrics.py``, numpy only)."""

from __future__ import annotations

import numpy as np

__all__ = ["compute_regression_metrics"]


def compute_regression_metrics(
    predictions: np.ndarray, targets: np.ndarray, target_names: list[str]
) -> dict[str, float]:
    """Per-target and aggregate MAE/MSE over [N, T] arrays."""
    predictions = np.asarray(predictions, dtype=np.float32)
    targets = np.asarray(targets, dtype=np.float32)
    if predictions.shape != targets.shape:
        raise ValueError(f"shape mismatch {predictions.shape} vs {targets.shape}")
    err = predictions - targets
    out: dict[str, float] = {}
    for i, name in enumerate(target_names):
        out[f"mae_{name}"] = float(np.mean(np.abs(err[:, i])))
        out[f"mse_{name}"] = float(np.mean(np.square(err[:, i])))
    out["mae"] = float(np.mean(np.abs(err)))
    out["mse"] = float(np.mean(np.square(err)))
    return out
