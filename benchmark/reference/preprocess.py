"""The loaders' preprocessing, plain (the reference's ``Resize(mode="area")``
then ``LocalNormalizeByMask``): area resize as adaptive average pooling,
then a z-score over the non-zero pixels (background kept at 0, a standard
deviation at or below 1e-5 taken as 1), in float64, the result float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def preprocess(raw: torch.Tensor, patch: tuple[int, int]) -> torch.Tensor:
    """[N, H, W] raw images -> [N, h, w, 1] float32."""
    x = F.adaptive_avg_pool2d(raw.double()[:, None], tuple(patch))[:, 0]
    nz = x != 0
    count = nz.sum(dim=(1, 2), keepdim=True).clamp_min(1)
    mean = torch.where(nz, x, 0.0).sum(dim=(1, 2), keepdim=True) / count
    var = torch.where(nz, (x - mean).square(), 0.0).sum(dim=(1, 2), keepdim=True) / count
    std = var.sqrt()
    std = torch.where(std > 1e-5, std, torch.ones_like(std))
    return torch.where(nz, (x - mean) / std, 0.0).float()[..., None]
