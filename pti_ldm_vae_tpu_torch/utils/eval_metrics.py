"""Batch PSNR, SSIM, MSE and MAE on NHWC tensors (counterpart of
``pti_ldm_vae_tpu/utils/eval_metrics.py``), numerically matching the
reference.

Reference: ``src/pti_ldm_vae/utils/eval_metrics.py:6-63`` — PSNR with an MSE
floor of 1e-12; SSIM from scratch with an 11x11 Gaussian window (sigma=1.5),
zero-padded depthwise convolution (torch conv2d padding=5), K1=0.01, K2=0.03.
As in the JAX package the Gaussian filter is applied as two separable 1-D
depthwise convolutions (the 2-D window is an outer product); the zero padding
is the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["compute_psnr", "compute_ssim", "compute_mse", "compute_mae"]


def _non_batch(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(1, x.dim()))


def compute_psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """PSNR per sample over NHWC batches (reference ``eval_metrics.py:6-19``)."""
    mse = torch.clamp(compute_mse(pred, target), min=1e-12)
    return 10.0 * torch.log10(data_range**2 / mse)


def compute_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).square().mean(dim=_non_batch(pred))


def compute_mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean(dim=_non_batch(pred))


@functools.lru_cache(maxsize=4)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(coords**2) / (2 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


def _depthwise_blur(x: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable zero-padded Gaussian blur on an NCHW tensor."""
    c = x.shape[1]
    g = torch.from_numpy(_gaussian_1d(window_size, sigma)).to(x.device)
    pad = window_size // 2
    x = F.conv2d(x, g.reshape(1, 1, window_size, 1).expand(c, 1, window_size, 1),
                 padding=(pad, 0), groups=c)
    return F.conv2d(x, g.reshape(1, 1, 1, window_size).expand(c, 1, 1, window_size),
                    padding=(0, pad), groups=c)


def compute_ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """SSIM per sample, NHWC, matching reference ``eval_metrics.py:22-63``.

    5-D (NDHWC) volumes are scored as the per-sample mean of 2-D SSIM over
    depth slices (JAX ``compute_ssim``: the JAX package's documented
    divergence from MONAI's 3-D windowed SSIM). Other ranks have no SSIM
    there either: a ``ValueError``."""
    if pred.dim() == 5:
        b, d = pred.shape[:2]
        per_slice = compute_ssim(pred.reshape(b * d, *pred.shape[2:]),
                                 target.reshape(b * d, *target.shape[2:]),
                                 data_range=data_range, k1=k1, k2=k2)
        return per_slice.reshape(b, d).mean(dim=1)
    if pred.dim() != 4:
        raise ValueError(f"compute_ssim takes NHWC (rank 4) or NDHWC (rank 5) batches, got rank "
                         f"{pred.dim()}")
    pred = pred.float().permute(0, 3, 1, 2)
    target = target.float().permute(0, 3, 1, 2)
    blur = functools.partial(_depthwise_blur, window_size=11, sigma=1.5)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_x = blur(pred)
    mu_y = blur(target)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x2 = blur(pred * pred) - mu_x2
    sigma_y2 = blur(target * target) - mu_y2
    sigma_xy = blur(pred * target) - mu_xy

    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2)
    )
    return ssim_map.mean(dim=(1, 2, 3))
