"""The loss terms and image metrics, plain (the reference trainer's
``train_vae.py`` and ``evaluate_vae.py``): per-sample terms that the callers
reduce as masked means over the valid rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def recon_per_sample(recon: torch.Tensor, x: torch.Tensor, kind: str = "l1") -> torch.Tensor:
    d = recon.float() - x.float()
    return (d.abs() if kind != "l2" else d.square()).flatten(1).mean(1)


def kl_per_sample(mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The reference objective, sigma in the log-variance slot:
    ``-0.5 * sum(1 + sigma - mu^2 - exp(sigma))``."""
    return (-0.5 * (1.0 + sigma - mu.square() - torch.exp(sigma))).flatten(1).sum(1)


def lsgan_per_sample(logits: torch.Tensor, target: float) -> torch.Tensor:
    return (logits.float() - target).square().flatten(1).mean(1)


def ar_loss(pooled: torch.Tensor, attrs: torch.Tensor, channels: list[int], deltas: list[float],
            valid: torch.Tensor) -> torch.Tensor:
    """Attribute regularization over every ordered pair of valid rows (pairwise
    "all"): per attribute the mean over pairs whose attributes differ of
    ``(tanh(delta * (z_j - z_i)) - sign(a_j - a_i))^2``, summed over the
    attributes. ``pooled`` [B, C], ``attrs`` [B, A], ``valid`` [B] bool."""
    total = pooled.new_zeros(())
    pair_ok = valid[:, None] & valid[None, :]
    for a, (ch, delta) in enumerate(zip(channels, deltas)):
        d_a = attrs[None, :, a] - attrs[:, None, a]
        d_z = pooled[None, :, ch] - pooled[:, None, ch]
        sign = torch.sign(d_a)
        use = (sign != 0) & pair_ok
        sq = (torch.tanh(delta * d_z) - sign).square() * use
        total = total + sq.sum() / use.sum().clamp_min(1)  # no pair: a sum of 0
    return total


def psnr(mse: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(1.0 / mse.clamp_min(1e-12))


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample SSIM of NHWC batches in [0, 1]: an 11x11 Gaussian window
    (sigma 1.5) with zero padding, K1 0.01, K2 0.03."""
    x, y = x.float().permute(0, 3, 1, 2), y.float().permute(0, 3, 1, 2)
    coords = torch.arange(11, dtype=torch.float32, device=x.device) - 5
    g = torch.exp(-coords.square() / (2 * 1.5 ** 2))
    window = (g[:, None] * g[None, :]) / g.sum() ** 2
    c = x.shape[1]
    w = window.expand(c, 1, 11, 11)

    def blur(t):
        return F.conv2d(t, w, padding=5, groups=c)

    mu_x, mu_y = blur(x), blur(y)
    sxx = blur(x * x) - mu_x * mu_x
    syy = blur(y * y) - mu_y * mu_y
    sxy = blur(x * y) - mu_x * mu_y
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)
         / ((mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2)))
    return s.flatten(1).mean(1)


def image_metrics(recon: torch.Tensor, x: torch.Tensor) -> dict[str, torch.Tensor]:
    """PSNR / SSIM / MSE / MAE per sample on [0, 1]-clamped images."""
    r, t = recon.clamp(0.0, 1.0), x.clamp(0.0, 1.0)
    mse = (r - t).square().flatten(1).mean(1)
    return {"psnr": psnr(mse), "ssim": ssim(r, t), "mse": mse,
            "mae": (r - t).abs().flatten(1).mean(1)}
