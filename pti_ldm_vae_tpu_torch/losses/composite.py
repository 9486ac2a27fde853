"""Reconstruction losses and total-loss composition (counterpart of
``pti_ldm_vae_tpu/losses/composite.py``). Weights are Python floats from the
config."""

from __future__ import annotations

import torch

__all__ = ["l1_loss", "l2_loss", "reconstruction_loss", "compute_total_loss"]


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).abs().mean()


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).square().mean()


def reconstruction_loss(pred: torch.Tensor, target: torch.Tensor, kind: str = "l1") -> torch.Tensor:
    """``recon_loss`` config knob: 'l1' (default) or 'l2'."""
    if kind == "l2":
        return l2_loss(pred, target)
    return l1_loss(pred, target)


def compute_total_loss(
    recons_loss,
    kl_loss,
    perceptual_loss,
    adv_gen_loss,
    ar_loss,
    *,
    kl_weight: float,
    perceptual_weight: float,
    adv_weight: float,
    ar_gamma: float,
    ar_vae_enabled: bool,
):
    """total = recon + kl_w*kl + p_w*perc + adv_w*adv [+ gamma*ar]; tensors
    or Python floats."""
    total = (
        recons_loss
        + kl_weight * kl_loss
        + perceptual_weight * perceptual_loss
        + adv_weight * adv_gen_loss
    )
    if ar_vae_enabled:
        total = total + ar_gamma * ar_loss
    return total
