"""LSGAN patch-adversarial objectives (counterpart of
``pti_ldm_vae_tpu/losses/adversarial.py``).

Equivalent of MONAI ``PatchAdversarialLoss(criterion="least_squares")`` as the
reference uses it (``train_vae.py:298,400-401,449-456``):

* generator loss: MSE(logits_fake, 1)
* discriminator loss: 0.5 * (MSE(logits_fake, 0) + MSE(logits_real, 1)); the
  reference applies the 0.5 at the call site, ``discriminator_loss`` here
  returns the halved sum.
"""

from __future__ import annotations

import torch

__all__ = ["lsgan_loss", "generator_loss", "discriminator_loss"]


def lsgan_loss(logits: torch.Tensor, target_is_real: bool) -> torch.Tensor:
    """Least-squares GAN objective on patch logits (mean over all elements, f32)."""
    target = 1.0 if target_is_real else 0.0
    return (logits.float() - target).square().mean()


def generator_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """The generator wants fake -> real target (``train_vae.py:400-401``)."""
    return lsgan_loss(logits_fake, target_is_real=True)


def discriminator_loss(logits_fake: torch.Tensor, logits_real: torch.Tensor) -> torch.Tensor:
    """0.5 * (fake->0 + real->1) (``train_vae.py:452-455``)."""
    return 0.5 * (lsgan_loss(logits_fake, target_is_real=False)
                  + lsgan_loss(logits_real, target_is_real=True))
