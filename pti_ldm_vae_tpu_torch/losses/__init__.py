from .adversarial import discriminator_loss, generator_loss, lsgan_loss
from .composite import compute_total_loss, l1_loss, l2_loss, reconstruction_loss
from .kl import compute_kl_loss, kl_from_forward

__all__ = [
    "compute_kl_loss",
    "compute_total_loss",
    "discriminator_loss",
    "generator_loss",
    "kl_from_forward",
    "l1_loss",
    "l2_loss",
    "lsgan_loss",
    "reconstruction_loss",
]
