"""KL divergence of the diagonal-Gaussian posterior (counterpart of
``pti_ldm_vae_tpu/losses/kl.py``).

The reference feeds the model's ``z_sigma`` (a standard deviation) to its KL
function as if it were a log-variance; the trained objective is therefore
``-0.5 * sum(1 + sigma - mu^2 - exp(sigma))``. ``mode="reference"``
reproduces that objective for parity; ``mode="corrected"`` computes the
standard KL from sigma.
"""

from __future__ import annotations

import torch

__all__ = ["compute_kl_loss", "kl_from_forward"]


def compute_kl_loss(
    z_mu: torch.Tensor, z_logvar: torch.Tensor, *, input_is_logvar: bool = True
) -> torch.Tensor:
    """KL(N(mu, var) || N(0, 1)), summed over non-batch dims, batch-meaned.

    With ``input_is_logvar=False`` the second argument is a standard deviation
    and is converted via ``log(sigma^2 + 1e-8)``."""
    z_mu = z_mu.float()
    z_logvar = z_logvar.float()
    if not input_is_logvar:
        z_logvar = torch.log(z_logvar.square() + 1e-8)
    dims = tuple(range(1, z_logvar.dim()))
    kl = -0.5 * torch.sum(1.0 + z_logvar - z_mu.square() - torch.exp(z_logvar), dim=dims)
    return kl.mean()


def kl_from_forward(
    z_mu: torch.Tensor, z_sigma: torch.Tensor, *, mode: str = "reference"
) -> torch.Tensor:
    """KL term from the model's ``(z_mu, z_sigma)`` outputs.

    ``mode="reference"``: the reference training objective (sigma used as a
    log-variance). ``mode="corrected"``: the standard KL with sigma as sigma."""
    if mode == "reference":
        return compute_kl_loss(z_mu, z_sigma, input_is_logvar=True)
    if mode == "corrected":
        return compute_kl_loss(z_mu, z_sigma, input_is_logvar=False)
    raise ValueError(f"kl mode must be 'reference' or 'corrected', got {mode!r}")
