"""Attribute-regularized VAE loss (counterpart of
``pti_ldm_vae_tpu/losses/ar_vae.py:35-175``).

Per attribute, over ordered sample pairs (i, j), i != j, with attribute delta
``Da = a_j - a_i`` and latent-channel delta ``Dz = z_j - z_i``::

    L_attr = mean_{pairs: sign(Da) != 0} (tanh(delta * Dz) - sign(Da))^2

* "all": the [A, B, B] difference matrices with a validity mask (the
  diagonal drops out by itself, since ``Da_ii = 0``);
* "subset": ``subset_pairs`` of the B(B-1) ordered pairs drawn without
  replacement. The JAX package draws them with ``jax.random.choice``; the
  port draws the same distribution from a ``torch.Generator``
  (``randperm(B(B-1))[:P]``) or takes the flat pair indices as an argument,
  so that a test can hand it the JAX draw. A flat index ``f`` is the pair
  ``i = f // (B-1)``, ``j = j0 + (j0 >= i)`` with ``j0 = f % (B-1)``.

``sample_mask`` keeps zero-padded rows out of every pair, and an attribute
with no ordered pair left contributes 0. Latents are pooled over H, W of NHWC
and taken in f32 whatever the compute type.

Under a process group the pairs run over the GLOBAL batch, as the JAX
package's ``jit`` over the sharded global array computes the term: the
pooled latents, the attributes and the mask of every rank are gathered (one
all-reduce, ``parallel/mesh.py:gather_rows``, differentiable), every rank
computes the same term, and "subset" pairs are drawn alike on every rank from
generators seeded alike.
"""

from __future__ import annotations

from typing import Any

import torch

from ..parallel.mesh import gather_rows, grouped

__all__ = ["ARVaeSpec", "make_ar_vae_spec", "compute_ar_vae_loss", "draw_subset_pairs"]


class ARVaeSpec:
    """Static AR-VAE configuration: attribute order, latent channels, deltas
    (config key ``regularized_attributes``)."""

    def __init__(self, names: tuple[str, ...], channels: tuple[int, ...],
                 deltas: tuple[float, ...], pairwise_mode: str, subset_pairs: int | None):
        if pairwise_mode not in {"all", "subset"}:
            raise ValueError(f"pairwise must be 'all' or 'subset', got {pairwise_mode}")
        if pairwise_mode == "subset" and (subset_pairs is None or subset_pairs <= 0):
            raise ValueError("subset_pairs must be a positive integer when pairwise='subset'")
        self.names = names
        self.channels = channels
        self.deltas = deltas
        self.pairwise_mode = pairwise_mode
        self.subset_pairs = subset_pairs

    def __len__(self) -> int:
        return len(self.names)


def make_ar_vae_spec(
    attribute_latent_mapping: dict[str, Any],
    *,
    pairwise_mode: str = "all",
    subset_pairs: int | None = None,
    delta_global: dict[str, Any] | None = None,
    latent_dim: int | None = None,
) -> ARVaeSpec:
    """Validate and freeze the attribute -> channel mapping (reference
    ``losses.py:111-128``): ``_``-prefixed keys are comments, a channel must
    lie below ``latent_dim``, a missing delta falls back to an enabled
    ``delta_global``."""
    names, channels, deltas = [], [], []
    for attr_name, mapping in attribute_latent_mapping.items():
        if str(attr_name).startswith("_"):
            continue
        target_latent = int(mapping["latent_channel"])
        if latent_dim is not None and target_latent >= latent_dim:
            raise ValueError(f"Latent channel {target_latent} for attribute {attr_name} "
                             f"exceeds latent size {latent_dim}")
        delta_attr = mapping.get("delta")
        if delta_attr is None and delta_global and delta_global.get("enabled", False):
            delta_attr = delta_global.get("value")
        if delta_attr is None:
            raise ValueError(f"Delta not provided for {attr_name} and no delta_global fallback.")
        names.append(attr_name)
        channels.append(target_latent)
        deltas.append(float(delta_attr))
    return ARVaeSpec(tuple(names), tuple(channels), tuple(deltas), pairwise_mode, subset_pairs)


def _pool_latents(latent_vectors: torch.Tensor) -> torch.Tensor:
    """[B, C] from [B, H, W, C] (NHWC, pooled over H, W) or [B, C]."""
    if latent_vectors.dim() == 4:
        return latent_vectors.mean(dim=(1, 2))
    if latent_vectors.dim() != 2:
        raise ValueError(f"Expected latent shape [B, C] or [B, H, W, C], got "
                         f"{tuple(latent_vectors.shape)}")
    return latent_vectors


def draw_subset_pairs(batch: int, subset_pairs: int, generator: torch.Generator | None = None,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """``min(subset_pairs, B(B-1))`` distinct flat ordered-pair indices,
    uniformly without replacement (the distribution of the JAX side's
    ``jax.random.choice(..., replace=False)``)."""
    n_all = batch * (batch - 1)
    n_sub = min(int(subset_pairs), n_all)
    gen_device = generator.device if generator is not None else device
    return torch.randperm(n_all, generator=generator, device=gen_device)[:n_sub].to(device)


def compute_ar_vae_loss(
    latent_vectors: torch.Tensor,
    attributes: dict[str, torch.Tensor],
    spec: ARVaeSpec,
    *,
    generator: torch.Generator | None = None,
    pair_indices: torch.Tensor | None = None,
    sample_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Returns (total_loss, losses_per_attr, pair_counts_per_attr).

    "subset" mode takes its flat pair indices from ``pair_indices`` when
    given, else draws them from ``generator``. ``sample_mask`` ([B], 1 =
    valid) excludes padded samples from every pair. Under a process group
    ``B`` in the pairs is the global batch's."""
    z = _pool_latents(latent_vectors).float()  # [B, C]
    try:
        a_rows = torch.stack([attributes[name].float() for name in spec.names], dim=1)
    except KeyError as exc:
        raise KeyError(f"Missing attribute values for {exc} in batch.") from exc
    a_rows = a_rows.to(z.device)  # [B, A]
    if grouped():
        # the global batch's rows, in one gather: [world * B, C + A + 1]
        m = (sample_mask.to(z.device).float() if sample_mask is not None
             else torch.ones(z.shape[0], device=z.device))
        rows = gather_rows(torch.cat([z, a_rows, m[:, None]], dim=1))
        c, a = z.shape[1], a_rows.shape[1]
        z, a_rows, sample_mask = rows[:, :c], rows[:, c:c + a], rows[:, c + a]
    batch = z.shape[0]
    z_sel = z[:, list(spec.channels)].T  # [A, B]
    a_sel = a_rows.T  # [A, B]
    deltas = torch.tensor(spec.deltas, dtype=torch.float32, device=z.device)[:, None]  # [A, 1]
    valid = sample_mask.to(z.device).bool() if sample_mask is not None else None

    if spec.pairwise_mode == "all":
        d_a = a_sel[:, None, :] - a_sel[:, :, None]  # [A, B, B]
        d_z = z_sel[:, None, :] - z_sel[:, :, None]
        ordering = torch.sign(d_a)
        mask = ordering != 0.0
        if valid is not None:
            mask = mask & valid[None, :, None] & valid[None, None, :]
        pred = torch.tanh(deltas[:, :, None] * d_z)
        sq = (pred - ordering).square() * mask
        counts = mask.sum(dim=(1, 2))
        losses = sq.sum(dim=(1, 2)) / torch.clamp(counts, min=1)
    else:
        if pair_indices is None:
            pair_indices = draw_subset_pairs(batch, spec.subset_pairs, generator, z.device)
        flat = pair_indices.to(device=z.device, dtype=torch.long)
        idx_i = flat // (batch - 1)
        j0 = flat % (batch - 1)
        idx_j = j0 + (j0 >= idx_i).long()  # skip the diagonal
        d_a = a_sel[:, idx_j] - a_sel[:, idx_i]  # [A, P]
        d_z = z_sel[:, idx_j] - z_sel[:, idx_i]
        ordering = torch.sign(d_a)
        mask = ordering != 0.0
        if valid is not None:
            mask = mask & valid[None, idx_i] & valid[None, idx_j]
        pred = torch.tanh(deltas * d_z)
        sq = (pred - ordering).square() * mask
        counts = mask.sum(dim=1)
        losses = sq.sum(dim=1) / torch.clamp(counts, min=1)

    losses = torch.where(counts > 0, losses, torch.zeros_like(losses))
    total = losses.sum()
    losses_per_attr = {name: losses[i] for i, name in enumerate(spec.names)}
    counts_per_attr = {name: counts[i] for i, name in enumerate(spec.names)}
    return total, losses_per_attr, counts_per_attr
