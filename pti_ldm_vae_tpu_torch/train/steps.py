"""Train / eval / inference steps for the VAE workload (counterpart of
``pti_ldm_vae_tpu/train/steps.py``).

One function computes the generator update (forward, all loss terms,
backward, Adam) and, when the adversarial branch is active, the discriminator
update on the detached reconstruction of the same forward, as the reference's
two-optimizer schedule does (G step ``train_vae.py:384-445``, D step
``:448-458``). The GAN warm-up gate is a static flag: build one step per
phase. Batches are zero-padded to a static size and every loss term
is a masked mean, so padding never leaks into gradients (same contract as
the JAX package, whose loader this port's loader mirrors). Losses accumulate
in f32 while the conv stack runs in the model's ``compute_dtype`` (bf16 on
the card by default; bf16 needs no gradient scaling).

The backward of every GroupNorm+SiLU and of both attentions runs through the
hand-written kernels of ``ops/kernels`` on CUDA tensors, and so do the 3x3
convolutions of a model built with ``conv_kernel=True``, forward, input
gradient and filter gradient.

With ``ar_vae_enabled`` and a spec, the attribute-regularization term of
``losses/ar_vae.py`` on ``z_mu`` joins the total at ``ar_gamma``; the batch's
``attributes`` ({name: [B] f32}) and its mask feed it, and "subset" pairs
are drawn from the step's generator unless ``pair_indices`` are given.

Under a process group (``parallel/``) the batch is this rank's rows of the
global batch: every masked mean divides by the global count of valid rows
(one all-reduce per step), the AR-VAE term runs over the gathered global
batch, each optimizer sums the ranks' gradients before its update
(``state.py``), and the metrics are the global batch's. With no group the
arithmetic is the single-device one, bit for bit.

Under spatial sharding (``parallel/spatial.py``) the images, the
reconstruction and the latents are height tiles: the per-sample means of the
reconstruction term, the KL sums and the AR-VAE term's pooled latents are
summed over the model group (``sum_over_model``, each rank's partial taking
the sum's gradient once), and LPIPS and the discriminator run on the model
group's gathered full-height reconstruction and target, alike on every rank
(the gather hands each rank its own rows' gradient). Under tensor sharding
(``parallel/tensor.py``) the model hands back whole reconstructions and
latents, and the step is the data-parallel one. Every loss term is then the
same on the ranks of a model group, and the metrics are summed over the
data group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..losses.ar_vae import compute_ar_vae_loss
from ..losses.composite import compute_total_loss
from ..models.autoencoder_kl import AutoencoderKL
from ..models.lpips import lpips_distance_per_sample, lpips_distance_per_sample_3d
from ..parallel.mesh import (
    allreduce_metrics,
    data_size,
    global_count,
    grouped,
    masked_mean,
    model_size,
    reduce_model_,
    sum_over_model,
)
from ..parallel.spatial import gather_height, spatial
from .state import GanTrainState

__all__ = ["LossConfig", "make_train_step", "make_eval_step", "make_inference_fn"]


@dataclass(frozen=True)
class LossConfig:
    """Static loss hyperparameters (from the ``autoencoder_train`` config block)."""

    recon_loss: str = "l1"
    kl_weight: float = 1e-3
    perceptual_weight: float = 1.0
    adv_weight: float = 0.5
    ar_gamma: float = 0.0
    ar_vae_enabled: bool = False
    ar_spec: Any | None = None
    kl_mode: str = "reference"  # see losses/kl.py
    use_perceptual: bool = True


def _over_image(per_tile: torch.Tensor, mean: bool) -> torch.Tensor:
    """A per-sample sum (``mean=False``) or mean over a height tile's pixels
    as the whole image's under spatial sharding; as it is otherwise."""
    if not spatial():
        return per_tile
    total = sum_over_model(per_tile)
    return total / model_size() if mean else total


def _per_sample_recon(pred: torch.Tensor, target: torch.Tensor, kind: str) -> torch.Tensor:
    diff = pred.float() - target.float()
    per = diff.abs() if kind != "l2" else diff.square()
    return _over_image(per.mean(dim=tuple(range(1, per.dim()))), mean=True)


def _per_sample_kl(z_mu: torch.Tensor, z_sigma: torch.Tensor, mode: str) -> torch.Tensor:
    """Per-sample KL matching losses/kl.py semantics (sum over non-batch dims)."""
    z_mu = z_mu.float()
    second = z_sigma.float()
    if mode == "corrected":
        second = torch.log(second.square() + 1e-8)
    dims = tuple(range(1, second.dim()))
    return _over_image(-0.5 * torch.sum(1.0 + second - z_mu.square() - torch.exp(second),
                                        dim=dims), mean=False)


def _per_sample_lsgan(logits: torch.Tensor, target: float) -> torch.Tensor:
    per = (logits.float() - target).square()
    return per.mean(dim=tuple(range(1, per.dim())))


def _discriminator_loss(disc, recon: torch.Tensor, images: torch.Tensor,
                        mask: torch.Tensor, count: torch.Tensor | None = None) -> torch.Tensor:
    """0.5 * (fake -> 0 + real -> 1) on the detached reconstruction, masked
    means over the padded batch (reference ``train_vae.py:449-455``);
    ``count`` as in ``_generator_losses``. Under spatial sharding on the
    model group's gathered full-height images."""
    logits_fake = disc(gather_height(recon.detach()))[-1]
    logits_real = disc(gather_height(images))[-1]
    fake = masked_mean(_per_sample_lsgan(logits_fake, 0.0), mask, count)
    real = masked_mean(_per_sample_lsgan(logits_real, 1.0), mask, count)
    return 0.5 * (fake + real)


def _check_branches(disc, lcfg: LossConfig, adv_active: bool) -> None:
    if adv_active and disc is None:
        raise ValueError("adv_active=True needs a discriminator (got disc=None)")
    if lcfg.ar_vae_enabled and lcfg.ar_spec is None:
        raise ValueError("ar_vae_enabled=True needs an ar_spec (losses/ar_vae.py:make_ar_vae_spec)")


def _generator_losses(
    model: AutoencoderKL, lcfg: LossConfig, lpips_params, images: torch.Tensor,
    mask: torch.Tensor, eps: torch.Tensor | None, generator: torch.Generator | None,
    disc=None, attributes: dict[str, torch.Tensor] | None = None,
    pair_indices: torch.Tensor | None = None, count: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """All generator-side loss terms; shared by the train and eval paths.
    With a discriminator the LSGAN generator term (fake -> 1 through ``disc``)
    joins the total, with an AR-VAE spec the attribute term on ``z_mu``.
    ``count`` is the global number of valid rows (``global_count``; this
    batch's when None)."""
    recon, z_mu, z_sigma = model(images, eps, generator)
    # the loss networks' input: under spatial sharding the gathered full height
    recon_full, images_full = gather_height(recon), gather_height(images)

    recons_loss = masked_mean(_per_sample_recon(recon, images, lcfg.recon_loss), mask, count)
    kl_loss = masked_mean(_per_sample_kl(z_mu, z_sigma, lcfg.kl_mode), mask, count)

    zero = torch.zeros((), dtype=torch.float32, device=recon.device)
    if lcfg.use_perceptual:
        # 5-D (NDHWC) reconstructions take the fake-3D slicing path
        if recon.dim() not in (4, 5):
            raise ValueError(
                f"perceptual loss supports 2-D (NHWC) and 3-D (NDHWC) models only, got "
                f"rank-{recon.dim()} reconstruction; set perceptual_weight=0 / "
                f"use_perceptual=False for spatial_dims=1")
        lpips_fn = lpips_distance_per_sample_3d if recon.dim() == 5 else lpips_distance_per_sample
        p_loss = masked_mean(lpips_fn(lpips_params, recon_full, images_full, model.compute_dtype),
                             mask, count)
    else:
        p_loss = zero

    if disc is not None:
        adv_gen = masked_mean(_per_sample_lsgan(disc(recon_full)[-1], 1.0), mask, count)
    else:
        adv_gen = zero

    ar_loss, ar_per_attr = zero, {}
    if lcfg.ar_vae_enabled:
        if attributes is None:
            raise ValueError("the AR-VAE term needs the batch's attributes")
        # under spatial sharding the tiles' pooled latents, summed into the images'
        pooled = _over_image(z_mu.mean(dim=(1, 2)), mean=True) if spatial() else z_mu
        ar_loss, ar_per_attr, _ = compute_ar_vae_loss(
            pooled, attributes, lcfg.ar_spec, generator=generator, pair_indices=pair_indices,
            sample_mask=mask)

    total = _total(lcfg, recons_loss, kl_loss, p_loss, adv_gen, ar_loss)
    aux = {
        "recon": recon, "z_mu": z_mu, "z_sigma": z_sigma,
        "recon_loss": recons_loss, "kl_loss": kl_loss, "perceptual_loss": p_loss,
        "adv_gen_loss": adv_gen, "ar_loss": ar_loss, "ar_per_attr": ar_per_attr,
    }
    return total, aux


def _total(lcfg: LossConfig, recons_loss, kl_loss, p_loss, adv_gen, ar_loss):
    return compute_total_loss(
        recons_loss, kl_loss, p_loss, adv_gen, ar_loss,
        kl_weight=lcfg.kl_weight,
        perceptual_weight=lcfg.perceptual_weight,
        adv_weight=lcfg.adv_weight,
        ar_gamma=lcfg.ar_gamma,
        ar_vae_enabled=lcfg.ar_vae_enabled,
    )


def _global_terms(lcfg: LossConfig, total: torch.Tensor, aux: dict, disc_loss: torch.Tensor
                  ) -> dict[str, torch.Tensor]:
    """The step's loss terms over the global batch, unscaled: the ranks'
    shares summed (one all-reduce), the AR-VAE terms (already the gathered
    batch's) as they are, and the total recomposed from them. The debug
    means are over the rows of every rank (the ranks' batches are equally
    padded; under model parallelism first over the model group's equal
    shards). Without a group: the terms as computed, ``total`` itself."""
    ar = {"ar_loss": aux["ar_loss"],
          **{f"ar_loss_{name}": v for name, v in aux["ar_per_attr"].items()}}
    terms = allreduce_metrics({
        "recon_loss": aux["recon_loss"], "kl_loss": aux["kl_loss"],
        "perceptual_loss": aux["perceptual_loss"], "adv_gen_loss": aux["adv_gen_loss"],
        "adv_disc_loss": disc_loss,
        "z_mu_mean": _model_mean(aux["z_mu"].detach().mean()) / data_size(),
        "z_sigma_mean": _model_mean(aux["z_sigma"].detach().mean()) / data_size(), **ar,
    }, replicated=ar)
    terms["loss_total"] = (_total(lcfg, terms["recon_loss"], terms["kl_loss"],
                                  terms["perceptual_loss"], terms["adv_gen_loss"],
                                  terms["ar_loss"]) if grouped() else total)
    return terms


def _model_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the model group's equal shards of a shard's mean."""
    return reduce_model_(x.clone()) / model_size() if model_size() > 1 else x


def make_train_step(model: AutoencoderKL, disc, lcfg: LossConfig, *, adv_active: bool) -> Callable:
    """Build the train step. Signature of the returned function:

        state, metrics = step(state, images, mask, attributes, lpips_params,
                              eps=None, generator=None, pair_indices=None)

    ``adv_active`` is the static warm-up gate (``epoch > 5`` in the
    reference); build one step per phase. When it is on, the generator's
    objective gains ``adv_weight`` x the LSGAN term through ``disc`` — whose
    parameters take no gradient in that pass — and, after the generator's
    Adam update, the discriminator takes one Adam step on ``adv_weight * 0.5 *
    (fake -> 0 + real -> 1)`` with the detached reconstruction of the same
    forward (reference ``train_vae.py:456``).

    ``state`` is updated in place and handed back. The posterior noise is
    ``eps`` when given, else drawn from ``generator`` (a ``torch.Generator``
    on the model's device). ``attributes`` ({name: [B] f32}) feed the AR-VAE
    term, whose "subset" pairs come from ``generator`` unless
    ``pair_indices`` are given. ``metrics`` are 0-dim tensors on the device:
    read them after the epoch, not per step."""
    _check_branches(disc, lcfg, adv_active)
    params_g = [p for p in model.parameters() if p.requires_grad]

    def step(state: GanTrainState, images, mask, attributes, lpips_params,
             eps: torch.Tensor | None = None, generator: torch.Generator | None = None,
             pair_indices: torch.Tensor | None = None):
        count = global_count(mask)
        loss_g, aux = _generator_losses(model, lcfg, lpips_params, images, mask, eps, generator,
                                        disc if adv_active else None, attributes, pair_indices,
                                        count)
        # gradients for the generator's parameters only: none lands on the
        # discriminator, whose own pass below starts from clean slots
        loss_g.backward(inputs=params_g)
        state.apply_g()

        disc_loss = torch.zeros_like(loss_g.detach())
        if adv_active:
            disc_loss = _discriminator_loss(disc, aux["recon"], images, mask, count)
            (lcfg.adv_weight * disc_loss).backward()
            state.apply_d()
        terms = _global_terms(lcfg, loss_g, aux, disc_loss)
        metrics = {
            "train/recon_loss": terms["recon_loss"],
            "train/kl_loss": terms["kl_loss"],
            "train/perceptual_loss": terms["perceptual_loss"],
            "train/adv_gen_loss": lcfg.adv_weight * terms["adv_gen_loss"],
            "train/adv_disc_loss": lcfg.adv_weight * terms["adv_disc_loss"],
            "train/loss_total": terms["loss_total"],
            **({"train/ar_loss_total": terms["ar_loss"],
                **{f"train/ar_loss_{name}": terms[f"ar_loss_{name}"]
                   for name in aux["ar_per_attr"]}}
               if lcfg.ar_vae_enabled else {}),
            # debug stats (reference ``train_vae.py:432-442``), cheap scalars
            "debug/z_mu_mean": terms["z_mu_mean"],
            "debug/z_sigma_mean": terms["z_sigma_mean"],
        }
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(model: AutoencoderKL, disc, lcfg: LossConfig, *, adv_active: bool) -> Callable:
    """Validation step (reference ``validate``): stochastic forward and all
    loss terms, plus the discriminator loss when the adversarial branch is
    active (unscaled, like ``adv_gen_loss``), no gradient. Returns ``(metrics,
    reconstruction)`` so the caller can dump triplets."""
    _check_branches(disc, lcfg, adv_active)

    def step(state: GanTrainState, images, mask, attributes, lpips_params,
             eps: torch.Tensor | None = None, generator: torch.Generator | None = None,
             pair_indices: torch.Tensor | None = None):
        del state
        with torch.no_grad():
            count = global_count(mask)
            total, aux = _generator_losses(model, lcfg, lpips_params, images, mask, eps,
                                           generator, disc if adv_active else None, attributes,
                                           pair_indices, count)
            disc_loss = (_discriminator_loss(disc, aux["recon"], images, mask, count)
                         if adv_active else torch.zeros_like(total))
            terms = _global_terms(lcfg, total, aux, disc_loss)
        metrics = {k: terms[k] for k in ("recon_loss", "kl_loss", "perceptual_loss",
                                         "adv_gen_loss", "adv_disc_loss", "ar_loss",
                                         "loss_total")}
        metrics.update({f"ar_loss_{name}": terms[f"ar_loss_{name}"] for name in aux["ar_per_attr"]})
        return metrics, aux["recon"]

    return step


def make_inference_fn(model: AutoencoderKL) -> Callable[[np.ndarray | torch.Tensor], torch.Tensor]:
    """Deterministic encode->decode (reference ``reconstruct_deterministic``,
    ``autoencoder.py:153-163``): NHWC images in, f32 NHWC reconstruction out,
    on the model's device."""
    device = next(model.parameters()).device

    def reconstruct(images: np.ndarray | torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            x = torch.as_tensor(images).to(device, non_blocking=True)
            return model.reconstruct_deterministic(x)

    return reconstruct
