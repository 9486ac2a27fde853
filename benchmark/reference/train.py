"""The reference's training steps and evaluation batch, plain and float32.

A step's objective is a masked mean over the batch's valid rows of per-sample
terms (L1, KL at ``kl_weight``, LPIPS at ``perceptual_weight``, the LSGAN
generator term at ``adv_weight``), plus ``gamma`` times the attribute term
over all pairs of the batch. It is computed in blocks of rows, so that a
batch whose float32 activations outgrow the card still fits: every
per-sample term's gradient is the sum of its blocks', and the attribute
term, which couples the rows, enters each block as a linear term in the
block's pooled latents with the whole batch's gradient (one pass of the
encoder without a graph first; a batch that is one block keeps the term in
its graph). The discriminator's objective,
``adv_weight * 0.5 * (fake -> 0 + real -> 1)`` on the detached
reconstruction, is blocked the same way. Adam as ``torch.optim.Adam``
(betas 0.9 / 0.999, eps 1e-8, bias-corrected).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import losses
from .nets import disc_logits, lpips_per_sample
from .ops import Ops
from .vae import VAE

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


@dataclass(frozen=True)
class Objective:
    kl_weight: float
    perceptual_weight: float
    recon_kind: str = "l1"
    adv_weight: float | None = None  # None: no adversarial phase
    ar_channels: tuple[int, ...] = ()
    ar_deltas: tuple[float, ...] = ()
    ar_gamma: float = 0.0


def _blocks(n: int, rows: int):
    return [slice(i, min(i + rows, n)) for i in range(0, n, rows)]


def step_gradients(vae: VAE, obj: Objective, P: dict, D: dict | None, L: dict, batch: dict,
                   block_rows: int) -> tuple[dict, dict | None, dict[str, torch.Tensor]]:
    """(generator gradients, discriminator gradients, loss terms) of one
    batch: ``image`` [B, H, W, 1], ``mask`` [B], ``eps`` the posterior noise
    [B, h, w, C], ``attrs`` [B, A] when the attribute term is on. The terms
    are named and weighted as the program's step metrics: ``recon_loss``,
    ``kl_loss``, ``perceptual_loss``, ``adv_gen_loss`` and ``adv_disc_loss``
    (times ``adv_weight``), ``ar_loss_total`` and ``loss_total``."""
    ops = vae.ops
    x, mask, eps = batch["image"], batch["mask"].float(), batch["eps"]
    count = mask.sum().clamp_min(1.0)
    n = x.shape[0]
    names_g = list(P)
    grads_g = {k: torch.zeros_like(v) for k, v in P.items()}
    grads_d = {k: torch.zeros_like(v) for k, v in D.items()} if obj.adv_weight is not None else None
    terms = {k: x.new_zeros(()) for k in ("recon_loss", "kl_loss", "perceptual_loss",
                                          "adv_gen_loss", "adv_disc_loss", "ar_loss_total")}
    ar_grad = None
    single = n <= block_rows  # one block: the attribute term in the graph, as the program has it
    if obj.ar_channels and not single:
        with torch.no_grad():
            pooled = torch.cat([vae.encode(P, x[s])[0].mean(dim=(1, 2))
                                for s in _blocks(n, block_rows)])
        pooled.requires_grad_(True)
        term = losses.ar_loss(pooled, batch["attrs"], list(obj.ar_channels), list(obj.ar_deltas),
                              mask > 0)
        ar_grad, = torch.autograd.grad(term, pooled)
        terms["ar_loss_total"] = term.detach()
    for s in _blocks(n, block_rows):
        xb, mb = x[s], mask[s]
        recon, mu, sigma = vae.forward(P, xb, eps[s])
        parts = {"recon_loss": losses.recon_per_sample(recon, xb, obj.recon_kind),
                 "kl_loss": losses.kl_per_sample(mu, sigma),
                 "perceptual_loss": lpips_per_sample(ops, L, recon, xb)}
        weights = {"recon_loss": 1.0, "kl_loss": obj.kl_weight,
                   "perceptual_loss": obj.perceptual_weight}
        if obj.adv_weight is not None:
            parts["adv_gen_loss"] = losses.lsgan_per_sample(disc_logits(ops, D, recon), 1.0)
            weights["adv_gen_loss"] = obj.adv_weight
        means = {k: (v * mb).sum() / count for k, v in parts.items()}
        total = sum(weights[k] * v for k, v in means.items())
        if ar_grad is not None:
            total = total + obj.ar_gamma * (mu.mean(dim=(1, 2)) * ar_grad[s]).sum()
        elif obj.ar_channels:
            term = losses.ar_loss(mu.mean(dim=(1, 2)), batch["attrs"], list(obj.ar_channels),
                                  list(obj.ar_deltas), mask > 0)
            total = total + obj.ar_gamma * term
            terms["ar_loss_total"] = term.detach()
        for k, g in zip(names_g, torch.autograd.grad(total, [P[k] for k in names_g])):
            grads_g[k] += g
        for k, v in means.items():
            terms[k] = terms[k] + v.detach() * (obj.adv_weight if k == "adv_gen_loss" else 1.0)
        if obj.adv_weight is not None:
            fake = losses.lsgan_per_sample(disc_logits(ops, D, recon.detach()), 0.0)
            real = losses.lsgan_per_sample(disc_logits(ops, D, xb), 1.0)
            d_part = 0.5 * ((fake * mb).sum() + (real * mb).sum()) / count
            d_grads = torch.autograd.grad(obj.adv_weight * d_part, list(D.values()))
            for k, g in zip(list(D), d_grads):
                grads_d[k] += g
            terms["adv_disc_loss"] = terms["adv_disc_loss"] + obj.adv_weight * d_part.detach()
    terms["loss_total"] = (terms["recon_loss"] + obj.kl_weight * terms["kl_loss"]
                           + obj.perceptual_weight * terms["perceptual_loss"]
                           + terms["adv_gen_loss"] + obj.ar_gamma * terms["ar_loss_total"])
    return grads_g, grads_d, terms


class Adam:
    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        b1, b2 = BETAS
        self.t += 1
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + ADAM_EPS
            p.sub_(self.lr / bc1 * self.m[k] / denom)


def train_steps(vae: VAE, obj: Objective, P0: dict, D0: dict | None, L: dict, batches: list[dict],
                lr: float, block_rows: int) -> dict:
    """Run the steps of ``batches`` from ``P0`` / ``D0``. Returns the loss
    terms of every step, the first step's gradients and the parameters after
    the last step."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    D = ({k: v.detach().clone().requires_grad_(True) for k, v in D0.items()}
         if obj.adv_weight is not None else None)
    opt_g, opt_d = Adam(P, lr), (Adam(D, lr) if D is not None else None)
    out: dict = {"terms": [], "grad_g": None, "grad_d": None}
    for i, batch in enumerate(batches):
        gg, gd, terms = step_gradients(vae, obj, P, D, L, batch, block_rows)
        out["terms"].append({k: float(v) for k, v in terms.items()})
        if i == 0:
            out["grad_g"], out["grad_d"] = gg, gd
        opt_g.step(P, gg)
        if D is not None:
            opt_d.step(D, gd)
    out["params_g"] = {k: v.detach() for k, v in P.items()}
    out["params_d"] = {k: v.detach() for k, v in D.items()} if D is not None else None
    return out


@torch.no_grad()
def evaluate_batch(vae: VAE, P: dict, L: dict, batch: dict, perceptual_weight: float,
                   recon_kind: str, block_rows: int) -> dict[str, torch.Tensor]:
    """The four loss terms (masked means; ``loss_total`` adds KL at weight 1,
    as the reference's evaluation does) and PSNR / SSIM / MSE / MAE per
    sample."""
    x, mask, eps = batch["image"], batch["mask"].float(), batch["eps"]
    count = mask.sum().clamp_min(1.0)
    sums = {"recon_loss": 0.0, "kl_loss": 0.0, "perceptual_loss": 0.0}
    per_sample: dict[str, list] = {"psnr": [], "ssim": [], "mse": [], "mae": []}
    for s in _blocks(x.shape[0], block_rows):
        xb, mb = x[s], mask[s]
        recon, mu, sigma = vae.forward(P, xb, eps[s])
        sums["recon_loss"] += (losses.recon_per_sample(recon, xb, recon_kind) * mb).sum() / count
        sums["kl_loss"] += (losses.kl_per_sample(mu, sigma) * mb).sum() / count
        sums["perceptual_loss"] += (lpips_per_sample(vae.ops, L, recon, xb) * mb).sum() / count
        for k, v in losses.image_metrics(recon, xb).items():
            per_sample[k].append(v)
    out = dict(sums)
    out["loss_total"] = (out["recon_loss"] + out["kl_loss"]
                         + perceptual_weight * out["perceptual_loss"])
    out.update({k: torch.cat(v) for k, v in per_sample.items()})
    return out


def reference_ops(precision: str = "f32") -> Ops:
    """The reference's operations: TF32 off for every float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return Ops(precision=precision)
