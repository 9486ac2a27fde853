"""Latent diffusion: noise schedule, DDIM sampling, epsilon-MSE train step
(counterpart of ``pti_ldm_vae_tpu/train/diffusion.py:39-152``).

* ``NoiseSchedule.linear_beta``: the DDPM linear-beta schedule (MONAI
  scheduler defaults: 1000 train steps, beta 1e-4 .. 2e-2) built in f32, as
  the JAX package builds it (``linspace``, then ``cumprod`` of ``1 - beta``);
* ``add_noise``: ``sqrt(a_t) x_0 + sqrt(1 - a_t) eps``;
* ``ddim_sample``: the DDIM loop over the same descending timesteps as the
  JAX ``lax.scan`` (``step_ratio = T // steps``). The per-step scalars come
  from a host copy of the schedule, so the loop makes no device-to-host
  copy and no ``.item()``: one step is the same launches every time, ready
  to be captured in a CUDA graph. ``x`` stays f32 and the UNet's output is
  cast to f32;
* ``make_diffusion_train_step``: the masked mean of the per-sample epsilon
  MSE (``cli/train_diffusion.py:128-134`` of the JAX package), backward,
  then one Adam update of the UNet and projector parameters.

Randomness: JAX's PRNG streams cannot be reproduced, so every draw takes an
explicit ``torch.Generator`` and can be passed in instead (initial noise,
the eta > 0 noise of each DDIM step, the train step's timesteps and noise).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from ..models.unet import project_latent_condition
from .state import GanTrainState

__all__ = [
    "NoiseSchedule",
    "add_noise",
    "ddim_sample",
    "ddim_timesteps",
    "diffusion_loss",
    "make_diffusion_train_step",
]


@dataclass(frozen=True)
class NoiseSchedule:
    betas: torch.Tensor           # [T] f32
    alphas_cumprod: torch.Tensor  # [T] f32
    num_train_timesteps: int

    @classmethod
    def linear_beta(cls, num_train_timesteps: int = 1000, beta_start: float = 1e-4,
                    beta_end: float = 2e-2) -> "NoiseSchedule":
        betas = torch.linspace(beta_start, beta_end, num_train_timesteps, dtype=torch.float32)
        return cls(betas, torch.cumprod(1.0 - betas, dim=0), num_train_timesteps)

    def to(self, device: torch.device | str) -> "NoiseSchedule":
        return NoiseSchedule(self.betas.to(device), self.alphas_cumprod.to(device),
                             self.num_train_timesteps)


def add_noise(schedule: NoiseSchedule, latents: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0): ``sqrt(a_t) x_0 + sqrt(1 - a_t) eps`` (f32 schedule)."""
    a = schedule.alphas_cumprod[timesteps]
    shape = (-1,) + (1,) * (latents.dim() - 1)
    return torch.sqrt(a).reshape(shape) * latents + torch.sqrt(1.0 - a).reshape(shape) * noise


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int) -> list[int]:
    """The DDIM timesteps, descending: ``arange(steps) * (T // steps)`` reversed."""
    step_ratio = num_train_timesteps // num_inference_steps
    return [i * step_ratio for i in reversed(range(num_inference_steps))]


def _ddim_coefficients(schedule: NoiseSchedule, num_inference_steps: int, eta: float
                       ) -> list[tuple[float, float, float, float, float]]:
    """Per step, in f32 on the host as the JAX loop computes them on the
    device: ``(sqrt(1 - a_t), sqrt(a_t), sqrt(a_prev), dir coefficient,
    sigma)`` with ``a_prev = 1`` where ``t - step_ratio < 0``."""
    f32 = np.float32
    acp = schedule.alphas_cumprod.cpu().numpy().astype(f32)
    step_ratio = schedule.num_train_timesteps // num_inference_steps
    out = []
    for t in ddim_timesteps(schedule.num_train_timesteps, num_inference_steps):
        a_t = acp[t]
        a_prev = acp[t - step_ratio] if t - step_ratio >= 0 else f32(1.0)
        sigma = (f32(eta) * np.sqrt((f32(1.0) - a_prev) / (f32(1.0) - a_t))
                 * np.sqrt(f32(1.0) - a_t / a_prev))
        dir_coef = np.sqrt(np.maximum(f32(1.0) - a_prev - sigma * sigma, f32(0.0)))
        out.append(tuple(float(v) for v in (np.sqrt(f32(1.0) - a_t), np.sqrt(a_t),
                                            np.sqrt(a_prev), dir_coef, sigma)))
    return out


def ddim_sample(
    unet_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor | None], torch.Tensor],
    schedule: NoiseSchedule,
    initial_noise: torch.Tensor,
    *,
    num_inference_steps: int = 50,
    context: torch.Tensor | None = None,
    eta: float = 0.0,
    generator: torch.Generator | None = None,
    step_noise: Sequence[torch.Tensor] | None = None,
) -> torch.Tensor:
    """DDIM from ``initial_noise`` (x_T, [B, *latent]) to x_0, in f32.

    ``unet_fn(x, timesteps [B] int, context) -> eps``. With ``eta > 0`` each
    step adds ``sigma * noise``: ``step_noise[i]`` where given, else a
    standard normal draw from ``generator``."""
    x = initial_noise.float()
    b, device = x.shape[0], x.device
    times = torch.tensor(ddim_timesteps(schedule.num_train_timesteps, num_inference_steps),
                         dtype=torch.int64, device=device)[:, None].expand(-1, b)
    for i, (c_noise, sqrt_a_t, sqrt_a_prev, dir_coef, sigma) in enumerate(
            _ddim_coefficients(schedule, num_inference_steps, eta)):
        eps = unet_fn(x, times[i], context).float()
        x0_pred = (x - c_noise * eps) / sqrt_a_t
        x = sqrt_a_prev * x0_pred + dir_coef * eps
        if eta > 0:
            noise = step_noise[i] if step_noise is not None else torch.randn(
                x.shape, generator=generator, dtype=torch.float32, device=device)
            x = x + sigma * noise.to(device=device, dtype=torch.float32)
    return x


def diffusion_loss(unet: nn.Module, schedule: NoiseSchedule, latents: torch.Tensor,
                   timesteps: torch.Tensor, noise: torch.Tensor, context: torch.Tensor | None,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked mean over the batch of the per-sample epsilon MSE (f32)."""
    eps = unet(add_noise(schedule, latents, noise, timesteps), timesteps, context)
    per = torch.square(eps - noise).mean(dim=tuple(range(1, eps.dim())))
    if mask is None:
        return per.mean()
    return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)


def make_diffusion_train_step(unet: nn.Module, schedule: NoiseSchedule, state: GanTrainState,
                              *, projector: nn.Module | None = None):
    """``step(latents, cond_latents=None, mask=None, *, timesteps=None,
    noise=None, generator=None) -> loss`` (a detached device scalar): draws
    timesteps in ``[0, T)`` and then the noise from ``generator`` unless they
    are given, projects ``cond_latents`` to the context when a projector is
    given, computes the loss, its gradients, and one Adam update through
    ``state`` (whose optimizer holds the UNet's and the projector's
    parameters)."""

    def step(latents: torch.Tensor, cond_latents: torch.Tensor | None = None,
             mask: torch.Tensor | None = None, *, timesteps: torch.Tensor | None = None,
             noise: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
        device = latents.device
        if timesteps is None:
            timesteps = torch.randint(0, schedule.num_train_timesteps, (latents.shape[0],),
                                      generator=generator, device=device)
        if noise is None:
            noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                device=device)
        context = None
        if projector is not None and cond_latents is not None:
            context = project_latent_condition(projector, cond_latents)
        loss = diffusion_loss(unet, schedule, latents.float(), timesteps, noise, context, mask)
        loss.backward()
        state.apply_g()
        return loss.detach()

    return step
