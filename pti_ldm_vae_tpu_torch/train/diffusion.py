"""Latent diffusion: noise schedule, DDIM sampling, epsilon-MSE train step,
pivotal-tuning inversion (counterpart of
``pti_ldm_vae_tpu/train/diffusion.py:39-393``).

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
  then one Adam update of the UNet and projector parameters; under a process
  group the mean is the global batch's, the gradients are summed over the
  ranks before the update (``state.py``), and the timesteps and noise are
  this rank's rows of the global batch's draws (``parallel/mesh.py``);
* ``pivotal_tuning_inversion`` and its batched form: stage 1 optimizes a
  latent per image through the frozen decoder (Adam on z), stage 2
  fine-tunes a fresh copy of the decoder around each pivot (Adam on the
  ``post_quant_conv`` and ``decoder`` parameters), image by image
  (``"scan"``) or all images at once on per-image copies of those parameters
  under ``torch.func.vmap`` (``"vmap"``). Each step's loss is kept
  before its update, as ``value_and_grad`` inside the JAX scan records it.
  Each image's optimisation is its own: under a process group a rank takes
  its images (``cli/run_pti.py``) and nothing is summed across ranks, as the
  JAX ``shard_map`` keeps one image per device with no collective.

Randomness: JAX's PRNG streams cannot be reproduced, so every draw takes an
explicit ``torch.Generator`` and can be passed in instead (initial noise,
the eta > 0 noise of each DDIM step, the train step's timesteps and noise).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
from torch import nn

from ..models.unet import project_latent_condition
from ..parallel.mesh import (
    allreduce_metrics,
    global_count,
    local_randint,
    local_randn,
    masked_mean,
    world_size,
)
from .state import GanTrainState

__all__ = [
    "NoiseSchedule",
    "add_noise",
    "ddim_sample",
    "ddim_timesteps",
    "diffusion_loss",
    "make_diffusion_train_step",
    "decoder_parameters",
    "swapped_decoder",
    "pivotal_tuning_inversion",
    "make_pivotal_tuning_inversion_batched",
    "pivotal_tuning_inversion_batched",
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
    """Masked mean over the batch of the per-sample epsilon MSE (f32); under a
    process group this rank's share of the global batch's mean."""
    eps = unet(add_noise(schedule, latents, noise, timesteps), timesteps, context)
    per = torch.square(eps - noise).mean(dim=tuple(range(1, eps.dim())))
    if mask is None:
        return per.mean() / world_size()
    return masked_mean(per, mask, global_count(mask))


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
            timesteps = local_randint(schedule.num_train_timesteps, latents.shape[0],
                                      generator=generator, device=device)
        if noise is None:
            noise = local_randn(tuple(latents.shape), generator=generator, dtype=torch.float32,
                                device=device)
        context = None
        if projector is not None and cond_latents is not None:
            context = project_latent_condition(projector, cond_latents)
        loss = diffusion_loss(unet, schedule, latents.float(), timesteps, noise, context, mask)
        loss.backward()
        state.apply_g()
        return allreduce_metrics({"loss": loss.detach()})["loss"]

    return step


# ---- pivotal-tuning inversion ------------------------------------------------------------

def decoder_parameters(model: nn.Module) -> dict[str, nn.Parameter]:
    """The parameters stage 2 tunes, by state-dict key: ``post_quant_conv.*``
    and ``decoder.*`` of an ``AutoencoderKL``. (The JAX package tunes the whole
    variables tree, but the encoder's gradient there is 0, so is its Adam
    update: tuning the decoder alone is the same result.)"""
    return {name: p for name, p in model.named_parameters()
            if name.startswith(("post_quant_conv.", "decoder."))}


@contextmanager
def _frozen(model: nn.Module, trainable: Sequence[nn.Parameter] = ()) -> Iterator[None]:
    """Every parameter of ``model`` but ``trainable`` at ``requires_grad=False``
    (the convolution kernels' backward then skips the filter gradient), the
    flags restored on exit."""
    flags = {p: p.requires_grad for p in model.parameters()}
    keep = {id(p) for p in trainable}
    try:
        for p in model.parameters():
            p.requires_grad_(id(p) in keep)
        yield
    finally:
        for p, flag in flags.items():
            p.requires_grad_(flag)


@contextmanager
def swapped_decoder(model: nn.Module, tuned: dict[str, torch.Tensor]) -> Iterator[nn.Module]:
    """``model`` with ``tuned`` (a ``decoder_parameters`` key -> tensor map)
    copied into its parameters in place, the original values back on exit."""
    params = decoder_parameters(model)
    saved = {name: params[name].detach().clone() for name in tuned}
    try:
        with torch.no_grad():
            for name, value in tuned.items():
                params[name].copy_(value)
        yield model
    finally:
        with torch.no_grad():
            for name, value in saved.items():
                params[name].copy_(value)


def _adam(params: Sequence[torch.Tensor], lr: float) -> torch.optim.Adam:
    """optax ``adam`` semantics: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root (eps_root 0); PyTorch's fused update on CUDA."""
    fused = all(p.device.type == "cuda" for p in params)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, fused=fused)


def _invert(model: nn.Module, targets: torch.Tensor, latent_init: torch.Tensor, steps: int,
            lr: float, per_image: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: Adam on z through the frozen decoder. ``per_image``: the loss
    is the sum over images of each image's mean squared error, so each
    latent's gradient is that of its own image alone (the JAX ``vmap`` over
    images; a batch mean would scale every gradient by 1/B, which Adam's eps
    does not forgive); else one mean over the whole batch. Returns (pivot,
    losses [B, steps] or [steps])."""
    z = latent_init.detach().clone().float().requires_grad_(True)
    opt = _adam([z], lr)
    losses = []
    with _frozen(model):
        for _ in range(steps):
            err = (model.decode(z) - targets).square()
            loss = err.mean(dim=tuple(range(1, err.dim()))) if per_image else err.mean()
            (loss.sum() if per_image else loss).backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            losses.append(loss.detach())
    return z.detach(), torch.stack(losses, dim=-1)


def _tune(model: nn.Module, target: torch.Tensor, pivot: torch.Tensor,
          start: dict[str, torch.Tensor], steps: int, lr: float
          ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Stage 2: from ``start``, a fresh Adam on the decoder's parameters
    around the fixed pivot; returns (tuned copies, losses [steps]). The model
    is left holding the tuned values."""
    params = decoder_parameters(model)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(start[name])
    opt = _adam(list(params.values()), lr)
    losses = []
    with _frozen(model, list(params.values())):
        for _ in range(steps):
            loss = (model.decode(pivot) - target).square().mean()
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            losses.append(loss.detach())
    return {name: p.detach().clone() for name, p in params.items()}, torch.stack(losses)


def pivotal_tuning_inversion(
    model: nn.Module, target: torch.Tensor, latent_init: torch.Tensor, *,
    latent_steps: int = 200, latent_lr: float = 1e-1, tune_steps: int = 100,
    tune_lr: float = 1e-4,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Two-stage PTI of ``target`` (NHWC) from ``latent_init`` through
    ``model.decode`` (JAX ``pivotal_tuning_inversion``): stage 1 inverts a
    pivot latent, stage 2 fine-tunes the decoder around it, both on the mean
    squared error over the whole target. Returns (pivot, tuned decoder
    parameters by state-dict key, ``{"latent": [latent_steps], "tune":
    [tune_steps]}``). The model's own parameters are unchanged afterwards."""
    pivot, latent_losses = _invert(model, target, latent_init, latent_steps, latent_lr,
                                   per_image=False)
    start = {name: p.detach().clone() for name, p in decoder_parameters(model).items()}
    try:
        tuned, tune_losses = _tune(model, target, pivot, start, tune_steps, tune_lr)
    finally:
        with torch.no_grad():
            for name, p in decoder_parameters(model).items():
                p.copy_(start[name])
    return pivot, tuned, {"latent": latent_losses, "tune": tune_losses}


@contextmanager
def _unchecked(model: nn.Module) -> Iterator[None]:
    """``model.decoder``'s ``remat`` off (where it has one), restored on exit."""
    decoder = getattr(model, "decoder", None)
    remat = getattr(decoder, "remat", None)
    try:
        if remat is not None:
            decoder.remat = False
        yield
    finally:
        if remat is not None:
            decoder.remat = remat


class _Decode(nn.Module):
    """``model.decode`` as a module's forward, for ``torch.func.functional_call``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model.decode(z)


def _tune_vmap(model: nn.Module, targets: torch.Tensor, pivots: torch.Tensor, steps: int,
               lr: float) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Stage 2 of every image at once (JAX ``run_vmap``'s ``tune_one`` under
    ``vmap``): the decoder's parameters stacked into one ``[B, ...]`` tensor
    per key, each step ``torch.func.vmap(torch.func.grad_and_value(loss))``
    over ``functional_call`` of the decoder with each image's own copy, pivot
    and target, then one Adam on the stacked tensors (elementwise, so B
    separate Adams). Returns (tuned {key: [B, ...]}, losses [B, steps]); the
    model's own parameters are not touched. A ``remat`` decoder runs its
    blocks unchecked here: ``torch.utils.checkpoint`` needs saved-tensor
    hooks, which ``torch.func.grad`` does not support, and remat changes the
    memory, not the numbers."""
    decode = _Decode(model)

    def loss(params: dict[str, torch.Tensor], pivot: torch.Tensor, target: torch.Tensor):
        recon = torch.func.functional_call(decode, params, (pivot[None],))
        return (recon - target[None]).square().mean()

    step = torch.func.vmap(torch.func.grad_and_value(loss))
    n = targets.shape[0]
    stacked = {f"model.{name}": p.detach().unsqueeze(0).repeat(n, *(1,) * p.dim())
               for name, p in decoder_parameters(model).items()}
    opt = _adam(list(stacked.values()), lr)
    losses = []
    with _frozen(model), _unchecked(model):
        for _ in range(steps):
            grads, value = step(stacked, pivots, targets)
            for key, t in stacked.items():
                t.grad = grads[key].contiguous()  # the fused Adam takes one layout for both
            opt.step()
            opt.zero_grad(set_to_none=True)
            losses.append(value.detach())
    tuned = {key[len("model."):]: t for key, t in stacked.items()}
    return tuned, torch.stack(losses, dim=-1)


def make_pivotal_tuning_inversion_batched(
    model: nn.Module, *, latent_steps: int = 200, latent_lr: float = 1e-1, tune_steps: int = 100,
    tune_lr: float = 1e-4, tune_formulation: str = "scan",
) -> Callable[[torch.Tensor, torch.Tensor],
              tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, torch.Tensor]]]:
    """The batched PTI program (JAX ``make_pivotal_tuning_inversion_batched``),
    built once and called per batch: ``program(targets [B, H, W, C], latent_inits [B, ...]) -> (pivots
    [B, ...], tuned {key: [B, ...]}, {"latent": [B, latent_steps], "tune":
    [B, tune_steps]})``, starting from the model's current decoder.

    Stage 1 inverts all B latents in one batched pass (per-image losses
    summed: see ``_invert``); decoder GroupNorm and attention are per sample
    and Adam per element, so each image's pivot is the one it would get alone.
    Stage 2, each image from the same decoder with a fresh Adam:

    * ``"scan"`` (default) tunes one image at a time: one copy of the
      decoder's parameters and Adam state live at a time;
    * ``"vmap"`` (the JAX package's legacy A/B layout) tunes all B at once on
      stacked per-image copies (``_tune_vmap``): every convolution and
      GroupNorm has a per-image weight, so cuDNN runs grouped convolutions,
      and the hand-written kernels (GroupNorm+SiLU; the convolution kernels
      with ``conv_kernel``) launch once per image while flash attention
      launches once for the batch (their ``vmap`` rules, ``ops/kernels``).

    The JAX mesh / ``shard_map`` form (one image per device, no collective) is
    the caller's split of its images over the ranks: ``cli/run_pti.py`` hands
    each rank's rows to this program, in either form."""
    if tune_formulation not in ("scan", "vmap"):
        raise ValueError(f"tune_formulation must be 'scan' or 'vmap', got {tune_formulation!r}")

    def program(targets: torch.Tensor, latent_inits: torch.Tensor):
        pivots, latent_losses = _invert(model, targets, latent_inits, latent_steps, latent_lr,
                                        per_image=True)
        if tune_formulation == "vmap":
            tuned, tune_losses = _tune_vmap(model, targets, pivots, tune_steps, tune_lr)
            return pivots, tuned, {"latent": latent_losses, "tune": tune_losses}
        start = {name: p.detach().clone() for name, p in decoder_parameters(model).items()}
        tuned: dict[str, list[torch.Tensor]] = {name: [] for name in start}
        tune_losses = []
        try:
            for i in range(targets.shape[0]):
                one, losses = _tune(model, targets[i:i + 1], pivots[i:i + 1], start, tune_steps,
                                    tune_lr)
                for name, value in one.items():
                    tuned[name].append(value)
                tune_losses.append(losses)
        finally:
            with torch.no_grad():
                for name, p in decoder_parameters(model).items():
                    p.copy_(start[name])
        return (pivots, {name: torch.stack(v) for name, v in tuned.items()},
                {"latent": latent_losses, "tune": torch.stack(tune_losses)})

    return program


def pivotal_tuning_inversion_batched(
    model: nn.Module, targets: torch.Tensor, latent_inits: torch.Tensor, *,
    latent_steps: int = 200, latent_lr: float = 1e-1, tune_steps: int = 100,
    tune_lr: float = 1e-4, tune_formulation: str = "scan",
) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """One call of ``make_pivotal_tuning_inversion_batched``'s program."""
    return make_pivotal_tuning_inversion_batched(
        model, latent_steps=latent_steps, latent_lr=latent_lr, tune_steps=tune_steps,
        tune_lr=tune_lr, tune_formulation=tune_formulation)(targets, latent_inits)
