"""Normalization ops on channel-last tensors (counterpart of
``pti_ldm_vae_tpu/ops/norm.py``).

    y = (x - mean_g) / sqrt(var_g + eps) * scale + bias

with mean/var over each group's (spatial, C/G) slab, biased variance
(``torch.nn.GroupNorm`` semantics), statistics in f32 whatever the input
dtype. ``group_norm_silu`` with one-pass statistics sends every call, forward
and backward, through the hand-written GroupNorm+SiLU kernels on CUDA
(``ops/kernels/groupnorm_silu.py``), whose plain versions run on the CPU.
``group_norm``, ``instance_norm`` and the two-pass ``group_norm_silu`` are
plain tensor code and differentiate through autograd.
"""

from __future__ import annotations

import torch

from .kernels.groupnorm_silu import groupnorm_silu

__all__ = ["DEFAULT_NORM_STATS", "group_norm", "group_norm_silu", "instance_norm"]

DEFAULT_NORM_STATS = "one_pass"


def group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int,
    eps: float = 1e-6,
    stats: str = DEFAULT_NORM_STATS,
) -> torch.Tensor:
    """GroupNorm over a channel-last [B, *spatial, C] tensor.

    ``stats="one_pass"``: ``var = mean(x^2) - mean(x)^2`` clamped at 0;
    ``stats="two_pass"``: ``var = mean((x - mean)^2)``, the centered form
    MONAI computes."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by num_groups {num_groups}")
    if stats not in ("two_pass", "one_pass"):
        raise ValueError(f"unknown stats mode {stats!r}")
    xg = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    if stats == "one_pass":
        var = torch.clamp(xg.square().mean(dim=(1, 3), keepdim=True) - mean.square(), min=0.0)
    else:
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def group_norm_silu(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int,
    eps: float = 1e-6,
    stats: str = DEFAULT_NORM_STATS,
) -> torch.Tensor:
    """Fused GroupNorm + SiLU on an NHWC tensor.

    ``"one_pass"`` statistics go through the GroupNorm+SiLU kernels (their
    plain versions on the CPU), forward and backward. The kernels compute
    one-pass statistics only, and no TPU kernel computes the centered form
    (the JAX package leaves it to XLA), so ``"two_pass"`` runs this plain
    formulation under autograd on every device, counted in
    ``group_norm_silu.two_pass_calls``. Only ``stats`` picks it: nothing
    falls back to it."""
    if stats == "one_pass":
        return groupnorm_silu(x.contiguous(), scale, bias, num_groups, eps)
    y = group_norm(x, scale, bias, num_groups=num_groups, eps=eps, stats=stats).float()
    group_norm_silu.two_pass_calls += 1
    return (y * torch.sigmoid(y)).to(x.dtype)


group_norm_silu.two_pass_calls = 0


def instance_norm(
    x: torch.Tensor,
    *,
    eps: float = 1e-5,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """InstanceNorm over a channel-last tensor of any spatial rank: per
    sample and channel, statistics over the spatial positions in f32,
    centered (two-pass) biased variance.

    Matches ``torch.nn.InstanceNorm{2,3}d`` defaults (``affine=False``,
    ``track_running_stats=False``) as the reference's PatchDiscriminator uses
    them (norm="INSTANCE")."""
    xf = x.float()
    dims = tuple(range(1, x.dim() - 1))
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    out = (xf - mean) / torch.sqrt(var + eps)
    if scale is not None:
        out = out * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
