"""Spatial sharding: image height over the model group (counterpart of
``pti_ldm_vae_tpu/parallel/spatial.py``).

The JAX package shards NHWC batches ``P("data", "model", None, None)`` and
lets XLA's spatial partitioner insert the halo exchanges, the GroupNorm
``psum``s and the gathers. The port writes each one out, on the current
:class:`~.mesh.Mesh` of kind ``"spatial"``: rank ``m`` of a model group of
``M`` holds rows ``[m * H/M, (m + 1) * H/M)`` of every image of its data
rank's batch (:func:`spatial_split`, :func:`shard_batch_spatial`), and

* a 3x3 stride-1 convolution takes one halo row from each neighbour and
  zero rows at the image's edges (:func:`halo_rows`), then runs unpadded in
  height (cuDNN) or on the haloed tile with its two edge rows cropped (the
  convolution kernel, which computes SAME padding); the stride-2 downsample
  takes one halo row from below; nearest x2 upsampling is local
  (``models/autoencoder_kl.py``);
* GroupNorm+SiLU takes the whole image's statistics
  (:func:`group_norm_silu_tiles`): one-pass statistics through the split
  GroupNorm+SiLU kernels, whose partial sums (forward and backward) are
  all-reduced over the model group between their two launches
  (``ops/kernels/groupnorm_silu.py``); two-pass statistics as plain code with
  their sums all-reduced under autograd, as they run unsharded;
* the attention blocks gather their input over the model group
  (:func:`gather_height`), run on every token and keep their rows;
* a per-sample sum over pixels is summed over the model group
  (``parallel/mesh.py:sum_over_model``);
* the loss networks (LPIPS, the PatchGAN) run on the model group's gathered
  full-height reconstruction and target, on every rank alike: the gather's
  backward hands each rank its own rows' gradient once, and the
  discriminator's gradients, the same on every rank of a model group, are
  summed over the data group only. Sharding them is a later item (ROADMAP).

The autoencoder's parameters are replicated and each rank's gradient is a
partial sum over its rows, so their gradients sum over the world. Every
collective is an ``all_reduce`` (a gather is one of a zero-filled buffer in
which each rank fills its own slot), the one collective gloo runs on CUDA
tensors, so the same code runs under NCCL with a card per rank and under
gloo with several ranks on one card.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.kernels.groupnorm_silu import groupnorm_silu_split
from ..ops.norm import group_norm_silu
from .mesh import current_mesh, model_rank, model_size, reduce_model_, sum_over_model

__all__ = ["gather_height", "group_norm_silu_tiles", "halo_rows", "shard_batch_spatial",
           "spatial", "spatial_split"]


def spatial() -> bool:
    """Whether the current mesh shards image height."""
    mesh = current_mesh()
    return mesh is not None and mesh.kind == "spatial" and mesh.model > 1


def spatial_split(x, dim: int = 1):
    """This rank's height tile of a full-height array (numpy or torch) along
    ``dim``: rows ``[m * H/M, (m + 1) * H/M)``. Only rank-4 NHWC arrays are
    split (the JAX ``spatial_sharding`` raises on any other rank)."""
    if x.ndim != 4:
        raise ValueError("spatial sharding targets NHWC image batches")
    m, size = model_rank(), model_size()
    if x.shape[dim] % size:
        raise ValueError(f"height {x.shape[dim]} does not split over {size} shards")
    tile = x.shape[dim] // size
    index = [slice(None)] * x.ndim
    index[dim] = slice(m * tile, (m + 1) * tile)
    return x[tuple(index)]


def shard_batch_spatial(batch: dict[str, Any]) -> dict[str, Any]:
    """A host batch with its rank-4 (NHWC) arrays cut to this rank's height
    tile and every other array (masks, attributes) as it is; the ranks of a
    model group load the same rows."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = shard_batch_spatial(value)
        elif getattr(value, "ndim", 0) == 4:
            out[key] = np.ascontiguousarray(spatial_split(value)) if isinstance(
                value, np.ndarray) else spatial_split(value).contiguous()
        else:
            out[key] = value
    return out


def _gather_buffer(x: torch.Tensor) -> torch.Tensor:
    """``[M, *x.shape]`` with this rank's slot filled, summed over the model
    group: every rank's ``x`` in rank order."""
    buf = x.new_zeros((model_size(), *x.shape))
    buf[model_rank()] = x
    return reduce_model_(buf)


class _GatherHeight(torch.autograd.Function):
    """The model group's height tiles ``[B, H/M, ...]`` -> ``[B, H, ...]``.
    Backward: with ``partitioned`` (each rank's use of the gathered tensor
    differs: an attention block keeping its own rows) the ranks' gradients
    are summed and each keeps its rows; without (every rank uses it alike,
    its loss counted once on each: the loss networks) each keeps its rows of
    its own gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, partitioned: bool) -> torch.Tensor:
        ctx.partitioned, ctx.tile = partitioned, x.shape[1]
        buf = _gather_buffer(x.contiguous())  # [M, B, h, ...]
        return buf.transpose(0, 1).reshape(x.shape[0], -1, *x.shape[2:])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if ctx.partitioned:
            grad = reduce_model_(grad.contiguous().clone())
        return grad.narrow(1, model_rank() * ctx.tile, ctx.tile).contiguous(), None


def gather_height(x: torch.Tensor, partitioned: bool = False) -> torch.Tensor:
    """The full-height tensor of the model group's tiles (differentiable, as
    :class:`_GatherHeight` says); ``x`` itself without spatial sharding."""
    return _GatherHeight.apply(x, partitioned) if spatial() else x


class _HaloRows(torch.autograd.Function):
    """``[B, h, W, C]`` -> ``[B, top + h + bottom, W, C]``: the last ``top``
    rows of the rank above and the first ``bottom`` rows of the rank below
    (zeros at the image's top and bottom edges), from one all-reduce of every
    rank's edge rows. Backward: the gradients of the halo rows go back to the
    ranks that own them, the same way, and add to their edge rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        m, size = model_rank(), model_size()
        ctx.top, ctx.bottom = top, bottom
        edges = torch.cat([x[:, x.shape[1] - top:], x[:, :bottom]], dim=1)
        buf = _gather_buffer(edges.contiguous())  # [M, B, top + bottom, W, C]
        above = buf[m - 1, :, :top] if m > 0 else x.new_zeros((x.shape[0], top, *x.shape[2:]))
        below = (buf[m + 1, :, top:] if m < size - 1
                 else x.new_zeros((x.shape[0], bottom, *x.shape[2:])))
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        m, size = model_rank(), model_size()
        top, bottom = ctx.top, ctx.bottom
        h = grad.shape[1] - top - bottom
        # slot m: the gradients of this rank's halo rows, for their owners
        buf = _gather_buffer(torch.cat([grad[:, :top], grad[:, top + h:]], dim=1).contiguous())
        dx = grad[:, top:top + h].clone()
        if m < size - 1 and top:  # the rank below's top halo is this rank's last rows
            dx[:, h - top:] += buf[m + 1, :, :top]
        if m > 0 and bottom:  # the rank above's bottom halo is this rank's first rows
            dx[:, :bottom] += buf[m - 1, :, top:]
        return dx, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """``x`` with ``top`` rows of the rank above and ``bottom`` of the rank
    below (differentiable); zero rows at the image's edges. Without spatial
    sharding: zero rows on both sides."""
    if spatial():
        return _HaloRows.apply(x, top, bottom)
    return torch.nn.functional.pad(x, (0, 0, 0, 0, top, bottom))


def group_norm_silu_tiles(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
                          num_groups: int, eps: float, stats: str) -> torch.Tensor:
    """``ops/norm.py:group_norm_silu`` of an NHWC height tile, with the
    statistics of the model group's whole images (module docstring)."""
    if x.dim() != 4:
        raise ValueError("spatial sharding targets NHWC image batches")
    hw_total = x.shape[1] * x.shape[2] * model_size()
    if stats == "one_pass":
        return groupnorm_silu_split(x.contiguous(), scale, bias, num_groups, eps, reduce_model_,
                                    hw_total)
    if stats != "two_pass":
        raise ValueError(f"unknown stats mode {stats!r}")
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, num_groups, c // num_groups)
    count = hw_total * (c // num_groups)
    mean = sum_over_model(xg.sum(dim=(1, 3), keepdim=True), partitioned=True) / count
    var = sum_over_model((xg - mean).square().sum(dim=(1, 3), keepdim=True),
                         partitioned=True) / count
    # rounded to x's dtype before the SiLU, as the unsharded two-pass route rounds group_norm's
    y = (((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape) * scale.float()
         + bias.float()).to(x.dtype).float()
    group_norm_silu.two_pass_calls += 1
    return (y * torch.sigmoid(y)).to(x.dtype)
