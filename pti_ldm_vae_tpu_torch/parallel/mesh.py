"""Data parallelism over a ``torch.distributed`` process group — the port of
``pti_ldm_vae_tpu/parallel/mesh.py``.

One process per card, as in the reference (DDP + NCCL + ``DistributedSampler``,
``distributed.py``, ``train_vae.py:277-304``). What the JAX package gets from
``jit`` over a batch sharded on the mesh's ``data`` axis, the port writes out:

* the global batch is the ranks' local batches, interleaved: rank ``r``'s row
  ``i`` is global row ``r + world * i`` (the loader's ``rank::world`` schedule,
  ``data/loader.py:shard_indices``);
* a loss is a GLOBAL masked mean: the local ``sum(per * mask)`` over the
  all-reduced ``sum(mask)`` (:func:`global_count`, :func:`masked_mean`); the
  divisor carries no gradient, so the ranks' gradients SUM to the gradient of
  the global mean (:func:`allreduce_gradients`: one flat buffer, one
  all-reduce per optimizer and step, before its update);
* a term over pairs of the global batch (AR-VAE) gathers the rows from every
  rank (:func:`gather_rows`, with a gradient);
* random draws of a batch (posterior noise, timesteps) are the global batch's,
  from a generator seeded alike on every rank, of which each rank keeps its
  rows (:func:`local_randn`, :func:`local_randint`): a run does not depend on
  how the global batch is split;
* metrics are reduced before they are read (:func:`allreduce_metrics`).

With no process group every helper is the single-process arithmetic, and a
group of one rank gives the same bits.

Model parallelism (``parallel/spatial.py``, ``parallel/tensor.py``) splits
the ranks into a ``data x model`` :class:`Mesh` (:func:`make_mesh`), rank
``r = d * model + m``: the ranks of one model group (consecutive ranks) hold
the same rows of the batch, each a piece of every image (a height tile) or
of every activation (a channel block). The data-parallel helpers above then
run over the data group (``d``: :func:`data_rank` of :func:`data_size`), and
the model group has its own collectives (:func:`sum_over_model`,
:func:`reduce_model_`). Without a mesh the data group is the world.

Every collective here is a ``broadcast``, an ``all_reduce`` or a ``barrier``:
the only ones gloo runs on CUDA tensors, so the same code runs under NCCL
with one card per rank and under gloo with several ranks on one card (the
tests). ``make_mesh``, ``data_sharding`` and ``replicated`` of the JAX module
have no counterpart: a process drives one device, and a tensor is wherever
its process put it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

__all__ = [
    "Mesh",
    "allreduce_gradients",
    "allreduce_metrics",
    "barrier_sync",
    "broadcast_module",
    "current_mesh",
    "data_group",
    "data_rank",
    "data_size",
    "first_local_rows",
    "gather_rows",
    "global_count",
    "grouped",
    "local_randint",
    "local_randn",
    "make_mesh",
    "masked_mean",
    "model_rank",
    "model_size",
    "own_rows",
    "pad_batch",
    "process_rank",
    "reduce_model_",
    "set_mesh",
    "sum_over_model",
    "world_size",
]


def grouped() -> bool:
    """Whether a process group is active."""
    return dist.is_initialized()


def world_size() -> int:
    """The number of ranks (1 without a group): the reference's DDP
    ``world_size``, by which the VAE trainer scales its LR. Each rank adds its
    ``batch_size`` rows to the global batch."""
    return dist.get_world_size() if grouped() else 1


def process_rank() -> int:
    return dist.get_rank() if grouped() else 0


@dataclass(frozen=True)
class Mesh:
    """The ``data x model`` split of the ranks (JAX ``make_mesh``'s
    ``devices.reshape(data, model)``): rank ``r = data_rank * model +
    model_rank``. ``kind`` is what the model axis carries: ``"spatial"``
    (image height, ``parallel/spatial.py``) or ``"tensor"`` (channels,
    ``parallel/tensor.py``). ``data_group`` joins the ranks of one
    ``model_rank``, ``model_group`` those of one ``data_rank``."""

    kind: str
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Any
    model_group: Any


_MESH: Mesh | None = None


def make_mesh(kind: str, model: int) -> Mesh:
    """Split the active process group into ``data x model``, ``data = world
    // model``, and make it the current mesh (:func:`set_mesh`). The caller
    has checked the split (``train/loop.py:check_parallelism``). Every rank
    must call it (it creates every group, in the same order on every rank)."""
    world, rank = world_size(), process_rank()
    data = world // model
    model_groups = [dist.new_group(list(range(d * model, (d + 1) * model)))
                    for d in range(data)]
    data_groups = [dist.new_group(list(range(m, world, model))) for m in range(model)]
    mesh = Mesh(kind, data, model, rank // model, rank % model, data_groups[rank % model],
                model_groups[rank // model])
    set_mesh(mesh)
    return mesh


def set_mesh(mesh: Mesh | None) -> None:
    """Make ``mesh`` the current one (``None``: data parallelism over the
    world, the default)."""
    global _MESH
    _MESH = mesh


def current_mesh() -> Mesh | None:
    return _MESH


def data_size() -> int:
    """The number of distinct batches a step sees: the world without a mesh,
    ``mesh.data`` with one. The LR scales by it."""
    return _MESH.data if _MESH is not None else world_size()


def data_rank() -> int:
    return _MESH.data_rank if _MESH is not None else process_rank()


def data_group():
    """The process group of this rank's data axis (``None``: the world)."""
    return _MESH.data_group if _MESH is not None else None


def model_size() -> int:
    return _MESH.model if _MESH is not None else 1


def model_rank() -> int:
    return _MESH.model_rank if _MESH is not None else 0


def _all_reduce(t: torch.Tensor, group, size: int) -> None:
    """In-place sum over ``group`` of ``size`` ranks; nothing for one rank."""
    if size > 1:
        dist.all_reduce(t, group=group)


def reduce_model_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the model group in place (no gradient); ``t`` itself."""
    if _MESH is not None:
        _all_reduce(t, _MESH.model_group, _MESH.model)
    return t


def _reduce_data_(t: torch.Tensor) -> torch.Tensor:
    if grouped():
        _all_reduce(t, data_group(), data_size())
    return t


class _SumOverModel(torch.autograd.Function):
    """Sum over the model group of a partial value. Backward: without
    ``partitioned`` every rank of the group uses the sum alike (a per-sample
    sum of a loss term, the loss counted once on each rank), so each partial
    receives the sum's gradient as it is; with it each rank's use differs (a
    statistic its own rows are normalised by), so the ranks' gradients are
    summed."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, partitioned: bool) -> torch.Tensor:
        ctx.partitioned = partitioned
        return reduce_model_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if ctx.partitioned:
            grad = reduce_model_(grad.contiguous().clone())
        return grad, None


def sum_over_model(x: torch.Tensor, partitioned: bool = False) -> torch.Tensor:
    """The model group's sum of ``x`` (differentiable, as
    :class:`_SumOverModel` says); ``x`` itself without model parallelism."""
    return _SumOverModel.apply(x, partitioned) if model_size() > 1 else x


def barrier_sync(tag: str = "barrier") -> None:
    """Cross-process barrier (reference ``dist.barrier()``,
    ``distributed.py:27``); nothing without a group. ``tag`` names the
    barrier for a reader of the code, as in the JAX package."""
    del tag
    if grouped():
        dist.barrier()


def pad_batch(batch: Any, multiple: int) -> Any:
    """Zero-pad every array's leading axis of a (nested dict of) numpy
    batch(es) to the next multiple. Padding rows carry ``mask == 0``, so the
    masked means ignore them."""
    if isinstance(batch, dict):
        return {k: pad_batch(v, multiple) for k, v in batch.items()}
    x = np.asarray(batch)
    if x.ndim == 0 or multiple <= 1:
        return x
    target = -(-x.shape[0] // multiple) * multiple
    if target == x.shape[0]:
        return x
    return np.pad(x, [(0, target - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def first_local_rows(x: torch.Tensor) -> np.ndarray:
    """Host copy of this process's rows (its whole local tensor: the rows of
    a rank live on its one device). Used for dumps, never for metrics. Under
    spatial sharding a rank holds a height tile of its rows: the model
    group's tiles of an NHWC ``x`` are stitched back along the height, as the
    JAX ``first_local_rows`` does, so every rank of the group must call it."""
    if _MESH is not None and _MESH.kind == "spatial" and x.dim() == 4:
        from .spatial import gather_height

        with torch.no_grad():
            x = gather_height(x)
    return x.detach().cpu().numpy()


def global_count(mask: torch.Tensor) -> torch.Tensor:
    """``sum(mask)`` over the global batch: the divisor of every masked mean
    of a step, all-reduced once over the data group (the ranks of a model
    group hold the same rows)."""
    return _reduce_data_(mask.float().sum())


def masked_mean(per_sample: torch.Tensor, mask: torch.Tensor,
                count: torch.Tensor | None = None) -> torch.Tensor:
    """This rank's share of the global masked mean: ``sum(per * mask) /
    max(count, 1)``, ``count`` from :func:`global_count` (the local ``sum(mask)``
    when None). The ranks' shares sum to the mean over the global batch."""
    mask = mask.float()
    if count is None:
        count = mask.sum()
    return torch.sum(per_sample * mask) / torch.clamp(count, min=1.0)


def _memory_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as a 1-D view in memory order (a channels-last
    gradient included): no copy. Every tensor handed to a collective here is
    dense, and every rank lays the same tensor out alike."""
    if t.is_contiguous():
        return t.view(-1)
    span = 1
    for d in sorted(range(t.dim()), key=t.stride):
        if t.size(d) != 1 and t.stride(d) != span:
            raise ValueError(f"a tensor of shape {tuple(t.shape)} and strides {t.stride()} "
                             "is not dense: it has no 1-D view")
        span *= t.size(d)
    return t.as_strided((t.numel(),), (1,), t.storage_offset())


def _through_flat(tensors: list[torch.Tensor], collective) -> None:
    """Run ``collective`` in place on ``tensors`` through one flat buffer per
    dtype: one collective for a whole model, whatever its tensor count, and
    two multi-tensor copies (``torch.cat`` in, ``_foreach_copy_`` out)."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(_memory_view(t))
    for views in by_dtype.values():
        flat = torch.cat(views)
        collective(flat)
        torch._foreach_copy_(views, list(torch.split(flat, [v.numel() for v in views])))


def allreduce_gradients(params: Iterable[torch.Tensor], group: Any = None) -> None:
    """Sum the ranks' gradients of ``params`` in place (one all-reduce of one
    flat buffer) over ``group`` (``None``: the world); a parameter without a
    gradient has none on every rank, and is skipped. Nothing without a
    group."""
    if not grouped():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _through_flat(grads, lambda flat: dist.all_reduce(flat, group=group))


def allreduce_metrics(metrics: dict[str, torch.Tensor],
                      replicated: Iterable[str] = ()) -> dict[str, torch.Tensor]:
    """Global values of a step's scalar metrics: every metric but those in
    ``replicated`` is a rank's share (a masked mean's, or a mean over its rows
    divided by the world size) and is summed over the ranks in one
    all-reduce; ``replicated`` ones are computed alike on every rank (a term
    over the gathered batch) and stay as they are. The sum runs over the data
    group: every metric is the same on the ranks of a model group."""
    if not grouped():
        return metrics
    skip = set(replicated)
    keys = [k for k in metrics if k not in skip]
    if not keys:
        return metrics
    flat = _reduce_data_(torch.stack([metrics[k].detach().float() for k in keys]))
    return {**metrics, **{k: flat[i] for i, k in enumerate(keys)}}


class _GatherRows(torch.autograd.Function):
    """``[B, ...]`` of every rank of the data group -> ``[data * B, ...]`` in
    global row order, from one all-reduce of a zeroed buffer in which each
    rank fills its own rows. Backward: every rank computes the same function
    of the gathered rows, so the gradient that reaches rank ``r``'s rows is
    the same on every rank, and the rank keeps it for its rows once (the
    all-reduce's own backward would sum ``world`` equal copies)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        world, rank = data_size(), data_rank()
        buf = x.new_zeros((x.shape[0], world, *x.shape[1:]))
        buf[:, rank] = x
        _reduce_data_(buf)
        ctx.rank, ctx.world = rank, world
        return buf.reshape(x.shape[0] * world, *x.shape[1:])

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad.reshape(-1, ctx.world, *grad.shape[1:])[:, ctx.rank]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of ``x`` (rank ``r``'s row ``i`` at ``r + world
    * i``), differentiable as :class:`_GatherRows` says; ``x`` itself without a
    group."""
    return _GatherRows.apply(x) if grouped() else x


def local_randn(shape: tuple[int, ...], *, generator: torch.Generator | None = None,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None,
                model_axis: int | None = None) -> torch.Tensor:
    """Standard normal ``shape`` rows of this rank: the global batch's draw,
    ``[data * B, ...]`` from ``generator``, at rows ``data_rank::data``.
    With ``model_axis`` (under model parallelism, the axis of ``shape`` that
    is this rank's tile of the model group's: the height under spatial
    sharding) the draw covers the whole axis and the rank keeps its tile.
    Without a group (or with one rank) it is the plain draw."""
    world, model = data_size(), model_size()
    full_shape = [shape[0] * world, *shape[1:]]
    if model_axis is not None:
        full_shape[model_axis] *= model
    full = torch.randn(tuple(full_shape), generator=generator, dtype=dtype, device=device)
    if world > 1:
        full = full[data_rank()::world]
    if model_axis is not None and model > 1:
        size = shape[model_axis]
        full = full.narrow(model_axis, model_rank() * size, size)
    return full


def local_randint(high: int, batch: int, *, generator: torch.Generator | None = None,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """``batch`` integers in ``[0, high)`` of this rank: rows ``rank::data``
    of the global batch's draw, as :func:`local_randn`."""
    world = data_size()
    full = torch.randint(0, high, (batch * world,), generator=generator, device=device)
    return full if world == 1 else full[data_rank()::world]


def own_rows(n: int) -> list[int]:
    """The rows of ``n`` that this rank takes in an entry point whose ranks
    do not talk (sampling, PTI): ``rank::world``, no padding."""
    return list(range(process_rank(), n, world_size()))


def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Every rank takes ``src``'s parameters and buffers (one broadcast of one
    flat buffer per dtype); nothing without a group."""
    if not grouped():
        return
    _through_flat([t.data for t in (*module.parameters(), *module.buffers())],
                  lambda flat: dist.broadcast(flat, src))
