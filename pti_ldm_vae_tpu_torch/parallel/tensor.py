"""Tensor parallelism: channel sharding over the model group (counterpart of
``pti_ldm_vae_tpu/parallel/tensor.py``).

The JAX package places every parameter whose trailing (output-channel)
axis is at least ``max(8, M)`` wide and divisible by ``M`` with that axis
sharded over the mesh's ``model`` axis, and GSPMD propagates the layout. The
port applies the same rule to its own layouts (:func:`tensor_parallel_params`:
dim 0 of an OIHW convolution weight, of an ``nn.Linear`` weight ``[out,
in]``, of a bias or a norm scale) and writes the collectives out, on the
current :class:`~.mesh.Mesh` of kind ``"tensor"``:

* a convolution or projection with a sharded weight computes its own
  ``Cout / M`` channels from its whole input: a channel-sharded input is
  gathered, whose backward sums the ranks' gradients and keeps this rank's
  channels (a reduce-scatter), and a whole input passes as it is, whose
  backward sums the ranks' gradients (:func:`channels_in` with
  ``partitioned=True``); its output is channel-sharded;
* a layer with a replicated weight (fewer channels: ``conv_out``, the
  latent convolutions, the PatchGAN's last layer) gathers a sharded input and
  computes its whole output alike on every rank; the gather's backward
  keeps this rank's channels of its own gradient (``partitioned=False``);
* GroupNorm runs on the shard with ``G / M`` groups where the shard holds
  whole groups, else on the gathered channels; InstanceNorm is per channel;
* the single attention head gathers q, k and v (``models/autoencoder_kl.py``).

So every rank of a model group computes the loss alike, each sharded
parameter's gradient lies on its rank, each replicated one's is the whole
gradient on every rank, and both are summed over the data group only. Adam
runs on the shards, so its state is split as the JAX test asserts. A
checkpoint holds the whole tensors (:func:`full_state_dict`, rank 0 writes
the MONAI-keyed ``.pth`` of the unsharded run) and a resume cuts them again
(:func:`shard_state_dict`). The rule is dims-agnostic: 1-D and 3-D models
shard alike. Every collective is an ``all_reduce``, as in ``spatial.py``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .mesh import current_mesh, model_rank, model_size, reduce_model_

__all__ = ["channels_in", "full_optimizer_state", "full_state_dict", "gather_channels",
           "shard_optimizer_state", "shard_state_dict", "shardable", "tensor",
           "tensor_parallel_params"]

MIN_FEATURES = 8


def tensor() -> bool:
    """Whether the current mesh shards channels."""
    mesh = current_mesh()
    return mesh is not None and mesh.kind == "tensor" and mesh.model > 1


def shardable(shape: tuple[int, ...], model: int) -> bool:
    """JAX ``tensor_parallel_params``'s rule on the port's layouts: dim 0 (the
    output channels, JAX's trailing axis) at least ``max(MIN_FEATURES,
    model)`` wide and divisible by ``model``."""
    return (model > 1 and len(shape) >= 1 and shape[0] >= max(MIN_FEATURES, model)
            and shape[0] % model == 0)


def tensor_parallel_params(module: nn.Module) -> list[str]:
    """Replace every shardable parameter of ``module`` by this rank's block of
    dim 0, in place (before its optimizer is built); returns their names. The
    whole shapes are kept in ``module.tp_full_shapes`` for the checkpoints."""
    names, full = [], {}
    for name, p in list(module.named_parameters()):
        if not shardable(tuple(p.shape), model_size()):
            continue
        owner_name, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner_name), leaf,
                nn.Parameter(_block(p.detach()), requires_grad=p.requires_grad))
        names.append(name)
        full[name] = tuple(p.shape)
    module.tp_full_shapes = full
    return names


def _gather_dim0(t: torch.Tensor, full0: int) -> torch.Tensor:
    """The whole dim 0 of a shard (no gradient)."""
    buf = t.new_zeros((model_size(), *t.shape))
    buf[model_rank()] = t
    return reduce_model_(buf).reshape(full0, *t.shape[1:])


def full_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """``module``'s state dict with every sharded tensor gathered whole (a
    collective of the model group: every rank calls it)."""
    full = getattr(module, "tp_full_shapes", {})
    sd = module.state_dict()
    with torch.no_grad():
        return {k: (_gather_dim0(v.contiguous(), full[k][0]) if k in full else v)
                for k, v in sd.items()}


def _block(v: torch.Tensor) -> torch.Tensor:
    """This rank's block of dim 0 of a whole tensor."""
    size = v.shape[0] // model_size()
    return v.narrow(0, model_rank() * size, size).clone()


def shard_state_dict(module: nn.Module, sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A whole state dict cut to this rank's blocks of ``module``'s sharded
    tensors (no collective)."""
    full = getattr(module, "tp_full_shapes", {})
    return {k: (_block(v) if k in full else v) for k, v in sd.items()}


def _sharded_slots(module: nn.Module) -> dict[int, int]:
    """Optimizer slot (position among the trainable parameters) -> whole dim 0,
    for the sharded parameters."""
    full = getattr(module, "tp_full_shapes", {})
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    return {i: full[n][0] for i, n in enumerate(names) if n in full}


def full_optimizer_state(module: nn.Module, optimizer: torch.optim.Optimizer) -> dict[str, Any]:
    """``optimizer``'s state dict with the moments of ``module``'s sharded
    parameters gathered whole (a collective of the model group)."""
    sd = optimizer.state_dict()
    slots = _sharded_slots(module)
    state = {}
    with torch.no_grad():
        for i, entry in sd["state"].items():
            state[i] = {k: (_gather_dim0(v.contiguous(), slots[i])
                            if i in slots and torch.is_tensor(v) and v.dim() > 0 else v)
                        for k, v in entry.items()}
    return {**sd, "state": state}


def shard_optimizer_state(module: nn.Module, sd: dict[str, Any]) -> dict[str, Any]:
    """A whole optimizer state dict cut to this rank's blocks."""
    slots = _sharded_slots(module)
    state = {i: {k: (_block(v) if i in slots and torch.is_tensor(v) and v.dim() > 0 else v)
                 for k, v in entry.items()} for i, entry in sd["state"].items()}
    return {**sd, "state": state}


class _GatherChannels(torch.autograd.Function):
    """The model group's channel blocks ``[..., C/M]`` -> ``[..., C]``.
    Backward: with ``partitioned`` (each rank computes its own output
    channels from the whole input) the ranks' gradients are summed and each
    keeps its channels; without (every rank computes the same) each keeps its
    channels of its own gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, partitioned: bool) -> torch.Tensor:
        ctx.partitioned, ctx.block = partitioned, x.shape[-1]
        buf = x.new_zeros((model_size(), *x.shape))
        buf[model_rank()] = x
        buf = reduce_model_(buf)  # [M, ..., C/M]
        return buf.movedim(0, -2).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if ctx.partitioned:
            grad = reduce_model_(grad.contiguous().clone())
        return grad.narrow(-1, model_rank() * ctx.block, ctx.block).contiguous(), None


class _CopyToModel(torch.autograd.Function):
    """A whole tensor that each rank of the model group turns into its own
    output channels: the identity, whose backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return reduce_model_(grad.contiguous().clone())


def gather_channels(x: torch.Tensor, partitioned: bool = False) -> torch.Tensor:
    """The whole channels of the model group's blocks (differentiable, as
    :class:`_GatherChannels` says)."""
    return _GatherChannels.apply(x, partitioned)


def channels_in(x: torch.Tensor, full: int, partitioned: bool) -> torch.Tensor:
    """``x`` with all ``full`` channels for a layer under tensor sharding: a
    channel block is gathered; a whole tensor passes as it is, and with
    ``partitioned`` its gradient is summed over the model group."""
    if x.shape[-1] == full:
        return _CopyToModel.apply(x) if partitioned else x
    if x.shape[-1] * model_size() != full:
        raise ValueError(f"a tensor of {x.shape[-1]} channels is neither the whole {full} nor "
                         f"a block of {model_size()}")
    return gather_channels(x, partitioned)
