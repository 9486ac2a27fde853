"""Train state: generator + optional discriminator, two Adam optimizers
(counterpart of ``pti_ldm_vae_tpu/train/state.py``).

The JAX package keeps an immutable pytree that a pure step replaces; PyTorch
parameters and optimizer state are updated in place, so the state here is a
small mutable object: the generator module, its ``torch.optim.Adam``, a step
counter and, when the adversarial branch is on, the discriminator module and
its own ``torch.optim.Adam``.

Under a process group (``parallel/``) each update first sums the ranks'
gradients of its optimizer's parameters: one all-reduce of one flat buffer
per optimizer and step (the explicit form of DDP's; DDP's reducer expects one
forward and one backward per wrapped module, and the adversarial step runs
the discriminator two or three times). LR x world size as in the reference
(``train_vae.py:301-304``): the world is the number of ranks, one per card,
each of which adds its ``batch_size`` rows to the global batch.

Under a model-parallel mesh (``parallel/mesh.py:make_mesh``) the LR scales by
the number of distinct batches (the caller passes ``data_size()``) and the
gradients sum over the group each parameter's gradient is partial over:
under spatial sharding the autoencoder's over the world (each rank's is a
partial sum over its rows) and the discriminator's over the data group (it
runs alike on every rank of a model group, on the gathered images); under
tensor sharding both over the data group (a sharded parameter's gradient
lies on its rank, a replicated one's is whole on every rank). Adam runs on
the shards, so its state is split like the parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from ..parallel.mesh import allreduce_gradients, current_mesh, data_group

__all__ = ["GanTrainState", "create_train_state"]


def _allreduce(optimizer: torch.optim.Optimizer, group: Any) -> None:
    allreduce_gradients((p for g in optimizer.param_groups for p in g["params"]), group)


@dataclass
class GanTrainState:
    step: int
    model_g: nn.Module
    optimizer_g: torch.optim.Optimizer
    model_d: nn.Module | None = None       # None while the adversarial branch is off
    optimizer_d: torch.optim.Optimizer | None = None
    group_g: Any = None  # the process groups the gradients sum over (None: the world)
    group_d: Any = None

    def apply_g(self) -> None:
        """One Adam update of the generator from the gradients on its
        parameters (summed over the ranks first); clears them afterwards."""
        _allreduce(self.optimizer_g, self.group_g)
        self.optimizer_g.step()
        self.optimizer_g.zero_grad(set_to_none=True)
        self.step += 1

    def apply_d(self) -> None:
        """One Adam update of the discriminator from the gradients on its
        parameters (summed over the ranks first); clears them afterwards. The
        step counter follows the generator alone."""
        _allreduce(self.optimizer_d, self.group_d)
        self.optimizer_d.step()
        self.optimizer_d.zero_grad(set_to_none=True)


def create_train_state(
    model_g: nn.Module,
    *,
    lr: float,
    world_size: int = 1,
    model_d: nn.Module | None = None,
    b1: float = 0.9,
    b2: float = 0.999,
) -> GanTrainState:
    """Adam with torch defaults (eps=1e-8), lr scaled by ``world_size`` (the
    number of ranks), one
    optimizer per model (the discriminator's only when ``model_d`` is given).
    On CUDA the update of all parameters is PyTorch's fused Adam (one library
    kernel per dtype and device), on the CPU its plain loop; the arithmetic is
    the same."""

    def adam(model: nn.Module) -> torch.optim.Adam:
        params = [p for p in model.parameters() if p.requires_grad]
        fused = bool(params) and all(p.device.type == "cuda" for p in params)
        return torch.optim.Adam(params, lr=lr * world_size, betas=(b1, b2), eps=1e-8, fused=fused)

    mesh = current_mesh()
    return GanTrainState(step=0, model_g=model_g, optimizer_g=adam(model_g), model_d=model_d,
                         optimizer_d=adam(model_d) if model_d is not None else None,
                         group_g=data_group() if mesh is not None and mesh.kind == "tensor"
                         else None,
                         group_d=data_group() if mesh is not None else None)
