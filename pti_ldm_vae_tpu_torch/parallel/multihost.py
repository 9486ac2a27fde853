"""Process-group start-up: the torchrun / ``env://`` rendezvous (counterpart
of ``pti_ldm_vae_tpu/parallel/multihost.py``).

The reference spawns one process per GPU with torchrun and meets through
``dist.init_process_group("nccl", init_method="env://")``
(``distributed.py:20-26``). The port does the same: one process per card,
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``
from torchrun, NCCL on CUDA and gloo on the CPU. (The JAX package runs one
process per HOST that drives all of its chips; here every card has its own
process.)

A process group that is already initialised is left as it is, whatever its
backend: a caller may start one itself (gloo with two ranks on one card, as
the tests and ``chip_smoke.py`` do) and then call the entry points. Without a
torchrun environment and without a group nothing happens.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize_distributed", "torchrun_local_rank"]

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def torchrun_local_rank() -> int | None:
    """``LOCAL_RANK`` of a torchrun launch, or None outside one."""
    value = os.environ.get("LOCAL_RANK")
    return None if value is None else int(value)


def maybe_initialize_distributed(device: torch.device | str = "cuda") -> bool:
    """Join the process group a torchrun launch describes; True when a group
    is active afterwards. Idempotent.

    ``device`` is the entry point's device: CUDA takes NCCL (and becomes the
    current device), the CPU gloo. NCCL missing on a CUDA run raises: there is
    no fallback to gloo, which stages every CUDA collective through the host.
    """
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    missing = [name for name in _TORCHRUN_VARS if name not in os.environ]
    if missing:
        raise RuntimeError(f"a torchrun launch sets {', '.join(_TORCHRUN_VARS)}; "
                           f"{', '.join(missing)} missing")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(device)
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch has no NCCL: a CUDA process group needs it "
                               "(gloo is for the CPU only)")
        index = device.index if device.index is not None else int(os.environ["LOCAL_RANK"])
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"cuda:{index} asked for, {torch.cuda.device_count()} card(s) seen")
        torch.cuda.set_device(index)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device}")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return True
