"""Data parallelism: one process per card over a ``torch.distributed``
process group (counterpart of ``pti_ldm_vae_tpu/parallel``). Spatial and
tensor parallelism (``shard_batch_spatial``, ``spatial_sharding``,
``tensor_parallel_params``) are not ported: ROADMAP A.13."""

from .mesh import (
    allreduce_gradients,
    allreduce_metrics,
    barrier_sync,
    broadcast_module,
    first_local_rows,
    gather_rows,
    global_count,
    grouped,
    local_randint,
    local_randn,
    masked_mean,
    own_rows,
    pad_batch,
    process_rank,
    world_size,
)
from .multihost import maybe_initialize_distributed, torchrun_local_rank

__all__ = [
    "allreduce_gradients",
    "allreduce_metrics",
    "barrier_sync",
    "broadcast_module",
    "first_local_rows",
    "gather_rows",
    "global_count",
    "grouped",
    "local_randint",
    "local_randn",
    "masked_mean",
    "maybe_initialize_distributed",
    "own_rows",
    "pad_batch",
    "process_rank",
    "torchrun_local_rank",
    "world_size",
]
