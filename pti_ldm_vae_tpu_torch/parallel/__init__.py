"""Data, spatial and tensor parallelism: one process per card over a
``torch.distributed`` process group (counterpart of
``pti_ldm_vae_tpu/parallel``): ``mesh.py`` (the data-parallel helpers and
the ``data x model`` mesh), ``spatial.py`` (image height over the model
group), ``tensor.py`` (channels over it), ``multihost.py`` (the torchrun
rendezvous), ``dryrun.py`` (the port's ``dryrun_multichip``)."""

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
    make_mesh,
    masked_mean,
    own_rows,
    pad_batch,
    process_rank,
    world_size,
)
from .multihost import maybe_initialize_distributed, torchrun_local_rank
from .spatial import shard_batch_spatial
from .tensor import tensor_parallel_params

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
    "make_mesh",
    "masked_mean",
    "maybe_initialize_distributed",
    "own_rows",
    "pad_batch",
    "process_rank",
    "shard_batch_spatial",
    "tensor_parallel_params",
    "torchrun_local_rank",
    "world_size",
]
