"""Loader factory for inference (counterpart of
``pti_ldm_vae_tpu/data/factory.py:create_vae_inference_dataloader``)."""

from __future__ import annotations

from .datasets import list_tif_paths
from .loader import ShardedDataLoader

__all__ = ["create_vae_inference_dataloader"]


def create_vae_inference_dataloader(
    input_dir: str,
    patch_size: tuple[int, int],
    batch_size: int,
    num_samples: int | None = None,
    num_workers: int = 4,
) -> tuple[ShardedDataLoader, list[str]]:
    """Reference ``create_vae_inference_dataloader`` (``dataloaders.py:332-367``)."""
    paths = list_tif_paths(input_dir, data_source="both")
    if num_samples is not None:
        paths = paths[:num_samples]
    loader = ShardedDataLoader(paths, patch_size, batch_size, num_workers=num_workers)
    return loader, paths
