"""Loader factories (counterpart of ``pti_ldm_vae_tpu/data/factory.py``:
``create_vae_dataloaders``, ``create_vae_inference_dataloader``)."""

from __future__ import annotations

from typing import Any

from .datasets import (
    attributes_for_paths,
    list_tif_paths,
    select_attribute_sources,
    split_dataset,
)
from .loader import ShardedDataLoader

__all__ = ["create_vae_dataloaders", "create_vae_inference_dataloader"]


def create_vae_dataloaders(
    data_base_dir: str,
    batch_size: int,
    patch_size: tuple[int, int],
    *,
    rank: int = 0,
    data_source: str = "edente",
    train_split: float = 0.9,
    num_workers: int = 4,
    seed: int | None = 42,
    subset_size: int | None = None,
    val_dir: str | None = None,
    cache_rate: float = 0.0,
    world_size: int = 1,
    ar_vae_enabled: bool = False,
    regularized_attributes: dict[str, Any] | None = None,
) -> tuple[ShardedDataLoader, ShardedDataLoader, list[str], list[str]]:
    """Returns (train_loader, val_loader, train_paths, val_paths) — reference
    ``create_vae_dataloaders`` contract (``dataloaders.py:370-593``). With
    ``ar_vae_enabled`` every image gets the attributes of
    ``regularized_attributes`` (file(s), mapping, normalization), carried
    through the split and into the batches' ``"attributes"``; a ``val_dir``
    override has its attributes joined on its own paths."""
    paths = list_tif_paths(data_base_dir, data_source)
    if subset_size is not None:
        paths = paths[:subset_size]

    attributes_per_image = None
    if ar_vae_enabled:
        if regularized_attributes is None:
            raise ValueError("AR-VAE enabled but regularized_attributes config is missing.")
        mapping = {k: v for k, v in regularized_attributes.get("attribute_latent_mapping", {}).items()
                   if not str(k).startswith("_")}
        if not mapping:
            raise ValueError("attribute_latent_mapping must be provided when AR-VAE is enabled.")
        sources = select_attribute_sources(regularized_attributes.get("attribute_file"),
                                           data_source)
        normalize_cfg = regularized_attributes.get("normalize_attributes")
        attributes_per_image = attributes_for_paths(paths, sources, mapping, normalize_cfg)

    val_override = list_tif_paths(val_dir, data_source) if val_dir is not None else None
    train_paths, val_paths, train_attrs, val_attrs = split_dataset(
        paths, train_split=train_split, seed=seed, attributes=attributes_per_image,
        val_paths_override=val_override)
    if ar_vae_enabled and val_override is not None:
        val_attrs = attributes_for_paths(val_paths, sources, mapping, normalize_cfg)
    common = dict(seed=seed, rank=rank, world=world_size, num_workers=num_workers)
    train_loader = ShardedDataLoader(train_paths, patch_size, batch_size, attributes=train_attrs,
                                     shuffle=True, cache_rate=cache_rate, **common)
    # validation is always fully cached in the reference (``dataloaders.py:524``)
    val_loader = ShardedDataLoader(val_paths, patch_size, batch_size, attributes=val_attrs,
                                   shuffle=False, cache_rate=1.0 if cache_rate > 0 else 0.0,
                                   **common)
    return train_loader, val_loader, train_paths, val_paths


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
