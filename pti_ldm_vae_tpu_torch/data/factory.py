"""Loader factories (counterpart of ``pti_ldm_vae_tpu/data/factory.py``:
``create_vae_dataloaders``, ``create_vae_inference_dataloader`` and the
regression loaders, whose batches add a ``"target"`` [B, T] matrix)."""

from __future__ import annotations

from typing import Any

import numpy as np

from .datasets import (
    attributes_for_paths,
    list_tif_paths,
    select_attribute_sources,
    split_dataset,
)
from .loader import ShardedDataLoader

__all__ = [
    "RegressionLoader",
    "create_regression_dataloaders",
    "create_regression_eval_dataloader",
    "create_regression_inference_dataloader",
    "create_vae_dataloaders",
    "create_vae_inference_dataloader",
]


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


def _targets_matrix(attrs: list[dict[str, float]], targets: list[str]) -> np.ndarray:
    """Attribute dicts -> [N, T] float32 (reference ``dataloaders.py:222-242``)."""
    try:
        return np.array([[float(a[t]) for t in targets] for a in attrs], dtype=np.float32)
    except KeyError as exc:
        raise KeyError(f"Missing target {exc} in attributes.") from exc


class RegressionLoader(ShardedDataLoader):
    """ShardedDataLoader variant yielding (image, target-vector) batches; the
    padded rows of the last batch get zero targets."""

    def __init__(self, *args, targets_matrix: np.ndarray, **kwargs):
        super().__init__(*args, **kwargs)
        self.targets_matrix = targets_matrix

    def apply_target_transform(self, fn) -> None:
        """Parity with ``DatasetWithTargets.apply_target_transform``
        (``dataloaders.py:95-101``)."""
        self.targets_matrix = np.asarray(fn(self.targets_matrix), dtype=np.float32)

    def stacked_targets(self) -> np.ndarray:
        return self.targets_matrix

    def _make_batch(self, idx_chunk):
        out = super()._make_batch(idx_chunk)
        bsz = out["image"].shape[0]
        tgt = np.zeros((bsz, self.targets_matrix.shape[1]), dtype=np.float32)
        tgt[: len(idx_chunk)] = self.targets_matrix[np.asarray(idx_chunk, dtype=int)]
        out["target"] = tgt
        return out


def create_regression_dataloaders(
    data_base_dir: str,
    attributes_path: str | dict[str, str],
    targets: list[str],
    batch_size: int,
    patch_size: tuple[int, int],
    *,
    data_source: str = "edente",
    train_split: float = 0.9,
    num_workers: int = 4,
    seed: int | None = 42,
    subset_size: int | None = None,
    val_dir: str | None = None,
    cache_rate: float = 0.0,
    normalize_attributes: dict | None = None,
) -> tuple[RegressionLoader, RegressionLoader, list[str], list[str]]:
    """Images + target vectors for latent regression (reference
    ``dataloaders.py:596-722``)."""
    paths = list_tif_paths(data_base_dir, data_source)
    if subset_size is not None:
        paths = paths[:subset_size]
    sources = select_attribute_sources(attributes_path, data_source)
    mapping = {t: {} for t in targets}
    attrs = attributes_for_paths(paths, sources, mapping, normalize_attributes)
    val_override = list_tif_paths(val_dir, data_source) if val_dir is not None else None
    train_paths, val_paths, train_attrs, val_attrs = split_dataset(
        paths, train_split=train_split, seed=seed, attributes=attrs,
        val_paths_override=val_override,
    )
    if val_override is not None:
        val_attrs = attributes_for_paths(val_paths, sources, mapping, normalize_attributes)
    seed = seed if seed is not None else 0
    train_loader = RegressionLoader(
        train_paths, patch_size, batch_size,
        targets_matrix=_targets_matrix(train_attrs, targets),
        shuffle=True, seed=seed, cache_rate=cache_rate, num_workers=num_workers,
    )
    val_loader = RegressionLoader(
        val_paths, patch_size, batch_size,
        targets_matrix=_targets_matrix(val_attrs, targets),
        shuffle=False, seed=seed, cache_rate=1.0 if cache_rate > 0 else 0.0,
        num_workers=num_workers,
    )
    return train_loader, val_loader, train_paths, val_paths


def create_regression_eval_dataloader(
    data_base_dir: str,
    attributes_path: str | dict[str, str],
    targets: list[str],
    batch_size: int,
    patch_size: tuple[int, int],
    *,
    data_source: str = "edente",
    num_samples: int | None = None,
    num_workers: int = 4,
    normalize_attributes: dict | None = None,
) -> tuple[RegressionLoader, list[str]]:
    """Evaluation loader over the full directory, no split (reference
    ``dataloaders.py:725-778``)."""
    paths = list_tif_paths(data_base_dir, data_source)
    if num_samples is not None:
        paths = paths[:num_samples]
    sources = select_attribute_sources(attributes_path, data_source)
    attrs = attributes_for_paths(paths, sources, {t: {} for t in targets}, normalize_attributes)
    loader = RegressionLoader(
        paths, patch_size, batch_size, targets_matrix=_targets_matrix(attrs, targets),
        shuffle=False, num_workers=num_workers,
    )
    return loader, paths


def create_regression_inference_dataloader(
    input_dir: str,
    patch_size: tuple[int, int],
    batch_size: int,
    num_samples: int | None = None,
    num_workers: int = 4,
) -> tuple[ShardedDataLoader, list[str]]:
    """Images only, no targets (reference ``dataloaders.py:781-795``)."""
    return create_vae_inference_dataloader(
        input_dir, patch_size, batch_size, num_samples=num_samples, num_workers=num_workers
    )
