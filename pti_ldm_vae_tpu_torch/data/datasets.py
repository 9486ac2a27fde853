"""Dataset assembly: path listing, the seeded train/val split and the
per-image attribute join of the AR-VAE term (counterpart of
``pti_ldm_vae_tpu/data/datasets.py``: ``list_tif_paths``,
``load_attribute_json``, ``select_attribute_sources``,
``normalize_attributes``, ``attributes_for_paths``, ``split_dataset``)."""

from __future__ import annotations

import json
import os
import random
from pathlib import Path
from typing import Any

__all__ = [
    "list_tif_paths",
    "load_attribute_json",
    "select_attribute_sources",
    "normalize_attributes",
    "attributes_for_paths",
    "split_dataset",
]


def list_tif_paths(data_base_dir: str, data_source: str) -> list[str]:
    """Sorted .tif paths for a source (reference ``dataloaders.py:15-47``):
    direct ``*.tif`` in the base dir win; otherwise ``edente``/``dente``
    subfolders (or both concatenated, edente first)."""
    base = Path(data_base_dir)
    direct = sorted(base.glob("*.tif"))
    if direct:
        return [str(p) for p in direct]
    if data_source == "edente":
        paths = sorted((base / "edente").glob("*.tif"))
    elif data_source == "dente":
        paths = sorted((base / "dente").glob("*.tif"))
    elif data_source == "both":
        paths = sorted((base / "edente").glob("*.tif")) + sorted((base / "dente").glob("*.tif"))
    else:
        raise ValueError(f"data_source must be 'edente', 'dente', or 'both', got '{data_source}'")
    if not paths:
        raise FileNotFoundError(f"No .tif images found in {data_base_dir}/{data_source}")
    return [str(p) for p in paths]


def load_attribute_json(attribute_file: str) -> dict[str, dict[str, float]]:
    """filename -> {attribute: value} (reference ``dataloaders.py:120-141``)."""
    if not os.path.exists(attribute_file):
        raise FileNotFoundError(f"Attribute file not found: {attribute_file}")
    try:
        with open(attribute_file, encoding="utf-8") as fh:
            return json.load(fh)
    except json.JSONDecodeError as exc:
        raise ValueError(f"Invalid attribute JSON: {attribute_file}") from exc


def select_attribute_sources(
    attribute_file: str | dict[str, str], data_source: str
) -> dict[str, dict[str, dict[str, float]]]:
    """Source name -> attribute mapping (reference ``dataloaders.py:143-154``):
    one file serves ``data_source``, a mapping names a file per source."""
    if isinstance(attribute_file, str):
        return {data_source: load_attribute_json(attribute_file)}
    if isinstance(attribute_file, dict):
        return {src: load_attribute_json(path) for src, path in attribute_file.items()}
    raise ValueError(
        "regularized_attributes.attribute_file must be a string or mapping from source to file.")


def normalize_attributes(
    attributes: dict[str, float], normalize_cfg: dict[str, Any] | None
) -> dict[str, float]:
    """Optional divisor normalization (reference ``dataloaders.py:157-172``)."""
    if not normalize_cfg or not normalize_cfg.get("enabled", False):
        return attributes
    divisor = float(normalize_cfg.get("divisor", 1.0))
    if divisor == 0:
        raise ValueError("Normalization divisor must be non-zero.")
    return {key: float(value) / divisor for key, value in attributes.items()}


def attributes_for_paths(
    paths: list[str],
    attribute_sources: dict[str, dict[str, dict[str, float]]],
    attribute_latent_mapping: dict[str, Any],
    normalize_cfg: dict[str, Any] | None = None,
) -> list[dict[str, float]]:
    """The attributes of each image path (reference ``dataloaders.py:175-219``).
    The source is read off the whole path, "edente" before "dente" (a
    substring of it): a directory named ``...edente...`` anywhere above the
    file routes it to "edente". A missing entry or attribute key raises."""
    wanted = [k for k in attribute_latent_mapping if not str(k).startswith("_")]
    out: list[dict[str, float]] = []
    for path in paths:
        base = os.path.basename(path)
        if "edente" in path:
            source_key = "edente"
        elif "dente" in path:
            source_key = "dente"
        else:
            raise ValueError(f"Cannot identify data source from path: {path}")
        entry = attribute_sources.get(source_key, {}).get(base)
        if entry is None:
            raise FileNotFoundError(f"Attribute entry missing for {base} in source {source_key}")
        filtered = {key: float(entry[key]) for key in wanted if key in entry}
        if len(filtered) != len(wanted):
            missing = set(wanted).difference(filtered)
            raise KeyError(f"Missing attributes for {base}: {missing}")
        out.append(normalize_attributes(filtered, normalize_cfg))
    return out


def split_dataset(
    paths: list[str],
    *,
    train_split: float = 0.9,
    seed: int | None = 42,
    attributes: list[dict[str, float]] | None = None,
    val_paths_override: list[str] | None = None,
) -> tuple[list[str], list[str], list | None, list | None]:
    """Seeded shuffle + split in the reference's ordering
    (``dataloaders.py:469-513``): ``random.seed(seed)`` then
    ``random.shuffle``; attributes, when given, are shuffled with their paths
    (a shuffle of the zipped pairs is the same permutation). Returns
    (train_paths, val_paths, train_attributes, val_attributes); with
    ``val_paths_override`` every shuffled path trains and the validation
    attributes are None (the caller joins them for the override)."""
    if not 0 < train_split < 1:
        raise ValueError(f"train_split must be in (0, 1), got {train_split}")
    paths = list(paths)
    attrs = list(attributes) if attributes is not None else None
    if seed is not None:
        random.seed(seed)
        if attrs is not None:
            paired = list(zip(paths, attrs))
            random.shuffle(paired)
            paths = [p for p, _ in paired]
            attrs = [a for _, a in paired]
        else:
            random.shuffle(paths)
    if val_paths_override is not None:
        return paths, list(val_paths_override), attrs, None
    split_idx = int(train_split * len(paths))
    if attrs is not None:
        return paths[:split_idx], paths[split_idx:], attrs[:split_idx], attrs[split_idx:]
    return paths[:split_idx], paths[split_idx:], None, None
