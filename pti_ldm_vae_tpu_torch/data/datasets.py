"""Dataset assembly: path listing and the seeded train/val split (counterpart
of ``pti_ldm_vae_tpu/data/datasets.py``: ``list_tif_paths``,
``split_dataset``). Per-image attributes come with the AR-VAE term."""

from __future__ import annotations

import random
from pathlib import Path

__all__ = ["list_tif_paths", "split_dataset"]


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


def split_dataset(
    paths: list[str],
    *,
    train_split: float = 0.9,
    seed: int | None = 42,
    val_paths_override: list[str] | None = None,
) -> tuple[list[str], list[str]]:
    """Seeded shuffle + split in the reference's ordering
    (``dataloaders.py:469-513``): ``random.seed(seed)`` then
    ``random.shuffle``. Returns (train_paths, val_paths); with
    ``val_paths_override`` every shuffled path trains."""
    if not 0 < train_split < 1:
        raise ValueError(f"train_split must be in (0, 1), got {train_split}")
    paths = list(paths)
    if seed is not None:
        random.seed(seed)
        random.shuffle(paths)
    if val_paths_override is not None:
        return paths, list(val_paths_override)
    split_idx = int(train_split * len(paths))
    return paths[:split_idx], paths[split_idx:]
