"""Dataset assembly: path listing (counterpart of
``pti_ldm_vae_tpu/data/datasets.py:list_tif_paths``)."""

from __future__ import annotations

from pathlib import Path

__all__ = ["list_tif_paths"]


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
