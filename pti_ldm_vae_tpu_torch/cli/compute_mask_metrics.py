"""Mask-attribute extraction CLI (the port's copy of
``pti_ldm_vae_tpu/cli/compute_mask_metrics.py``, on the port's TIFF reader;
it writes the same bytes).

Workload parity with ``vae_scripts/compute_mask_metrics.py`` (SURVEY.md §2.1
#11): for each (edente, dente) mask pair sharing a filename stem —

* edente: bounding-box height (``height_0``) plus N evenly-spaced row widths
  between the bbox top and bottom, reported bottom-up
  (``compute_mask_metrics.py:48-61``),
* dente: widths at rows located at fixed mm offsets from the image bottom
  (``:64-68,76-78,186-188``), sharing the edente bbox height,

writing ``attributes_edente.json`` / ``attributes_dente.json`` consumed by
AR-VAE training and latent regression. Host-side numpy (one-shot data prep,
not a hot loop); the row-width scans are vectorized with argmax instead of
per-row Python loops.

    python -m pti_ldm_vae_tpu_torch.cli.compute_mask_metrics --edente-dir masks/edente \\
        --dente-dir masks/dente --output-edente attributes_edente.json \\
        --output-dente attributes_dente.json
"""

from __future__ import annotations

import argparse
import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Sequence

import numpy as np

from ..data.io import read_image

__all__ = [
    "MetricConfig",
    "load_binary_mask",
    "compute_bbox",
    "compute_edente_widths",
    "compute_dente_width",
    "pixel_offsets_mm",
    "process_dataset",
    "main",
]


@dataclass
class MetricConfig:
    edente_dir: Path
    dente_dir: Path
    output_edente: Path
    output_dente: Path
    pixel_size_mm: float
    dente_heights_mm: tuple[float, ...]
    edente_width_samples: int


def load_binary_mask(path: Path) -> np.ndarray:
    """TIFF mask -> {0,1} uint8."""
    mask = read_image(str(path))
    if mask.ndim == 3:
        mask = mask[..., 0]
    return (mask > 0).astype(np.uint8)


def compute_bbox(mask: np.ndarray) -> tuple[int, int, int, int]:
    """(x0, y0, width, height) of the foreground extent."""
    ys, xs = np.where(mask == 1)
    if ys.size == 0:
        raise ValueError("Mask does not contain any foreground pixels")
    x0, y0 = int(xs.min()), int(ys.min())
    return x0, y0, int(xs.max()) - x0 + 1, int(ys.max()) - y0 + 1


def _row_widths(rows: np.ndarray) -> np.ndarray:
    """Vectorized [N, W] -> per-row span (last - first nonzero + 1, else 0)."""
    any_fg = rows.any(axis=1)
    first = rows.argmax(axis=1)
    last = rows.shape[1] - 1 - rows[:, ::-1].argmax(axis=1)
    return np.where(any_fg, last - first + 1, 0).astype(int)


def compute_edente_widths(
    mask: np.ndarray, x: int, y: int, width: int, height: int, samples: int
) -> tuple[int, list[int]]:
    """Bbox height + ``samples`` evenly-spaced row widths, bottom-up order."""
    if samples <= 0:
        return height, []
    ys = np.linspace(0, height, samples + 2, dtype=int)[1:-1][::-1] + y
    rows = mask[ys, x : x + width]
    return height, _row_widths(rows).tolist()


def compute_dente_width(mask: np.ndarray, row_index: int) -> int:
    return int(_row_widths(mask[row_index : row_index + 1])[0])


def pixel_offsets_mm(heights_mm: Sequence[float], pixel_size_mm: float) -> list[int]:
    return [int(round(h / pixel_size_mm)) for h in heights_mm]


def list_tif_files(path: Path) -> dict[str, Path]:
    return {p.stem: p for p in sorted(path.iterdir()) if p.suffix.lower() in {".tif", ".tiff"}}


def process_dataset(config: MetricConfig):
    """Returns (attributes_edente, attributes_dente); skips failing pairs
    (reference skip-and-continue behavior, ``:194-199``)."""
    if not config.edente_dir.is_dir():
        raise FileNotFoundError(f"Edente directory not found: {config.edente_dir}")
    if not config.dente_dir.is_dir():
        raise FileNotFoundError(f"Dente directory not found: {config.dente_dir}")
    config.output_edente.parent.mkdir(parents=True, exist_ok=True)
    config.output_dente.parent.mkdir(parents=True, exist_ok=True)

    edente_files = list_tif_files(config.edente_dir)
    dente_files = list_tif_files(config.dente_dir)
    common = sorted(set(edente_files) & set(dente_files))
    if not common:
        raise FileNotFoundError(
            "No matching TIFF files found in both edente and dente directories."
        )

    dente_offsets = pixel_offsets_mm(config.dente_heights_mm, config.pixel_size_mm)
    attributes_edente: dict[str, dict[str, int]] = {}
    attributes_dente: dict[str, dict[str, int]] = {}
    skipped = []
    for stem in common:
        try:
            ed_mask = load_binary_mask(edente_files[stem])
            de_mask = load_binary_mask(dente_files[stem])
            x0, y0, width, height = compute_bbox(ed_mask)
            bbox_height, widths_e = compute_edente_widths(
                ed_mask, x0, y0, width, height, config.edente_width_samples
            )
            attributes_edente[edente_files[stem].name] = {
                "height_0": int(bbox_height),
                **{f"width_{i}": int(v) for i, v in enumerate(widths_e)},
            }
            mask_h = de_mask.shape[0]
            rows = [max(0, min(mask_h - 1, mask_h - 1 - off)) for off in dente_offsets]
            widths_d = [compute_dente_width(de_mask, r) for r in rows]
            attributes_dente[dente_files[stem].name] = {
                "height_0": int(bbox_height),
                **{f"width_{i}": int(v) for i, v in enumerate(widths_d)},
            }
        except (FileNotFoundError, ValueError) as exc:
            skipped.append((stem, str(exc)))
            print(f"Skipping {stem}: {exc}")
    if skipped:
        print(f"Skipped {len(skipped)} pairs due to errors.")
    return attributes_edente, attributes_dente


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Compute edente/dente mask attributes.")
    parser.add_argument("--edente-dir", type=Path, default=Path("./data/edente"))
    parser.add_argument("--dente-dir", type=Path, default=Path("./data/dente"))
    parser.add_argument("--output-edente", type=Path,
                        default=Path("./data/metrics/attributes_edente.json"))
    parser.add_argument("--output-dente", type=Path,
                        default=Path("./data/metrics/attributes_dente.json"))
    parser.add_argument("--pixel-size-mm", type=float, default=0.15)
    parser.add_argument("--dente-heights-mm", type=float, nargs="+",
                        default=(5.0, 10.0, 14.0, 18.0, 22.0))
    parser.add_argument("--edente-width-samples", type=int, default=5)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    config = MetricConfig(
        edente_dir=args.edente_dir.expanduser().resolve(),
        dente_dir=args.dente_dir.expanduser().resolve(),
        output_edente=args.output_edente.expanduser().resolve(),
        output_dente=args.output_dente.expanduser().resolve(),
        pixel_size_mm=float(args.pixel_size_mm),
        dente_heights_mm=tuple(float(v) for v in args.dente_heights_mm),
        edente_width_samples=int(args.edente_width_samples),
    )
    attributes_edente, attributes_dente = process_dataset(config)
    config.output_edente.write_text(json.dumps(attributes_edente, indent=4), encoding="utf-8")
    config.output_dente.write_text(json.dumps(attributes_dente, indent=4), encoding="utf-8")
    summary = {
        "config": {k: str(v) if isinstance(v, Path) else v for k, v in asdict(config).items()},
        "generated": [str(config.output_edente), str(config.output_dente)],
        "edente_entries": len(attributes_edente),
        "dente_entries": len(attributes_dente),
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
