"""The numbers that decide ``correct``: each is a gap between what the
program's timed path produced and what the plain reference computes from
the same inputs, held to the cell's limit (``benchmark/limits/<cell>.json``).

* ``loader_gap``: every row the program's loader delivered for a compared
  step, against the reference's preprocessing of the raw image it came from
  (found by its content), largest absolute difference; attributes too.
  A row that matches no image, or two rows of one batch that are one image,
  read as infinite.
* ``loss_gap``: each compared step's objective (and discriminator loss),
  relative to the reference's.
* ``grad_gap`` / ``change_gap``: per parameter tensor ("leaf"), the gap
  between the norm of the program's and of the reference's first gradient
  (or parameter change after the compared steps), relative to the larger of
  the reference leaf's norm and the median leaf's; leaves whose reference
  gradient is under a thousandth of the median leaf's move by round-off
  alone and are left out of ``change_gap``.
* ``metric_gap``: per-sample image metrics, each relative to the larger of
  its reference value and the batch's median.
"""

from __future__ import annotations

import math
import statistics

import torch
import torch.nn.functional as F

ROUNDOFF_SHARE = 1e-3


def _features(images: torch.Tensor) -> torch.Tensor:
    """[N, h, w, 1] -> [N, 64]: 8x8 block means, a fingerprint of each image."""
    return F.adaptive_avg_pool2d(images[..., 0][:, None].float(), (8, 8)).flatten(1)


def identify(rows: torch.Tensor, reference: torch.Tensor) -> tuple[torch.Tensor, float]:
    """For each program row the index of the reference image it is, and the
    largest absolute difference between the two."""
    idx = torch.cdist(_features(rows), _features(reference)).argmin(dim=1)
    gap = float((rows - reference[idx]).abs().max()) if rows.numel() else 0.0
    return idx, gap


def rel(p: float, r: float) -> float:
    return abs(p - r) / abs(r) if r != 0 else (0.0 if p == 0 else math.inf)


def leaf_gap(prog: dict[str, float], ref: dict[str, float], keep: set[str] | None = None) -> float:
    """The worst leaf's gap between two norms, relative to the larger of the
    reference leaf's norm and the median leaf's (a leaf the program lacks: inf)."""
    names = [k for k in ref if keep is None or k in keep]
    median = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) if k in prog else math.inf
               for k in names)


def worst_leaves(prog: dict[str, float], ref: dict[str, float], keep: set[str] | None = None,
                 n: int = 2) -> str:
    """The leaves behind :func:`leaf_gap`, worst first: ``name program/reference``."""
    names = [k for k in ref if (keep is None or k in keep) and k in prog]
    median = statistics.median(ref[k] for k in names)
    names.sort(key=lambda k: -abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30))
    return " ".join(f"{k} {prog[k]:.4g}/{ref[k]:.4g}" for k in names[:n]) + f" median {median:.4g}"


def moved_leaves(ref_grad: dict[str, float]) -> set[str]:
    """Leaves whose reference gradient is not nought to rounding."""
    median = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= ROUNDOFF_SHARE * median}


def sample_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-sample gaps, each relative to the larger of its reference value and
    the batch's median."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    scale = torch.maximum(ref.abs(), ref.abs().median()).clamp_min(1e-30)
    return (prog - ref).abs() / scale


def bf16_loader_gap(rows: torch.Tensor) -> float:
    """The loader's control: the reference's own rows in bfloat16, the type
    below the float32 the loaders deliver."""
    return float((rows.bfloat16().float() - rows).abs().max())


def verdict(checks: dict[str, tuple[float, float]]) -> bool:
    """Every number at or under its limit (NaN fails)."""
    return all(value <= limit for value, limit in checks.values())


def record(run, numbers: dict[str, float]) -> None:
    """Hold every number that the cell's limits name to its limit; note the
    others' readings (the limits file names the numbers a cell compares)."""
    run.checks = {k: (v, float(run.limits[k])) for k, v in numbers.items() if k in run.limits}
    missing = set(run.limits) - set(numbers)
    if missing:
        raise KeyError(f"the run computed no {sorted(missing)}")
    run.notes += [f"reading {k} {v:.6g}" for k, v in numbers.items()]
