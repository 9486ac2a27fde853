"""Run one benchmark cell of the PyTorch port on this machine's card(s).

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Everything a cell is comes from data found by
name: the cell in ``BENCHMARK.json``, its configuration
``benchmark/configs/<config>.json``, its traffic ``benchmark/traffic/<traffic>.json``
(which names the entry ``benchmark/entries/<entry>.py``), the limits of its
comparison ``benchmark/limits/<workload>.json`` and one reader per per-layer
metric ``benchmark/metrics/<metric>.py``.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones (from a device trace of the window).
The last line of standard output is the result; the numbers that decided
``correct`` end standard error, each beside its limit. A run with no CUDA
card, or fewer than the cell asks for, fails without a result; so does one
that finds the JAX stack or the JAX package loaded. ``--control`` (a
comma-separated list of ``fp8``, ``half_batch``, ``altered``) adds, for the
readings behind the limits, the same numbers with the reference put in the
program's place in float8 or with a fault planted.
"""

from __future__ import annotations

import time

_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default="")
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def cell_metrics(manifest: dict, cell: str, group: str) -> list[dict]:
    """The metrics of ``group`` that ``cell`` reports: those listing it, and
    those with no list, where the cell reports the end-to-end metric they move."""
    e2e = {m["name"] for m in manifest["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in manifest[group]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def fixed_caches(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / sub)
    os.environ["PTI_LPIPS_WEIGHTS"] = "none"  # LPIPS features are the benchmark's own


def main(argv=None, *, device: str = "cuda") -> int:
    """``device`` other than ``cuda`` is for the harness's own CPU tests."""
    args = parse_args(argv)
    root = Path.cwd()
    manifest = load_json(root / "BENCHMARK.json")
    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    fixed_caches(root)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3

    from .harness import Run, breakdown, busy_s, foreign_modules

    bench = root / "benchmark"
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    scratch = Path(tempfile.mkdtemp(prefix="pti-bench-"))
    try:
        run = Run(config=load_json(bench / "configs" / f"{cell['config']}.json"),
                  traffic=traffic, limits=load_json(bench / "limits" / f"{cell['name']}.json"),
                  seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device(device), scratch=scratch,
                  control=[c for c in args.control.split(",") if c])
        entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}").make(run)
        run.notes.append(f"setup s: process to entry {time.perf_counter() - _PROCESS_START:.2f}")
        entry.setup()
        setup_s = time.perf_counter() - _PROCESS_START
        entry.window()
        found = foreign_modules()
        if found:
            print(f"the run loaded {', '.join(found)}: the port must not", file=sys.stderr)
            return 4
        metrics: dict[str, dict] = {}
        result: dict = {}
        if run.trace:
            entry.work()
            run.counts["busy_s"] = busy_s(run)
            for m in cell_metrics(manifest, cell["name"], "per_layer"):
                reader = load_module(bench / "metrics" / f"{m['name']}.py",
                                     "metric_" + m["name"].replace(".", "_"))
                value = reader.read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["breakdown"] = breakdown(run, traffic.get("busy_label", "step"))
        else:
            run.end_to_end["setup_s"] = setup_s
            for m in cell_metrics(manifest, cell["name"], "end_to_end"):
                metrics[m["name"]] = {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
        entry.check()
        from .check import verdict

        correct = verdict(run.checks)
        attempted, failed = entry.attempted()
        dev = {"platform": "gpu" if run.cuda else device, "count": int(cell["chips"]),
               "kind": torch.cuda.get_device_name(0) if run.cuda else device,
               "memory_peak_bytes": run.peak_bytes, "power_limit": card_limit() if run.cuda else ""}
        if run.trace:
            dev.update(busy_s=run.counts["busy_s"], window_s=run.window_s)
        found = foreign_modules()
        if found:
            print(f"the run loaded {', '.join(found)}: the port must not", file=sys.stderr)
            return 4
        out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
               "device": dev, **result}
        if run.controls:
            out["controls"] = run.controls
        out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
        run.notes.append("counts " + json.dumps(run.counts))
        for note in run.notes:
            print("note " + note, file=sys.stderr)
        for variant, numbers in run.controls.items():
            print("control " + variant + " " + " ".join(f"{k} {v:.6g}" for k, v in numbers.items()),
                  file=sys.stderr)
        for name, (value, limit) in run.checks.items():
            print(f"check {name} {value:.6g} limit {limit:.6g}", file=sys.stderr)
        sys.stdout.flush()
        print(json.dumps(out))
        return 0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
