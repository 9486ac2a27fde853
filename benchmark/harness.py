"""The parts of a run that every entry shares: the run's record, the measured
window (and the device trace of a traced run), the benchmark's own host spans,
and the reduction of the trace into busy time, idle gaps and the heaviest
device operations.

Times: the host clock is ``time.perf_counter_ns`` for durations, shifted
onto the wall clock (``time.time_ns``) that ``torch.profiler`` stamps its
device events with, so a span and a kernel can be set side by side.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch

# packages the port must not load: the JAX stack and the JAX package (whole top-level names)
FOREIGN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "pti_ldm_vae_tpu"})
_WALL_OFFSET = time.time_ns() - time.perf_counter_ns()


def now_ns() -> int:
    """The wall clock in ns, read through the monotonic counter."""
    return time.perf_counter_ns() + _WALL_OFFSET


def foreign_modules(modules: dict[str, Any] | None = None) -> list[str]:
    """The forbidden top-level packages present in ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FOREIGN)


@dataclass
class Run:
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    scratch: Path
    control: list[str] = field(default_factory=list)
    spans: list[tuple[str, int, int]] = field(default_factory=list)
    counts: dict[str, float] = field(default_factory=dict)
    end_to_end: dict[str, float] = field(default_factory=dict)
    checks: dict[str, tuple[float, float]] = field(default_factory=dict)
    controls: dict[str, dict[str, float]] = field(default_factory=dict)
    notes: list[str] = field(default_factory=list)  # what the comparison saw, for standard error
    window_ns: tuple[int, int] | None = None
    kernels: list[tuple[str, int, int]] = field(default_factory=list)
    peak_window_bytes: int = 0
    peak_bytes: int = 0
    work: dict[str, float] = field(default_factory=dict)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def span(self, label: str, start_ns: int) -> None:
        self.spans.append((label, start_ns, now_ns()))

    @property
    def window_s(self) -> float:
        start, end = self.window_ns
        return (end - start) / 1e9


class Window:
    """The measured window: opened after set-up, closed by the entry after a
    device sync once ``seconds`` have passed. In a traced run the profiler
    (device activity alone) starts before the window opens and stops after
    it closes, so its start-up cost stays outside."""

    def __init__(self, run: Run):
        self.run = run
        self.start_ns = 0
        self.closed = False
        self._prof = None

    def open(self) -> None:
        run = self.run
        if run.trace:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
        run.sync()
        if run.cuda:
            run.peak_bytes = torch.cuda.max_memory_allocated(run.device)
            torch.cuda.reset_peak_memory_stats(run.device)
        self.start_ns = now_ns()

    def due(self) -> bool:
        return now_ns() - self.start_ns >= self.run.seconds * 1e9

    def close(self) -> None:
        run = self.run
        run.sync()
        run.window_ns = (self.start_ns, now_ns())
        self.closed = True
        if run.cuda:
            run.peak_window_bytes = torch.cuda.max_memory_allocated(run.device)
            run.peak_bytes = max(run.peak_bytes, run.peak_window_bytes)
        if self._prof is not None:
            self._prof.stop()
            from torch.autograd import DeviceType

            run.kernels = sorted(
                (e.name(), e.start_ns(), e.end_ns())
                for e in self._prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and e.end_ns() > e.start_ns())
            self._prof = None
            if not run.kernels:
                raise RuntimeError("the profiler recorded no device operation in the window")


def busy_intervals(kernels: list[tuple[str, int, int]]) -> list[tuple[int, int]]:
    """The union of the device operations' intervals, merged, in order."""
    merged: list[list[int]] = []
    for _, start, end in sorted(kernels, key=lambda k: k[1]):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_s(run: Run) -> float:
    return sum(b - a for a, b in busy_intervals(run.kernels)) / 1e9


SPAN_ORDER = ("loader_wait", "read", "validate", "epoch_end")


def host_label(run: Run, t_ns: int, default: str) -> str:
    """What the host was doing at ``t_ns``: the first of ``SPAN_ORDER`` whose
    span covers it, else ``default`` (the step or batch itself)."""
    covering = {label for label, a, b in run.spans if a <= t_ns < b}
    return next((label for label in SPAN_ORDER if label in covering), default)


def short_name(name: str, width: int = 44) -> str:
    """A kernel's name without its common prefixes, cut to ``width``."""
    for prefix in ("void ", "(anonymous namespace)::", "at::native::", "(anonymous namespace)::"):
        name = name.removeprefix(prefix)
    return name[:width]


def breakdown(run: Run, default_label: str, top: int = 10) -> dict:
    """The device operations that took most time (by name, seconds) and the
    longest idle gaps of the window, each named by the host span that covers
    its middle and its start in seconds from the window's opening."""
    by_name: dict[str, float] = {}
    for name, start, end in run.kernels:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (end - start) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = run.window_ns
    edges = [w0] + [t for iv in busy_intervals(run.kernels) for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = [[f"{host_label(run, (a + b) // 2, default_label)}@{(a - w0) / 1e9:.3f}s", (b - a) / 1e9]
            for a, b in gaps]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
