"""The reductions behind the per-layer metrics, shared by their readers
(``benchmark/metrics/<name>.py``). Each returns a number, or None where the
run holds nothing to read (then the metric is left out of the line)."""

from __future__ import annotations

from .kernels import device_s, kind
from .peaks import PEAK_FLOP_PER_S


def span_share(run, label: str) -> float:
    """Percent of the window the host spent in spans of ``label``."""
    w0, w1 = run.window_ns
    inside = sum(min(b, w1) - max(a, w0) for name, a, b in run.spans
                 if name == label and b > w0 and a < w1)
    return 100.0 * inside / (w1 - w0)


def mfu(run) -> float | None:
    """Model FLOPs of the window's steps over its seconds, percent of the
    card's dense peak for the configuration's compute type."""
    flops = run.work.get("flops")
    if not flops:
        return None
    return 100.0 * flops / run.window_s / PEAK_FLOP_PER_S[run.config["precision"]]


def glue_share(run) -> float | None:
    """Percent of device time in operations that are neither the port's
    hand-written kernels nor cuDNN's / cuBLAS'."""
    total = sum(end - start for _, start, end in run.kernels)
    if not total:
        return None
    glue = sum(end - start for name, start, end in run.kernels if kind(name) == "glue")
    return 100.0 * glue / total


def roofline(run, words: tuple[str, ...], bound_key: str) -> float | None:
    """Percent: the least time the calls of a kernel family could take (from
    the reference's shapes) over the device time of the kernels named by ``words``."""
    seconds, bound = device_s(run.kernels, *words), run.work.get(bound_key)
    if not seconds or not bound:
        return None
    return 100.0 * bound / seconds


def idle_share(run) -> float:
    return 100.0 * (1.0 - run.counts["busy_s"] / run.window_s)


def peak_gb(run) -> float | None:
    return run.peak_window_bytes / 1e9 if run.cuda else None
