"""Tracing and step timing (counterpart of ``pti_ldm_vae_tpu/utils/profiling.py``).

Usage::

    with trace_if(run_dir / "traces", enabled=step == 20):
        train_step(...)

    timer = StepTimer()
    ...
    timer.tick()   # per-step wall clock; .summary() for p50/p90/mean

``trace_if`` runs ``torch.profiler`` over the block (CPU activity, and CUDA
activity when a card is in use) and writes a Chrome trace that TensorBoard's
profiler plugin reads (``tensorboard_trace_handler``) into ``log_dir``: the
kernels of the block appear there by name. ``start_profiler_server`` has no
counterpart: torch has no live profiler endpoint to attach to.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["start_profiler_server", "trace_if", "StepTimer"]


def start_profiler_server(port: int = 9999) -> None:
    """Not available in the port: raises ``NotImplementedError``."""
    raise NotImplementedError(
        f"--profile-port {port} is not ported: torch has no live profiler endpoint to attach "
        "to (the JAX package starts jax.profiler's server); capture a trace of one step "
        "with --trace-at-step N instead")


@contextlib.contextmanager
def trace_if(log_dir: str | os.PathLike, *, enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` when ``enabled``; CUDA activity is traced when CUDA is
    initialized in this process. The caller synchronizes the device inside the
    block, so that its kernels end within the trace."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


class StepTimer:
    """Wall-clock step timing with percentile summary."""

    def __init__(self):
        self._times: list[float] = []
        self._last = time.perf_counter()

    def reset(self) -> None:
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._times.append(dt)
        return dt

    def summary(self) -> dict[str, float]:
        if not self._times:
            return {}
        arr = np.asarray(self._times)
        return {
            "steps": int(arr.size),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "max_s": float(arr.max()),
        }
