"""Step timing, traces and finite checks (``uwudiff_tpu/training/profiling.py``).

``StepTimer`` gives the JAX package's metric names (``perf/step_time_ms``,
``perf/steps_per_sec``) from the host clock between ticks; ``trace_steps``
records a ``torch.profiler`` trace (CPU and, on a GPU, CUDA activity) and
writes it as a Chrome trace (``start_trace``/``stop_trace`` around
``fit``'s ``profile_steps``); ``check_finite`` is a 0-dim bool tensor.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["StepTimer", "trace_steps", "start_trace", "stop_trace", "check_finite"]


class StepTimer:
    """Rolling wall-clock step timing -> metrics dict entries."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self) -> dict[str, float]:
        now = time.perf_counter()
        out: dict[str, float] = {}
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
            out["perf/step_time_ms"] = dt * 1000.0
            out["perf/steps_per_sec"] = 1.0 / (sum(self._times) / len(self._times))
        self._last = now
        return out


def start_trace(log_dir: str) -> torch.profiler.profile:
    """A started ``torch.profiler`` session; :func:`stop_trace` ends it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str) -> str:
    """Wait for the device, stop ``prof`` and write its Chrome trace into
    ``log_dir``; returns the file's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace_steps(log_dir: str):
    """A ``torch.profiler`` trace of the block, written into ``log_dir``
    (open it in Perfetto or chrome://tracing)."""
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)


def check_finite(tensors, name: str = "tree") -> torch.Tensor:
    """A 0-dim bool tensor: every element of ``tensors`` (a tensor, or a
    dict or sequence of them) is finite. ``name`` is kept for the JAX
    function's signature."""
    del name
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    elif isinstance(tensors, dict):
        tensors = list(tensors.values())
    finite = torch.tensor(True)
    for t in tensors:
        finite = finite.to(t.device) & torch.isfinite(t).all()
    return finite
