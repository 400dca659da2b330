"""Profiling and timing hooks (port of the JAX package's
``utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace of the host and the card
while its context runs and writes it as a Chrome trace (Perfetto,
``chrome://tracing``); :func:`measure_round_trip` is the mean time of a
trivial op on the card and its read back to the host (the host's share of
any small request); :class:`StepTimer` gives wall-clock step statistics,
synchronising only the device of the tensor it is handed, so queued work
on the card is not serialised by accident.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, *, enabled: bool = True):
    """Record a ``torch.profiler`` trace (CPU, and CUDA where available)
    while the context runs and write it as ``log_dir/trace.json``.  Yields
    the profiler (None when not ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def measure_round_trip(iters: int = 5, device="cuda") -> float:
    """Mean seconds of a trivial op on ``device`` read back to the host
    (``.item()``), after one warm-up: the fixed cost a timing harness
    subtracts from a small request's time."""
    y = torch.zeros(8, device=device)
    y = y + 1.0
    y[0].item()  # warm: allocator, first launch and transfer
    t0 = time.perf_counter()
    for _ in range(iters):
        y = y + 1.0
        y[0].item()
    return (time.perf_counter() - t0) / iters


def _devices(tree) -> set:
    """The CUDA devices of the tensors in a tensor, list, tuple or dict."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_devices(t) for t in tree)) if tree else set()
    return set()


class StepTimer:
    """Wall-clock per-step timing with a percentile summary."""

    def __init__(self):
        self.times: list[float] = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self, block_on=None):
        """End the step; with ``block_on`` (a tensor, or a list, tuple or
        dict of them) first wait for the work queued on its CUDA devices."""
        for device in _devices(block_on):
            torch.cuda.synchronize(device)
        self.times.append(time.perf_counter() - self._last)

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "total_s": float(arr.sum()),
        }
