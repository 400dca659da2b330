"""Profiling and timing hooks (port of the JAX package's
``utils/profiling.py``).

:func:`trace` records a ``torch.profiler`` trace of the host and the card
while its context runs and writes it as a Chrome trace (Perfetto,
``chrome://tracing``); :func:`measure_round_trip` is the mean time of a
trivial op on the card and its read back to the host (the host's share of
any small request); :class:`StepTimer` gives wall-clock step statistics,
synchronising only the device of the tensor it is handed, so queued work
on the card is not serialised by accident.  :func:`time_calls`,
:func:`device_seconds` and :func:`card_identity` are the timer, the busy
share reader and the card's name of the bench tools (``bench_torch.py``,
``tools/bench_*_torch.py``).
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


def card_identity() -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (the first card),
    or None where ``nvidia-smi`` is absent: a time on the card means little
    without the limit it ran under."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else None


def device_seconds(fn) -> tuple[float, float]:
    """One call of ``fn`` under ``torch.profiler``, then a synchronize →
    (the card's kernel seconds, the call's wall seconds, profiling
    included).  Only the card's activity is recorded (the host's operators
    would add their recording to a host-bound call's wall); kernel time is
    summed from the raw trace (``prof.events()`` builds an object an event:
    minutes for the ~10⁶ events of a 1000-step chain), less any ranges that
    user annotations mirror onto the card's timeline (they overlap the
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA and not e.is_user_annotation())
    return busy_ns / 1e9, wall


def time_calls(fn, *, reps: int = 3, iters: int = 1, device="cuda",
               queued: bool = False, warmup: bool = True) -> dict:
    """Time ``fn`` as the port's bench tools do.

    On the card: a warm-up call (skipped with ``warmup=False``, where the
    caller has made one), so one-time work (kernel builds, weight packs,
    the allocator's growth) sits in neither reading; then one call under
    ``torch.profiler`` gives the card's kernel seconds of a warm call; then
    ``reps`` repetitions, each ``iters`` calls back to back between two
    CUDA events recorded after a synchronize, so each repetition is the
    card's time from the first call's issue to the last call's end, host
    gaps included.  Nothing is subtracted: the card is local, so no
    dispatch round trip sits in the time (the JAX tools subtracted a remote
    TPU's).  ``queued``: each repetition first queues a spin kernel (at
    least ~5 ms, and twice the host's measured time to issue ``iters``
    calls), so the host has issued the calls before the card reaches them
    and the events time them back to back on the card (a kernel's device
    time, not the host's issue rate).  On the CPU: the warm-up call, then
    the host clock.

    → ``seconds`` (the fastest repetition's, per call), ``reps_s`` (each
    repetition's, per call), ``first_s`` (the warm-up call's wall; None
    without one), ``kernel_s`` (the profiled call's kernel seconds) and
    ``busy_share``: ``kernel_s`` over ``seconds`` — the share of a timed
    call the card was busy, from a warm call with the same work (None on
    the CPU).  A share reads at most about 1: above it the two calls did
    not do the same work.
    """
    device = torch.device(device)
    first = kernel_s = busy = None
    if warmup:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        first = time.perf_counter() - t0
    reps_s = []
    if device.type == "cuda":
        kernel_s, _ = device_seconds(fn)
        spin = 10_000_000
        if queued:  # the spin outlasts the host's issue of ``iters`` calls twice over
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            spin = max(spin, int(4e9 * (time.perf_counter() - t0)))  # cycles at ≤ 2 GHz
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            if queued:
                torch.cuda._sleep(spin)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            reps_s.append(start.elapsed_time(end) / 1e3 / iters)
        busy = kernel_s / min(reps_s)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            reps_s.append((time.perf_counter() - t0) / iters)
    return {"seconds": min(reps_s), "reps_s": reps_s, "first_s": first,
            "kernel_s": kernel_s, "busy_share": busy}


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
