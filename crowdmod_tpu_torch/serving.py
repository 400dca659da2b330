"""Inference serving: checkpoint → warmed predictor on the card (port of the
JAX package's ``serving.py``: ``Predictor``, ``load_predictor`` and
``BatchingQueue``).

  * **Static shape buckets** — requests are padded up to the nearest
    registered batch size, so the card only ever sees those shapes;
    ``warmup()`` runs each bucket once (which also builds the kernels).
  * **Explicit randomness** — a request either carries a ``seed`` (the
    draws ``normal(seed, step)`` that an exported artifact makes, so the
    output is deterministic and equals ``serve --artifact``'s, as both paths
    of the JAX package sample from ``PRNGKey(seed)``) or draws from the
    predictor's device generator, seeded once from ``seed`` and advanced by
    every keyless request, as the JAX package splits its key per request.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, TimeoutError as FuturesTimeoutError
from dataclasses import dataclass

from typing import TYPE_CHECKING

import numpy as np
import torch

from crowdmod_tpu_torch.ops.kernels.library import seeded_noise

if TYPE_CHECKING:  # a served artifact loads no config module
    from crowdmod_tpu_torch.config import FrozenConfig


@dataclass
class PredictorStats:
    requests: int = 0
    samples: int = 0
    total_latency_s: float = 0.0

    def record(self, n: int, dt: float):
        self.requests += 1
        self.samples += n
        self.total_latency_s += dt


BATCH_BUCKETS = (1, 8, 64, 256)  # the batch sizes a predictor compiles for


class Predictor:
    """Serves ``predict(past) -> future`` for a trained model.

    Wraps a :class:`~crowdmod_tpu_torch.train.trainer.Trainer` in
    inference-only mode: loads the checkpoint and pads incoming requests to
    the batch buckets.
    """

    def __init__(
        self,
        cfg: FrozenConfig,
        arch: str,
        checkpoint_path: str,
        *,
        device="cuda",
        batch_buckets: tuple[int, ...] = BATCH_BUCKETS,
        seed: int = 0,
    ):
        from crowdmod_tpu_torch.train.trainer import Trainer

        self.cfg = cfg
        self.arch = arch
        self.batch_buckets = tuple(sorted(set(batch_buckets)))
        self._trainer = Trainer(cfg, arch, device=device, seed=seed)
        self._trainer.load(checkpoint_path)
        self.device = self._trainer.device
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = PredictorStats()
        self._lock = threading.Lock()
        p, f, h, w = self._trainer._grid_shapes()
        self._shape = (p, f, h, w, self._trainer.mprops_count)

    @property
    def input_spec(self) -> tuple[int, int, int, int, int]:
        """Per-request input geometry ``(past_len, future_len, H, W, C)`` —
        a request's ``past`` is ``(N, past_len, H, W, C)``."""
        return self._shape

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"request batch {n} exceeds largest bucket "
            f"{self.batch_buckets[-1]}"
        )

    def warmup(self):
        """Run every bucket once ahead of traffic (builds the kernels)."""
        p, f, h, w, c = self._shape
        for b in self.batch_buckets:
            past = np.zeros((b, p, h, w, c), np.float32)
            self.predict(past, seed=0)
            logging.info("warmed bucket %d", b)
        return self

    def predict(self, past, seed: int | None = None) -> np.ndarray:
        """``(N, P, H, W, C)`` past → ``(N, F, H, W, C)`` future.

        N is padded to the nearest bucket; padding rows are dropped from the
        output.  Thread-safe: concurrent callers are serialized (the lock
        guards the generator and the bound weights).
        """
        past = np.asarray(past, np.float32)
        n = past.shape[0]
        bucket = self._bucket(n)
        if bucket != n:
            pad = np.zeros((bucket - n,) + past.shape[1:], np.float32)
            past = np.concatenate([past, pad])
        with self._lock:
            t0 = time.perf_counter()
            if seed is None:
                out = self._trainer.sample(past, self._generator)
            else:
                p, f, h, w, c = self._shape
                out = self._trainer.sample(
                    past, noise=seeded_noise(seed, (bucket, f, h, w, c), self.device))
            out = out[:n].cpu().numpy()
            self.stats.record(n, time.perf_counter() - t0)
        return out

    @property
    def mean_latency_ms(self) -> float:
        s = self.stats
        return 1e3 * s.total_latency_s / s.requests if s.requests else 0.0


def load_predictor(
    config_yml: str,
    arch: str,
    *,
    datafiles_yml: str | None = None,
    epoch_tag: str | int = "000",
    data_parallel: bool = False,
    **kwargs,
) -> Predictor:
    """Convenience constructor from config paths + checkpoint tag; keywords
    ``device``, ``batch_buckets`` and ``seed`` go to :class:`Predictor`.
    ``data_parallel`` (one request batch sharded over the cards) is not
    ported yet and raises."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.train import checkpoint as ckpt

    if data_parallel:
        raise NotImplementedError(
            "data_parallel serving is not ported to PyTorch yet: ROADMAP.md "
            "Queue 1 item 16 (the parallel paths)"
        )

    cfg = load_config(config_yml, datafiles_yml)
    path = os.path.join(
        cfg.DATA_FS.SAVE_DIR, ckpt.checkpoint_name(cfg, arch, epoch_tag)
    )
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"no checkpoint for {arch} at {path!r} — save one first or pass "
            "a different epoch_tag"
        )
    return Predictor(cfg, arch, path, **kwargs)


# ---------------------------------------------------------------------------
# Request coalescing
# ---------------------------------------------------------------------------

class _Request:
    __slots__ = ("past", "seed", "future", "n")

    def __init__(self, past: np.ndarray, seed: int | None):
        self.past = past
        self.seed = seed
        self.future: Future = Future()
        self.n = past.shape[0]


class BatchingQueue:
    """Micro-batching front end for a :class:`Predictor`.

    Concurrent callers ``submit()`` requests; one dispatcher thread coalesces
    seedless requests that arrive within ``max_delay_ms`` of each other into
    one dispatch (up to the predictor's largest bucket), then scatters the
    rows back to each caller's future.  Seeded requests are dispatched alone
    so their output stays deterministic whatever else is in flight.
    """

    def __init__(self, predictor: Predictor, *, max_delay_ms: float = 5.0,
                 max_queue: int = 4096):
        self.predictor = predictor
        self.max_delay_s = max_delay_ms / 1e3
        self.max_queue = max_queue
        self.dispatches = 0
        self.coalesced_requests = 0
        self._pending: deque[_Request] = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="crowdmod-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, past, seed: int | None = None) -> Future:
        """Enqueue one request; resolves to the ``(N, F, H, W, C)`` future
        frames.  Raises if the queue is closed or full."""
        past = np.asarray(past, np.float32)
        if past.ndim != 5:
            raise ValueError(f"expected (N, P, H, W, C) past, got {past.shape}")
        # Oversized requests fail fast with the predictor's bucket error.
        self.predictor._bucket(past.shape[0])
        req = _Request(past, seed)
        with self._cv:
            if self._closed:
                raise RuntimeError("BatchingQueue is closed")
            if len(self._pending) >= self.max_queue:
                raise RuntimeError("BatchingQueue is full")
            self._pending.append(req)
            self._cv.notify()
        return req.future

    def predict(self, past, seed: int | None = None,
                timeout: float | None = None):
        """Blocking wrapper around :meth:`submit`; a request that exceeds
        ``timeout`` is cancelled and leaves the queue."""
        fut = self.submit(past, seed)
        try:
            return fut.result(timeout)
        except (TimeoutError, FuturesTimeoutError):
            self.cancel(fut)
            raise

    def cancel(self, future: Future) -> bool:
        """Best-effort cancel: drop the request if it hasn't dispatched yet."""
        with self._cv:
            for i, req in enumerate(self._pending):
                if req.future is future:
                    del self._pending[i]
                    break
        return future.cancel()

    @property
    def depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def close(self, timeout: float = 10.0):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        with self._cv:
            while self._pending:
                req = self._pending.popleft()
                req.future.set_exception(RuntimeError("queue closed"))

    def _take_batch(self) -> list[_Request]:
        """Block for the next request, then coalesce seedless followers."""
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait()
            if not self._pending:
                return []
            head = self._pending.popleft()
        if head.seed is not None:
            return [head]
        cap = self.predictor.batch_buckets[-1]
        batch, rows = [head], head.n
        deadline = time.perf_counter() + self.max_delay_s
        with self._cv:
            while rows < cap:
                if not self._pending:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._closed:
                        break
                    self._cv.wait(remaining)
                    continue
                nxt = self._pending[0]
                if nxt.seed is not None or rows + nxt.n > cap:
                    break
                self._pending.popleft()
                batch.append(nxt)
                rows += nxt.n
        return batch

    def _dispatch_loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return  # closed and drained
            batch = [r for r in batch if r.future.set_running_or_notify_cancel()]
            if not batch:
                continue
            try:
                if len(batch) == 1:
                    out = self.predictor.predict(batch[0].past, batch[0].seed)
                    batch[0].future.set_result(out)
                else:
                    past = np.concatenate([r.past for r in batch])
                    out = self.predictor.predict(past)
                    off = 0
                    for r in batch:
                        r.future.set_result(out[off:off + r.n])
                        off += r.n
                    self.coalesced_requests += len(batch)
                self.dispatches += 1
            except Exception as e:  # surfaced to the callers via their futures
                logging.exception("BatchingQueue dispatch failed")
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
