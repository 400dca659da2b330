"""Prefetch and the file stream, for corpora larger than the card's memory
(port of the JAX package's ``data/prefetch.py``).

The resident case needs none of this: :class:`~crowdmod_tpu_torch.data.
windows.WindowDataset` keeps the raw tensor on the card and gathers batches
there.  This module covers streaming:

  * :func:`device_prefetch` — double buffering: a thread copies ``depth``
    batches ahead from pinned host memory on a side CUDA stream, so the
    host→card copy of batch k+1 overlaps the compute of batch k;
  * :class:`FileWindowStream` — an epoch over a list of pickle files that
    never holds more than two files in host memory (a loader thread reads
    file k+1 while file k trains), its batches gathered on the host and
    prefetched onto the card;
  * :func:`host_shard` — the deterministic round-robin file split of a
    multi-process run, for a caller whose processes each read only their own
    files.  No path of the port calls it yet: under a process group every
    process streams every file and the trainer cuts its rows of each global
    batch, so a W-process run equals the one-process run.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from crowdmod_tpu_torch.parallel import multiprocess

_SENTINEL = object()


def _resolve(device) -> torch.device:
    from crowdmod_tpu_torch.train.trainer import resolve_device

    return resolve_device(device)


def device_prefetch(batches: Iterable, *, depth: int = 2, device="cuda",
                    rank_rows: bool | None = None) -> Iterator:
    """Yield the batches of ``batches`` (tensors or arrays in nested tuples,
    lists or dicts) on ``device``, copied ``depth`` ahead by a thread.

    On the card each host tensor is pinned (a property of the target: the
    CPU never pins) and copied with ``non_blocking`` on a side stream; the
    consumer's stream waits for that batch's copies (an event recorded on
    the side stream after them), and each tensor is recorded on the
    consumer's stream so the allocator does not reuse it while the consumer
    still reads it.  ``rank_rows`` (default: inside a process group) yields
    this process's rows of each batch
    (:func:`~crowdmod_tpu_torch.parallel.multiprocess.global_batch`), cut
    on the host before the copy.  An error in the source reaches the
    consumer; a consumer that stops early releases the thread.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    device = _resolve(device)
    if rank_rows is None:
        rank_rows = multiprocess.process_count() > 1
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device=device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        # Bounded put, so an abandoned consumer (break, exception, close)
        # releases the worker instead of leaving it blocked forever with
        # depth + 1 batches on the card.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def copy(x):
        t = torch.as_tensor(x)
        if cuda and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    def worker():
        source = iter(batches)
        try:
            with (torch.cuda.device(device) if cuda else contextlib.nullcontext()), \
                    (torch.cuda.stream(side) if cuda else contextlib.nullcontext()):
                for batch in source:
                    if stop.is_set():
                        return
                    if rank_rows:
                        batch = multiprocess.global_batch(batch)
                    batch = multiprocess._tree_map(copy, batch)
                    ready = None
                    if cuda:
                        ready = torch.cuda.Event()
                        ready.record(side)
                    if not _put((batch, ready)):
                        return
        except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
            _put(e)
            return
        finally:
            close = getattr(source, "close", None)
            if close is not None:
                close()
        _put(_SENTINEL)

    threading.Thread(target=worker, daemon=True, name="crowdmod-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if cuda:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                multiprocess._tree_map(lambda t: t.record_stream(consumer), batch)
            yield batch
    finally:
        stop.set()
        while not q.empty():  # drop buffered batches so the card frees them
            try:
                q.get_nowait()
            except queue.Empty:
                break


def host_shard(files: Sequence, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """Round-robin slice of ``files`` owned by this process; deterministic
    in file order, so every process agrees without communication.
    Defaults to the process group's rank and size (everything, alone)."""
    if process_index is None:
        process_index = multiprocess.process_index()
    if process_count is None:
        process_count = multiprocess.process_count()
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} out of range [0, {process_count})"
        )
    return [f for i, f in enumerate(files) if i % process_count == process_index]


class FileWindowStream:
    """Stream (past, future) batches across pickle files, one file resident
    (two while the next loads).

    For corpora too large for the card (the full ATC year is ~41 files),
    the epoch loops over files; file k+1 loads on a thread while file k
    trains.  Windows and batches within a file are :class:`WindowDataset`'s
    (gathered on the host here), shuffled within the file by
    ``default_rng(seed + file_i)``: the batches of a resident dataset of
    each file, in the same order.  Files are reference-layout ``(N, C, H, W,
    L)`` pickles, transposed on load; ``mprops_count`` slices channels.
    ``batches`` yields global batches on ``device`` through
    :func:`device_prefetch` (a trainer under a process group takes its rows
    itself), with a dataset's signature: :meth:`Trainer.fit` takes a stream
    as its training set.
    """

    def __init__(self, files: Sequence[str], *, past_len: int, future_len: int,
                 stride: int, mprops_count: int = 3, velocity_norm: bool = False,
                 stats=None, device="cuda"):
        if not files:
            raise ValueError("FileWindowStream needs at least one file")
        self.files = list(files)
        self.past_len = past_len
        self.future_len = future_len
        self.stride = stride
        self.mprops_count = mprops_count
        self.velocity_norm = velocity_norm
        self.stats = stats
        self.device = _resolve(device)

    def compute_stats(self) -> np.ndarray:
        """The corpus's per-channel ``(mean, std, min, max)`` in one pass,
        one file at a time: min and max combine exactly across files, mean
        and std come from streamed count, sum and sum-of-squares moments."""
        count = 0
        s = s2 = lo = hi = None
        for path in self.files:
            arr = self._load_host(path).astype(np.float64)
            ax = tuple(range(arr.ndim - 1))
            if s is None:
                c = arr.shape[-1]
                s, s2 = np.zeros(c), np.zeros(c)
                lo, hi = np.full(c, np.inf), np.full(c, -np.inf)
            count += int(np.prod(arr.shape[:-1]))
            s += arr.sum(axis=ax)
            s2 += (arr * arr).sum(axis=ax)
            lo = np.minimum(lo, arr.min(axis=ax))
            hi = np.maximum(hi, arr.max(axis=ax))
        mean = s / count
        std = np.sqrt(np.maximum(s2 / count - mean * mean, 0.0))
        return np.stack([mean, std, lo, hi], axis=1)

    def _load_host(self, path: str) -> np.ndarray:
        """One pickle → its native ``(N, L, H, W, C)`` host array."""
        from crowdmod_tpu_torch.data.ingest import load_pickle_native

        return load_pickle_native(path, self.mprops_count)

    def _files_ahead(self) -> Iterator[np.ndarray]:
        """The files' host arrays with one file of read-ahead.  The loader
        takes its queue slot BEFORE it reads the next file: otherwise it
        would read file k+2 and block on the put while the consumer holds
        file k and the queue holds k+1, three files resident."""
        q: queue.Queue = queue.Queue(maxsize=1)
        slot = threading.Semaphore(1)
        stop = threading.Event()

        def _acquire_slot() -> bool:
            while not stop.is_set():
                if slot.acquire(timeout=0.2):
                    return True
            return False

        def loader():
            try:
                for path in self.files:
                    # The slot doubles as the abandonment check: a closed
                    # consumer sets stop and releases the loader.
                    if not _acquire_slot() or stop.is_set():
                        return
                    q.put(self._load_host(path))
            except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
                q.put(e)
                return
            if _acquire_slot():
                q.put(_SENTINEL)

        threading.Thread(target=loader, daemon=True, name="crowdmod-file-loader").start()
        try:
            while True:
                item = q.get()
                slot.release()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # free the buffered file promptly
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def _host_batches(self, batch_size: int, shuffle: bool, seed: int) -> Iterator:
        from crowdmod_tpu_torch.data.ingest import normalize_velocity
        from crowdmod_tpu_torch.data.windows import WindowDataset

        for file_i, host_arr in enumerate(self._files_ahead()):
            if self.velocity_norm:
                host_arr = normalize_velocity(host_arr, self.stats)
            ds = WindowDataset(torch.from_numpy(host_arr), past_len=self.past_len,
                               future_len=self.future_len, stride=self.stride)
            order = np.arange(len(ds))
            if shuffle:
                np.random.default_rng(seed + file_i).shuffle(order)
            for b in range(len(order) // batch_size):
                yield ds.gather(order[b * batch_size:(b + 1) * batch_size])

    def batches(self, batch_size: int, *, shuffle: bool = True, seed: int = 0) -> Iterator:
        """One epoch: (past, future) batches on the stream's device over all
        files, full batches only (shuffled within each file: a shuffle
        across files would defeat streaming; split files across processes
        with :func:`host_shard`)."""
        if self.velocity_norm and self.stats is None:
            # One extra pass over the corpus; kept for later epochs.
            self.stats = self.compute_stats()
        return device_prefetch(self._host_batches(batch_size, shuffle, seed),
                               device=self.device, rank_rows=False)
