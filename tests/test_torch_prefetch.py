"""The port's prefetch and file stream (``crowdmod_tpu_torch.data.prefetch``)
against the JAX package's ``data/prefetch.py`` on the CPU.

``device_prefetch`` keeps order and values, forwards a source's error and
releases its thread when the consumer stops; ``host_shard`` is JAX's for
every (index, count) up to 4; ``FileWindowStream.batches`` yields JAX's
stream's batches exactly (shuffled or not, with velocity normalization),
``compute_stats`` its statistics within 1e-12, and the loader keeps the
two-file budget.  The pinned-memory, side-stream path runs on the card only
(``chip_smoke.py`` phase 16 holds the stream there bit for bit against the
resident dataset).
"""

import pickle
import threading
import time

import numpy as np
import pytest
import torch

from crowdmod_tpu.data.prefetch import FileWindowStream as JaxFileWindowStream
from crowdmod_tpu.data.prefetch import host_shard as jax_host_shard
from crowdmod_tpu_torch.data.prefetch import FileWindowStream, device_prefetch, host_shard
from crowdmod_tpu_torch.data.windows import WindowDataset

H, W, L = 4, 6, 12


def _alive(name: str) -> int:
    return sum(t.is_alive() and t.name == name for t in threading.enumerate())


def _wait_until(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


@pytest.fixture
def files(tmp_path):
    """Three reference-layout ``(N, 4, H, W, L)`` pickles with distinct
    scales (per-file statistics would differ from the corpus's)."""
    rng = np.random.default_rng(1)
    paths = []
    for k, n in enumerate((3, 2, 4)):
        arr = (rng.normal(size=(n, 4, H, W, L)) * (k + 1)).astype(np.float32)
        path = tmp_path / f"f{k}.pkl"
        with open(path, "wb") as f:
            pickle.dump(arr, f)
        paths.append(str(path))
    return paths


def test_device_prefetch_preserves_order_and_values():
    rng = np.random.default_rng(0)
    src = [(rng.normal(size=(4, 3)).astype(np.float32),
            {"b": torch.from_numpy(rng.normal(size=(4, 2)).astype(np.float32))})
           for _ in range(7)]
    out = list(device_prefetch(iter(src), depth=2, device="cpu"))
    assert len(out) == 7
    for (a, b), (da, db) in zip(src, out):
        assert isinstance(da, torch.Tensor) and da.device.type == "cpu"
        assert np.array_equal(a, da.numpy()) and torch.equal(b["b"], db["b"])


def test_device_prefetch_propagates_source_errors():
    def bad():
        yield np.zeros(3, np.float32)
        raise RuntimeError("disk on fire")

    it = device_prefetch(bad(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(it)
    with pytest.raises(ValueError, match="depth"):
        next(device_prefetch(iter([]), depth=0, device="cpu"))


def test_device_prefetch_releases_worker_on_abandon():
    """A consumer that stops early releases the thread (and the batches it
    holds) instead of leaving it blocked on its put; the source is closed."""
    base = _alive("crowdmod-prefetch")
    closed = []

    def src():
        try:
            for _ in range(1000):
                yield np.zeros((2, 2), np.float32)
        finally:
            closed.append(True)

    it = device_prefetch(src(), depth=1, device="cpu")
    next(it)
    it.close()
    assert _wait_until(lambda: _alive("crowdmod-prefetch") <= base), \
        "prefetch worker leaked after generator close"
    assert _wait_until(lambda: closed == [True])


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_host_shard_matches_jax(count):
    files = [f"f{i}" for i in range(10)]
    shards = [host_shard(files, i, count) for i in range(count)]
    assert shards == [jax_host_shard(files, i, count) for i in range(count)]
    assert sorted(sum(shards, [])) == sorted(files)
    assert host_shard(files) == jax_host_shard(files) == files  # one process: all
    with pytest.raises(ValueError, match="out of range"):
        host_shard(files, count, count)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("velocity_norm", [False, True])
def test_stream_batches_equal_jax(files, shuffle, velocity_norm):
    """Every batch of the port's stream equals the JAX stream's, in order
    (within-file shuffles by ``default_rng(seed + file_i)``, the corpus's
    statistics for the velocity normalization); ``compute_stats`` within
    1e-12."""
    kw = dict(past_len=5, future_len=3, stride=4, mprops_count=3,
              velocity_norm=velocity_norm)
    port = FileWindowStream(files, device="cpu", **kw)
    jax_stream = JaxFileWindowStream(files, **kw)
    got = list(port.batches(2, shuffle=shuffle, seed=3))
    want = list(jax_stream.batches(2, shuffle=shuffle, seed=3))
    assert len(got) == len(want) > 3
    for (gp, gf), (wp, wf) in zip(got, want):
        assert gp.shape == (2, 5, H, W, 3) and gf.shape == (2, 3, H, W, 3)
        assert np.array_equal(gp.numpy(), np.asarray(wp))
        assert np.array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_allclose(port.compute_stats(), jax_stream.compute_stats(),
                               rtol=1e-12, atol=1e-12)
    if velocity_norm:
        np.testing.assert_allclose(port.stats, jax_stream.stats, rtol=1e-12, atol=1e-12)


def test_stream_equals_resident_dataset_per_file(files):
    """The stream's epoch is each file's resident ``WindowDataset`` epoch,
    file after file (the file's shuffle seeded ``seed + file_i``)."""
    from crowdmod_tpu_torch.data.ingest import load_pickle_native

    stream = FileWindowStream(files, past_len=5, future_len=3, stride=4, device="cpu")
    got = list(stream.batches(2, seed=7))
    want = []
    for k, path in enumerate(files):
        ds = WindowDataset(torch.from_numpy(load_pickle_native(path, 3)), past_len=5,
                           future_len=3, stride=4)
        want += list(ds.batches(2, shuffle=True, seed=7 + k))
    assert len(got) == len(want)
    for (gp, gf), (wp, wf) in zip(got, want):
        assert torch.equal(gp, wp) and torch.equal(gf, wf)


def test_trainer_fits_on_a_stream(files, tmp_path):
    """``Trainer.fit`` takes a stream as its training set: one file's
    stream trains exactly as its resident dataset."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.ingest import load_pickle_native
    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg = load_config("4test/ATC.yml", overrides={
        "MACROPROPS": {"ROWS": H, "COLS": W}, "DATASET": {"BATCH_SIZE": 2},
        "MODEL": {"DDPM": {"TIMESTEPS": 10, "CHECKPOINTS_TO_KEEP": 0, "DIT": {
            "HIDDEN_SIZE": 32, "DEPTH": 1, "NUM_HEADS": 4, "PATCH_SIZE": 2,
            "TRAIN": {"EPOCHS": 1}}}}})
    losses = []
    for data in (FileWindowStream(files[2:], past_len=5, future_len=3, stride=4,
                                  device="cpu"),
                 WindowDataset(torch.from_numpy(load_pickle_native(files[2], 3)),
                               past_len=5, future_len=3, stride=4)):
        run = tmp_path / f"run{len(losses)}"
        tr = Trainer(cfg.updated({"DATA_FS": {"SAVE_DIR": str(run / "ckpts")}}), "DDPM-DiT",
                     device="cpu", seed=2, run_dir=str(run))
        losses.append(tr.fit(data, epochs=1)["step_loss"])
    assert losses[0] == losses[1] and len(losses[0][0]) == 4


def test_files_ahead_two_file_budget(tmp_path, monkeypatch):
    """The loader does not read file k+1 until the consumer holds file k:
    at most two files resident (one consumed, one buffered or loading)."""
    rng = np.random.default_rng(0)
    paths = []
    for k in range(4):
        path = tmp_path / f"f{k}.pkl"
        with open(path, "wb") as f:
            pickle.dump(rng.normal(size=(2, 4, H, W, L)).astype(np.float32), f)
        paths.append(str(path))
    stream = FileWindowStream(paths, past_len=5, future_len=3, stride=4, device="cpu")
    loads, lock = [], threading.Lock()
    real = FileWindowStream._load_host

    def counting_load(self, path):
        with lock:
            loads.append(path)
        return real(self, path)

    monkeypatch.setattr(FileWindowStream, "_load_host", counting_load)
    it = stream._files_ahead()
    next(it)  # starts the loader; the consumer holds file 0
    time.sleep(0.6)
    assert len(loads) == 2  # file 1 buffered, file 2 not started
    next(it)
    time.sleep(0.6)
    assert len(loads) == 3
    next(it)
    next(it)
    with pytest.raises(StopIteration):
        next(it)
    assert loads == paths


def test_file_stream_releases_loader_on_abandon(files):
    base = _alive("crowdmod-file-loader")
    stream = FileWindowStream(files, past_len=5, future_len=3, stride=4, device="cpu")
    it = stream._files_ahead()
    next(it)
    it.close()
    assert _wait_until(lambda: _alive("crowdmod-file-loader") <= base), \
        "file loader thread leaked after generator close"
