"""Pickle ingestion and dataset splits (port of the JAX package's
``data/ingest.py``, its pickle path).

Macroprop pickles hold reference-layout arrays ``(N, C, H, W, L)``.  They
load into one preallocated host array, are transposed once by the native
library (:mod:`crowdmod_tpu_torch.native`) to the native ``(N, L, H, W, C)``,
and become one tensor on the requested device that a :class:`WindowDataset`
gathers from.  The first load of a pickle writes a ``<file>.cmb`` sidecar
(the JAX package's binary format, so either package reads the other's);
later loads read it with the native reader, no unpickling.
``CROWDMOD_CMB_CACHE=0`` turns the sidecar off.  The splits draw from the
same Python ``random`` and numpy seeds as the JAX package, so both packages
pick the same files and windows.

Split strategies (``DATASET.DATASET_TYPE``):
  * ``ByFilenames``  — shuffle files, TRAIN/VAL/TEST_FILE_COUNT partition;
  * ``BySplitRatio`` — load everything, 0.9/0.1 window-level split with a
                       fixed seed;
  * fixed past       — one pickle under ``PICKLE_DIR/4sampling/``.
"""

from __future__ import annotations

import logging
import os
import pickle
import random
from pathlib import Path

import numpy as np
import torch

from crowdmod_tpu_torch.config import FrozenConfig
from crowdmod_tpu_torch.data.windows import WindowDataset


def filenames_with_counts(cfg: FrozenConfig) -> list[tuple[str, int]]:
    """DATA_LIST entries → full pickle paths and sample counts.

    Both DATA_LIST forms: ``[file, n]`` pairs, and plain file names, whose
    count is read from the pickle.
    """
    raw_ext = cfg.DATASET.get("RAW_EXT", ".csv")
    out = []
    for entry in cfg.DATA_LIST:
        if isinstance(entry, (list, tuple)):
            filename, n = entry
            n = int(n)
        else:
            filename, n = entry, None
        filename = str(filename)
        for ext in (raw_ext, ".csv", ".txt"):
            if filename.endswith(ext):
                filename = filename[: -len(ext)]
                break
        if not filename.endswith(".pkl"):
            filename += ".pkl"
        path = os.path.join(cfg.DATA_FS.PICKLE_DIR, filename)
        if n is None:
            with open(path, "rb") as f:
                n = len(pickle.load(f))
        out.append((path, n))
    return out


def channel_stats(data: np.ndarray) -> np.ndarray:
    """Per-channel (mean, std, min, max) → ``(C, 4)``."""
    c = data.shape[-1]
    stats = np.empty((c, 4))
    for i in range(c):
        ch = data[..., i]
        stats[i] = (ch.mean(), ch.std(), ch.min(), ch.max())
        logging.info(
            "channel %d stats: mean=%.4f std=%.4f min=%.4f max=%.4f",
            i, *stats[i],
        )
    return stats


def _use_cmb() -> bool:
    return os.environ.get("CROWDMOD_CMB_CACHE", "1") != "0"


def _load_one(path: str, use_cmb: bool) -> np.ndarray:
    """One macroprop file as a float32 array (reference layout), through its
    ``.cmb`` sidecar: the first load unpickles and writes ``<file>.cmb``,
    later loads read the sidecar while it is not older than the pickle.  A
    corrupt sidecar (a crash mid-write) is dropped and rebuilt."""
    from crowdmod_tpu_torch import native

    cmb = str(path) + ".cmb"
    if use_cmb and os.path.exists(cmb) and os.path.getmtime(cmb) >= os.path.getmtime(path):
        try:
            return native.read_tensor(cmb)
        except (OSError, ValueError) as e:
            logging.warning("corrupt cmb cache %s (%s); rebuilding", cmb, e)
            try:
                os.remove(cmb)
            except OSError:
                pass
    with open(path, "rb") as f:
        arr = np.asarray(pickle.load(f), np.float32)
    if use_cmb:
        try:
            native.write_tensor(cmb, arr)
        except OSError:
            logging.info("could not write cmb cache next to %s", path)
    return arr


def load_pickle_native(path: str, mprops_count: int = 4) -> np.ndarray:
    """ONE macroprop pickle → native ``(n, L, H, W, C)`` float32, through
    the ``.cmb`` sidecar and the native transpose."""
    from crowdmod_tpu_torch.native import transpose_to_native

    arr = _load_one(path, _use_cmb())
    return np.ascontiguousarray(transpose_to_native(arr)[..., :mprops_count])


def load_pickles(
    files_and_counts: list[tuple[str, int]],
    mprops_count: int,
    per_sample_shape: tuple[int, int, int],  # (H, W, L)
) -> tuple[np.ndarray, np.ndarray]:
    """Load macroprop pickles → native ``(N, L, H, W, C)`` float32 and its
    channel stats.  The counts come from the DATA_LIST, so the output is
    allocated once."""
    h, w, L = per_sample_shape
    total = sum(n for _, n in files_and_counts)
    from crowdmod_tpu_torch.native import transpose_to_native

    data = np.empty((total, 4, h, w, L), np.float32)
    at = 0
    use_cmb = _use_cmb()
    for k, (path, n) in enumerate(files_and_counts):
        logging.info("loading %s (%d/%d)", path, k + 1, len(files_and_counts))
        try:
            data[at : at + n] = _load_one(path, use_cmb)
        except MemoryError:
            # As the reference: log, and leave this file's samples zero
            # rather than abort the run.
            logging.error("MemoryError loading %s; slots left zeroed", path)
            data[at : at + n] = 0.0
        at += n
    native = transpose_to_native(data)[..., :mprops_count]
    return np.ascontiguousarray(native), channel_stats(native)


def normalize_velocity(data: np.ndarray, stats: np.ndarray) -> np.ndarray:
    """Min-max the velocity channels into [-1, 1] (DATASET.VELOCITY_NORM)."""
    out = data.copy()
    for ch in (1, 2):
        lo, hi = stats[ch, 2], stats[ch, 3]
        rng = hi - lo if hi > lo else 1.0  # constant channel → map to -1
        out[..., ch] = (data[..., ch] - lo) / rng * 2.0 - 1.0
    return out


def _window_ds(cfg: FrozenConfig, raw: np.ndarray, mprops_count: int, device):
    if cfg.DATASET.get("VELOCITY_NORM"):
        raw = normalize_velocity(raw, channel_stats(raw))
    return WindowDataset(
        torch.from_numpy(np.ascontiguousarray(raw[..., :mprops_count])).to(device),
        past_len=cfg.DATASET.PAST_LEN,
        future_len=cfg.DATASET.FUTURE_LEN,
        stride=cfg.MACROPROPS.STRIDE,
    )


def split_by_filenames(
    cfg: FrozenConfig,
    files_and_counts,
    mprops_count: int = 4,
    seed: int | None = None,
    which: tuple[str, ...] = ("train", "val", "test"),
    device="cpu",
) -> dict[str, WindowDataset | None]:
    """File-level split: shuffle, then TRAIN/VAL/TEST_FILE_COUNT partition."""
    files = list(files_and_counts)
    rng = random.Random(seed)
    rng.shuffle(files)
    n_train = cfg.DATASET.TRAIN_FILE_COUNT
    n_val = cfg.DATASET.VAL_FILE_COUNT
    n_test = cfg.DATASET.TEST_FILE_COUNT
    shape = (
        cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, cfg.DATASET.RAW_SEQ_LEN
    )
    parts = {
        "train": files[:n_train],
        "val": files[n_train : n_train + n_val],
        "test": files[n_train + n_val : n_train + n_val + n_test],
    }
    out: dict[str, WindowDataset | None] = {}
    for name in ("train", "val", "test"):
        if name not in which or not parts[name]:
            out[name] = None
            continue
        data, _ = load_pickles(parts[name], mprops_count, shape)
        out[name] = _window_ds(cfg, data, mprops_count, device)
    return out


def split_by_ratio(
    cfg: FrozenConfig,
    files_and_counts,
    mprops_count: int = 4,
    split_ratio: float = 0.9,
    seed: int = 0,
    device="cpu",
) -> dict[str, WindowDataset]:
    """Window-level 90/10 split with a fixed shuffle seed: two
    WindowDatasets over one tensor, restricted to disjoint window ids."""
    shape = (cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, cfg.DATASET.RAW_SEQ_LEN)
    data, _ = load_pickles(files_and_counts, mprops_count, shape)
    full = _window_ds(cfg, data, mprops_count, device)
    n = len(full)
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(split_ratio * n)

    def restricted(ids):
        ds = WindowDataset(
            full.raw, past_len=full.past_len, future_len=full.future_len,
            stride=full.stride,
        )
        ds.indices = full.indices[ids]
        return ds

    return {
        "train": restricted(perm[:n_train]),
        "val": None,
        "test": restricted(perm[n_train:]),
    }


def fixed_past_dataset(cfg: FrozenConfig, mprops_count: int = 4,
                       device="cpu") -> WindowDataset:
    """The fixed sampling set: the first pickle under
    ``PICKLE_DIR/4sampling/``, all channels loaded (velocity normalization
    sees them), then cut to ``mprops_count``."""
    d = Path(cfg.DATA_FS.PICKLE_DIR) / "4sampling"
    filename = sorted(os.listdir(d))[0]
    return _window_ds(cfg, load_pickle_native(str(d / filename)), mprops_count, device)


def get_training_dataset(cfg: FrozenConfig, mprops_count: int, seed=None,
                         device="cpu"):
    """→ (train_ds, val_ds) per DATASET_TYPE, each tensor on ``device``."""
    fc = filenames_with_counts(cfg)
    kind = cfg.DATASET.DATASET_TYPE
    if kind == "ByFilenames":
        parts = split_by_filenames(cfg, fc, mprops_count, seed=seed,
                                   which=("train", "val"), device=device)
    elif kind == "BySplitRatio":
        parts = split_by_ratio(cfg, fc, mprops_count, device=device)
    else:
        raise ValueError(f"unsupported DATASET_TYPE {kind!r}")
    return parts["train"], parts["val"]


def get_test_dataset(
    cfg: FrozenConfig, mprops_count: int, from_fixed_past: bool = False,
    seed=None, device="cpu",
):
    """→ test_ds on ``device``."""
    if from_fixed_past:
        return fixed_past_dataset(cfg, mprops_count, device)
    fc = filenames_with_counts(cfg)
    kind = cfg.DATASET.DATASET_TYPE
    if kind == "ByFilenames":
        return split_by_filenames(
            cfg, fc, mprops_count, seed=seed, which=("test",), device=device
        )["test"]
    if kind == "BySplitRatio":
        return split_by_ratio(cfg, fc, mprops_count, device=device)["test"]
    raise ValueError(f"unsupported DATASET_TYPE {kind!r}")
