"""Port parity: pickle ingestion and the dataset splits (``data/ingest.py``)
against the JAX package's on the same pickles: the same files in each
split, the same windows in the same order, the same values (exact: both
are numpy transposes of the same float32 data) and the same
``channel_stats``."""

import pickle

import numpy as np
import pytest
import torch
import yaml

from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.data import ingest as jax_ingest
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.data import ingest

H, W, L = 8, 12, 16
COUNTS = [3, 2, 4, 2, 3, 1]


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    """Six reference-layout pickles with differing sample counts, a
    DATA_LIST in each of its two forms, and a fixed-past pickle; the JAX
    side without its ``.cmb`` sidecar cache, which the port does not have."""
    monkeypatch.setenv("CROWDMOD_CMB_CACHE", "0")
    rng = np.random.default_rng(11)
    pkl = tmp_path / "pickle"
    (pkl / "4sampling").mkdir(parents=True)
    pairs, names = [], []
    for k, n in enumerate(COUNTS):
        arr = rng.normal(size=(n, 4, H, W, L)).astype(np.float32)
        with open(pkl / f"scene{k}.pkl", "wb") as f:
            pickle.dump(arr, f)
        pairs.append([f"scene{k}.csv", n])  # the RAW_EXT form of the name
        names.append(f"scene{k}")  # the bare form: counts from the pickle
    with open(pkl / "4sampling" / "fixed.pkl", "wb") as f:
        pickle.dump(rng.normal(size=(2, 4, H, W, L)).astype(np.float32), f)
    paths = {}
    for form, entries in (("pairs", pairs), ("names", names)):
        paths[form] = tmp_path / f"{form}.yml"
        paths[form].write_text(yaml.safe_dump({"DATA_LIST": entries}))
    return tmp_path, paths


def _configs(root, list_path, **dataset):
    over = {
        "DATA_FS": {"PICKLE_DIR": str(root / "pickle")},
        "MACROPROPS": {"ROWS": H, "COLS": W},
        "DATASET": {"RAW_SEQ_LEN": L, "TRAIN_FILE_COUNT": 3, "VAL_FILE_COUNT": 2,
                    "TEST_FILE_COUNT": 1, **dataset},
    }
    return (load_config("4test/ATC.yml", str(list_path), overrides=over),
            jax_load_config("4test/ATC.yml", str(list_path), overrides=over))


def _assert_same_windows(port_ds, jax_ds):
    assert (port_ds is None) == (jax_ds is None)
    if port_ds is None:
        return
    assert port_ds.raw.device.type == "cpu"
    assert np.array_equal(port_ds.raw.numpy(), np.asarray(jax_ds.raw))
    assert np.array_equal(port_ds.indices, np.asarray(jax_ds.indices))
    assert (port_ds.past_len, port_ds.future_len, port_ds.stride) == (
        jax_ds.past_len, jax_ds.future_len, jax_ds.stride)
    n = len(jax_ds)
    p_past, p_fut = port_ds.gather(np.arange(n))
    j_past, j_fut = jax_ds.gather(np.arange(n))
    assert np.array_equal(p_past.numpy(), np.asarray(j_past))
    assert np.array_equal(p_fut.numpy(), np.asarray(j_fut))


@pytest.mark.parametrize("form", ["pairs", "names"])
def test_filenames_with_counts(corpus, form):
    root, paths = corpus
    cfg, jcfg = _configs(root, paths[form])
    got = ingest.filenames_with_counts(cfg)
    assert got == jax_ingest.filenames_with_counts(jcfg)
    assert [n for _, n in got] == COUNTS


@pytest.mark.parametrize("seed", [None, 0, 42])
@pytest.mark.parametrize("norm", [False, True])
def test_split_by_filenames(corpus, seed, norm):
    root, paths = corpus
    cfg, jcfg = _configs(root, paths["pairs"], DATASET_TYPE="ByFilenames",
                         VELOCITY_NORM=norm)
    if seed is None:  # an unseeded shuffle: only the shapes can agree
        train, val = ingest.get_training_dataset(cfg, 3, device="cpu")
        assert train.raw.shape[1:] == (L, H, W, 3) and val is not None
        return
    train, val = ingest.get_training_dataset(cfg, 3, seed=seed, device="cpu")
    j_train, j_val = jax_ingest.get_training_dataset(jcfg, 3, seed=seed)
    _assert_same_windows(train, j_train)
    _assert_same_windows(val, j_val)
    _assert_same_windows(ingest.get_test_dataset(cfg, 3, seed=seed, device="cpu"),
                         jax_ingest.get_test_dataset(jcfg, 3, seed=seed))
    # Each split holds whole files: 3 + 2 + 1 of the 6.
    assert len(train.raw) + len(val.raw) + len(
        ingest.get_test_dataset(cfg, 3, seed=seed, device="cpu").raw) == sum(COUNTS)


@pytest.mark.parametrize("mprops", [3, 4])
def test_split_by_ratio(corpus, mprops):
    root, paths = corpus
    cfg, jcfg = _configs(root, paths["names"], DATASET_TYPE="BySplitRatio")
    train, val = ingest.get_training_dataset(cfg, mprops, device="cpu")
    j_train, j_val = jax_ingest.get_training_dataset(jcfg, mprops)
    assert val is None and j_val is None
    _assert_same_windows(train, j_train)
    test = ingest.get_test_dataset(cfg, mprops, device="cpu")
    _assert_same_windows(test, jax_ingest.get_test_dataset(jcfg, mprops))
    parts = ingest.split_by_ratio(cfg, ingest.filenames_with_counts(cfg), mprops,
                                 device="cpu")
    assert parts["train"].raw is parts["test"].raw  # one tensor, disjoint ids
    assert not set(map(tuple, train.indices)) & set(map(tuple, test.indices))
    assert len(train) + len(test) == 2 * sum(COUNTS)  # two windows a sequence


def test_load_pickles_and_channel_stats(corpus):
    root, paths = corpus
    cfg, jcfg = _configs(root, paths["pairs"])
    fc = ingest.filenames_with_counts(cfg)
    data, stats = ingest.load_pickles(fc, 4, (H, W, L))
    j_data, j_stats = jax_ingest.load_pickles(fc, 4, (H, W, L))
    assert data.shape == (sum(COUNTS), L, H, W, 4) and data.flags.c_contiguous
    assert np.array_equal(data, j_data)
    assert np.array_equal(stats, j_stats)
    assert np.array_equal(ingest.channel_stats(data[..., :3]),
                          jax_ingest.channel_stats(j_data[..., :3]))
    assert np.array_equal(ingest.normalize_velocity(data, stats),
                          jax_ingest.normalize_velocity(j_data, j_stats))


def test_fixed_past_and_device(corpus):
    root, paths = corpus
    cfg, jcfg = _configs(root, paths["pairs"], VELOCITY_NORM=True)
    _assert_same_windows(ingest.get_test_dataset(cfg, 3, from_fixed_past=True, device="cpu"),
                         jax_ingest.get_test_dataset(jcfg, 3, from_fixed_past=True))
    ds = ingest.get_test_dataset(cfg, 3, seed=0, device=torch.device("cpu"))
    assert ds.raw.dtype == torch.float32 and ds.raw.device.type == "cpu"


def test_unknown_split_raises(corpus):
    root, paths = corpus
    cfg, _ = _configs(root, paths["pairs"], DATASET_TYPE="ByScene")
    with pytest.raises(ValueError, match="unsupported DATASET_TYPE"):
        ingest.get_training_dataset(cfg, 3, device="cpu")
    with pytest.raises(ValueError, match="unsupported DATASET_TYPE"):
        ingest.get_test_dataset(cfg, 3, device="cpu")
