"""The port's pandas-free ETL (``crowdmod_tpu_torch.data.etl``, the raw
trajectories of ``data.synthetic`` and ``python -m crowdmod_tpu_torch.cli
etl``) against the JAX package's pandas ETL on the same seeded inputs, on
the CPU.  Density is held exactly; the float channels and columns within
rtol 1e-5, atol 1e-6 where they are not equal (most are: the port's
binning adds in the JAX scatter's order).  CSVs written by either package
read in the other to the same values."""

import pickle

import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import jax.numpy as jnp

from crowdmod_tpu.cli import etl as jax_etl_cli
from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.data import etl as jax_etl
from crowdmod_tpu.data import synthetic as jax_synthetic
from crowdmod_tpu_torch import cli
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.data import etl, synthetic

RTOL, ATOL = 1e-5, 1e-6
ROWS, COLS = 4, 6
GEO = dict(rows=ROWS, cols=COLS, dx=1.0, dy=1.0, lu=(0.0, 4.0))


@pytest.fixture(scope="module")
def cfgs():
    return jax_load_config("ATC.yml"), load_config("ATC.yml")


def raw_kwargs(cfg, n_frames=60, walkers=3, subsamples=3, seed=2):
    m = cfg.MACROPROPS
    return dict(n_frames=n_frames, rows=m.ROWS, cols=m.COLS, lu=list(m.LU), theta=m.THETA,
                walkers_per_row=walkers, subsamples=subsamples, seed=seed)


# pandas' default CSV float parser is not correctly rounded: a value written
# in its shortest round-trip form can read back one ulp off.  The port's
# reader (numpy's) returns the written value, as pandas' "round_trip" parser
# does; against pandas' default it is held within a few ulp.
PARSE_RTOL = 1e-15


def assert_frame_equal(got: dict, want: pd.DataFrame, rtol=0.0):
    """Every column equal, float columns within ``rtol`` if it is not 0."""
    assert list(got) == list(want.columns)
    for k in want.columns:
        w = want[k].to_numpy()
        assert len(got[k]) == len(w), k
        if rtol == 0.0 or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=0, err_msg=k)


def read_aggregated_round_trip(path) -> pd.DataFrame:
    """The JAX package's ``read_aggregated_csv`` with pandas' correctly
    rounded float parser."""
    df = pd.read_csv(path, float_precision="round_trip")
    df = df.drop(columns=[c for c in df.columns if c.startswith("Unnamed")])
    if pd.api.types.is_numeric_dtype(df["time"]):
        df["time"] = pd.to_datetime(df["time"], unit="s")
    else:
        df["time"] = pd.to_datetime(df["time"])
    return df


def assert_macroprops_close(got, want):
    """Density exactly; the other channels within RTOL/ATOL."""
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1:], want[..., 1:], rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Raw trajectories and the CSV files

@pytest.mark.parametrize("walkers,subsamples,seed", [(2, 1, 0), (3, 3, 2), (8, 2, 5)])
def test_synthetic_raw_trajectories_equal_jax(cfgs, walkers, subsamples, seed):
    kw = raw_kwargs(cfgs[1], 24, walkers, subsamples, seed)
    assert_frame_equal(synthetic.synthetic_raw_trajectories(**kw),
                       jax_synthetic.synthetic_raw_trajectories(**kw))


def test_synthetic_dataset_equals_jax():
    base = np.random.default_rng(0).normal(size=(2, 8, 12, 36, 4)).astype(np.float32)
    np.testing.assert_array_equal(synthetic.synthetic_dataset(base, kind="FORWARD"),
                                  jax_synthetic.synthetic_dataset(base, kind="FORWARD"))


def test_raw_csv_reads_in_both_packages(cfgs, tmp_path):
    kw = raw_kwargs(cfgs[1])
    port, jax = tmp_path / "port.csv", tmp_path / "jax.csv"
    raw = synthetic.synthetic_raw_trajectories(**kw)
    synthetic.write_atc_raw_csv(raw, str(port))
    jax_synthetic.write_atc_raw_csv(jax_synthetic.synthetic_raw_trajectories(**kw), str(jax))
    for path in (port, jax):
        got = etl.read_atc_raw(path)
        for k, v in got.items():
            np.testing.assert_array_equal(v, raw[k], err_msg=k)  # the written values
        read = dict(names=jax_etl.ATC_COLUMNS, header=None, usecols=jax_etl.ATC_READ_COLUMNS)
        assert_frame_equal(got, pd.read_csv(path, float_precision="round_trip", **read))
        assert_frame_equal(got, pd.read_csv(path, **read), rtol=PARSE_RTOL)


def test_seconds_to_datetime_is_pandas_conversion():
    s = np.concatenate([1_352_862_000.0 + np.random.default_rng(0).uniform(0, 7200, 2000),
                        1_352_862_000.0 + 0.25 * np.arange(40), [0.3, 1.1, 0.0]])
    np.testing.assert_array_equal(etl.seconds_to_datetime(s),
                                  pd.to_datetime(s, unit="s").to_numpy())


# ---------------------------------------------------------------------------
# Aggregation

@pytest.mark.parametrize("subsamples", [1, 3])
def test_aggregate_atc_equals_jax(cfgs, subsamples):
    raw = synthetic.synthetic_raw_trajectories(**raw_kwargs(cfgs[1], subsamples=subsamples))
    raw = {k: raw[k] for k in etl.ATC_READ_COLUMNS}
    rng = np.random.default_rng(1)
    raw["time"] = raw["time"] + rng.uniform(-0.01, 0.01, len(raw["time"]))  # bins cross
    raw["vel"] = raw["vel"] + rng.normal(0, 100, len(raw["vel"]))
    got = etl.aggregate_atc(raw)
    want = jax_etl.aggregate_atc(pd.DataFrame(raw))
    assert_frame_equal(got, want)


def test_aggregate_atc_small_case_as_jax():
    raw = {"time": np.array([0.0, 0.1, 0.2, 0.6]), "personID": np.array([1, 1, 2, 1]),
           "pos_x": np.array([0.0, 1.0, 5.0, 2.0]), "pos_y": np.array([0.0, 1.0, 5.0, 2.0]),
           "vel": np.array([1.0, 2.0, 3.0, np.nan]), "motion_angle": np.zeros(4)}
    got = etl.aggregate_atc(raw)
    assert_frame_equal(got, jax_etl.aggregate_atc(pd.DataFrame(raw)))
    assert got["time"][0].astype("datetime64[h]").astype(int) % 24 == 9  # the +9 h shift


def test_aggregated_csv_reads_in_both_packages(cfgs, tmp_path):
    """``aggregate_atc_files`` of each package → both readers; and the
    epoch-seconds convention without an index column."""
    jcfg, cfg = cfgs
    raw_dir = tmp_path / "raw"
    raw_dir.mkdir()
    synthetic.write_atc_raw_csv(synthetic.synthetic_raw_trajectories(**raw_kwargs(cfg)),
                                str(raw_dir / "day.csv"))
    etl.aggregate_atc_files(cfg, ["day.csv"], raw_dir, tmp_path / "port")
    jax_etl.aggregate_atc_files(jcfg, ["day.csv"], raw_dir, tmp_path / "jax")
    for side in ("port", "jax"):
        path = str(tmp_path / side / "day.csv")
        want = read_aggregated_round_trip(path)
        assert_frame_equal(etl.read_aggregated_csv(path), want)
        assert_frame_equal(etl.read_aggregated_csv(path), jax_etl.read_aggregated_csv(path),
                           rtol=PARSE_RTOL)
    # The two aggregations differ only where pandas read a raw value an ulp off.
    assert_frame_equal(etl.read_aggregated_csv(str(tmp_path / "port" / "day.csv")), want,
                       rtol=RTOL)
    epoch = tmp_path / "epoch.csv"
    seconds = want.assign(time=want["time"].astype("int64") / 1e9)
    seconds.to_csv(epoch, index=False)
    assert_frame_equal(etl.read_aggregated_csv(str(epoch)), read_aggregated_round_trip(epoch))


# ---------------------------------------------------------------------------
# Preprocessing, binning, windows

@pytest.fixture(scope="module")
def aggregated(cfgs):
    raw = synthetic.synthetic_raw_trajectories(**raw_kwargs(cfgs[1], n_frames=90, walkers=4))
    raw = {k: raw[k] for k in etl.ATC_READ_COLUMNS}
    return etl.aggregate_atc(raw), jax_etl.aggregate_atc(pd.DataFrame(raw))


def test_preprocess_and_filter_equal_jax(cfgs, aggregated):
    jcfg, cfg = cfgs
    port, jax = aggregated
    got, rlu = etl.preprocess_trajectories(port, cfg)
    want, jrlu = jax_etl.preprocess_trajectories(jax, jcfg)
    np.testing.assert_array_equal(rlu, jrlu)
    assert_frame_equal(got, want)
    # Move a third of the rows off the grid, so the filter has work.
    got["pos_x"][::3] += 40.0
    want.loc[want.index[::3], "pos_x"] += 40.0
    kept = etl.filter_by_grid(got, cfg, rlu)
    assert_frame_equal(kept, jax_etl.filter_by_grid(want, jcfg, jrlu).reset_index(drop=True))
    assert 0 < len(kept["time"]) < len(got["time"])


def _frame_inputs(n, seed):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-1, COLS + 1, n).astype(np.float32)  # some off the grid
    py = rng.uniform(4 - ROWS - 1, 5, n).astype(np.float32)
    vx, vy = rng.normal(size=(2, n)).astype(np.float32)
    return px, py, vx, vy, np.hypot(vx, vy)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_frame_equals_jax(seed):
    px, py, vx, vy, vn = _frame_inputs(60, seed)
    mask = np.random.default_rng(seed).uniform(size=60) < 0.8
    got = etl.bin_frame(*map(torch.from_numpy, (px, py, vx, vy, vn, mask)), **GEO)
    want = jax_etl.bin_frame(*map(jnp.asarray, (px, py, vx, vy, vn, mask)), **GEO)
    assert got.shape == (ROWS, COLS, 4)
    assert got[..., 0].sum() > 10
    assert_macroprops_close(got.numpy(), np.asarray(want))


def test_bin_frames_in_one_pass_equal_bin_frame_per_frame():
    """Every frame binned in one pass (rows of several frames interleaved)
    equals each frame binned alone, bit for bit."""
    px, py, vx, vy, vn = _frame_inputs(200, 3)
    frame = np.random.default_rng(4).integers(-1, 6, 200)  # −1: no frame
    args = [torch.from_numpy(a) for a in (px, py, vx, vy, vn)]
    got = etl.bin_frames(torch.from_numpy(frame), *args, n_frames=5, **GEO)
    for f in range(5):
        one = etl.bin_frame(*args, torch.from_numpy(frame == f), **GEO)
        assert torch.equal(got[f], one)


@pytest.mark.parametrize("overlap", [False, True])
def test_compute_macroprop_sequences_equal_jax(cfgs, aggregated, overlap):
    jcfg, cfg = cfgs
    over = {"MACROPROPS": {"OVERLAP": overlap, "WINDOWSIZE": 3}}
    jcfg, cfg = jcfg.updated(over), cfg.updated(over)
    pre, rlu = etl.preprocess_trajectories(aggregated[0], cfg)
    jpre, jrlu = jax_etl.preprocess_trajectories(aggregated[1], jcfg)
    filt = etl.filter_by_grid(pre, cfg, rlu)
    got = etl.compute_macroprop_sequences(filt, cfg, rlu, t_init=pre["time"].min(),
                                          t_final=pre["time"].max(), device="cpu")
    want = jax_etl.compute_macroprop_sequences(
        jax_etl.filter_by_grid(jpre, jcfg, jrlu), jcfg, jrlu,
        t_init=jpre["time"].min(), t_final=jpre["time"].max())
    window = cfg.DATASET.PAST_LEN + cfg.DATASET.FUTURE_LEN
    assert got.shape[1:] == (window, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 4)
    frames = int((pre["time"].max() - pre["time"].min()) / np.timedelta64(500, "ms"))
    stride = 3 if overlap else window
    assert got.shape[0] == (frames - window) // stride + 1 and got[..., 0].sum() > 0
    assert_macroprops_close(got, want)
    # Frames split by time as the JAX package splits them.
    frames = etl._frames_from_df(filt, np.datetime64(pre["time"].min()), 10,
                                 cfg.MACROPROPS.TIME_RES)
    jframes = jax_etl._frames_from_df(jax_etl.filter_by_grid(jpre, jcfg, jrlu).sort_values(
        "time"), np.datetime64(jpre["time"].min()), 10, jcfg.MACROPROPS.TIME_RES)
    for a, b in zip(frames, jframes):
        for k in b:
            np.testing.assert_array_equal(np.sort(a[k]), np.sort(b[k]))


def test_macroprops_from_aggregated_and_pickle_layout_equal_jax(cfgs, aggregated):
    got = etl.macroprops_from_aggregated(aggregated[0], cfgs[1], device="cpu")
    want = jax_etl.macroprops_from_aggregated(aggregated[1], cfgs[0])
    assert_macroprops_close(got, want)
    np.testing.assert_array_equal(etl.to_reference_pickle_layout(got),
                                  jax_etl.to_reference_pickle_layout(want))


def test_short_span_gives_no_windows(cfgs, aggregated):
    short = {k: v[:20] for k, v in aggregated[0].items()}
    got = etl.macroprops_from_aggregated(short, cfgs[1], device="cpu")
    want = jax_etl.macroprops_from_aggregated(aggregated[1].iloc[:20], cfgs[0])
    assert got.shape == want.shape == (0, 8, 12, 36, 4)


def test_binning_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        etl.macroprop_frames({"time": np.array([], "datetime64[ns]")}, load_config("ATC.yml"),
                             (0.0, 0.0))


# ---------------------------------------------------------------------------
# ETH / UCY and counting

def _eth_txt(path, rng):
    rows = []
    for agent in range(1, 7):
        n = 1 if agent == 6 else int(rng.integers(3, 8))  # agent 6 seen once
        start = int(rng.integers(0, 40))
        for k in range(n):
            frame = (start + k) * 10
            x, y = 5 + 0.3 * k + rng.normal(0, 0.05), 3 + 0.2 * agent + 0.1 * k
            rows.append(f"{frame}.0\t{agent}.0\t{x:.4f}\t{y:.4f}")
            if agent == 2 and k == 1:  # the same place twice, a frame apart
                rows.append(f"{frame + 10}.0\t{agent}.0\t{x:.4f}\t{y:.4f}")
                break
    rng.shuffle(rows)
    path.write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("name", ["biwi_hotel.txt", "crowds_zara01.txt"])
def test_eth_helpers_equal_jax(tmp_path, name):
    path = tmp_path / name
    _eth_txt(path, np.random.default_rng(len(name)))
    got, want = etl.eth_read_raw(str(path)), jax_etl.eth_read_raw(str(path))
    assert_frame_equal(got, want)
    vel = etl.add_velocity_and_angle(got)
    jvel = jax_etl.add_velocity_and_angle(want)
    assert_frame_equal(vel, jvel)
    assert np.isfinite(vel["vel"]).all() and 6.0 not in vel["agent_ID"]
    lu = etl.find_max_density_lu(got, cols=2, rows=2)
    assert tuple(map(int, lu)) == tuple(map(int, jax_etl.find_max_density_lu(want, 2, 2)))
    assert_frame_equal(etl.crop_to_lu(got, lu, 2, 2),
                       jax_etl.crop_to_lu(want, lu, 2, 2))
    assert_frame_equal(etl.eth_frames_to_unixtime(got, 10.0),
                       jax_etl.eth_frames_to_unixtime(want, 10.0))


def test_find_max_density_lu_equals_jax():
    rng = np.random.default_rng(1)
    df = {"pos_x": np.concatenate([rng.uniform(10, 12, 200), rng.uniform(0, 20, 20)]),
          "pos_y": np.concatenate([rng.uniform(5, 7, 200), rng.uniform(0, 10, 20)])}
    for cols, rows in ((3, 3), (5, 2), (40, 3)):
        got = etl.find_max_density_lu(df, cols, rows)
        assert tuple(map(int, got)) == tuple(map(int, jax_etl.find_max_density_lu(
            pd.DataFrame(df), cols, rows)))


def test_count_samples_equals_jax(tmp_path):
    for name, n in (("b.pkl", 3), ("a.pkl", 5)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(np.zeros((n, 4, 2, 2, 8), np.float32), f)
    (tmp_path / "notes.txt").write_text("x")
    got = etl.count_samples(str(tmp_path), str(tmp_path / "port.yml"))
    want = jax_etl.count_samples(str(tmp_path), str(tmp_path / "jax.yml"))
    assert got == want == [["a.pkl", 5], ["b.pkl", 3]]
    assert (tmp_path / "port.yml").read_text() == (tmp_path / "jax.yml").read_text()


# ---------------------------------------------------------------------------
# The command

def test_etl_command_equals_the_jax_command(cfgs, tmp_path):
    """Raw CSVs → aggregated CSVs → pickles + DATA_LIST, both packages'
    ``etl``: the same files, counts and (held as above) windows."""
    jcfg, cfg = cfgs
    raw = tmp_path / "raw"
    raw.mkdir()
    for k in range(2):
        synthetic.write_atc_raw_csv(synthetic.synthetic_raw_trajectories(
            **raw_kwargs(cfg, n_frames=50 + 20 * k, seed=k)), str(raw / f"day{k}.csv"))
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.updated({"DATA_FS": {
        "OUTPUT_DIR": str(tmp_path / "out")}}).to_dict()))
    args = {side: ["--config-yml-file", str(cfg_path), "--raw-dir", str(raw),
                   "--agg-dir", str(tmp_path / side / "agg"),
                   "--pickle-dir", str(tmp_path / side / "pkl"),
                   "--data-list-out", str(tmp_path / side / "list.yml")]
            for side in ("port", "jax")}
    assert cli.main(["etl", *args["port"], "--device", "cpu"]) == 0
    assert jax_etl_cli.run(args["jax"]) == 0
    lists = {s: yaml.safe_load((tmp_path / s / "list.yml").read_text()) for s in args}
    assert lists["port"] == lists["jax"] == {"DATA_LIST": [["day0.pkl", 6], ["day1.pkl", 8]]}
    for k in range(2):
        got, want = (pickle.load(open(tmp_path / s / "pkl" / f"day{k}.pkl", "rb"))
                     for s in ("port", "jax"))
        assert got.shape[1:] == (4, 12, 36, 8)
        assert_macroprops_close(np.moveaxis(got, 1, -1), np.moveaxis(want, 1, -1))
    # --skip-aggregate from the JAX package's aggregated CSVs: the same pickles.
    again = tmp_path / "again"
    assert cli.main(["etl", "--config-yml-file", str(cfg_path), "--skip-aggregate",
                     "--agg-dir", str(tmp_path / "jax" / "agg"), "--pickle-dir", str(again),
                     "--device", "cpu"]) == 0
    for k in range(2):
        np.testing.assert_array_equal(
            pickle.load(open(again / f"day{k}.pkl", "rb")),
            pickle.load(open(tmp_path / "port" / "pkl" / f"day{k}.pkl", "rb")))


def test_etl_command_exits_2_on_a_missing_directory(cfgs, tmp_path):
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(cfgs[1].updated({"DATA_FS": {
        "OUTPUT_DIR": str(tmp_path / "out")}}).to_dict()))
    base = ["--config-yml-file", str(cfg_path), "--pickle-dir", str(tmp_path / "pkl")]
    missing = str(tmp_path / "nowhere")
    for argv in (["--raw-dir", missing], ["--skip-aggregate", "--agg-dir", missing]):
        assert cli.main(["etl", *base, *argv, "--device", "cpu"]) == 2
        assert jax_etl_cli.run([*base, *argv]) == 2
