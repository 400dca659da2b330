"""The port's data drills (``tools/*_torch.py``) at toy size on the CPU
(``--device cpu``), against the JAX tools where they share data.

  * the ETL drill: its raw CSVs byte for byte the JAX tool's for one seed,
    and the whole chain (raw CSVs → ``etl`` → a ``train`` process → restore
    → sample → score) to a report.  Its ≥ 3 dB criterion needs more epochs
    than a CPU test can give, like the end-to-end validation's: both are
    held on the card (``chip_smoke.py --drills``);
  * the protocol drill: its corpus the JAX tool's ``build_corpus`` arrays,
    and a ``--skip-train`` run off a trained checkpoint to its CSVs;
  * the stream soak: an epoch over a corpus of about 1 MB, its IO timed.
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from tools import etl_drill as jax_etl_drill
from tools import etl_drill_torch, eval_protocol_full_torch, soak_stream_torch
from tools.eval_protocol_full import build_corpus as jax_build_corpus

@pytest.fixture(autouse=True)
def two_threads(monkeypatch):
    """Two intra-op threads for this process's work and each process a
    drill spawns: the models are tiny, and the test workers share the
    host's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)



def test_etl_drill_raw_csvs_are_the_jax_tools(tmp_path):
    from crowdmod_tpu.data.synthetic import (
        synthetic_raw_trajectories, write_atc_raw_csv,
    )

    port = etl_drill_torch.write_raw_csvs(str(tmp_path), n_frames=40, rows=8, cols=12,
                                          seed=7)
    for k, path in enumerate(port):
        df = synthetic_raw_trajectories(
            n_frames=40, rows=8, cols=12, lu=jax_etl_drill.LU, theta=jax_etl_drill.THETA,
            subsamples=2, walkers_per_row=1, t0=jax_etl_drill.T0 + k * 86_400.0,
            seed=7 + k)
        want = tmp_path / f"jax_{k}.csv"
        write_atc_raw_csv(df, str(want))
        assert Path(path).read_bytes() == want.read_bytes(), path


def test_etl_drill_runs_to_a_report(tmp_path):
    report_path = tmp_path / "report.json"
    rc = etl_drill_torch.main([
        "--out", str(tmp_path / "drill"), "--epochs", "1", "--n-frames", "16",
        "--batch", "8", "--report", str(report_path), "--device", "cpu"])
    report = json.loads(report_path.read_text())
    assert rc == (0 if report["ok"] else 1)
    assert report["files"] == 3 and report["windows"] == 3 * (16 - 8)
    assert report["criterion"] == "trained > untrained + 3 dB"
    assert np.isfinite([report["untrained_density_psnr_db"],
                        report["trained_density_psnr_db"]]).all()
    assert (tmp_path / "drill" / "list.yml").exists()


@pytest.mark.parametrize("seed", [0, 7])
def test_protocol_corpus_is_the_jax_tools(seed, tmp_path):
    want_dir, want_files = jax_build_corpus(str(tmp_path / "jax"), n_files=2, per_file=3,
                                            seed=seed)
    got_dir, got_files = eval_protocol_full_torch.build_corpus(
        str(tmp_path / "port"), n_files=2, per_file=3, seed=seed)
    assert got_files == want_files
    for name, _ in want_files:
        with open(Path(want_dir) / name, "rb") as fw, open(Path(got_dir) / name, "rb") as fg:
            want, got = pickle.load(fw), pickle.load(fg)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def test_protocol_skip_train_reaches_its_csvs(tmp_path):
    """A first run trains DDPM-DiT (the ATC width, one epoch of 3 steps) and
    scores DPM-Solver; a ``--skip-train`` run off its checkpoint scores
    DDIM-eta: both write the 20 CSVs and the manifest."""
    out = tmp_path / "protocol"
    common = ["--out", str(out), "--device", "cpu", "--files", "3", "--per-file", "4",
              "--batch-size", "4", "--chunk", "2", "--timesteps", "50",
              "--train-epochs", "1"]
    assert eval_protocol_full_torch.main(common + ["--samplers", "DPM-Solver"]) == 0
    assert eval_protocol_full_torch.main(
        common + ["--skip-train", "--samplers", "DDIM-eta:1.0:2"]) == 0
    report = json.loads((out / "report.json").read_text())
    assert report["train_wall_s"] == 0.0 and report["protocol"]["nsamples"] == 8
    for sampler in ("DPM-Solver", "DDIM-eta_1.0_2"):
        d = out / "metrics" / sampler
        manifest = json.loads((d / "metrics_files.json").read_text())
        files = [f for k, f in manifest.items() if k != "title"]
        assert len(files) == 20 and all((d / Path(f).name).exists() for f in files)
        assert len(list(d.glob("*.csv"))) == 20
    means = report["samplers"]["DDIM-eta:1.0:2"]["metric_means"]
    assert "MAX_PSNR" in means and all(np.isfinite(list(means.values())))


def test_stream_soak_epoch(tmp_path):
    out = tmp_path / "report.json"
    rc = soak_stream_torch.main([
        "--device", "cpu", "--gb", "0.001", "--per-file", "4", "--batch", "4",
        "--dir", str(tmp_path / "corpus"), "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0 and report["files"] == 2
    assert report["batches"] == 2 * (4 * 3 // 4)  # 3 windows a sequence at stride 4
    assert np.isfinite(report["final_loss"]) and report["io_s"] > 0
    assert 0.0 <= report["hidden_io_share"] <= 1.0
