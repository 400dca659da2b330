"""The port's twins of the JAX repo's tools (``tools/*_torch.py``,
``tools/*_torch.sh``) against the JAX tools on the CPU (``--device cpu``),
on conftest's tiny workspace:

  * ``generate_synthetic_data``: its two pickles byte for byte the JAX
    tool's;
  * ``visualize_forward``: the noised states within 1e-6 of the JAX
    ``q_sample``'s with the JAX noise injected, and its PNG;
  * ``ddim_sweep`` and ``lambda_sweep``: ``tests/test_torch_tools_sweeps.py``
    (split off for time);
  * ``gen_configs``: its YAML byte for byte the JAX generator's, both
    written into the test's directory through ``OUT``;
  * ``gen_api_docs``: ``docs/API_torch.md`` regenerates identically;
  * ``protocol_variance``: two runs at the smallest protocol to the JAX
    tool's summary keys and statistics;
  * ``plot_fixed_crowd``: the JAX tool's figures from one aggregated CSV;
  * ``native_sanitize``: the front end's arguments;
  * ``preflight_torch.sh`` and ``sample_all_datasets_torch.sh``: ``bash
    -n``, ``--help`` and a dry run (the JAX script's datasets, the port's
    commands, the card by default).
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tools import generate_synthetic_data as jax_generate_synthetic_data
from tools import (
    gen_api_docs_torch,
    generate_synthetic_data_torch,
    native_sanitize_torch,
    plot_fixed_crowd_torch,
    protocol_variance_torch,
    visualize_forward_torch,
)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the models are tiny, and the test workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def test_generate_synthetic_data_pickles_are_the_jax_tools(workspace):
    ws = workspace
    args = ["--config-yml-file", ws["cfg"], "--configList-yml-file", ws["list"],
            "--samples", "4", "--kind", "ALL", "--row", "3"]
    assert jax_generate_synthetic_data.main(args + ["--out-dir", str(ws["tmp"] / "jax")]) == 0
    assert generate_synthetic_data_torch.main(
        args + ["--out-dir", str(ws["tmp"] / "port"), "--device", "cpu"]) == 0
    for name in ("true_data.pkl", "synthetic_data.pkl"):
        assert (ws["tmp"] / "port" / name).read_bytes() == (ws["tmp"] / "jax" / name).read_bytes()


def test_visualize_forward_states_are_jax_q_sample(tmp_path):
    """The JAX tool's default ladder, its noise injected: each state within
    1e-6 plus the schedules' own agreement (16 f32 ulp of each coefficient,
    ``tests/test_torch_sampling.py::test_linear_schedule_matches_jax``)
    times |x0| and |ε|."""
    from crowdmod_tpu.config import load_config as jax_load_config
    from crowdmod_tpu.core import schedule as jax_schedule
    from crowdmod_tpu.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.core.schedule import linear_schedule

    cfg = jax_load_config("4test/ATC.yml")
    seed, ts = 42, [0, 100, 250, 500, 750, 999]
    x0 = synthetic_walkers(1, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS,
                           cfg.DATASET.FUTURE_LEN)
    jsched = jax_schedule.linear_schedule(cfg.MODEL.DDPM.TIMESTEPS, scale=cfg.MODEL.DDPM.SCALE)
    keys = {t: jax.random.PRNGKey(seed + t) for t in ts}
    want = {t: np.asarray(jax_schedule.q_sample(jsched, x0, np.array([t]), keys[t])[0])
            for t in ts}
    eps = {t: np.array(jax.random.normal(keys[t], x0.shape)) for t in ts}
    sched = linear_schedule(cfg.MODEL.DDPM.TIMESTEPS, scale=cfg.MODEL.DDPM.SCALE)
    got = visualize_forward_torch.forward_states(
        sched, torch.from_numpy(x0), ts, lambda t: torch.from_numpy(eps[t]))
    ulp = np.finfo(np.float32).eps
    for t in ts:
        bound = 1e-6 + 16 * ulp * (np.abs(x0) + np.abs(eps[t]))
        assert (np.abs(got[t].numpy() - want[t]) <= bound).all(), t

    out = tmp_path / "fwd.png"
    assert visualize_forward_torch.main(["--synthetic", "--out", str(out), "--timesteps",
                                         "0", "50", "99", "--device", "cpu"]) == 0
    assert out.stat().st_size > 0


def test_gen_configs_yaml_is_the_jax_generators(tmp_path):
    jax_gen = _load("gen_configs", REPO / "tools" / "gen_configs.py")
    port_gen = _load("gen_configs_torch", REPO / "tools" / "gen_configs_torch.py")
    jax_gen.OUT, port_gen.OUT = tmp_path / "jax", tmp_path / "port"
    jax_gen.main()
    port_gen.main(["--device", "cpu"])
    files = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == files and "sweep_config.yaml" in files
    for rel in files:
        if rel.endswith((".yml", ".yaml")):
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def test_api_docs_torch_in_sync(tmp_path, monkeypatch):
    """docs/API_torch.md regenerates identically (written here into the
    test's directory): API changes must re-run ``python
    tools/gen_api_docs_torch.py --device cpu``."""
    (tmp_path / "docs").mkdir()
    monkeypatch.setattr(gen_api_docs_torch, "REPO", str(tmp_path))
    gen_api_docs_torch.main(["--device", "cpu"])
    committed = (REPO / "docs" / "API_torch.md").read_text()
    assert (tmp_path / "docs" / "API_torch.md").read_text() == committed, (
        "docs/API_torch.md is stale; run: python tools/gen_api_docs_torch.py --device cpu")
    for sym in ("fused_attention", "BatchingQueue", "FileWindowStream", "Trainer",
                "MetricsEngine", "conv3d_same_im2col"):
        assert sym in committed, sym
    assert "crowdmod_tpu_torch.ops.kernels.build" not in committed


def test_protocol_variance_two_runs(tmp_path, monkeypatch):
    """``--runs 2`` with the gate's protocol cut to the CPU's size (3 files
    of 4 sequences, T 20, one epoch, one 2-step sampler): per-run rows,
    the JAX tool's summary keys, mean/σ/min/max and floors of the rows."""
    monkeypatch.setattr(protocol_variance_torch, "SAMPLERS", ["DDIM-eta:1.0:2"])
    monkeypatch.setattr(protocol_variance_torch, "GATE_ARGS", [
        "--timesteps", "20", "--train-epochs", "1", "--pred-type", "v", "--ema-decay",
        "0.999", "--files", "3", "--per-file", "4", "--batch-size", "4", "--chunk", "2"])
    out = tmp_path / "pv"
    assert protocol_variance_torch.main(["--runs", "2", "--out", str(out),
                                         "--device", "cpu"]) == 0
    summary = json.loads((out / "summary.json").read_text())
    assert sorted(summary) == ["gate_args", "rows", "runs", "stats", "suggested_floors"]
    rows, s = summary["rows"], "DDIM-eta:1.0:2"
    assert [r["seed"] for r in rows] == [42, 43]
    psnr = np.array([r[s]["PSNR"] for r in rows])
    st = summary["stats"][s]["PSNR"]
    assert st["mean"] == round(float(psnr.mean()), 3)
    assert st["std"] == round(float(psnr.std(ddof=1)), 3)
    assert summary["suggested_floors"][s] == round(psnr.mean() - (2.0 + psnr.std(ddof=1)), 2)
    assert (out / "run_42" / "report.json").exists() and (out / "run_43" / "report.json").exists()


def test_plot_fixed_crowd_figures_are_the_jax_tools(smoke_cfg, tmp_path):
    import pandas as pd

    sys.path.insert(0, str(REPO / "tools"))
    try:
        import plot_fixed_crowd
    finally:
        sys.path.pop(0)
    cfg = smoke_cfg
    rows, cols = cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS
    theta = np.pi - float(cfg.MACROPROPS.THETA)  # ATC4TEST: the ATC convention
    rot = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    lu_r = rot @ np.asarray(list(cfg.MACROPROPS.LU), float)
    lu_r[0] -= cols
    rng = np.random.default_rng(0)
    n_frames = cfg.DATASET.PAST_LEN + cfg.DATASET.FUTURE_LEN
    t0 = pd.Timestamp("2020-01-01 10:00:00")
    recs = []
    for f in range(n_frames):
        for _ in range(10):
            px = lu_r[0] + rng.uniform(0.2, cols - 0.2) * cfg.MACROPROPS.DX
            py = lu_r[1] - rng.uniform(0.2, rows - 0.2) * cfg.MACROPROPS.DY
            raw = rot.T @ np.array([px, py]) * 1000.0
            recs.append({"time": t0 + pd.to_timedelta(f * cfg.MACROPROPS.TIME_RES, "s"),
                         "personID": len(recs), "pos_x": raw[0], "pos_y": raw[1],
                         "vel": rng.uniform(500, 1500),
                         "motion_angle": rng.uniform(-np.pi, np.pi)})
    csv = tmp_path / "agg.csv"
    pd.DataFrame(recs).to_csv(csv, index=False)
    args = ["--config-yml-file", str(REPO / "configs" / "4test" / "ATC.yml"), "--agg-csv",
            str(csv), "--t-init", "2020-01-01 10:00:00"]
    assert plot_fixed_crowd.main(args + ["--out-dir", str(tmp_path / "jax")]) == 0
    assert plot_fixed_crowd_torch.main(args + ["--out-dir", str(tmp_path / "port"),
                                               "--device", "cpu"]) == 0
    files = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == files and f"macroprops_f{n_frames}.png" in files
    assert all((tmp_path / "port" / f).stat().st_size > 0 for f in files)


def test_native_sanitize_front_end(monkeypatch, capsys):
    """The JAX tool's arguments (sanitizer names, both by default) handed
    to the port's harness; an unknown name refused with exit 2."""
    from crowdmod_tpu_torch.native import sanitize

    calls = []
    monkeypatch.setattr(sanitize, "run_one", lambda name, workdir: calls.append(name) or True)
    assert native_sanitize_torch.main(["--device", "cpu"]) == 0
    assert native_sanitize_torch.main(["thread", "--device", "cpu"]) == 0
    assert calls == ["thread", "address", "thread"]
    assert native_sanitize_torch.main(["bogus", "--device", "cpu"]) == 2


def _bash(*args):
    return subprocess.run(["bash", *args], cwd=REPO, capture_output=True, text=True,
                          timeout=60)


@pytest.mark.parametrize("script", ["preflight_torch.sh", "sample_all_datasets_torch.sh"])
def test_shell_twins_parse_and_help(script):
    path = f"tools/{script}"
    assert _bash("-n", path).returncode == 0
    r = _bash(path, "--help")
    assert r.returncode == 0 and "crowdmod_tpu_torch" in r.stdout


def test_sample_all_datasets_dry_run_is_the_jax_loop():
    jax_line = next(ln for ln in (REPO / "tools" / "sample_all_datasets.sh").read_text()
                    .splitlines() if ln.startswith("DATASETS="))
    port_text = (REPO / "tools" / "sample_all_datasets_torch.sh").read_text()
    assert jax_line in port_text.splitlines()
    r = _bash("tools/sample_all_datasets_torch.sh", "--dry-run")
    assert r.returncode == 0, r.stderr
    cmds = [ln for ln in r.stdout.splitlines() if ln.startswith("+ ")]
    datasets = jax_line.split("(")[1].rstrip(")").split()
    assert len(cmds) == len(datasets)
    for ds, cmd in zip(datasets, cmds):
        assert cmd.startswith("+ python -m crowdmod_tpu_torch.cli.generate_samples")
        assert f"configs/{ds}.yml" in cmd and cmd.endswith("--device cuda")
    r = _bash("tools/sample_all_datasets_torch.sh", "--dry-run", "DDPM-DiT", "Dynamic", "cpu")
    assert "--arch DDPM-DiT --plot-type Dynamic --device cpu" in r.stdout


def test_preflight_dry_run_runs_the_ports_gate():
    r = _bash("tools/preflight_torch.sh", "--dry-run")
    assert r.returncode == 0, r.stderr
    cmds = [ln for ln in r.stdout.splitlines() if ln.startswith("+ ")]
    assert cmds[0] == "+ python -m crowdmod_tpu_torch.cli.doctor --skip-mesh --device cuda"
    assert cmds[1].startswith("+ python -m pytest tests/test_torch_")
    assert "-m not slow" in cmds[1] and "tests/test_tools.py" not in cmds[1]
    r = _bash("tools/preflight_torch.sh", "--dry-run", "--slow", "--device", "cpu")
    cmds = [ln for ln in r.stdout.splitlines() if ln.startswith("+ ")]
    assert "--device cpu" in cmds[0] and len(cmds) == 3
