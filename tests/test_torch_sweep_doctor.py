"""``sweep`` and ``doctor`` of the port, and the native sanitizer harness.

The sweep's search spaces, trials (numpy's ``default_rng(seed)``), config
overrides and W&B configuration equal the JAX command's; a 2-trial sweep
on the tiny pickle workspace writes its records and ``best.json``; the
``--wandb`` path runs through a stub agent; a failing trial is logged and
recorded, and the sweep goes on.  ``doctor --device cpu`` passes with
warnings (the device and kernel checks never ``ok`` on the CPU), the
default ``--device cuda`` exits 1 here with the device check FAIL, the
2-process gloo mesh check passes.  The sanitizer harness passes under TSan
and ASan + UBSan against the port's native source."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from crowdmod_tpu.cli import sweep as jax_sweep
from crowdmod_tpu_torch import cli
from crowdmod_tpu_torch.cli import doctor, sweep

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("DDPM-UNet", "FM-DiT", "ConvRNN")


@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_trials_match_jax(arch):
    space = sweep.sweep_space(arch)
    assert space == jax_sweep.sweep_space(arch)
    assert sweep.wandb_sweep_configuration(arch) == jax_sweep.wandb_sweep_configuration(arch)
    for seed in (0, 42):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(5):
            trial = sweep.sample_trial(space, rng)
            assert trial == jax_sweep.sample_trial(space, jrng)
            assert sweep.trial_overrides(arch, trial) == jax_sweep.trial_overrides(arch, trial)
    with pytest.raises(ValueError, match="not supported"):
        sweep.sweep_space("DDPM-Nope")


def _common(ws, *extra):
    return ["--config-yml-file", ws["cfg"], "--configList-yml-file", ws["list"],
            "--arch", "DDPM-UNet", "--device", "cpu", *extra]


def _records(path):
    return [json.loads(line) for line in open(path)]


def _more_windows(ws, seqs=16):
    """The workspace's pickles with ``seqs`` sequences each (2 windows a
    sequence): enough full batches for the sampled batch sizes 16 and 32."""
    import pickle

    import yaml

    rng = np.random.default_rng(1)
    for k in range(3):
        arr = np.abs(rng.normal(size=(seqs, 4, 8, 12, 16))).astype(np.float32)
        with open(ws["tmp"] / "pickle" / f"f{k}.pkl", "wb") as f:
            pickle.dump(arr, f)
    (ws["tmp"] / "list.yml").write_text(yaml.safe_dump(
        {"DATA_LIST": [[f"f{k}.pkl", seqs] for k in range(3)]}))


def test_sweep_two_trials(workspace):
    """Seed 42's two trials (batch 32 base 32, batch 16 base 64) train one
    epoch each to a finite loss."""
    ws = workspace
    _more_windows(ws)
    out = ws["tmp"] / "sweep"
    assert cli.main(["sweep", *_common(ws, "--trials", "2", "--epochs-per-trial", "1",
                                       "--sweep-dir", str(out))]) == 0
    records = _records(out / "sweep_results.jsonl")
    rng = np.random.default_rng(42)
    space = jax_sweep.sweep_space("DDPM-UNet")
    assert [r["params"] for r in records] == [
        json.loads(json.dumps(jax_sweep.sample_trial(space, rng))) for _ in range(2)]
    assert [r["trial"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in records)
    best = json.loads((out / "best.json").read_text())
    assert best["trial"] in (0, 1)
    assert best["loss"] == min(r["train_loss"] for r in records)
    log = (out / "sweep.log").read_text()
    assert "kernel launches: " in log and "sweep done; best trial" in log
    assert sorted(p for p in os.listdir(out) if p.startswith("trial_")) == [
        "trial_000", "trial_001"]


def test_sweep_wandb_agent_and_failing_trial(workspace, monkeypatch):
    """``--wandb`` through a stub of the W&B agent (it samples the sweep
    configuration and calls the trial function); a trial whose ``fit``
    raises is logged with its traceback and recorded with a NaN loss, and
    the next trial runs."""
    ws = workspace
    logged = []
    fake = types.ModuleType("wandb")

    def _sweep(sweep, project=None):
        fake.cfg = sweep
        assert sweep["method"] == "random"
        assert sweep["metric"] == {"goal": "minimize", "name": "train_loss"}
        return "sweep-123"

    def _agent(sweep_id, function, count=1):
        assert sweep_id == "sweep-123"
        rng = np.random.default_rng(0)
        for _ in range(count):
            fake.current = sweep.sample_trial({"parameters": fake.cfg["parameters"]}, rng)
            fake.current.update(base_ch=8, batch_size=4)  # the workspace's tiny grid
            function()

    fake.sweep, fake.agent = _sweep, _agent
    fake.init = lambda *a, **k: types.SimpleNamespace(config=dict(fake.current))
    fake.log = logged.append
    fake.finish = lambda: None
    monkeypatch.setitem(sys.modules, "wandb", fake)

    from crowdmod_tpu_torch.train.trainer import Trainer

    fit, calls = Trainer.fit, []

    def fit_failing_first(self, *a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise FloatingPointError("diverged")
        return fit(self, *a, **kw)

    monkeypatch.setattr(Trainer, "fit", fit_failing_first)
    out = ws["tmp"] / "wsweep"
    assert sweep.run(_common(ws, "--trials", "2", "--epochs-per-trial", "1", "--wandb",
                             "--sweep-dir", str(out))) == 0
    records = _records(out / "sweep_results.jsonl")
    assert len(records) == 2 and len(calls) == 2
    assert np.isnan(records[0]["train_loss"]) and records[0]["val_loss"] is None
    assert np.isfinite(records[1]["train_loss"])
    assert "trial 0 failed" in (out / "sweep.log").read_text()
    assert "FloatingPointError: diverged" in (out / "sweep.log").read_text()
    assert {"train_loss": records[1]["train_loss"]} in logged


def test_doctor_on_the_cpu(capsys):
    """``--device cpu``: exit 0, the device and kernel checks warn (never
    ok), the host checks pass."""
    assert doctor.run(["--device", "cpu", "--skip-mesh"]) == 0
    out = capsys.readouterr().out
    lines = {ln.split("[")[0].strip(): ln for ln in out.splitlines() if "[" in ln}
    assert "[warn] not built: CPU" in lines["device"] and "[warn] not built: CPU" in \
        lines["kernels"]
    for name in ("native runtime", "shipped configs", "checkpoint io"):
        assert "[ok]" in lines[name], lines[name]
    assert "3 ok, 2 warnings, 0 failures" in out


def test_doctor_default_fails_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["doctor", "--skip-mesh"]) == 1
    out = capsys.readouterr().out
    assert "device                      [FAIL] CUDA is not available" in out
    assert "kernels                     [FAIL] not built" in out
    assert "2 failures" in out


def test_doctor_mesh_kernels_and_cache_flags(tmp_path, capsys):
    """The 2-process gloo mesh check passes; the kernel probes (on the CPU,
    the twins) are within their tolerances; the JAX command's
    ``--compile-cache`` and ``--no-compile-cache`` are refused (exit 2):
    the kernel libraries are always cached by the hash of their sources."""
    results = []
    doctor.check_mesh(results)
    assert results[0][:2] == ("mesh (2 processes)", "ok"), results
    probes = doctor.kernel_probes("cpu")
    assert set(probes) == {"fused_attention", "fused_ancestral_update", "fused_group_norm",
                           "conv3d_same_im2col", "conv3d_same_tapgemm", "fused_resblock"}
    assert all(err <= tol for err, tol in probes.values()), probes
    for flags in (["--no-compile-cache"], ["--compile-cache", str(tmp_path)]):
        with pytest.raises(SystemExit) as exc:
            doctor.run(flags)
        assert exc.value.code == 2
        assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.parametrize("sanitizer", ["thread", "address"])
def test_sanitizer_harness(sanitizer):
    """Every native entry point under TSan / ASan + UBSan, in a bare
    process (``python -m crowdmod_tpu_torch.native.sanitize``)."""
    proc = subprocess.run([sys.executable, "-m", "crowdmod_tpu_torch.native.sanitize",
                           sanitizer], capture_output=True, text=True, timeout=300,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"[{sanitizer}] PASS" in proc.stdout and "sanitize_harness OK" in proc.stdout


def test_sanitized_native_build_is_its_own_library(monkeypatch):
    from crowdmod_tpu_torch.native import build, sanitize

    plain = build.library_path()
    assert build.flags() == build.FLAGS
    monkeypatch.setenv("CROWDMOD_NATIVE_SANITIZE", "thread")
    assert build.flags()[:3] == ("-O1", "-g", "-fsanitize=thread")
    assert "-O3" not in build.flags() and build.library_path() != plain
    monkeypatch.setenv("CROWDMOD_NATIVE_SANITIZE", "nonsense")
    assert build.library_path() == plain
    assert sanitize.main(["memory"]) == 2
    assert "-fsanitize=address,undefined" in build.flags("address")
    # One set of sanitized flags: the harness is built with the library's.
    for name in build.SANITIZERS:
        cmd = sanitize.harness_command("g++", name, "harness")
        assert cmd[1:-4] == [f for f in build.flags(name) if f not in ("-shared", "-fPIC")]
        assert cmd[-4:] == [str(build.SRC), str(sanitize.SRC / "sanitize_harness.cpp"),
                            "-o", "harness"]
