"""The port's operational drills (``tools/*_torch.py``) at toy size on the
CPU (``--device cpu``), against the JAX tools where they share data.

  * the training drill: a real ``train`` process SIGINT'd at epoch 2 of 6,
    resumed with ``--resume`` to the end; every check of the JAX tool's
    report true, and the emergency checkpoint whole on disk;
  * the HTTP soak: 3 clients for 3 s, no error, a coalesced dispatch, the
    JAX tool's report keys.

The data drills (ETL, protocol, stream) are in ``test_torch_data_drills.py``.
"""

import ast
import json
from pathlib import Path

import pytest
import torch
import yaml

from crowdmod_tpu_torch.config import load_config
from tools import soak_http_torch, training_drill_torch

REPO = Path(__file__).resolve().parents[1]

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



def _narrow_config(path: Path, base: str, node: dict) -> str:
    """``base`` with the ``MODEL.DDPM`` overrides ``node``, written as YAML:
    the CPU's model for a drill the card runs at full width."""
    cfg = load_config(base).updated({"MODEL": {"DDPM": node}})
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return str(path)


def test_training_drill_kill_and_resume(tmp_path):
    cfg = _narrow_config(tmp_path / "narrow.yml", "ATC.yml", {"UNET": {
        "BASE_CH": 8, "BASE_CH_MULT": [1, 2], "APPLY_ATTENTION": [False, True]}})
    out = tmp_path / "drill"
    rc = training_drill_torch.main([
        "--out", str(out), "--epochs", "6", "--kill-epoch", "2", "--files", "4",
        "--per-file", "2", "--batch-size", "4", "--config-yml-file", cfg,
        "--device", "cpu", "--timeout", "240"])
    report = json.loads((out / "report.json").read_text())
    checks = report["checks"]
    assert rc == 0 and all(checks.values()), checks
    assert set(checks) == {"abort_checkpoint_whole", "continuity", "plateau_state_resumed",
                           "best_ckpt_is_global_best", "best_ckpt_loads",
                           "abort_gc_on_completion", "retention_policy"}
    assert "plateau_lr_note" in report  # under 100 epochs, as the JAX tool
    p1, p2 = report["phase1"], report["phase2"]
    assert 2 <= p1["killed_at_epoch"] < 6 and p1["abort_checkpoint_whole"]
    assert p2["rc"] == 0 and p1["epochs_logged"] + p2["epochs_logged"] == 6
    assert "SIGINT received" in (out / "phase1.log").read_text()
    assert "resumed from emergency checkpoint" in (out / "phase2.log").read_text()


def _jax_report_keys() -> set:
    """The keys of the report dict in the JAX tool's source."""
    tree = ast.parse((REPO / "tools" / "soak_http.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "report" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no report dict in tools/soak_http.py")


def test_http_soak(tmp_path):
    cfg = _narrow_config(tmp_path / "narrow.yml", "4test/ATC.yml", {
        "TIMESTEPS": 50, "DIT": {"HIDDEN_SIZE": 64, "DEPTH": 2}})
    out = tmp_path / "report.json"
    rc = soak_http_torch.main([
        "--config-yml-file", cfg, "--sampler", "DDIM-eta:1.0:5+Sparsity:0.6",
        "--clients", "3", "--duration", "3", "--ramp-s", "1", "--batch-buckets", "1", "8",
        "--train-epochs", "1", "--workdir", str(tmp_path / "work"), "--out", str(out),
        "--device", "cpu"])
    report = json.loads(out.read_text())
    assert rc == 0 and report["errors"] == 0, report
    assert _jax_report_keys() <= set(report)
    assert report["coalesced_requests"] > 0  # a dispatch served several requests
    assert report["requests_total"] > 0 and report["latency_ms"]["p50"] > 0
    assert report["predictions"] == report["dispatches"] + 2  # + a warmup call a bucket
