"""The port's command line (``python -m crowdmod_tpu_torch.cli``) against
the JAX package's on the tiny pickle workspace (``conftest.workspace``):
``train`` then ``generate-metrics`` (DDPM-UNet, then ``distill``; FM-DiT
followed by ``reflow``; ConvRNN on the pickles' 4 channels), on the CPU,
give the same checkpoint names and metadata keys, run files, metric CSV
names, headers and columns and manifest keys as ``crowdmod_tpu.cli``'s run,
and the same ``losses.png`` and boxplot PNG names (skipped, with a log line
saying why, where matplotlib is missing).  Every JAX command dispatches in
the port; every command runs on the card unless given ``--device cpu``;
``params`` totals equal the JAX command's."""

import json
import os
import subprocess
import sys

import pytest
import torch
import yaml

from crowdmod_tpu.cli import distill as jax_distill
from crowdmod_tpu.cli import generate_metrics as jax_generate_metrics
from crowdmod_tpu.cli import main as jax_main
from crowdmod_tpu.cli import reflow as jax_reflow
from crowdmod_tpu.cli import train as jax_train
from crowdmod_tpu_torch import cli, export_artifact
from crowdmod_tpu_torch.cli import (
    distill,
    generate_metrics,
    generate_samples,
    import_checkpoint,
    reflow,
    serve,
    sweep,
    train,
)
from crowdmod_tpu_torch.utils import model_info

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "crowdmod_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
        env=None if env is None else {**os.environ, **env},
    )


def _wandb_stub_env(tmp):
    """An environment whose ``wandb`` is a stub that marks ``wandb_init``
    in ``tmp`` when a run is started (and then raises, so nothing waits on
    a network); W&B mode online.  The JAX package's ``reflow`` and
    ``distill`` track locally only, and so must the port's."""
    stub = tmp / "wandb_stub"
    stub.mkdir(exist_ok=True)
    (stub / "wandb.py").write_text(
        "import pathlib\n"
        "def init(**kw):\n"
        f"    pathlib.Path({str(tmp / 'wandb_init')!r}).write_text('init')\n"
        "    raise RuntimeError('W&B stub')\n")
    path = os.pathsep.join(p for p in (str(stub), os.environ.get("PYTHONPATH")) if p)
    return {"PYTHONPATH": path, "WANDB_MODE": "online"}


def _jax_workspace(ws):
    """The workspace config with its own checkpoint and output dirs: both
    packages name their checkpoints alike."""
    cfg = yaml.safe_load(open(ws["cfg"]))
    cfg["DATA_FS"]["SAVE_DIR"] = str(ws["tmp"] / "jax_ckpts")
    cfg["DATA_FS"]["OUTPUT_DIR"] = str(ws["tmp"] / "jax_out")
    path = ws["tmp"] / "jax_cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _csvs(directory):
    """{file name: (header, number of columns)} of a metrics directory."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".csv"):
            with open(os.path.join(directory, name)) as f:
                header, first = f.readline().strip(), f.readline().strip()
            out[name] = (header, len(first.split(",")))
    return out


def test_train_then_generate_metrics_match_jax(workspace):
    ws = workspace
    common = ["--config-yml-file", ws["cfg"], "--configList-yml-file", ws["list"],
              "--arch", "DDPM-UNet"]
    r = _port_cli("train", *common, "--device", "cpu", "--run-dir", str(ws["tmp"] / "run"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert (ws["tmp"] / "run" / "losses.png").exists()
    r = _port_cli("generate-metrics", *common, "--device", "cpu", "--metric", "ALL",
                  "--output-dir", str(ws["tmp"] / "metrics"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "metric means" in r.stdout and "kernel launches" in r.stdout

    jcommon = ["--config-yml-file", _jax_workspace(ws), "--configList-yml-file",
               ws["list"], "--arch", "DDPM-UNet"]
    assert jax_train.run(jcommon + ["--run-dir", str(ws["tmp"] / "jax_run")]) == 0
    assert jax_generate_metrics.run(
        jcommon + ["--metric", "ALL", "--output-dir", str(ws["tmp"] / "jax_metrics")]) == 0

    assert os.listdir(ws["tmp"] / "ckpts") == os.listdir(ws["tmp"] / "jax_ckpts")
    for name in ("events.jsonl", "config.json"):
        assert (ws["tmp"] / "run" / name).exists() and (ws["tmp"] / "jax_run" / name).exists()
    events = [json.loads(line) for line in open(ws["tmp"] / "run" / "events.jsonl")]
    jax_events = [json.loads(line) for line in open(ws["tmp"] / "jax_run" / "events.jsonl")]
    assert [sorted(e) for e in events] == [sorted(e) for e in jax_events]

    port_csvs = _csvs(ws["tmp"] / "metrics")
    assert len(port_csvs) == 20 and port_csvs == _csvs(ws["tmp"] / "jax_metrics")
    manifest = json.loads((ws["tmp"] / "metrics" / "metrics_files.json").read_text())
    jax_manifest = json.loads((ws["tmp"] / "jax_metrics" / "metrics_files.json").read_text())
    assert manifest.keys() == jax_manifest.keys()
    assert manifest["title"] == jax_manifest["title"]
    assert {os.path.basename(v) for k, v in manifest.items() if k != "title"} == set(port_csvs)
    assert (ws["tmp"] / "jax_run" / "losses.png").exists()
    pngs = sorted(p for p in os.listdir(ws["tmp"] / "metrics") if p.endswith(".png"))
    assert pngs == sorted(p for p in os.listdir(ws["tmp"] / "jax_metrics")
                          if p.endswith(".png"))
    assert pngs == ["BP_BHATT.png", "BP_ENERGY.png", "BP_MF_MSE.png", "BP_PSNR.png",
                    "BP_RE_DENSITY.png", "BP_SSIM.png"]
    assert os.path.exists(ws["tmp"] / "out" / "logs" / "genMetrics.log")

    # distill on the trained checkpoint (T = 5: one phase, 2 → 1 steps).
    steps = ["--steps", "1", "--start-steps", "2", "--epochs-per-phase", "1"]
    r = _port_cli("distill", *common, *steps, "--device", "cpu",
                  env=_wandb_stub_env(ws["tmp"]))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "distillation complete" in r.stdout and "kernel launches" in r.stdout
    assert not (ws["tmp"] / "wandb_init").exists()  # local tracking only, as JAX's
    assert jax_distill.run(jcommon + steps) == 0
    names = sorted(os.listdir(ws["tmp"] / "ckpts"))
    assert names == sorted(os.listdir(ws["tmp"] / "jax_ckpts"))
    d001 = [n for n in names if "_CED001" in n]
    assert len(d001) == 1
    meta = json.loads((ws["tmp"] / "ckpts" / d001[0] / "metadata.json").read_text())
    jax_meta = json.loads((ws["tmp"] / "jax_ckpts" / d001[0] / "metadata.json").read_text())
    assert sorted(meta) == sorted(jax_meta)
    assert meta["distilled_steps"] == jax_meta["distilled_steps"] == 1
    assert os.path.exists(ws["tmp"] / "out" / "logs" / "distill.log")


def _fm_workspace(ws):
    """The workspace config with a small FM-DiT (hidden 32, depth 1) and a
    3-step Euler integrator."""
    cfg = yaml.safe_load(open(ws["cfg"]))
    fm = cfg["MODEL"]["FM"]
    fm.update({"CHECKPOINTS_TO_KEEP": 0, "INTEGRATOR_STEPS": {"EULER": 3, "HEUN": 2}})
    fm["DIT"].update({"HIDDEN_SIZE": 32, "DEPTH": 1, "NUM_HEADS": 2, "DROPOUT_RATE": 0.0})
    fm["DIT"]["TRAIN"]["EPOCHS"] = 1
    path = ws["tmp"] / "fm_cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    return {**ws, "cfg": str(path)}


def test_fm_dit_train_metrics_reflow_match_jax(workspace):
    """FM-DiT through ``train → generate-metrics → reflow``: the best-loss
    and the ``RF1`` checkpoints, the CSVs and the manifest under the JAX
    package's names."""
    ws = _fm_workspace(workspace)
    common = ["--config-yml-file", ws["cfg"], "--configList-yml-file", ws["list"],
              "--arch", "FM-DiT"]
    r = _port_cli("train", *common, "--device", "cpu", "--run-dir", str(ws["tmp"] / "run"))
    assert r.returncode == 0, r.stdout + r.stderr
    r = _port_cli("generate-metrics", *common, "--device", "cpu", "--metric", "ALL",
                  "--output-dir", str(ws["tmp"] / "metrics"))
    assert r.returncode == 0, r.stdout + r.stderr
    r = _port_cli("reflow", *common, "--device", "cpu", "--rounds", "1",
                  "--epochs-per-round", "1", "--coupling-steps", "2",
                  env=_wandb_stub_env(ws["tmp"]))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "reflow complete" in r.stdout and "kernel launches" in r.stdout
    assert not (ws["tmp"] / "wandb_init").exists()  # local tracking only, as JAX's

    jcommon = ["--config-yml-file", _jax_workspace(ws), "--configList-yml-file",
               ws["list"], "--arch", "FM-DiT"]
    assert jax_train.run(jcommon + ["--run-dir", str(ws["tmp"] / "jax_run")]) == 0
    assert jax_generate_metrics.run(
        jcommon + ["--metric", "ALL", "--output-dir", str(ws["tmp"] / "jax_metrics")]) == 0
    assert jax_reflow.run(jcommon + ["--rounds", "1", "--epochs-per-round", "1",
                                     "--coupling-steps", "2"]) == 0

    names = sorted(os.listdir(ws["tmp"] / "ckpts"))
    assert names == sorted(os.listdir(ws["tmp"] / "jax_ckpts"))
    assert [n.rsplit("_CE", 1)[1] for n in names] == ["000_Linear", "RF1_Linear"]
    port_csvs = _csvs(ws["tmp"] / "metrics")
    assert len(port_csvs) == 20 and port_csvs == _csvs(ws["tmp"] / "jax_metrics")
    manifest = json.loads((ws["tmp"] / "metrics" / "metrics_files.json").read_text())
    jax_manifest = json.loads((ws["tmp"] / "jax_metrics" / "metrics_files.json").read_text())
    assert manifest.keys() == jax_manifest.keys()
    assert manifest["title"] == jax_manifest["title"]
    assert os.path.exists(ws["tmp"] / "out" / "logs" / "reflow.log")


def _convrnn_workspace(ws):
    """The workspace config with a small ConvRNN (4–8 channels)."""
    cfg = yaml.safe_load(open(ws["cfg"]))
    cfg["MODEL"]["CONVRNN"].update({
        "ENC_HIDDEN_CH": [4, 6, 6, 8, 8, 8], "FORC_HIDDEN_CH": [8, 8, 8, 8, 8, 6, 4],
        "CHECKPOINTS_TO_KEEP": 0})
    cfg["MODEL"]["CONVRNN"]["TRAIN"]["EPOCHS"] = 1
    path = ws["tmp"] / "convrnn_cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    return {**ws, "cfg": str(path)}


def test_convrnn_train_then_generate_metrics_match_jax(workspace):
    """ConvRNN through ``train → generate-metrics`` on the pickles' 4
    channels (the metrics on the first 3): the same checkpoint names, CSVs
    and manifest as the JAX package's run."""
    ws = _convrnn_workspace(workspace)
    common = ["--config-yml-file", ws["cfg"], "--configList-yml-file", ws["list"],
              "--arch", "ConvRNN"]
    one_thread = {"OMP_NUM_THREADS": "1"}  # small CPU convolutions
    r = _port_cli("train", *common, "--device", "cpu", "--run-dir", str(ws["tmp"] / "run"),
                  env=one_thread)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "mprops_count=4" in r.stdout
    r = _port_cli("generate-metrics", *common, "--device", "cpu", "--metric", "ALL",
                  "--output-dir", str(ws["tmp"] / "metrics"), env=one_thread)
    assert r.returncode == 0, r.stdout + r.stderr
    launches = json.loads(r.stdout.rsplit("kernel launches: ", 1)[1].splitlines()[0])
    assert set(launches.values()) == {0}  # ConvRNN runs library convolutions only

    jcommon = ["--config-yml-file", _jax_workspace(ws), "--configList-yml-file",
               ws["list"], "--arch", "ConvRNN"]
    assert jax_train.run(jcommon + ["--run-dir", str(ws["tmp"] / "jax_run")]) == 0
    assert jax_generate_metrics.run(
        jcommon + ["--metric", "ALL", "--output-dir", str(ws["tmp"] / "jax_metrics")]) == 0
    names = sorted(os.listdir(ws["tmp"] / "ckpts"))
    assert names == sorted(os.listdir(ws["tmp"] / "jax_ckpts")) and "GRU" in names[0]
    port_csvs = _csvs(ws["tmp"] / "metrics")
    assert len(port_csvs) == 20 and port_csvs == _csvs(ws["tmp"] / "jax_metrics")
    manifest = json.loads((ws["tmp"] / "metrics" / "metrics_files.json").read_text())
    jax_manifest = json.loads((ws["tmp"] / "jax_metrics" / "metrics_files.json").read_text())
    assert manifest.keys() == jax_manifest.keys()
    assert manifest["title"] == jax_manifest["title"] and "(ConvRNN)" in manifest["title"]


def test_every_jax_command_is_ported_or_named(capsys):
    """The port dispatches every command of the JAX package's, and no other."""
    jax_main(["--help"])
    usage = capsys.readouterr().out
    jax_commands = set(usage.split("{", 1)[1].split("}", 1)[0].split(","))
    assert jax_commands == set(cli.COMMANDS) and len(jax_commands) == 14
    assert not hasattr(cli, "NOT_PORTED")


# The five commands that once exited 2 here: each now dispatches to its
# port module (``--help`` is its own parser's, exit 0).
LATE_COMMANDS = {"compare": "crowdmod_tpu_torch.viz.compare_models",
                 "doctor": "crowdmod_tpu_torch.cli.doctor",
                 "generate-samples": "crowdmod_tpu_torch.cli.generate_samples",
                 "sweep": "crowdmod_tpu_torch.cli.sweep",
                 "view": "crowdmod_tpu_torch.viz.html_viewer"}


@pytest.mark.parametrize("command", sorted(LATE_COMMANDS))
def test_unported_command_exits_2_naming_its_item(command, capsys, monkeypatch):
    import importlib

    module = importlib.import_module(LATE_COMMANDS[command])
    ran = []
    monkeypatch.setattr(module, "run", lambda argv: ran.append(argv) or 0)
    assert cli.COMMANDS[command] == LATE_COMMANDS[command]
    assert cli.main([command, "--config-yml-file", "x.yml"]) == 0
    assert ran == [["--config-yml-file", "x.yml"]]
    monkeypatch.undo()
    with pytest.raises(SystemExit) as e:
        cli.main([command, "--help"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_help_unknown_and_module_entry(capsys):
    assert cli.main(["--help"]) == 0
    assert "generate-samples" in capsys.readouterr().out
    assert cli.main(["bogus"]) == 2
    r = _port_cli("doctor", "--device", "cpu", "--skip-mesh")
    assert r.returncode == 0 and "crowdmod doctor" in r.stdout, r.stdout + r.stderr


def test_plots_skipped_without_matplotlib(workspace, monkeypatch, capsys):
    """Where matplotlib is missing, ``train`` and ``generate-metrics`` still
    exit 0, write no PNG, and log that matplotlib is why."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ws = workspace
    common = ["--config-yml-file", ws["cfg"], "--configList-yml-file", ws["list"],
              "--arch", "DDPM-UNet", "--device", "cpu"]
    assert train.run(common + ["--run-dir", str(ws["tmp"] / "run")]) == 0
    assert generate_metrics.run(common + ["--metric", "PSNR", "--output-dir",
                                          str(ws["tmp"] / "metrics")]) == 0
    out = capsys.readouterr().out
    assert "losses.png not written: matplotlib is not installed" in out
    assert "boxplots not written: matplotlib is not installed" in out
    assert not list(ws["tmp"].rglob("*.png"))
    assert (ws["tmp"] / "metrics" / "metrics_files.json").exists()


# Each command's required arguments besides the config.
REQUIRED = {serve: [], export_artifact: ["--output", "x.pt2"], model_info: [],
            import_checkpoint: ["--torch-ckpt", "x.pt"]}


@pytest.mark.parametrize("module", [train, generate_metrics, reflow, distill, serve,
                                    export_artifact, import_checkpoint, model_info,
                                    generate_samples, sweep])
def test_commands_default_to_the_card(module, workspace):
    args = module.build_parser().parse_args(REQUIRED.get(module, []))
    assert args.device == "cuda"
    if torch.cuda.is_available():
        return
    argv = ["--config-yml-file", workspace["cfg"], "--configList-yml-file",
            workspace["list"], *REQUIRED.get(module, [])]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run(argv)


def test_params_totals_match_jax(workspace, capsys):
    """``params --all-archs``: every arch's total equals the JAX command's."""
    from crowdmod_tpu.utils import model_info as jax_model_info

    argv = ["--config-yml-file", workspace["cfg"], "--all-archs"]
    assert jax_model_info.run(argv) == 0
    want = [line for line in capsys.readouterr().out.splitlines() if "trainable" in line]
    assert cli.main(["params", *argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = [line for line in out.splitlines() if "trainable" in line]
    assert got == want and len(got) == 5
    assert "  encoder_blocks:" in out  # the port's top-level modules


def test_train_exits_1_on_a_nan_abort(workspace, monkeypatch):
    from crowdmod_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "fit", lambda self, *a, **kw: {"aborted": True})
    argv = ["--config-yml-file", workspace["cfg"], "--configList-yml-file",
            workspace["list"], "--device", "cpu", "--run-dir",
            str(workspace["tmp"] / "run")]
    assert train.run(argv) == 1
