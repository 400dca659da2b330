"""The port's sweep tools (``tools/ddim_sweep_torch.py``,
``tools/lambda_sweep_torch.py``) against the JAX tools on the CPU
(``--device cpu``), on conftest's tiny workspace, off one checkpoint in
each package's format (the JAX weights carried by ``state_dict_from_jax``):
the same output trees, and the DDIM sweep's metric CSVs within
``tests/test_torch_metrics.py``'s tolerances with the JAX protocol's draws
injected.  (The other tools: ``tests/test_torch_tools.py``.)
"""

import json
from pathlib import Path

import pytest
import torch
import yaml

from tests import torch_geometries as geo
from tests.test_torch_metrics import _assert_close, _jax_protocol_draws, _read_csv
from tools import ddim_sweep as jax_ddim_sweep
from tools import ddim_sweep_torch, lambda_sweep_torch
from tools import lambda_sweep as jax_lambda_sweep

ARCH = "DDPM-UNet"


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the models are tiny, and the test workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _tree(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def _checkpoints(ws) -> str:
    """One DDPM-UNet checkpoint ``000`` in each package's format, the same
    weights (``tests/torch_geometries.py``'s, from the JAX model's shapes):
    the JAX one under the SAVE_DIR of a copy of the workspace config (→ its
    path), the port's under the workspace's own."""
    from crowdmod_tpu.config import load_config as jax_load_config
    from crowdmod_tpu.models.factory import build_backbone as jax_build_backbone
    from crowdmod_tpu.train import checkpoint as jax_ckpt
    from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg = yaml.safe_load(open(ws["cfg"]))
    cfg["DATA_FS"]["SAVE_DIR"] = str(ws["tmp"] / "jax_ckpts")
    cfg["DATA_FS"]["OUTPUT_DIR"] = str(ws["tmp"] / "jax_out")
    jax_cfg = ws["tmp"] / "jax_cfg.yml"
    jax_cfg.write_text(yaml.safe_dump(cfg))

    jcfg = jax_load_config(str(jax_cfg), ws["list"])
    params = geo.random_params(jax_build_backbone(jcfg, ARCH), geo.inputs(jcfg, 0), 3)
    jax_ckpt.save_checkpoint(
        str(ws["tmp"] / "jax_ckpts" / jax_ckpt.checkpoint_name(jcfg, ARCH, "000")),
        {"params": {"params": params}}, jax_ckpt.build_metadata(jcfg, ARCH, "000"))
    pcfg = load_config(ws["cfg"], ws["list"])
    tr = Trainer(pcfg, ARCH, device="cpu", seed=0)
    tr.model.load_state_dict(state_dict_from_jax(params))
    tr.save(pcfg.DATA_FS.SAVE_DIR, "000")
    return str(jax_cfg)


def test_sweeps_match_jax(workspace, monkeypatch):
    """Off one checkpoint in each package's format: ``lambda_sweep`` at one
    λ with the viewer, the JAX tool's tree (configs, samples, GIFs, log,
    viewer); ``ddim_sweep --skip-samples`` at one divider, PSNR, the JAX
    tool's tree and its CSVs within the metric tolerances (the JAX
    selection and DDIM noise injected into the port's protocol)."""
    from crowdmod_tpu_torch.train.trainer import Trainer

    ws = workspace
    jax_cfg = _checkpoints(ws)
    lam = ["--configList-yml-file", ws["list"], "--arch", ARCH, "--lambdas", "0.01", "--view"]
    jroot, proot = ws["tmp"] / "jax_lambda", ws["tmp"] / "port_lambda"
    assert jax_lambda_sweep.main(["--config-yml-file", jax_cfg, *lam,
                                  "--output-root", str(jroot)]) == 0
    assert lambda_sweep_torch.main(["--config-yml-file", ws["cfg"], *lam, "--output-root",
                                    str(proot), "--device", "cpu"]) == 0
    assert _tree(proot) == _tree(jroot)
    assert (proot / "run_lambda_0.01").is_dir() and (proot / "lambda_viewer.html").exists()

    sweep = ["--configList-yml-file", ws["list"], "--arch", ARCH, "--dividers", "2",
             "--metric", "PSNR", "--chunk-repd-past-seq", "2", "--skip-samples"]
    jroot, proot = ws["tmp"] / "jax_sweep", ws["tmp"] / "port_sweep"
    assert jax_ddim_sweep.main(["--config-yml-file", jax_cfg, *sweep,
                                "--output-root", str(jroot)]) == 0
    shape = (8, 3, 8, 12, 3)  # BATCH_SIZE 4 × chunk 2 samples of (F, H, W, 3)
    generate = Trainer.generate_metrics

    def injected(self, ds, **kw):
        draws = iter(_jax_protocol_draws(kw["seed"], min(len(ds), shape[0]), shape[0],
                                         shape, self.cfg.MODEL.DDPM.TIMESTEPS, 1))
        return generate(self, ds, draws=lambda: next(draws), **kw)

    monkeypatch.setattr(Trainer, "generate_metrics", injected)
    assert ddim_sweep_torch.main(["--config-yml-file", ws["cfg"], *sweep, "--output-root",
                                  str(proot), "--device", "cpu"]) == 0
    assert _tree(proot) == _tree(jroot)
    jm = json.loads((jroot / "DDIM_2" / "metrics_files.json").read_text())
    pm = json.loads((proot / "DDIM_2" / "metrics_files.json").read_text())
    assert pm.keys() == jm.keys() and len(jm) > 1
    for name in (k for k in jm if k != "title"):
        h_j, v_j = _read_csv(jroot / "DDIM_2" / Path(jm[name]).name)
        h_p, v_p = _read_csv(proot / "DDIM_2" / Path(pm[name]).name)
        assert h_p == h_j and v_p.shape == v_j.shape, name
        _assert_close("ddim_sweep csv", name, v_p, v_j, {}, atol=1e-4)
