"""``generate-samples`` of the port against the JAX command on the tiny
pickle workspace (``conftest.workspace``, DDPM-UNet, T = 5): the weights
cross over from the JAX checkpoint (``state_dict_from_jax``), the JAX
key stream's window permutation and sampler noise are injected, and the
port writes the same files as the JAX run, its SVG byte for byte equal to
JAX's.  Also: the GIF run, ``--data-parallel`` on the CPU (a world of one
over gloo) drawing the plain run's samples, the tracker's artifact records, the
exit status 2 on a host without matplotlib, and the device half alone."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from crowdmod_tpu.cli import generate_samples as jax_generate_samples
from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
from crowdmod_tpu_torch import cli
from crowdmod_tpu_torch.cli import generate_samples
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.train.trainer import ProtocolDraws, Trainer

ARCH, SEED, NSAMPLES = "DDPM-UNet", 42, 2


@pytest.fixture(autouse=True)
def fixed_svg(monkeypatch):
    import matplotlib

    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    monkeypatch.setitem(matplotlib.rcParams, "svg.hashsalt", "crowdmod")


def _config(ws, name: str) -> str:
    """The workspace config with its own checkpoint and output dirs (both
    packages name their checkpoints alike) and two samples to plot."""
    cfg = yaml.safe_load(open(ws["cfg"]))
    cfg["DATA_FS"]["SAVE_DIR"] = str(ws["tmp"] / f"{name}_ckpts")
    cfg["DATA_FS"]["OUTPUT_DIR"] = str(ws["tmp"] / f"{name}_out")
    cfg["MODEL"]["NSAMPLES4PLOTS"] = NSAMPLES
    path = ws["tmp"] / f"{name}_cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _checkpoints(ws) -> tuple[str, str]:
    """A JAX checkpoint of perturbed weights and the port's of the same
    weights → (JAX config, port config)."""
    jcfg_path, cfg_path = _config(ws, "jax"), _config(ws, "port")
    jcfg = jax_load_config(jcfg_path, ws["list"])
    jtr = JaxTrainer(jcfg, ARCH, seed=SEED).setup()
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0, 0.05, np.shape(a)).astype(np.float32), jtr.state.params)
    jtr.state = jtr.state.replace(params=params)
    jtr.save(jcfg.DATA_FS.SAVE_DIR, "000")
    cfg = load_config(cfg_path, ws["list"])
    tr = Trainer(cfg, ARCH, device="cpu", seed=SEED).setup()
    tr.model.load_state_dict(state_dict_from_jax(params["params"]))
    tr.save(cfg.DATA_FS.SAVE_DIR, "000")
    return jcfg_path, cfg_path


def _jax_draws(cfg, n_windows: int) -> ProtocolDraws:
    """The JAX command's draws: ``split(PRNGKey(seed))`` into the window
    permutation's key and the DDPM sampler's (x_T, then each step's
    ``fold_in``)."""
    ksel, ksamp = jax.random.split(jax.random.PRNGKey(SEED))
    k_init, k_loop = jax.random.split(ksamp)
    shape = (NSAMPLES, cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    noise = {None: jax.random.normal(k_init, shape, jnp.float32)}
    for t in range(cfg.MODEL.DDPM.TIMESTEPS):
        noise[t] = jax.random.normal(jax.random.fold_in(k_loop, t), shape, jnp.float32)
    return ProtocolDraws(
        perm=torch.from_numpy(np.array(jax.random.permutation(ksel, n_windows))),
        noise=lambda t: torch.from_numpy(np.array(noise[t])))


def _args(cfg_path, ws, out, *extra):
    return ["--config-yml-file", cfg_path, "--configList-yml-file", ws["list"],
            "--arch", ARCH, "--seed", str(SEED), "--output-dir", str(out), *extra]


def _events(path):
    return [json.loads(line) for line in open(path / "events.jsonl")]


def test_generate_samples_matches_jax(workspace):
    ws = workspace
    jcfg_path, cfg_path = _checkpoints(ws)
    static = ["--plot-type", "Static", "--plot-mprop", "Density"]
    assert jax_generate_samples.run(_args(jcfg_path, ws, ws["tmp"] / "jax", *static)) == 0

    from crowdmod_tpu_torch.data.ingest import get_test_dataset

    cfg = load_config(cfg_path, ws["list"])
    draws = _jax_draws(cfg, len(get_test_dataset(cfg, 3, seed=SEED, device="cpu")))
    assert generate_samples.run(_args(cfg_path, ws, ws["tmp"] / "port", *static, "--device",
                                      "cpu"), draws=draws) == 0
    got, want = ws["tmp"] / "port", ws["tmp"] / "jax"
    names = sorted(os.listdir(got))
    assert names == sorted(os.listdir(want))
    assert names == ["config.json", "events.jsonl",
                     "mpSampling_DDPM-UNet_4Density_TE1_PL5_FL3_CE000_NA.svg",
                     "rho_seq_1.png", "rho_seq_2.png"]
    svg = names[2]
    assert (got / svg).read_bytes() == (want / svg).read_bytes()
    events, jax_events = _events(got), _events(want)
    assert [(e["artifact"].replace(str(got), ""), e["kind"]) for e in events] == \
        [(e["artifact"].replace(str(want), ""), e["kind"]) for e in jax_events]
    assert [sorted(e) for e in events] == [sorted(e) for e in jax_events]
    assert json.loads((got / "config.json").read_text()).keys() == \
        json.loads((want / "config.json").read_text()).keys()
    log = ws["tmp"] / "port_out" / "logs" / "genSamples.log"
    assert "sample L1 norm: " in log.read_text() and "kernel launches: " in log.read_text()

    # The device half alone, from the same draws: the samples, their L1
    # norm and the overlays (on the samples' device) it reports.
    args = generate_samples.build_parser().parse_args(_args(cfg_path, ws, got))
    out = generate_samples.sample_sequences(cfg, args, "cpu",
                                            draws=_jax_draws(cfg, len(draws.perm)))
    assert out["pred"].shape == (NSAMPLES, 3, 8, 12, 3)
    assert out["seqs"].shape == (2 * NSAMPLES, 8, 8, 12, 3)
    assert torch.equal(out["seqs"][0::2, 5:], out["pred"])
    assert out["l1"] == float(out["pred"].abs().sum())
    assert f"sample L1 norm: {out['l1']:.4f}" in log.read_text()
    assert {k: v.shape for k, v in out["overlays"].items()} == \
        {k: (NSAMPLES, 8, 3) for k in ("psnr", "mpsnr", "ssim", "tv")}
    assert set(out["launches"].values()) == {0}  # the CPU launches no kernel


def test_gifs_data_parallel_and_dispatch(workspace):
    """The Dynamic run writes the JAX command's GIF names; ``--data-parallel``
    on the CPU (a world of one over gloo, a spawned process) draws the same
    samples as the plain run (its density plots byte-equal); the dispatcher
    runs the command."""
    ws = workspace
    cfg_path = _config(ws, "port")
    cfg = load_config(cfg_path, ws["list"])
    tr = Trainer(cfg, ARCH, device="cpu", seed=SEED).setup()
    tr.save(cfg.DATA_FS.SAVE_DIR, "000")
    cpu = ["--device", "cpu"]
    assert cli.main(["generate-samples", *_args(cfg_path, ws, ws["tmp"] / "gif", *cpu,
                                               "--plot-type", "Dynamic")]) == 0
    assert sorted(p for p in os.listdir(ws["tmp"] / "gif") if p.endswith(".gif")) == [
        "mprops_GT_seq_1.gif", "mprops_GT_seq_2.gif", "mprops_seq_1.gif", "mprops_seq_2.gif"]
    assert generate_samples.run(_args(cfg_path, ws, ws["tmp"] / "plain", *cpu)) == 0
    assert generate_samples.run(_args(cfg_path, ws, ws["tmp"] / "dp", *cpu,
                                      "--data-parallel")) == 0
    # The density curves are drawn from the samples (the SVG's ids come
    # from the drawing process's rcParams, which the spawned rank does not
    # share).
    files = [sorted(os.listdir(ws["tmp"] / d)) for d in ("plain", "dp")]
    assert files[0] == files[1] and "rho_seq_2.png" in files[0]
    for name in ("rho_seq_1.png", "rho_seq_2.png"):
        assert (ws["tmp"] / "plain" / name).read_bytes() == \
            (ws["tmp"] / "dp" / name).read_bytes()
    assert os.path.exists(ws["tmp"] / "port_out" / "logs" / "genSamples.p0.log")
    with pytest.raises(SystemExit):
        generate_samples.run(_args(cfg_path, ws, ws["tmp"] / "x", *cpu, "--multihost"))


def test_without_matplotlib_exits_2_before_loading(monkeypatch, tmp_path, capsys):
    """No matplotlib: exit 2 naming it, before the config or checkpoint is
    read (the config here does not exist)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = ["--config-yml-file", str(tmp_path / "missing.yml"), "--device", "cpu",
            "--output-dir", str(tmp_path / "out")]
    assert generate_samples.run(argv) == 2
    assert "matplotlib" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_multihost_sampling_gathers_the_plain_samples(workspace):
    """Two OS processes of ``generate-samples --data-parallel --multihost``
    (CROWDMOD_* variables, gloo, one thread each): each samples its row of
    the two, both log the gathered samples' L1 norm, equal to a plain
    run's, and process 0 alone draws the plain run's files."""
    import socket
    import subprocess

    ws = workspace
    cfg_path = _config(ws, "port")
    cfg = load_config(cfg_path, ws["list"])
    Trainer(cfg, ARCH, device="cpu", seed=SEED).setup().save(cfg.DATA_FS.SAVE_DIR, "000")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "crowdmod_tpu_torch.cli", "generate-samples",
            *_args(cfg_path, ws, ws["tmp"] / "mh", "--device", "cpu", "--data-parallel",
                   "--multihost")]
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env={**os.environ, "OMP_NUM_THREADS": "1",
                                              "CROWDMOD_COORDINATOR": f"127.0.0.1:{port}",
                                              "CROWDMOD_NUM_PROCESSES": "2",
                                              "CROWDMOD_PROCESS_ID": str(r)})
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert generate_samples.run(_args(cfg_path, ws, ws["tmp"] / "plain", "--device", "cpu")) == 0

    def l1(text):
        return float(text.split("sample L1 norm: ")[1].split()[0])

    plain = l1((ws["tmp"] / "port_out" / "logs" / "genSamples.log").read_text())
    assert l1(outs[0]) == l1(outs[1])
    assert abs(l1(outs[0]) - plain) <= 1e-6 * plain + 1e-4
    assert "process 1/2" in outs[1] and "wrote static" not in outs[1]
    assert sorted(os.listdir(ws["tmp"] / "mh")) == sorted(os.listdir(ws["tmp"] / "plain"))
