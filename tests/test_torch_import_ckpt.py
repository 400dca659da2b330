"""``import-checkpoint`` in the port (``crowdmod_tpu_torch.cli.import_checkpoint``
and ``compat/torch_import.py``) against the JAX package's, on the CPU.

For each reference arch's backbone (UNet3D, DiT4D_V4, DiT2D, ConvRNN) a
reference-format ``.pt`` (``{"opt", "model"}``, with the reference's
sinusoidal time table) is written from seeded weights and imported by both
commands; the two imported models' forwards agree within 1e-4 of max|JAX|
in float32 (ConvRNN: the deterministic rollout).  Both refuse a backbone
that is not the arch's; the port reports a corrupted key or shape before
writing anything.  ``detect_backbone`` agrees with the JAX one on every
backbone, DiT4DJoint and DiT4DTube included (no config builds those two:
the importers identify and refuse them under every arch)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from crowdmod_tpu.cli import import_checkpoint as jax_import
from crowdmod_tpu.compat import detect_backbone as jax_detect_backbone
from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
from crowdmod_tpu_torch import cli
from crowdmod_tpu_torch.compat.torch_import import (
    BACKBONE_FOR_ARCH,
    detect_backbone,
    import_torch_checkpoint,
)
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.models import factory
from crowdmod_tpu_torch.models.backbones import dit
from crowdmod_tpu_torch.serving import load_predictor
from crowdmod_tpu_torch.train import checkpoint as ckpt
from crowdmod_tpu_torch.train.trainer import Trainer

P, F, H, W = 5, 3, 8, 12
FORWARD_RTOL = 1e-4  # of max|JAX|, float32
ARCHS = ("DDPM-UNet", "DDPM-DiT", "FM-DiT", "ConvRNN")
TINY = {
    "TPU": {"COMPUTE_DTYPE": "float32"},
    "MACROPROPS": {"ROWS": H, "COLS": W},
    "MODEL": {
        "DDPM": {"UNET": {"BASE_CH": 8, "BASE_CH_MULT": [1, 2],
                          "APPLY_ATTENTION": [False, True, False]},
                 "DIT": {"HIDDEN_SIZE": 64, "DEPTH": 2, "NUM_HEADS": 2}},
        "FM": {"DIT": {"HIDDEN_SIZE": 64, "DEPTH": 2, "NUM_HEADS": 2}},
        "CONVRNN": {"ENC_HIDDEN_CH": [4, 6, 6, 8, 8, 8],
                    "FORC_HIDDEN_CH": [8, 8, 8, 8, 8, 6, 4]},
    },
}


def channels(arch):
    return 4 if arch == "ConvRNN" else 3


def reference_state_dict(model, seed):
    """A reference ``state_dict`` from ``model``'s layout: seeded weights
    (every tensor perturbed: a fresh DiT outputs exactly 0), plus the
    sinusoidal table the reference stores and both importers drop."""
    gen = torch.Generator().manual_seed(seed)
    sd = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
          for k, v in model.state_dict().items()}
    time_key = next((k.replace("time_blocks.1.weight", "time_blocks.0.weight")
                     for k in sd if k.endswith("time_blocks.1.weight")), None)
    if time_key:
        sd[time_key] = torch.randn(1000, 8, generator=gen)
    return sd


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A config file per package (own checkpoint dirs) → paths."""
    root = tmp_path_factory.mktemp("import_ckpt")
    paths = {"root": root}
    for name in ("port", "jax"):
        cfg = load_config("4test/ATC.yml", overrides={
            **TINY, "DATA_FS": {"SAVE_DIR": str(root / f"{name}_ckpts"),
                                "OUTPUT_DIR": str(root / f"{name}_out")}})
        paths[name] = root / f"{name}.yml"
        paths[name].write_text(yaml.safe_dump(cfg.to_dict()))
    return paths


def write_reference(workdir, arch, sd=None) -> Path:
    cfg = load_config(str(workdir["port"]))
    if sd is None:
        sd = reference_state_dict(factory.build_backbone(cfg, arch, channels(arch)),
                                  seed=ARCHS.index(arch))
    path = workdir["root"] / f"{arch}.pt"
    torch.save({"opt": {}, "model": sd}, path)
    return path


def run_import(workdir, arch, pt, package="port", check_arch=None):
    argv = ["--config-yml-file", str(workdir[package]), "--arch", check_arch or arch,
            "--torch-ckpt", str(pt)]
    if package == "port":
        return cli.main(["import-checkpoint", *argv, "--device", "cpu"])
    return jax_import.run(argv)


@pytest.mark.parametrize("arch", ARCHS)
def test_import_forward_matches_the_jax_import(workdir, arch):
    pt = write_reference(workdir, arch)
    assert run_import(workdir, arch, pt, "port") == 0
    assert run_import(workdir, arch, pt, "jax") == 0

    cfg = load_config(str(workdir["port"]))
    path = Path(cfg.DATA_FS.SAVE_DIR) / ckpt.checkpoint_name(cfg, arch, "000")
    meta = json.loads((path / "metadata.json").read_text())
    assert meta["source"] == f"torch-import:{pt.resolve()}"
    assert meta["name"] == ckpt.checkpoint_name(cfg, arch, "000")
    trainer = Trainer(cfg, arch, device="cpu")
    trainer.load(str(path))
    jcfg = jax_load_config(str(workdir["jax"]))
    jtrainer = JaxTrainer(jcfg, arch)
    jtrainer.load(str(Path(jcfg.DATA_FS.SAVE_DIR) / ckpt.checkpoint_name(cfg, arch, "000")))

    rng = np.random.default_rng(7)
    c = channels(arch)
    past = np.abs(rng.normal(size=(2, P, H, W, c))).astype(np.float32)
    if arch == "ConvRNN":
        want = np.asarray(jtrainer.sample(jnp.asarray(past), jax.random.PRNGKey(0)))
        got = trainer.sample(past).numpy()
    else:
        future = rng.normal(size=(2, F, H, W, c)).astype(np.float32)
        t = np.array([3, 7], np.int32)
        want = np.asarray(jtrainer.model.apply(
            jtrainer.state.params, jnp.asarray(future), jnp.asarray(t), jnp.asarray(past)))
        with torch.no_grad():
            got = trainer.model(torch.from_numpy(future), torch.from_numpy(t).long(),
                                torch.from_numpy(past)).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 1e-3
    assert np.abs(got - want).max() <= FORWARD_RTOL * np.abs(want).max()
    # The imported weights are the file's (the EMA seeded from them).
    sd = torch.load(pt, weights_only=True)["model"]
    for k, v in trainer.params.items():
        assert torch.equal(v, sd[k]), k
    for k, v in trainer.ema_params.items() if trainer.ema_params else ():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_another_archs_backbone_is_refused_by_both(workdir, arch):
    pt = write_reference(workdir, arch)
    wrong = "FM-DiT" if arch == "DDPM-DiT" else "DDPM-DiT"
    for package in ("port", "jax"):
        with pytest.raises(ValueError, match=f"contains a {BACKBONE_FOR_ARCH[arch]} "
                                             f"backbone but --arch {wrong} expects"):
            run_import(workdir, arch, pt, package, check_arch=wrong)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_corrupted_key_is_reported_before_anything_is_written(workdir, arch, tmp_path):
    cfg = load_config(str(workdir["port"]))
    model = factory.build_backbone(cfg, arch, channels(arch))
    sd = reference_state_dict(model, seed=1)
    renamed = sorted(k for k in sd if not k.endswith("time_blocks.0.weight"))[-1]
    sd[renamed + "_x"] = sd.pop(renamed)
    reshaped = sorted(sd)[0]
    sd[reshaped] = torch.zeros(sd[reshaped].numel() + 1)
    pt = write_reference(workdir, arch, sd)
    out = tmp_path / "out"
    argv = ["import-checkpoint", "--config-yml-file", str(workdir["port"]), "--arch", arch,
            "--torch-ckpt", str(pt), "--device", "cpu", "--out-dir", str(out)]
    with pytest.raises(ValueError) as exc:
        cli.main(argv)
    msg = str(exc.value)
    assert f"missing params: ['{renamed}']" in msg
    assert f"unexpected params: ['{renamed}_x']" in msg
    assert f"{reshaped}: checkpoint ({sd[reshaped].numel()},)" in msg
    assert not out.exists()
    with pytest.raises(ValueError, match="not a reference checkpoint"):
        torch.save({"model": {"a": 1}}, tmp_path / "bad.pt")
        import_torch_checkpoint(str(tmp_path / "bad.pt"), arch, model.state_dict())


def test_detect_backbone_agrees_with_jax_on_every_backbone(workdir):
    cfg = load_config(str(workdir["port"]))
    common = dict(out_channels=3, grid_rows=H, grid_cols=W, patch_size=4, hidden_size=64,
                  depth=1, num_heads=2, past_len=P, future_len=F)
    models = {arch: factory.build_backbone(cfg, arch, channels(arch)) for arch in ARCHS}
    models["joint"] = dit.DiT4DJoint(t_patch_size=4, **common)
    models["tube"] = dit.DiT4DTube.make(**common)
    got = {}
    for name, model in models.items():
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        got[name] = detect_backbone(sd)
        assert got[name] == jax_detect_backbone(sd)
    assert got == {"DDPM-UNet": "unet3d", "DDPM-DiT": "dit4d_factorized", "FM-DiT": "dit2d",
                   "ConvRNN": "convrnn", "joint": "dit4d_joint", "tube": "dit4d_tube"}
    with pytest.raises(ValueError, match="unrecognized state_dict"):
        detect_backbone({"nope.weight": np.zeros(1)})


def test_an_imported_checkpoint_is_served(workdir):
    """``load_predictor`` resolves the imported name: the ConvRNN's future
    is the imported model's rollout."""
    pt = write_reference(workdir, "ConvRNN")
    assert run_import(workdir, "ConvRNN", pt) == 0
    pred = load_predictor(str(workdir["port"]), "ConvRNN", device="cpu", batch_buckets=(2,))
    past = np.abs(np.random.default_rng(2).normal(size=(2, P, H, W, 4))).astype(np.float32)
    want = Trainer(load_config(str(workdir["port"])), "ConvRNN", device="cpu")
    want.model.load_state_dict({k: v for k, v in torch.load(
        pt, weights_only=True)["model"].items()})
    np.testing.assert_allclose(pred.predict(past), want.sample(past).numpy(), rtol=0, atol=0)
