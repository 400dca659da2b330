"""The port's asynchronous checkpoint commits (``train/checkpoint.py``), the
JAX package's ``save_checkpoint(async_save=True)`` contract: the state is
the one at the call however the steps after it change the live tensors in
place; the staged ``.pending`` directory replaces the previous checkpoint
only once committed; a synchronous save commits pending ones first; the
files are those of a synchronous save, byte for byte, from a single save
and from a whole ``fit``; the retention sweep removes what the JAX
package's removes, orphans of crashed async saves included.  On a tiny
DDPM-UNet on the CPU (``test_torch_train_loop``'s)."""

import filecmp
import os
from pathlib import Path

import pytest
import torch

from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.train.checkpoint import gc_checkpoints as jax_gc_checkpoints
from crowdmod_tpu_torch.parallel import multiprocess
from crowdmod_tpu_torch.train import checkpoint as ckpt
from crowdmod_tpu_torch.train.trainer import StepDraws
from test_torch_train_loop import ARCH, tiny_cfg, trainer, walker_ds


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def _same_files(a: Path, b: Path) -> None:
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert filecmp.cmp(fa[name], fb[name], shallow=False), name


def _state(tr) -> dict:
    """A deep copy of everything a save writes."""
    return {"params": {k: v.clone() for k, v in tr.params.items()},
            "ema_params": {k: v.clone() for k, v in tr.ema_params.items()},
            "optimizer": ckpt._snapshot(tr.state.optimizer.state_dict())[0],
            "step": tr.state.step}


def _assert_loads_to(path, want) -> None:
    payload, _ = ckpt.load_checkpoint(path)
    assert payload["step"] == want["step"]
    for name in ("params", "ema_params"):
        assert payload[name].keys() == want[name].keys()
        for k, v in want[name].items():
            assert torch.equal(payload[name][k], v), (name, k)
    got, opt = payload["optimizer"], want["optimizer"]
    assert got["param_groups"] == opt["param_groups"]
    for i, moments in opt["state"].items():
        for k, v in moments.items():
            assert torch.equal(got["state"][i][k], v), (i, k)


def _steps(tr, ds, n: int) -> None:
    """``n`` training steps: Adam and the EMA update the tensors a pending
    save was made from, in place."""
    gen = torch.Generator().manual_seed(5)
    batches = iter(ds.batches(8, shuffle=False))
    for _ in range(n):
        tr._train_step(*tr._rank_args(next(batches), StepDraws(generator=gen)))


@pytest.fixture
def fitted(tmp_path):
    """A trainer one step in: Adam's moments and the EMA set."""
    cfg = tiny_cfg(tmp_path, TRAIN={"EPOCHS": 1, "EMA_DECAY": 0.9})
    ds = walker_ds()
    tr = trainer(cfg, tmp_path)
    tr.setup()
    _steps(tr, ds, 1)
    return cfg, ds, tr


def test_async_save_raced_by_steps_loads_to_its_snapshot(fitted, tmp_path):
    """Save asynchronously, step at once, then wait: the checkpoint holds
    the state at the save, and its files are a synchronous save's of that
    state, byte for byte."""
    cfg, ds, tr = fitted
    want = _state(tr)
    sync = Path(tr.save(str(tmp_path / "sync"), 7))
    path = Path(tr.save(cfg.DATA_FS.SAVE_DIR, 7, async_save=True))
    _steps(tr, ds, 1)
    assert any(not torch.equal(tr.params[k], want["params"][k]) for k in tr.params)
    ckpt.wait_for_saves()
    _assert_loads_to(path, want)
    _same_files(path, sync)
    assert not Path(f"{path}.pending").exists() and not Path(f"{path}.meta.json").exists()


def test_previous_checkpoint_survives_until_the_swap(fitted):
    """While the new save is pending, the directory holds the previous
    checkpoint whole, and read_metadata reads its metadata; the sidecar
    and the staged directory sit beside it until the swap."""
    cfg, ds, tr = fitted
    before = _state(tr)
    path = Path(tr.save(cfg.DATA_FS.SAVE_DIR, 3, extra={"epoch_loss": 1.0}))
    _steps(tr, ds, 1)
    after = _state(tr)
    tr.save(cfg.DATA_FS.SAVE_DIR, 3, extra={"epoch_loss": 0.5}, async_save=True)
    assert Path(f"{path}.pending").is_dir() and Path(f"{path}.meta.json").exists()
    _assert_loads_to(path, before)
    assert ckpt.read_metadata(path)["epoch_loss"] == 1.0
    ckpt.wait_for_saves()
    _assert_loads_to(path, after)
    assert ckpt.read_metadata(path)["epoch_loss"] == 0.5
    assert not Path(f"{path}.pending").exists() and not Path(f"{path}.meta.json").exists()


def test_read_metadata_falls_back_to_the_sidecar(tmp_path):
    """The sidecar is read while the checkpoint directory exists without
    its metadata.json; an orphaned sidecar is not."""
    path = tmp_path / "ckpt"
    ckpt._write_json(Path(f"{path}.meta.json"), {"epoch": 4})
    assert ckpt.read_metadata(path) is None
    path.mkdir()
    assert ckpt.read_metadata(path) == {"epoch": 4}


def test_sync_save_commits_pending_saves_first(fitted):
    cfg, ds, tr = fitted
    first = Path(tr.save(cfg.DATA_FS.SAVE_DIR, 4, async_save=True))
    assert ckpt._PENDING
    second = Path(tr.save(cfg.DATA_FS.SAVE_DIR, 5))
    assert not ckpt._PENDING
    for path in (first, second):
        assert (path / ckpt.STATE_FILE).exists() and (path / ckpt.METADATA_FILE).exists()
        assert not Path(f"{path}.pending").exists()


def test_async_fit_writes_the_files_of_a_sync_fit(tmp_path, monkeypatch):
    """fit's best and late saves are asynchronous; the files it leaves are
    those of the same fit with every save synchronous.  One epoch, and the
    one late checkpoint is that epoch's: two saves."""
    calls = []
    save = ckpt.save_checkpoint

    def spy(*args, async_save=False, **kw):
        calls.append(async_save)
        return save(*args, async_save=async_save, **kw)

    monkeypatch.setattr(ckpt, "save_checkpoint", spy)
    ds = walker_ds()
    roots = []
    for mode in ("async", "sync"):
        root = tmp_path / mode
        cfg = tiny_cfg(root, TRAIN={"EPOCHS": 1, "EMA_DECAY": 0.9})
        tr = trainer(cfg, root)
        if mode == "sync":
            plain = tr.save
            monkeypatch.setattr(tr, "save", lambda *a, async_save=False, **kw: plain(*a, **kw))
        tr.fit(ds)
        roots.append(Path(cfg.DATA_FS.SAVE_DIR))
        if mode == "async":
            assert calls == [True, True]
            assert not ckpt._PENDING
    assert sorted(_files(roots[0])) == sorted(
        f"{ckpt.checkpoint_name(cfg, ARCH, e)}/{n}" for e in ("000", 1)
        for n in (ckpt.METADATA_FILE, ckpt.STATE_FILE))
    _same_files(*roots)


def _tree(root: Path, pre: str, other: str) -> None:
    """The names a crashed run leaves: this run's checkpoints, their
    sidecars, staged and orbax temporary directories, and another run's."""
    dirs = [f"{pre}{tag}_NA" for tag in ("000", "001", "002", "005", "abort", "x7")]
    dirs += [f"{pre}003_NA.pending", f"{pre}006_NA.orbax-checkpoint-tmp",
             f"{pre}008_NA.pending.orbax-checkpoint-tmp", f"{pre}000_NA.pending",
             f"{other}001_NA", f"{other}002_NA.pending", f"{other}003_NA.orbax-checkpoint-tmp"]
    files = [f"{pre}002_NA.meta.json", f"{pre}004_NA.meta.json", f"{pre}001_NA.meta.json",
             f"{other}004_NA.meta.json", "notes.txt", f"{pre}009_NA.pending"]
    for d in dirs:
        (root / d).mkdir(parents=True)
        (root / d / "state.pt").write_bytes(b"x")
    for f in files:
        (root / f).write_text("{}")


@pytest.mark.parametrize("keep, remove_abort", [(None, False), (0, False), (1, True),
                                                (2, True)])
def test_gc_sweeps_what_the_jax_sweep_does(tmp_path, keep, remove_abort):
    over = {"MODEL": {"DDPM": {"UNET": {"TRAIN": {"EPOCHS": 2}}}}}
    cfg = tiny_cfg(tmp_path)
    jcfg = jax_load_config("4test/ATC.yml", overrides={
        "DATASET": {"NAME": cfg.DATASET.NAME}, **over})
    pre = ckpt.checkpoint_name(cfg, ARCH, "@").split("@")[0]
    assert pre == ckpt.checkpoint_name(jcfg, ARCH, "@").split("@")[0]
    other = ckpt.checkpoint_name(cfg, "DDPM-DiT", "@").split("@")[0]
    port, jax_root = tmp_path / "port", tmp_path / "jax"
    for root in (port, jax_root):
        _tree(root, pre, other)
    got = ckpt.gc_checkpoints(port, cfg, ARCH, keep_epochs=keep, remove_abort=remove_abort)
    want = jax_gc_checkpoints(jax_root, jcfg, ARCH, keep_epochs=keep,
                              remove_abort=remove_abort)
    assert sorted(os.path.basename(p) for p in got) == sorted(
        os.path.basename(p) for p in want)
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_root))
    assert f"{pre}003_NA.pending" not in os.listdir(port)


def test_gc_sweeps_on_process_0_only(tmp_path, monkeypatch):
    cfg = tiny_cfg(tmp_path)
    pre = ckpt.checkpoint_name(cfg, ARCH, "@").split("@")[0]
    _tree(tmp_path / "d", pre, "other_")
    before = sorted(os.listdir(tmp_path / "d"))
    monkeypatch.setattr(multiprocess, "process_count", lambda: 2)
    monkeypatch.setattr(multiprocess, "is_main", lambda: False)
    assert ckpt.gc_checkpoints(tmp_path / "d", cfg, ARCH, keep_epochs=0,
                               remove_abort=True) == []
    assert sorted(os.listdir(tmp_path / "d")) == before
