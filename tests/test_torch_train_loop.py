"""The port's ``Trainer.fit`` loop: the JAX package's trainer tests that
apply to DDPM (``tests/test_trainer.py``), ported.

Checkpoints (best "000", late epochs, the emergency "abort", retention),
the full train state through save/load and resume, the NaN watchdog, SIGINT
at step boundaries, the eval loss's determinism, and same-seed
reproducibility, on a tiny DDPM-UNet (base 8, two levels) on the CPU.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
from crowdmod_tpu_torch.data.windows import WindowDataset
from crowdmod_tpu_torch.train import checkpoint as ckpt
from crowdmod_tpu_torch.train.checkpoint import checkpoint_name, gc_checkpoints
from crowdmod_tpu_torch.train.optim import get_learning_rate
from crowdmod_tpu_torch.train.trainer import StepDraws, Trainer
from crowdmod_tpu_torch.utils.tracker import RunTracker

ARCH = "DDPM-UNet"


def tiny_cfg(tmp_path, **unet):
    return load_config("4test/ATC.yml", overrides={
        "DATA_FS": {"SAVE_DIR": str(tmp_path / "ckpts"), "OUTPUT_DIR": str(tmp_path / "out")},
        "MACROPROPS": {"ROWS": 8, "COLS": 12},
        "DATASET": {"BATCH_SIZE": 8},
        "MODEL": {"DDPM": {"TIMESTEPS": 10, "CHECKPOINTS_TO_KEEP": 1, "UNET": {
            "BASE_CH": 8, "BASE_CH_MULT": [1, 2], "APPLY_ATTENTION": [False, False],
            "DROPOUT_RATE": 0.0, "TRAIN": {"EPOCHS": 2}, **unet}}},
    })


def walker_ds(n=6):
    return WindowDataset(torch.from_numpy(synthetic_walkers(n, 8, 12, 16)),
                         past_len=5, future_len=3, stride=8)


def trainer(cfg, tmp_path, name="run", **kw):
    return Trainer(cfg, ARCH, device="cpu", run_dir=str(tmp_path / name), **kw)


def _best(cfg):
    return os.path.join(cfg.DATA_FS.SAVE_DIR, checkpoint_name(cfg, ARCH, "000"))


def test_fit_checkpoint_load_restores_the_full_train_state(tmp_path):
    """fit → save → a fresh trainer's load: weights, EMA, step, Adam moments
    and LR; then it samples."""
    cfg = tiny_cfg(tmp_path, TRAIN={"EPOCHS": 2, "EMA_DECAY": 0.9})
    ds = walker_ds()
    tr = trainer(cfg, tmp_path)
    hist = tr.fit(ds, ds)
    assert len(hist["train_loss"]) == 2 and np.isfinite(hist["train_loss"]).all()
    assert hist["val_loss"][0] is not None and hist["aborted"] is False
    assert os.path.exists(os.path.join(_best(cfg), "metadata.json"))
    events = (tmp_path / "run" / "events.jsonl").read_text().splitlines()
    assert [json.loads(e)["step"] for e in events] == [1, 2]
    assert (tmp_path / "run" / "config.json").exists()
    assert tr.state.step == 2 and not tr.model.training
    assert any(not torch.equal(tr.params[k], tr.ema_params[k]) for k in tr.params)

    path = tr.save(cfg.DATA_FS.SAVE_DIR, 999)
    tr2 = trainer(cfg, tmp_path, "run2")
    meta = tr2.load(path)
    assert meta["arch"] == ARCH and meta["epoch"] == 999
    for a, b in ((tr.params, tr2.params), (tr.ema_params, tr2.ema_params)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert tr2.state.step == tr.state.step
    assert get_learning_rate(tr2.state.optimizer) == get_learning_rate(tr.state.optimizer)
    assert tr2.plateau.lr == get_learning_rate(tr.state.optimizer)
    s1, s2 = tr.state.optimizer.state_dict(), tr2.state.optimizer.state_dict()
    for i, st in s1["state"].items():
        for k, v in st.items():
            assert torch.equal(v, s2["state"][i][k]), (i, k)
    past, _ = ds.gather(np.arange(2))
    out = tr2.sample(past, torch.Generator().manual_seed(0))
    assert out.shape == (2, 3, 8, 12, 3) and torch.isfinite(out).all()


def test_ema_decay_is_validated(tmp_path):
    cfg = tiny_cfg(tmp_path, TRAIN={"EPOCHS": 1, "EMA_DECAY": 1.5})
    with pytest.raises(ValueError, match="EMA_DECAY"):
        trainer(cfg, tmp_path).setup()


def test_nan_watchdog_aborts_without_completing(tmp_path):
    cfg = tiny_cfg(tmp_path)
    tr = trainer(cfg, tmp_path).setup()
    stale = os.path.join(cfg.DATA_FS.SAVE_DIR, checkpoint_name(cfg, ARCH, 7))
    os.makedirs(stale)
    real = tr._train_step
    tr._train_step = lambda batch, draws: real(batch, draws) * float("nan")
    hist = tr.fit(walker_ds(), epochs=10)
    assert hist["aborted"] is True
    assert len(hist["train_loss"]) == 3  # stopped at the watchdog, not 10
    assert os.path.isdir(stale), "a failed run must not collect earlier checkpoints"


def test_eval_loss_is_deterministic_and_dropout_off(tmp_path):
    cfg = tiny_cfg(tmp_path, DROPOUT_RATE=0.5, TRAIN={"EPOCHS": 1})
    ds = walker_ds()
    tr = trainer(cfg, tmp_path).setup()
    batch = ds.gather(np.arange(4))
    gen = lambda: StepDraws(generator=torch.Generator().manual_seed(7))  # noqa: E731
    e1 = tr._loss_fn(deterministic=True)(batch, gen()).item()
    e2 = tr._loss_fn(deterministic=True)(batch, gen()).item()
    t1 = tr._loss_fn()(batch, gen()).item()
    assert e1 == e2 and abs(t1 - e1) > 1e-9  # 50% dropout changes the train loss
    v1, v2 = tr.evaluate(ds), tr.evaluate(ds)
    assert np.isfinite(v1) and v1 == v2


def test_eval_loss_skips_condition_dropout(tmp_path):
    base = tiny_cfg(tmp_path)
    with_drop = base.updated({"MODEL": {"DDPM": {"CFG_DROP_PROB": 0.5}}})
    tr_a = trainer(base, tmp_path, "a", seed=0).setup()
    tr_b = trainer(with_drop, tmp_path, "b", seed=0).setup()
    batch = walker_ds().gather(np.arange(4))
    gen = lambda: StepDraws(generator=torch.Generator().manual_seed(3))  # noqa: E731
    e_a = tr_a._loss_fn(deterministic=True)(batch, gen()).item()
    e_b = tr_b._loss_fn(deterministic=True)(batch, gen()).item()
    assert e_a == e_b
    keep = torch.tensor([True, False, False, True])
    t_b = tr_b._loss_fn()(batch, StepDraws(generator=gen().generator, keep=keep)).item()
    assert abs(t_b - e_b) > 1e-9


def test_evaluate_drops_the_ragged_remainder(tmp_path):
    cfg = tiny_cfg(tmp_path).updated({"DATASET": {"BATCH_SIZE": 4}})
    tr = trainer(cfg, tmp_path).setup()
    seen = []
    tr._eval_loss = lambda batch, draws: seen.append(batch[0].shape) or torch.tensor(0.5)
    assert tr.evaluate(walker_ds(n=5)) == 0.5  # 10 windows: 2 full batches of 4
    assert len(seen) == 2 and all(s[0] == 4 for s in seen)
    seen.clear()
    tr.evaluate(walker_ds(n=1))  # 2 windows < one batch: its one partial batch
    assert seen == [(2, 5, 8, 12, 3)]


def test_resume_from_abort_and_keep_the_best_checkpoint(tmp_path):
    """After resume_from_abort a worse first epoch must not overwrite the
    pre-crash '000'; a fresh run replaces it."""
    cfg = tiny_cfg(tmp_path)
    ds = walker_ds()
    tr = trainer(cfg, tmp_path).setup()
    assert not tr.resume_from_abort()  # nothing saved yet
    save_dir = cfg.DATA_FS.SAVE_DIR
    tr.save(save_dir, "000", extra={"epoch_loss": 1e-12})
    tr.save(save_dir, "abort")
    tr2 = trainer(cfg, tmp_path, "run2")
    assert tr2.resume_from_abort()
    for k, v in tr.params.items():
        assert torch.equal(v, tr2.params[k])
    tr2.fit(ds, epochs=1)
    assert ckpt.read_metadata(_best(cfg))["epoch_loss"] == 1e-12
    trainer(cfg, tmp_path, "run3").fit(ds, epochs=1)
    assert ckpt.read_metadata(_best(cfg))["epoch_loss"] != 1e-12


def test_late_checkpoint_epochs_are_distinct(tmp_path):
    cfg = tiny_cfg(tmp_path).updated({"MODEL": {"DDPM": {"CHECKPOINTS_TO_KEEP": 3}}})
    trainer(cfg, tmp_path).fit(walker_ds(), epochs=4)
    tags = [d.split("_CE")[-1].split("_")[0] for d in os.listdir(cfg.DATA_FS.SAVE_DIR)]
    # The pool is epochs {3, 4}; keep = 3 must save both, not fewer.
    assert sorted(t for t in tags if t.isdigit() and t != "000") == ["3", "4"]


def test_gc_checkpoints_retention(tmp_path):
    cfg = tiny_cfg(tmp_path)
    save = tmp_path / "ckpts"

    def mk(tag, arch=ARCH):
        d = save / checkpoint_name(cfg, arch, tag)
        d.mkdir(parents=True)
        return d

    best, abort = mk("000"), mk("abort")
    epochs = {e: mk(e) for e in (3, 7, 12, 20)}
    other = mk(5, "DDPM-DiT")  # another run's: untouched
    removed = gc_checkpoints(save, cfg, ARCH, keep_epochs=2, remove_abort=True)
    assert best.is_dir() and other.is_dir() and not abort.exists()
    assert not epochs[3].exists() and not epochs[7].exists()
    assert epochs[12].is_dir() and epochs[20].is_dir() and len(removed) == 3
    assert gc_checkpoints(save, cfg, ARCH, keep_epochs=5) == []
    gc_checkpoints(save, cfg, ARCH, keep_epochs=0)
    assert best.is_dir() and not epochs[12].exists() and not epochs[20].exists()


def test_fit_removes_a_stale_abort(tmp_path):
    cfg = tiny_cfg(tmp_path)
    stale = tmp_path / "ckpts" / checkpoint_name(cfg, ARCH, "abort")
    stale.mkdir(parents=True)
    trainer(cfg, tmp_path).fit(walker_ds())
    assert not stale.exists() and os.path.isdir(_best(cfg))


def test_emergency_checkpoint_on_abort(tmp_path):
    cfg = tiny_cfg(tmp_path)
    tracker = RunTracker(tmp_path / "run")

    class Boom(RuntimeError):
        pass

    tracker.log = lambda *a, **k: (_ for _ in ()).throw(Boom("log"))
    with pytest.raises(Boom):  # at the end of epoch 1: 16 windows, 2 steps
        trainer(cfg, tmp_path).fit(walker_ds(n=8), epochs=2, tracker=tracker)
    abort = os.path.join(cfg.DATA_FS.SAVE_DIR, checkpoint_name(cfg, ARCH, "abort"))
    assert ckpt.read_metadata(abort)["epoch"] == "abort"
    payload, _ = ckpt.load_checkpoint(abort)
    assert payload["step"] == 2 and "optimizer" in payload


def test_sigint_lands_at_a_step_boundary(tmp_path):
    """The first SIGINT is deferred to the end of the step it arrives in:
    that step completes, then the run stops with the abort checkpoint."""
    cfg = tiny_cfg(tmp_path)
    tr = trainer(cfg, tmp_path).setup()
    real, steps = tr._train_step, []

    def step(batch, draws):
        if not steps:
            os.kill(os.getpid(), signal.SIGINT)
        loss = real(batch, draws)
        steps.append(float(loss))
        return loss

    tr._train_step = step
    handler = signal.getsignal(signal.SIGINT)
    with pytest.raises(KeyboardInterrupt):
        tr.fit(walker_ds(n=12), epochs=3)  # 3 steps an epoch
    assert len(steps) == 1 and tr.state.step == 1
    assert signal.getsignal(signal.SIGINT) is handler
    payload, _ = ckpt.load_checkpoint(
        os.path.join(cfg.DATA_FS.SAVE_DIR, checkpoint_name(cfg, ARCH, "abort")))
    assert payload["step"] == 1


def test_fit_is_bit_deterministic_for_a_seed(tmp_path):
    cfg = tiny_cfg(tmp_path, DROPOUT_RATE=0.1)
    ds = walker_ds(n=8)
    runs = []
    for i, seed in enumerate((3, 3, 4)):
        tr = trainer(cfg, tmp_path, f"d{i}", seed=seed)
        runs.append((tr.fit(ds, epochs=2)["train_loss"], tr.params))
    (h1, p1), (h2, p2), (h3, _) = runs
    assert h1 == h2 and h3 != h1
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


def test_fit_times_each_step_in_its_history(tmp_path):
    """``step_ms``: an epoch's list of step times beside its ``step_loss``,
    without a wrapper around the step."""
    cfg = tiny_cfg(tmp_path)
    tr = trainer(cfg, tmp_path)
    hist = tr.fit(walker_ds(n=8), epochs=2)
    assert [len(e) for e in hist["step_ms"]] == [len(e) for e in hist["step_loss"]]
    assert len(hist["step_ms"]) == 2 and all(len(e) >= 1 for e in hist["step_ms"])
    assert all(np.isfinite(ms) and ms > 0 for e in hist["step_ms"] for ms in e)


def test_read_metadata_tolerates_corruption(tmp_path):
    """A truncated metadata.json (a hard kill mid-write) reads as None, and
    the metadata keeps the JAX package's ``default=str``."""
    path = ckpt.save_checkpoint(tmp_path / "ck", {"params": {"w": torch.zeros(2)}},
                                {"epoch_loss": 2.0, "where": tmp_path})
    assert ckpt.read_metadata(path) == {"epoch_loss": 2.0, "where": str(tmp_path)}
    (tmp_path / "ck" / "metadata.json").write_text('{"epoch_loss": 2.')
    assert ckpt.read_metadata(path) is None
    assert ckpt.read_metadata(tmp_path / "missing") is None
