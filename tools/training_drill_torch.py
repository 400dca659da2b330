#!/usr/bin/env python
"""Full-reference-budget training drill: kill mid-run, resume, complete —
the PyTorch port (``crowdmod_tpu_torch``) on the GPU.

Exercises the long-run operational story at the reference's real budget
shape (DDPM-UNet, ``EPOCHS: 200`` — reference config/ATC.yml:61-94) on the
scaled synthetic corpus:

  1. train through the port's ``train`` command (plateau-LR schedule,
     asynchronous best/late checkpoint commits, retention GC);
  2. SIGINT the process mid-run (default: epoch 60) — the trainer's
     emergency handler must persist an ``abort`` checkpoint, whole on disk
     (its ``state.pt`` and ``metadata.json``, no ``state.pt.tmp`` left);
  3. relaunch with ``--resume`` for the remaining budget — it must restore
     model/optimizer/EMA/plateau state and run to completion;
  4. assert the drill postconditions: loss-curve continuity across the kill
     (the resumed first epoch must look like a warm continuation, not a
     restart), best-checkpoint integrity (its recorded ``epoch_loss`` is the
     global best over BOTH phases and the weights load back cleanly), the
     abort checkpoint is garbage-collected on completion, and the late-epoch
     retention policy held (≤ CHECKPOINTS_TO_KEEP numbered checkpoints).

Resume-after-crash is beyond the reference (its train.py:78 only
warm-starts weights).  Writes ``report.json`` (+ ``loss_curve.png`` where
matplotlib imports) under --out.

    python tools/training_drill_torch.py --out /tmp/training_drill
    python tools/training_drill_torch.py --device cpu --epochs 6 --kill-epoch 2
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

ARCH = "DDPM-UNet"


def read_epochs(events_path):
    """Train-loss/lr rows from a (possibly still-growing) events.jsonl."""
    rows = []
    if not os.path.exists(events_path):
        return rows
    with open(events_path) as f:
        for line in f:
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:  # half-written tail line
                continue
            if "train_loss" in ev:
                rows.append(ev)
    return rows


def launch(cmd, log_path):
    logf = open(log_path, "w")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH"), REPO) if p
    )
    return subprocess.Popen(
        cmd, stdout=logf, stderr=subprocess.STDOUT, env=env, cwd=REPO,
    ), logf


def checkpoint_whole(path) -> bool:
    """A committed checkpoint directory: ``state.pt`` loads, its metadata
    reads, and no torn ``state.pt.tmp`` is left beside them."""
    from crowdmod_tpu_torch.train import checkpoint as ckpt

    if not os.path.isdir(path) or os.path.exists(
            os.path.join(path, ckpt.STATE_FILE + ".tmp")):
        return False
    try:
        payload, meta = ckpt.load_checkpoint(path)
    except (OSError, RuntimeError):
        return False
    return meta is not None and "params" in payload


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="/tmp/training_drill")
    p.add_argument("--epochs", type=int, default=None,
                   help="total budget (default: the config's reference "
                        "budget, 200 for DDPM-UNet)")
    p.add_argument("--kill-epoch", type=int, default=60)
    p.add_argument("--files", type=int, default=6)
    p.add_argument("--per-file", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=None,
                   help="override DATASET.BATCH_SIZE (a toy-scale drill "
                        "shrinks it; the reference budget keeps 64)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--timeout", type=int, default=5400,
                   help="per-phase wall budget in seconds")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--config-yml-file", default="ATC.yml",
                   help="base config (its DDPM-UNet is trained; a CPU "
                        "rehearsal passes a narrower copy)")
    args = p.parse_args(argv)

    import yaml

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import Trainer, resolve_device
    from tools.eval_protocol_full_torch import build_corpus

    resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    pkl_dir, files = build_corpus(
        args.out, n_files=args.files, per_file=args.per_file, seed=args.seed
    )

    save_dir = os.path.join(args.out, "ckpts")
    over = {
        "DATA_FS": {
            "PICKLE_DIR": pkl_dir,
            "SAVE_DIR": save_dir,
            "OUTPUT_DIR": os.path.join(args.out, "out"),
        },
        "DATASET": {
            "RAW_SEQ_LEN": 24,
            "TRAIN_FILE_COUNT": max(args.files - 2, 1),
            "VAL_FILE_COUNT": 1,
            "TEST_FILE_COUNT": 1,
            **({"BATCH_SIZE": args.batch_size} if args.batch_size else {}),
        },
    }
    if args.epochs:
        over["MODEL"] = {"DDPM": {"UNET": {"TRAIN": {"EPOCHS": args.epochs}}}}
    cfg = load_config(args.config_yml_file).updated(over)
    total_epochs = int(cfg.MODEL.DDPM.UNET.TRAIN.EPOCHS)
    keep = int(cfg.MODEL.DDPM.CHECKPOINTS_TO_KEEP)
    assert args.kill_epoch < total_epochs, "kill point must be mid-run"

    cfg_path = os.path.join(args.out, "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    list_path = os.path.join(args.out, "list.yml")
    with open(list_path, "w") as f:
        yaml.safe_dump({"DATA_LIST": files}, f)

    base_cmd = [
        sys.executable, "-m", "crowdmod_tpu_torch.cli.train",
        "--config-yml-file", cfg_path, "--configList-yml-file", list_path,
        "--arch", ARCH, "--seed", str(args.seed), "--device", args.device,
    ]
    abort_dir = os.path.join(
        save_dir, ckpt.checkpoint_name(cfg, ARCH, "abort")
    )
    best_dir = os.path.join(save_dir, ckpt.checkpoint_name(cfg, ARCH, "000"))
    report = {"arch": ARCH, "total_epochs": total_epochs,
              "kill_epoch": args.kill_epoch, "checkpoints_to_keep": keep,
              "device": args.device}

    # ---- Phase 1: train until the kill point, then SIGINT ----------------
    run1 = os.path.join(args.out, "run1")
    proc, logf = launch(base_cmd + ["--run-dir", run1],
                        os.path.join(args.out, "phase1.log"))
    events1 = os.path.join(run1, "events.jsonl")
    t0 = time.time()
    killed_at = None
    try:
        while proc.poll() is None:
            n = len(read_epochs(events1))
            if n >= args.kill_epoch:
                killed_at = n
                print(f"phase 1: SIGINT at epoch {n} "
                      f"({time.time() - t0:.0f}s in)", flush=True)
                proc.send_signal(signal.SIGINT)
                break
            if time.time() - t0 > args.timeout:
                proc.kill()
                raise SystemExit("phase 1 timed out before the kill point")
            # Short poll: on toy corpora several epochs can complete per
            # poll window, so a coarse sleep would overshoot --kill-epoch
            # (or miss the run entirely if it finishes inside one window).
            time.sleep(0.2)
        rc1 = proc.wait(timeout=600)  # grace for the emergency save
    finally:
        logf.close()
    assert killed_at is not None, (
        f"phase 1 exited rc={proc.returncode} before epoch "
        f"{args.kill_epoch} — nothing to resume (see phase1.log)"
    )
    phase1 = read_epochs(events1)
    assert os.path.isdir(abort_dir), (
        f"no emergency checkpoint at {abort_dir} after SIGINT"
    )
    abort_meta = ckpt.read_metadata(abort_dir) or {}
    abort_whole = checkpoint_whole(abort_dir)
    report["phase1"] = {
        "rc": rc1, "epochs_logged": len(phase1),
        "killed_at_epoch": killed_at,
        "kill_overshoot_epochs": killed_at - args.kill_epoch,
        "wall_s": round(time.time() - t0, 1),
        "first_loss": phase1[0]["train_loss"],
        "last_loss": phase1[-1]["train_loss"],
        "abort_checkpoint": True,
        "abort_checkpoint_whole": abort_whole,
    }
    print(f"phase 1 done: {len(phase1)} epochs logged, abort ckpt saved "
          f"(loss {phase1[0]['train_loss']:.4f} -> "
          f"{phase1[-1]['train_loss']:.4f})", flush=True)

    # ---- Phase 2: resume for the remaining budget ------------------------
    remaining = total_epochs - len(phase1)
    run2 = os.path.join(args.out, "run2")
    t1 = time.time()
    proc2, logf2 = launch(
        base_cmd + ["--run-dir", run2, "--resume",
                    "--epochs", str(remaining)],
        os.path.join(args.out, "phase2.log"),
    )
    try:
        rc2 = proc2.wait(timeout=args.timeout)
    finally:
        logf2.close()
    phase2 = read_epochs(os.path.join(run2, "events.jsonl"))
    report["phase2"] = {
        "rc": rc2, "epochs_logged": len(phase2),
        "wall_s": round(time.time() - t1, 1),
        "first_loss": phase2[0]["train_loss"] if phase2 else None,
        "last_loss": phase2[-1]["train_loss"] if phase2 else None,
    }
    assert rc2 == 0, f"resumed run failed rc={rc2} (see phase2.log)"
    assert len(phase2) == remaining, (
        f"resumed run logged {len(phase2)} epochs, wanted {remaining}"
    )

    # ---- Postconditions --------------------------------------------------
    checks = {}
    # The emergency save ran synchronously after the asynchronous commits
    # in flight: a torn state.pt.tmp or a missing metadata file is a fault.
    checks["abort_checkpoint_whole"] = abort_whole
    # (a) Warm continuation, not a restart: the first resumed epoch must sit
    # near the pre-kill loss, far below the cold first epoch.  2x headroom
    # absorbs one epoch of optimizer-state settling + data-order noise; a
    # restart would be at phase-1-first-epoch level (an order of magnitude
    # up at this kill point).
    cold, pre_kill = phase1[0]["train_loss"], phase1[-1]["train_loss"]
    resumed = phase2[0]["train_loss"]
    checks["continuity"] = bool(
        resumed < max(2.0 * pre_kill, 0.05 * cold + pre_kill)
    )
    # (b) The plateau-LR schedule actually scheduled: the resumed run's
    # final LR must be strictly below the configured base LR (>=1 plateau
    # reduction across the drill), and the resumed first LR must equal the
    # pre-kill LR (plateau state survived the crash).  Only enforceable at
    # the reference budget — a short smoke run never plateaus (PATIENCE 10).
    base_lr = float(cfg.MODEL.DDPM.UNET.TRAIN.SOLVER.LR)
    lrs = [e["lr"] for e in phase1 + phase2 if "lr" in e]
    if total_epochs >= 100:
        checks["plateau_lr_scheduled"] = bool(lrs and lrs[-1] < base_lr)
    else:
        report["plateau_lr_note"] = (
            "check skipped below 100 epochs (no plateau expected)"
        )
    # Relative tolerance: the emergency checkpoint round-trips the LR
    # through the optimizer state (~1e-8 relative at most), while a real
    # plateau reduction is x0.5 — 1e-6 relative separates them.
    checks["plateau_state_resumed"] = bool(
        phase2[0].get("lr") is not None
        and phase1[-1].get("lr") is not None
        and abs(phase2[0]["lr"] - phase1[-1]["lr"])
        <= 1e-6 * max(abs(phase1[-1]["lr"]), 1e-30)
    )
    report["lr"] = {"base": base_lr, "pre_kill": phase1[-1].get("lr"),
                    "resumed_first": phase2[0].get("lr"),
                    "final": lrs[-1] if lrs else None,
                    # 6-sig-fig dedup: round-trip jitter must not count as a
                    # plateau reduction.
                    "reductions": len({f"{x:.6g}" for x in lrs}) - 1}
    # (c) Best-checkpoint integrity: metadata epoch_loss == global best over
    # both phases, and the weights load back into a Trainer cleanly.
    best_meta = ckpt.read_metadata(best_dir) or {}
    global_best = min(e["train_loss"] for e in phase1 + phase2)
    checks["best_ckpt_is_global_best"] = bool(
        isinstance(best_meta.get("epoch_loss"), float)
        and abs(best_meta["epoch_loss"] - global_best) < 1e-9
    )
    trainer = Trainer(cfg, ARCH, run_dir=os.path.join(args.out, "verify"),
                      seed=args.seed, device=args.device)
    trainer.setup()
    trainer.load(best_dir)
    checks["best_ckpt_loads"] = True
    # (d) Completion-time GC: abort dropped, retention policy held.
    checks["abort_gc_on_completion"] = not os.path.exists(abort_dir)
    numbered = [d for d in os.listdir(save_dir)
                if d != os.path.basename(best_dir)
                and os.path.isdir(os.path.join(save_dir, d))
                and not d.endswith("abort")]
    checks["retention_policy"] = len(numbered) <= keep
    report["numbered_checkpoints"] = sorted(numbered)
    report["abort_meta_epoch_loss"] = abort_meta.get("epoch_loss")
    report["global_best_loss"] = global_best
    report["best_meta_epoch_loss"] = best_meta.get("epoch_loss")
    report["checks"] = checks

    # ---- Loss curve with the resume point marked -------------------------
    from crowdmod_tpu_torch.viz import plotting_unavailable

    no_plots = plotting_unavailable()
    if no_plots:
        report["loss_curve_png"] = f"unavailable: {no_plots}"
    else:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        losses = [e["train_loss"] for e in phase1 + phase2]
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.semilogy(range(1, len(losses) + 1), losses, lw=1.2)
        ax.axvline(len(phase1) + 0.5, color="crimson", ls="--", lw=1,
                   label=f"SIGINT + resume (epoch {len(phase1)})")
        ax.set_xlabel("epoch")
        ax.set_ylabel("train loss")
        ax.set_title(f"{ARCH} {total_epochs}-epoch drill: "
                     "kill at dashed line, resumed to completion")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(args.out, "loss_curve.png"), dpi=120)
        plt.close(fig)
        report["loss_curve_png"] = os.path.join(args.out, "loss_curve.png")

    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    ok = all(checks.values())
    print("DRILL PASS" if ok else f"DRILL FAIL: "
          f"{[k for k, v in checks.items() if not v]}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
