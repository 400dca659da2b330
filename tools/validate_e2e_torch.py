#!/usr/bin/env python
"""End-to-end validation: train → sample → score on the walker fixture,
with the PyTorch port (``crowdmod_tpu_torch``) on the GPU.

Trains DDPM (UNet or DiT) on the deterministic diagonal-walker dataset
(SURVEY.md §4's synthetic harness), samples conditioned futures, and scores
them against ground truth with the metric suite on the device.  Passes when
the trained model clearly beats an untrained one on density PSNR (by more
than 3 dB) — i.e., the whole stack (data → train → checkpoint → sample →
metrics) demonstrably learns.

    python tools/validate_e2e_torch.py --arch DDPM-UNet --epochs 60
    python tools/validate_e2e_torch.py --device cpu ...   # no GPU
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="DDPM-UNet")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--sampler", default="DPM-Solver",
                   help="DDPM | DDIM | DPM-Solver")
    p.add_argument("--out", default=None, help="Write a JSON report here.")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--w-type", default=None, choices=["Linear", "Conic"],
                   help="FM interpolant override (MODEL.FM.W_TYPE)")
    p.add_argument("--ema", type=float, default=0.0,
                   help="TRAIN.EMA_DECAY (0 disables; e.g. 0.995)")
    p.add_argument("--distill", type=int, default=0,
                   help="After training, progressively distill the sampler "
                        "to this many steps (DDPM archs only; 0 = off).")
    p.add_argument("--distill-start", type=int, default=64)
    p.add_argument("--distill-epochs", type=int, default=6,
                   help="Epochs per halving phase.")
    p.add_argument("--distill-lr", type=float, default=1e-4)
    p.add_argument("--reflow", type=int, default=0,
                   help="After training an FM arch, rectify (ReFlow) and "
                        "compare this many Euler steps (0 = off).")
    p.add_argument("--reflow-epochs", type=int, default=6)
    p.add_argument("--cfg-drop", type=float, default=0.0,
                   help="Train with classifier-free-guidance condition "
                        "dropout (MODEL.*.CFG_DROP_PROB).")
    p.add_argument("--cfg-scales", type=float, nargs="*", default=[],
                   help="After training, score guided sampling at each "
                        "CFG_SCALE (requires --cfg-drop > 0).")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    from crowdmod_tpu_torch.train.trainer import resolve_device

    resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="validate_") as work:
        return run(args, work)


def run(args, work: str) -> int:
    """The validation with its checkpoints and run files under ``work``."""
    import torch

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.metrics import functional as F
    from crowdmod_tpu_torch.train.trainer import Trainer, resolve_device

    device = resolve_device(args.device)
    h, w = 12, 36
    epochs_node = {"TRAIN": {
        "EPOCHS": args.epochs,
        **({"EMA_DECAY": args.ema} if args.ema else {}),
    }}
    cfg = load_config(os.path.join(REPO, "configs", "4test", "ATC.yml")).updated({
        "DATA_FS": {"SAVE_DIR": os.path.join(work, "ckpts"),
                    "OUTPUT_DIR": os.path.join(work, "out")},
        "DATASET": {"BATCH_SIZE": args.batch},
        "MODEL": {
            "DDPM": {
                "SAMPLER": args.sampler, "DPM_STEPS": 25, "DDIM_DIVIDER": 10,
                "UNET": epochs_node, "DIT": epochs_node,
                **({"CFG_DROP_PROB": args.cfg_drop} if args.cfg_drop else {}),
            },
            "FM": {"UNET": epochs_node, "DIT": epochs_node,
                   "INTEGRATOR_STEPS": {"EULER": 100, "HEUN": 50},
                   **({"W_TYPE": args.w_type} if args.w_type else {}),
                   **({"CFG_DROP_PROB": args.cfg_drop}
                      if args.cfg_drop else {})},
            "CONVRNN": epochs_node,
        },
    })

    # Walkers with per-sequence phase diversity: roll the time axis so the
    # model must actually use the conditioning.
    rng = np.random.default_rng(args.seed)
    channels = 4 if args.arch == "ConvRNN" else 3
    base = synthetic_walkers(args.n_train, h, w, 16)
    for i in range(len(base)):
        base[i] = np.roll(base[i], int(rng.integers(16)), axis=0)
    if channels == 4:
        base = np.concatenate(
            [base, np.zeros(base.shape[:-1] + (1,), base.dtype)], -1
        )
    ds = WindowDataset(torch.from_numpy(base).to(device), past_len=5,
                       future_len=3, stride=4)

    def score(pred, future):
        ranges = F.channel_ranges(future[..., :3])
        psnr = F.psnr_over_time(pred[..., :3], future[..., :3], ranges)
        return float(psnr[..., 0].mean())

    def density_psnr(trainer, n=64, seed=0):
        past, future = ds.gather(np.arange(min(n, len(ds))))
        gen = torch.Generator(device=device).manual_seed(seed)
        return score(trainer.sample(past, gen), future)

    trainer = Trainer(cfg, args.arch, run_dir=os.path.join(work, "run"),
                      seed=args.seed, device=device)
    trainer.setup()
    untrained = density_psnr(trainer)
    print(f"untrained density PSNR: {untrained:.3f} dB")

    t0 = time.time()
    hist = trainer.fit(ds, epochs=args.epochs)
    wall = time.time() - t0
    print(f"trained {args.epochs} epochs in {wall:.1f}s "
          f"(final loss {hist['train_loss'][-1]:.5f})")

    trained = density_psnr(trainer)
    print(f"trained density PSNR:   {trained:.3f} dB "
          f"(+{trained - untrained:.3f} dB)")

    report = {
        "arch": args.arch,
        "sampler": args.sampler,
        "w_type": args.w_type,
        "epochs": args.epochs,
        "train_wall_s": round(wall, 1),
        "final_loss": round(hist["train_loss"][-1], 6),
        "untrained_density_psnr_db": round(untrained, 3),
        "trained_density_psnr_db": round(trained, 3),
        "improvement_db": round(trained - untrained, 3),
        "backend": device.type,
    }
    if args.cfg_drop:
        report["cfg_drop_prob"] = args.cfg_drop

    if args.cfg_scales:
        # CFG quality study (guidance family precedent: reference
        # models/guidance.py:4-69): the same trained model, sampled at each
        # guidance scale — scale 1.0 is the pure-conditional baseline.
        if not args.cfg_drop:
            raise SystemExit("--cfg-scales needs --cfg-drop > 0 (no trained "
                             "unconditional branch otherwise)")
        node = "FM" if args.arch.startswith("FM") else "DDPM"
        cfg_psnr = {}
        for scale in args.cfg_scales:
            trainer.cfg = cfg.updated(
                {"MODEL": {node: {"CFG_SCALE": float(scale)}}}
            )
            cfg_psnr[str(scale)] = round(density_psnr(trainer), 3)
            print(f"CFG_SCALE={scale}: density PSNR "
                  f"{cfg_psnr[str(scale)]:.3f} dB", flush=True)
        trainer.cfg = cfg
        report["cfg_scale_density_psnr_db"] = cfg_psnr

    if args.reflow:
        from crowdmod_tpu_torch.models.flow_matching import euler_sample
        from crowdmod_tpu_torch.train.distiller import reflow as run_reflow

        tmp_pos = cfg.MODEL.FM.TIME_MAX_POS

        def density_psnr_euler(model, n_steps, n=64, seed=0):
            past, future = ds.gather(np.arange(min(n, len(ds))))
            gen = torch.Generator(device=device).manual_seed(seed)
            with torch.no_grad():
                pred = euler_sample(
                    trainer._denoise_fn(model), past, tuple(future.shape),
                    steps=n_steps, time_max_pos=tmp_pos, generator=gen,
                    device=device,
                )
            return score(pred, future)

        raw_fewstep = density_psnr_euler(trainer._sample_model(), args.reflow)
        print(f"teacher at {args.reflow} Euler steps: {raw_fewstep:.3f} dB")

        t1 = time.time()
        run_reflow(
            trainer, ds, rounds=1, coupling_steps=100,
            epochs_per_round=args.reflow_epochs, seed=args.seed,
        )
        reflow_wall = time.time() - t1
        student = density_psnr_euler(trainer.model, args.reflow)
        print(f"rectified at {args.reflow} Euler steps: {student:.3f} dB "
              f"(reflowed in {reflow_wall:.1f}s)")
        report.update({
            "reflow_steps": args.reflow,
            "reflow_wall_s": round(reflow_wall, 1),
            "teacher_fewstep_psnr_db": round(raw_fewstep, 3),
            "reflow_psnr_db": round(student, 3),
            "reflow_gain_db": round(student - raw_fewstep, 3),
        })

    if args.distill:
        from crowdmod_tpu_torch.models.diffusion import distilled_sample
        from crowdmod_tpu_torch.train.distiller import progressive_distill

        def density_psnr_nstep(model, n_steps, n=64, seed=0):
            past, future = ds.gather(np.arange(min(n, len(ds))))
            gen = torch.Generator(device=device).manual_seed(seed)
            with torch.no_grad():
                pred = distilled_sample(
                    trainer._denoise_fn(model), trainer.sched, past,
                    tuple(future.shape), n_steps, generator=gen,
                    device=device,
                )
            return score(pred, future)

        raw_fewstep = density_psnr_nstep(trainer._sample_model(), args.distill)
        print(f"teacher forced to {args.distill} det. steps: "
              f"{raw_fewstep:.3f} dB")

        t1 = time.time()
        progressive_distill(
            trainer, ds, target_steps=args.distill,
            start_steps=args.distill_start,
            epochs_per_phase=args.distill_epochs, lr=args.distill_lr,
            seed=args.seed,
        )
        distill_wall = time.time() - t1
        student = density_psnr_nstep(trainer.model, args.distill)
        print(f"distilled {args.distill}-step student:      "
              f"{student:.3f} dB (distilled in {distill_wall:.1f}s)")
        report.update({
            "distill_steps": args.distill,
            "distill_start_steps": args.distill_start,
            "distill_wall_s": round(distill_wall, 1),
            "teacher_fewstep_psnr_db": round(raw_fewstep, 3),
            "distilled_psnr_db": round(student, 3),
            "distill_gain_db": round(student - raw_fewstep, 3),
        })
    ok = trained > untrained + 3.0
    report["ok"] = bool(ok)
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
