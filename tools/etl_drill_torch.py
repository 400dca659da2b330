#!/usr/bin/env python
"""Raw-CSV → trained-model drill of the PyTorch port
(``crowdmod_tpu_torch``) on the GPU.

One invocation proves the WHOLE chain — the offline ETL the reference ships
as three standalone scripts plus the online trainer — end to end on data
that enters the system in the rawest form it supports:

  synthesize raw ATC-format sensor CSVs from walker dynamics
    (headerless 8-column epoch-seconds/millimetre schema,
     reference aggregateData.py:46-47; numpy, no pandas)
  → the port's ``etl``   (500 ms aggregation → rotation/LU filter → binning
                          → sliding windows → pickles → DATA_LIST yml)
  → the port's ``train`` (the command, as a subprocess)
  → restore the best checkpoint → sample conditioned futures on the held-out
    test file
  → PASS iff the trained model beats the untrained one by ≥3 dB density
    PSNR (the tools/validate_e2e_torch.py criterion).

    python tools/etl_drill_torch.py --out /tmp/etl_drill --epochs 40
    python tools/etl_drill_torch.py --full-width ...   # the ATC grid and UNet
    python tools/etl_drill_torch.py --device cpu ...   # no GPU
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Fixture geometry: small grid, shipped ATC THETA, fractional LU.
THETA = 2.5647
LU = [11.37, 4.21]
T0 = 1_352_862_000.0


def write_raw_csvs(raw_dir, *, n_frames, rows, cols, seed):
    """The drill's three raw sensor CSVs (train/val/test), the JAX tool's
    bytes for the same arguments; → their paths."""
    from crowdmod_tpu_torch.data.synthetic import (
        synthetic_raw_trajectories, write_atc_raw_csv,
    )

    paths = []
    for k in range(3):
        df = synthetic_raw_trajectories(
            n_frames=n_frames, rows=rows, cols=cols,
            lu=LU, theta=THETA, subsamples=2, walkers_per_row=1,
            t0=T0 + k * 86_400.0, seed=seed + k,
        )
        paths.append(os.path.join(raw_dir, f"walkers_{k}.csv"))
        write_atc_raw_csv(df, paths[-1])
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="/tmp/etl_drill")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--lr", type=float, default=2e-4,
                   help="solver LR override (the 4test default 5e-5 needs "
                        "~40 epochs to clear the criterion; 2e-4 does it "
                        "in ~16)")
    p.add_argument("--n-frames", type=int, default=240,
                   help="sensor frames per raw file (windows ≈ frames − 8)")
    p.add_argument("--rows", type=int, default=8)
    p.add_argument("--cols", type=int, default=12)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--arch", default="DDPM-UNet")
    p.add_argument("--sampler", default="DPM-Solver")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--report", default=None, help="write a JSON report here")
    p.add_argument("--timeout", type=int, default=2400,
                   help="training subprocess wall budget (s)")
    p.add_argument("--full-width", action="store_true",
                   help="train the config's UNet (base 32, mults 1-2-4, "
                        "attention at level 2) instead of the fixture's "
                        "base-16 two-level one; pass --rows 12 --cols 36 "
                        "for the ATC grid")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    import torch
    import yaml

    from crowdmod_tpu_torch.cli import etl as cli_etl
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import resolve_device

    device = resolve_device(args.device)
    out = os.path.abspath(args.out)
    raw_dir = os.path.join(out, "raw")
    agg_dir = os.path.join(out, "agg")
    pkl_dir = os.path.join(out, "pickle")
    save_dir = os.path.join(out, "ckpts")
    for d in (raw_dir, agg_dir, pkl_dir, save_dir):
        os.makedirs(d, exist_ok=True)

    # ---- [1] raw sensor CSVs: 3 files (train/val/test) -------------------
    t_synth = time.time()
    write_raw_csvs(raw_dir, n_frames=args.n_frames, rows=args.rows,
                   cols=args.cols, seed=args.seed)
    print(f"[1] synthesized 3 raw CSVs ({time.time() - t_synth:.1f}s)",
          flush=True)

    # ---- [2] config for this corpus --------------------------------------
    window = 8  # PAST 5 + FUTURE 3
    unet = {"DROPOUT_RATE": 0.0,
            "TRAIN": {"EPOCHS": args.epochs, "SOLVER": {"LR": args.lr}}}
    if not args.full_width:
        unet.update({"BASE_CH": 16, "BASE_CH_MULT": [1, 2],
                     "APPLY_ATTENTION": [False, False]})
    cfg = load_config(os.path.join(REPO, "configs", "4test", "ATC.yml")).updated({
        "DATA_FS": {
            "RAW_DATA_DIR": raw_dir, "AGG_DATA_DIR": agg_dir,
            "PICKLE_DIR": pkl_dir, "SAVE_DIR": save_dir,
            "OUTPUT_DIR": os.path.join(out, "out"),
        },
        "MACROPROPS": {
            "ROWS": args.rows, "COLS": args.cols, "LU": LU, "THETA": THETA,
            "OVERLAP": True, "WINDOWSIZE": 1,
        },
        "DATASET": {
            "NAME": "ATC", "RAW_SEQ_LEN": window,
            "BATCH_SIZE": args.batch,
            "TRAIN_FILE_COUNT": 1, "VAL_FILE_COUNT": 1,
            "TEST_FILE_COUNT": 1, "DATASET_TYPE": "ByFilenames",
        },
        "MODEL": {
            "NSAMPLES4PLOTS": 1,
            "DDPM": {
                "SAMPLER": args.sampler, "TIMESTEPS": 100, "DPM_STEPS": 25,
                "CHECKPOINTS_TO_KEEP": 1,
                "UNET": unet,
            },
        },
    })
    cfg_path = os.path.join(out, "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)

    # ---- [3] etl: raw → agg → pickles → DATA_LIST ------------------------
    t_etl = time.time()
    list_path = os.path.join(out, "list.yml")
    rc = cli_etl.run([
        "--config-yml-file", cfg_path, "--data-list-out", list_path,
        "--device", args.device,
    ])
    if rc != 0:
        print(f"[3] etl FAILED rc={rc}")
        return 1
    with open(list_path) as f:
        entries = yaml.safe_load(f)["DATA_LIST"]
    n_windows = sum(c for _, c in entries)
    etl_wall = time.time() - t_etl
    print(f"[3] etl: {len(entries)} pickles / {n_windows} windows "
          f"({etl_wall:.1f}s)", flush=True)
    if len(entries) != 3 or n_windows < 3 * (args.n_frames - window - 10):
        print("[3] unexpected ETL output volume — FAIL")
        return 1

    # ---- [4] train (the command, subprocess) -----------------------------
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (env.get("PYTHONPATH"), REPO) if p
    )
    t_train = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "crowdmod_tpu_torch.cli.train",
         "--config-yml-file", cfg_path, "--configList-yml-file", list_path,
         "--arch", args.arch, "--seed", str(args.seed),
         "--run-dir", os.path.join(out, "run"), "--device", args.device],
        env=env, timeout=args.timeout, capture_output=True, text=True,
        cwd=REPO,
    )
    train_wall = time.time() - t_train
    with open(os.path.join(out, "train.log"), "w") as f:
        f.write(r.stdout + r.stderr)
    if r.returncode != 0:
        print(f"[4] train FAILED rc={r.returncode}\n"
              f"{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        return 1
    print(f"[4] train: {args.epochs} epochs ({train_wall:.1f}s)",
          flush=True)

    # ---- [5] restore + sample + score ------------------------------------
    from crowdmod_tpu_torch.data.ingest import get_test_dataset
    from crowdmod_tpu_torch.metrics import functional as F
    from crowdmod_tpu_torch.train.trainer import Trainer

    # Re-load with the DATA_LIST merged in (what the train subprocess saw).
    cfg = load_config(cfg_path, list_path)
    trainer = Trainer(cfg, args.arch, seed=args.seed, device=device,
                      run_dir=os.path.join(out, "verify"))
    trainer.setup()
    test_ds = get_test_dataset(cfg, trainer.mprops_count, seed=args.seed,
                               device=device)
    past, future = test_ds.gather(np.arange(min(64, len(test_ds))))

    def density_psnr():
        gen = torch.Generator(device=device).manual_seed(0)
        pred = trainer.sample(past, gen)
        ranges = F.channel_ranges(future[..., :3])
        return float(F.psnr_over_time(pred[..., :3], future[..., :3],
                                      ranges)[..., 0].mean())

    untrained = density_psnr()
    best = os.path.join(save_dir, ckpt.checkpoint_name(cfg, args.arch, "000"))
    trainer.load(best)
    trained = density_psnr()
    ok = trained > untrained + 3.0

    report = {
        "drill": "etl_raw_to_train",
        "arch": args.arch,
        "files": 3,
        "windows": n_windows,
        "epochs": args.epochs,
        "grid": [args.rows, args.cols],
        "unet_base_ch": int(cfg.MODEL.DDPM.UNET.BASE_CH),
        "unet_ch_mult": list(cfg.MODEL.DDPM.UNET.BASE_CH_MULT),
        "etl_wall_s": round(etl_wall, 1),
        "train_wall_s": round(train_wall, 1),
        "untrained_density_psnr_db": round(untrained, 3),
        "trained_density_psnr_db": round(trained, 3),
        "improvement_db": round(trained - untrained, 3),
        "criterion": "trained > untrained + 3 dB",
        "backend": device.type,
        "ok": bool(ok),
    }
    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    print(f"ETL DRILL {'PASS' if ok else 'FAIL'}: raw CSV → aggregate → bin "
          f"→ window → pickle → train → sample, {trained - untrained:+.2f} dB")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
