#!/usr/bin/env python
"""Run-to-run variance of the reduced nightly protocol, with the PyTorch
port (``crowdmod_tpu_torch``) on the GPU.

Runs ``tools/eval_protocol_full_torch.py`` at the nightly gate scale N
times with different seeds and summarizes per-sampler mean/σ for PSNR,
SSIM and ENERGY, with the floors ``measured_mean − (2 dB + σ)`` that the
JAX tool suggests.  The JAX tool's flags, ``summary.json`` and report
keys, plus ``--device``.

Optionally (--regression) also runs one raw-weights (EMA-ablated) pass at
the base seed.

    python tools/protocol_variance_torch.py --runs 5 --out /tmp/proto_var
    python tools/protocol_variance_torch.py --device cpu ...   # no GPU
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SAMPLERS = ["DDPM", "DDIM-eta:1.0:10", "DDIM-eta:0.0:10",
            "DDIM-eta:1.0:10+Sparsity:0.4"]
GATE_ARGS = [
    "--timesteps", "100", "--train-epochs", "25", "--pred-type", "v",
    "--ema-decay", "0.999", "--files", "3", "--per-file", "24",
    "--batch-size", "16", "--chunk", "4",
]


def run_once(out, seed, device, sample_weights="ema"):
    from tools.eval_protocol_full_torch import main as eval_main

    rc = eval_main([
        "--out", out, *GATE_ARGS, "--seed", str(seed),
        "--sample-weights", sample_weights,
        "--samplers", *SAMPLERS, "--device", device,
    ])
    assert rc == 0, f"protocol run failed (seed {seed})"
    with open(os.path.join(out, "report.json")) as f:
        return json.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--base-seed", type=int, default=42)
    p.add_argument("--out", default="/tmp/proto_var")
    p.add_argument("--regression", action="store_true",
                   help="also run one raw-weights (EMA-ablated) pass at the "
                        "base seed")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    if args.runs < 2:
        p.error("--runs must be >= 2 (sample std with ddof=1 needs two "
                "runs; floors derived from one run would be meaningless)")

    from crowdmod_tpu_torch.train.trainer import resolve_device

    resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for k in range(args.runs):
        seed = args.base_seed + k
        t0 = time.time()
        rep = run_once(os.path.join(args.out, f"run_{seed}"), seed, args.device)
        wall = time.time() - t0
        row = {"seed": seed, "wall_s": round(wall, 1)}
        for s in SAMPLERS:
            means = rep["samplers"][s]["metric_means"]
            row[s] = {m: means.get(m) for m in ("PSNR", "SSIM", "ENERGY")}
        rows.append(row)
        print(f"seed {seed} ({wall:.0f}s): " + "  ".join(
            f"{s}: PSNR {row[s]['PSNR']} SSIM {row[s]['SSIM']} "
            f"ENERGY {row[s]['ENERGY']}" for s in SAMPLERS), flush=True)

    summary = {"runs": args.runs, "gate_args": GATE_ARGS, "rows": rows,
               "stats": {}, "suggested_floors": {}}
    for s in SAMPLERS:
        summary["stats"][s] = {}
        for m in ("PSNR", "SSIM", "ENERGY"):
            vals = np.array([r[s][m] for r in rows if r[s][m] is not None])
            if not len(vals):
                continue
            mean, std = float(vals.mean()), float(vals.std(ddof=1))
            summary["stats"][s][m] = {
                "mean": round(mean, 3), "std": round(std, 3),
                "min": round(float(vals.min()), 3),
                "max": round(float(vals.max()), 3),
            }
            if m == "PSNR":
                summary["suggested_floors"][s] = round(mean - (2.0 + std), 2)

    if args.regression:
        t0 = time.time()
        rep = run_once(os.path.join(args.out, "run_raw"), args.base_seed,
                       args.device, sample_weights="raw")
        summary["raw_weights_regression"] = {
            s: {m: rep["samplers"][s]["metric_means"].get(m)
                for m in ("PSNR", "SSIM", "ENERGY")}
            for s in SAMPLERS
        }
        summary["raw_weights_wall_s"] = round(time.time() - t0, 1)
        print("raw-weights (EMA-ablated) pass:", json.dumps(
            summary["raw_weights_regression"], indent=2), flush=True)

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary["stats"], indent=2))
    print("suggested PSNR floors (mean - (2 + sigma)):",
          json.dumps(summary["suggested_floors"], indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
