#!/usr/bin/env python
"""Sampler throughput of the port across every bundled dataset geometry,
on one GPU — the twin of ``tools/bench_geometries.py``.

The reference ships six grid geometries (its config/*.yml); this sweep
runs the two DDPM samplers (UNet3D and the DiT flagship, both at their
reference ATC model configs: ``bench_torch.py``'s models, bf16 on the
card) at every bundled geometry, showing how throughput scales with grid
area.  Each point is one ancestral chain (``Trainer.sample``) timed by
``tools/bench_suite_torch.py::timeit``: a warm-up, one profiled chain,
then 3 chains between CUDA events, nothing subtracted (the card is local:
no dispatch round trip in the time); ``busy_share`` is the card's kernel
seconds of the profiled chain over the timed chain's, ``device`` the
card's name and power limit as ``nvidia-smi`` gives them.

Usage::

    python tools/bench_geometries_torch.py [--quick] [--backbone unet|dit|both]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools.bench_suite_torch import timeit  # noqa: E402

B, P, F, C = 64, 5, 3, 3

# Bundled configs with distinct grids (the -OBST variants share geometry
# with their base configs).
GEOMETRY_CONFIGS = [
    "ATC.yml",            # 12×36
    "HERMES-BO.yml",      # 12×24
    "HERMES-BN.yml",      # 28×16
    "HERMES-CR-90.yml",   # 12×20
    "HERMES-CR-120.yml",  # 28×24
    "ETHUCY.yml",         # 8×12
]
REPORT_KEYS = ("metric", "geometry", "config", "value", "unit")
ADDED_KEYS = ("busy_share", "device")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--backbone", choices=["unet", "dit", "both"],
                   default="both")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    from bench_torch import ARCHS, bench_config, bench_trainer, chain
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.train.trainer import resolve_device
    from crowdmod_tpu_torch.utils.profiling import card_identity

    device = resolve_device(args.device)
    card = card_identity() if device.type == "cuda" else "cpu"
    timesteps = 100 if args.quick else 1000
    names = ["unet", "dit"] if args.backbone == "both" else [args.backbone]

    for cfg_name in GEOMETRY_CONFIGS:
        geo = load_config(cfg_name)
        h, w = int(geo.MACROPROPS.ROWS), int(geo.MACROPROPS.COLS)
        cfg = bench_config(timesteps, grid=(h, w))
        for name in names:
            trainer = bench_trainer(cfg, ARCHS[name], device)
            dt, busy = timeit(chain(trainer, B), reps=3, device=device)
            print(json.dumps({
                "metric": f"ddpm_{name}_steps_per_sec",
                "geometry": f"{h}x{w}",
                "config": cfg_name,
                "value": round(B * timesteps / dt, 1),
                "unit": "sample-steps/s (batch 64)",
                "busy_share": busy,
                "device": card,
            }), flush=True)
            del trainer
    return 0


if __name__ == "__main__":
    sys.exit(main())
