#!/usr/bin/env python
"""Batch scaling of the port's DDPM samplers on one GPU — the twin of
``tools/bench_batch_scaling.py``.

``bench_torch.py``'s metric is fixed at batch 64, but production serving
wants the card's saturation point: how far does throughput rise (and
per-sample latency fall) as the sampler batch grows?  Each point is one
ancestral chain of ``bench_torch.py``'s model (``Trainer.sample``, bf16 on
the card) at that batch, timed by ``tools/bench_suite_torch.py::timeit``:
a warm-up, one profiled chain, then 3 chains between CUDA events, nothing
subtracted (the card is local: no dispatch round trip in the time).
``busy_share`` (the card's kernel seconds of the profiled chain over the
timed chain's) says where the host stops holding the card back; ``device``
is the card's name and power limit as ``nvidia-smi`` gives them.

Usage::

    python tools/bench_batch_scaling_torch.py [--quick] [--backbone unet|dit|both]
        [--batches 16,32,64,128,256,512] [--device cuda]
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

P, F, H, W, C = 5, 3, 12, 36, 3
REPORT_KEYS = ("metric", "batch", "value", "chain_latency_s", "unit")
ADDED_KEYS = ("busy_share", "device")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--backbone", choices=["unet", "dit", "both"],
                   default="dit")
    p.add_argument("--batches", default="16,32,64,128,256,512")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]

    from bench_torch import ARCHS, bench_config, bench_trainer, chain
    from crowdmod_tpu_torch.train.trainer import resolve_device
    from crowdmod_tpu_torch.utils.profiling import card_identity

    device = resolve_device(args.device)
    card = card_identity() if device.type == "cuda" else "cpu"
    timesteps = 100 if args.quick else 1000
    cfg = bench_config(timesteps)
    names = ["unet", "dit"] if args.backbone == "both" else [args.backbone]

    for name in names:
        trainer = bench_trainer(cfg, ARCHS[name], device)
        for b in batches:
            dt, busy = timeit(chain(trainer, b), reps=3, device=device)
            print(json.dumps({
                "metric": f"ddpm_{name}_steps_per_sec",
                "batch": b,
                "value": round(b * timesteps / dt, 1),
                "chain_latency_s": round(dt, 3),
                "unit": "sample-steps/s",
                "busy_share": busy,
                "device": card,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
