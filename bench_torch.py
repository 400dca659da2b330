#!/usr/bin/env python
"""Benchmark: DDPM reverse-sampling throughput of the port
(``crowdmod_tpu_torch``) on one GPU — the twin of ``bench.py``.

Metric: denoise steps/s at batch 64 on the canonical ATC geometry — one
"denoise step" is one sample advanced one reverse timestep, so
rate = batch * timesteps / wall time of the full ancestral chain (T = 1000
on the card; T = 10 with ``--device cpu``, which is not comparable).

Models (``bench.py:85-104``, ``configs/ATC.yml`` MODEL.DDPM): the flagship
DDPM-DiT (DiT4DFactorized, hidden 256 × depth 6 × 4 heads, patch 4 /
t-patch 4: 11.7M parameters) and the DDPM-UNet (base 32, mults 1-2-4,
attention at level 2: 7.2M), seeded random weights, bf16 on the card
(``TPU.COMPUTE_DTYPE``) with the port's tanh-GELU there
(``models/backbones/dit.py::gelu_approximate``), f32 and exact GELU on the
CPU.  Each chain is ``Trainer.sample``, the call ``serving.Predictor``
makes for a request.

Timing (``utils/profiling.py::time_calls``): a warm-up chain, then one
chain under ``torch.profiler`` gives the card's kernel seconds of a warm
chain; then 3 chains,
each between two CUDA events after a synchronize; the fastest gives the
rate.  Nothing is subtracted: the card is local, so no dispatch round trip
sits in the time (``bench.py`` subtracts a remote TPU's).  ``busy_share``
is the kernel seconds of a chain over the timed chain's seconds: the
sampler is host-bound where it is well under 1.

``vs_baseline`` and ``unet_vs_baseline`` are null: ``bench.py``'s target is
a TPU figure, not this card's.  ``device`` is the card's name and power
limit as ``nvidia-smi`` gives them.

Prints exactly one JSON line::

    python bench_torch.py                # on the card
    python bench_torch.py --device cpu   # T = 10, f32
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

B, P, F, H, W, C = 64, 5, 3, 12, 36, 3
# bench.py's two models, as MODEL.DDPM nodes of configs/ATC.yml.
DIT = {"PATCH_SIZE": 4, "HIDDEN_SIZE": 256, "DEPTH": 6, "NUM_HEADS": 4, "MLP_RATIO": 4.0,
       "DROPOUT_RATE": 0.1, "TIME_EMB_MULT": 4, "T_PATCH_SIZE": 4, "CONDITION": "Past"}
UNET = {"BASE_CH": 32, "BASE_CH_MULT": [1, 2, 4],
        "APPLY_ATTENTION": [False, False, True, False], "DROPOUT_RATE": 0.1,
        "NUM_RES_BLOCKS": 1, "TIME_EMB_MULT": 4, "CONDITION": "Past"}
ARCHS = {"dit": "DDPM-DiT", "unet": "DDPM-UNet"}
REPORT_KEYS = ("metric", "value", "unit", "vs_baseline", "unet_steps_per_sec",
               "unet_vs_baseline", "backend", "note")
ADDED_KEYS = ("device", "busy_share", "unet_busy_share")


def bench_config(timesteps: int, *, grid: tuple[int, int] = (H, W), overrides=None):
    """``configs/ATC.yml`` pinned to ``bench.py``'s workload: ancestral DDPM
    over ``timesteps``, linear schedule at scale 0.5, no guidance, its DiT
    and UNet (the FM node's UNet too), bf16 on the card, the ``grid``
    (rows, cols); ``overrides`` merge last."""
    from crowdmod_tpu_torch.config import load_config

    cfg = load_config("ATC.yml").updated({
        "MACROPROPS": {"ROWS": grid[0], "COLS": grid[1]},
        "DATASET": {"PAST_LEN": P, "FUTURE_LEN": F, "BATCH_SIZE": B},
        "MODEL": {"DDPM": {"SAMPLER": "DDPM", "TIMESTEPS": timesteps, "SCALE": 0.5,
                           "GUIDANCE": "None", "DIT": DIT, "UNET": UNET},
                  "FM": {"UNET": UNET}},
        "TPU": {"COMPUTE_DTYPE": "bfloat16"},
    })
    return cfg.updated(overrides) if overrides else cfg


def bench_trainer(cfg, arch: str, device, *, seed: int = 0, conv_impl: str = "im2col",
                  compute_dtype=None):
    """The trainer whose ``sample`` a request runs, weights from ``seed``."""
    from crowdmod_tpu_torch.train.trainer import Trainer

    return Trainer(cfg, arch, device=device, seed=seed, conv_impl=conv_impl,
                   compute_dtype=compute_dtype)


def chain(trainer, batch: int = B, *, seed: int = 1, noise=None):
    """One sampling call at ``batch`` from zero pasts on the trainer's
    device, as ``Predictor.predict`` makes it (draws from a device generator
    seeded ``seed``, or ``noise`` injected) → a callable returning the
    future."""
    import torch

    p, f, h, w = trainer._grid_shapes()
    past = torch.zeros((batch, p, h, w, trainer.mprops_count), device=trainer.device)
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    return lambda: trainer.sample(past, None if noise is not None else gen, noise=noise)


def measure(trainer, batch: int = B, reps: int = 3) -> dict:
    """``reps`` timed chains at ``batch`` (after a warm-up and a profiled
    chain) → steps a second, the chain's seconds (each repetition's, the
    warm-up's) and the busy share."""
    from crowdmod_tpu_torch.utils.profiling import time_calls

    t = time_calls(chain(trainer, batch), reps=reps, device=trainer.device)
    steps = trainer.cfg.MODEL.DDPM.TIMESTEPS
    return {"steps_per_sec": batch * steps / t["seconds"], "chain_s": t["seconds"],
            "reps_s": t["reps_s"], "first_s": t["first_s"], "busy_share": t["busy_share"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from crowdmod_tpu_torch.train.trainer import resolve_device
    from crowdmod_tpu_torch.utils.profiling import card_identity

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    timesteps = 1000 if on_card else 10
    cfg = bench_config(timesteps)
    rates = {name: measure(bench_trainer(cfg, arch, device))
             for name, arch in ARCHS.items()}
    dit, unet = rates["dit"], rates["unet"]
    record = {
        "metric": "ddpm_denoise_steps_per_sec_per_chip",
        "value": round(dit["steps_per_sec"], 1),
        "unit": ("sample-steps/s (batch 64, ATC 12x36x3 grid, "
                 f"DiT4D-factorized 11.7M params, T={timesteps})"),
        "vs_baseline": None,
        "unet_steps_per_sec": round(unet["steps_per_sec"], 1),
        "unet_vs_baseline": None,
        "backend": device.type,
        "note": ("bench.py's baseline is a TPU target: no ratio against it on "
                 + ("this card" if on_card else "the CPU (T=10, not comparable)")),
        "device": card_identity() if on_card else "cpu",
        "busy_share": dit["busy_share"],
        "unet_busy_share": unet["busy_share"],
    }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
