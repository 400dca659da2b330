#!/usr/bin/env python
"""Extended benchmark suite of the port (``crowdmod_tpu_torch``) on one
GPU: every hot path, one JSON line per metric — the twin of
``tools/bench_suite.py``, with its sections, metric names and units.

``bench_torch.py`` reports the headline metric; this suite covers the rest
of the surface (training step, DDIM, the distilled sampler, flow-matching
integrators, ConvRNN rollout, the metric suite).  The models are
``bench_torch.py``'s (``configs/ATC.yml`` widths, seeded random weights,
bf16 on the card), each sampler called through ``Trainer.sample`` as a
request runs it.

Timing (:func:`timeit`, over ``utils/profiling.py::time_calls``): a warm-up
call, one call under ``torch.profiler``, then repetitions between CUDA events after a
synchronize (a short call is repeated ``iters`` times between the events,
where the JAX suite loops on the device).  Nothing is subtracted: the card
is local, so no dispatch round trip sits in the time (the JAX suite
subtracts a remote TPU's).  Each line carries ``busy_share``, the card's
kernel seconds of a warm call over the timed call's (the samplers are
host-bound where it is well under 1), and ``device``, the card's name and
power limit as ``nvidia-smi`` gives them.

Usage::

    python tools/bench_suite_torch.py [--quick] [--only ddpm,dit] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

B, P, F, H, W, C = 64, 5, 3, 12, 36, 3

SECTIONS = (
    "ddpm", "dit", "ddim", "distilled", "train", "fm", "convrnn", "metrics"
)
# The metrics of every section, in the order the suite reports them.
METRICS = (
    "ddpm_denoise_steps_per_sec", "ddpm_dit_denoise_steps_per_sec",
    "ddim10_samples_per_sec", "distilled8_samples_per_sec", "train_steps_per_sec",
    "train_samples_per_sec", "fm_euler_steps_per_sec", "fm_heun_steps_per_sec",
    "convrnn_rollouts_per_sec", "metric_suite_seqs_per_sec",
)
REPORT_KEYS = ("metric", "value", "unit")
ADDED_KEYS = ("busy_share", "device")


def timeit(fn, *args, reps: int = 5, iters: int = 1, device="cuda") -> tuple:
    """``fn(*args)`` timed (module docstring) → (seconds a call, busy
    share; None on the CPU)."""
    from crowdmod_tpu_torch.utils.profiling import time_calls

    t = time_calls(lambda: fn(*args), reps=reps, iters=iters, device=device)
    return max(t["seconds"], 1e-9), t["busy_share"]


def report(metric, value, unit, busy_share, device):
    print(json.dumps({"metric": metric, "value": round(value, 1), "unit": unit,
                      "busy_share": busy_share, "device": device}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument(
        "--only", default=None,
        help="comma-separated subset of sections to run: "
             + ",".join(SECTIONS),
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    only = set(args.only.split(",")) if args.only else set(SECTIONS)
    unknown = only - set(SECTIONS)
    if unknown:
        p.error(f"unknown sections {sorted(unknown)}")
    run = only.__contains__

    import torch

    from bench_torch import bench_config, bench_trainer, chain
    from crowdmod_tpu_torch.train.trainer import resolve_device
    from crowdmod_tpu_torch.utils.profiling import card_identity

    device = resolve_device(args.device)
    card = card_identity() if device.type == "cuda" else "cpu"
    T = 200 if args.quick else 1000
    cfg = bench_config(T)

    def sampler(arch, overrides=None):
        tr = bench_trainer(cfg.updated(overrides) if overrides else cfg, arch, device)
        return chain(tr)

    # 1. DDPM ancestral sampling (headline).
    if run("ddpm"):
        dt, busy = timeit(sampler("DDPM-UNet"), reps=3, device=device)
        report("ddpm_denoise_steps_per_sec", B * T / dt, "sample-steps/s", busy, card)

    # 1b. DDPM-DiT flagship (reference DDPM-DiT config).
    if run("dit"):
        dt, busy = timeit(sampler("DDPM-DiT"), reps=3, device=device)
        report("ddpm_dit_denoise_steps_per_sec", B * T / dt, "sample-steps/s", busy, card)

    # 2. DDIM (divider 10).
    if run("ddim"):
        fn = sampler("DDPM-UNet", {"MODEL": {"DDPM": {"SAMPLER": "DDIM",
                                                      "DDIM_DIVIDER": 10}}})
        dt, busy = timeit(fn, reps=3, device=device)
        report("ddim10_samples_per_sec", B / dt, "full samples/s (batch 64)", busy, card)

    # 2b. Distilled few-step sampler (DiT flagship geometry; a short chain,
    # repeated between the events).
    if run("distilled"):
        fn = sampler("DDPM-DiT", {"MODEL": {"DDPM": {"SAMPLER": "Distilled",
                                                     "DISTILL_STEPS": 8}}})
        dt, busy = timeit(fn, reps=3, iters=50, device=device)
        report("distilled8_samples_per_sec", B / dt,
               "full samples/s (batch 64, 8-step DiT student)", busy, card)

    # 3. Training step throughput.
    if run("train"):
        from crowdmod_tpu_torch.models.diffusion.ddpm import ddpm_loss
        from crowdmod_tpu_torch.train.optim import adam
        from crowdmod_tpu_torch.train.state import TrainState, train_step

        tr = bench_trainer(cfg, "DDPM-UNet", device)
        model = tr.model.train()
        gen = torch.Generator(device=device).manual_seed(2)
        past = torch.zeros((B, P, H, W, C), device=device)
        future = torch.zeros((B, F, H, W, C), device=device)

        def loss_fn(p_, f_):
            d = lambda x, t, c_: model(x, t, c_, generator=gen)  # noqa: E731
            return ddpm_loss(d, tr.sched, f_, p_, generator=gen)

        state = TrainState(model, adam(model.parameters(), 1e-4))
        dt, busy = timeit(train_step, state, loss_fn, past, future, reps=10,
                          device=device)
        report("train_steps_per_sec", 1.0 / dt, "optimizer steps/s (batch 64)", busy, card)
        report("train_samples_per_sec", B / dt, "training samples/s", busy, card)

    # 4. Flow matching integrators.
    if run("fm"):
        steps = 100 if args.quick else 1000
        for name, n in (("Euler", steps), ("Heun", steps // 2)):
            fn = sampler("FM-UNet", {"MODEL": {"FM": {
                "INTEGRATOR": name, "TIME_MAX_POS": T,
                "INTEGRATOR_STEPS": {name.upper(): n}}}})
            dt, busy = timeit(fn, reps=3, device=device)
            report(f"fm_{name.lower()}_steps_per_sec", B * n / dt,
                   "integrator steps/s", busy, card)

    # 5. ConvRNN rollout.
    if run("convrnn"):
        from crowdmod_tpu_torch.models.convrnn import CELLS, Forecaster
        from crowdmod_tpu_torch.train.trainer import platform_compute_dtype

        conv_model = Forecaster(
            out_channels=4, cell=CELLS["ConvGRUCell"],
            dtype=platform_compute_dtype(cfg, device.type),
        ).to(device).eval()
        past4 = torch.zeros((B, P, H, W, 4), device=device)

        @torch.no_grad()
        def rollout(x):
            return conv_model(x, future_len=F, teacher_forcing=False)

        dt, busy = timeit(rollout, past4, reps=3, iters=200, device=device)
        report("convrnn_rollouts_per_sec", B / dt, "forecasts/s (batch 64)", busy, card)

    # 6. On-device metric suite.
    if run("metrics"):
        from crowdmod_tpu_torch.metrics import functional as mf

        gen = torch.Generator(device=device).manual_seed(5)
        pred = torch.rand((256, F, H, W, C), generator=gen, device=device)
        gt = torch.rand((256, F, H, W, C), generator=gen, device=device)

        def metric_suite(pred, gt):
            r = mf.channel_ranges(gt)
            return (
                mf.psnr_over_time(pred, gt, r),
                mf.psnr_over_time(pred, gt, r, masked=True),
                mf.ssim_over_time(pred, gt, r),
                mf.tv_over_time(pred, gt),
                mf.re_density(pred, gt),
            )

        dt, busy = timeit(metric_suite, pred, gt, reps=3, iters=600, device=device)
        report("metric_suite_seqs_per_sec", 256 / dt,
               "sequences/s (PSNR+mPSNR+SSIM+TV+RE)", busy, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
