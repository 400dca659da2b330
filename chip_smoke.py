#!/usr/bin/env python3
"""Drive the PyTorch port (``crowdmod_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, on a machine with CUDA
    python3 chip_smoke.py --conv-baseline DIR   # phase 1, then this tree's conv
                                   # kernels against DIR/conv3d.cu, common.cuh,
                                   # mma.cuh of commit cdc7807
    python3 chip_smoke.py --kernel-baseline DIR # phase 1, then this tree's
                                   # attention and fused resblock against
                                   # DIR/attention.cu, resblock.cu (+ headers)
                                   # of commit ed2c182, at every path shape at
                                   # batch 64, 8 and 1, in turns
    python3 chip_smoke.py --conv-ab SRC...      # phase 1, then builds of variants
                                   # of csrc/conv3d.cu against each other
    python3 chip_smoke.py --conv-tiles          # phase 1, then every bf16 halo
                                   # block at every path shape (the plans' data)
    python3 chip_smoke.py --gn-plans            # phase 1, then every bf16 GroupNorm
                                   # route and cluster size at every path shape
                                   # and serving bucket (the plan's data)
    python3 chip_smoke.py --serving [DIR]       # phases 1, 3-4 and 6-7 only, with
                                   # the port package of checkout DIR (default:
                                   # this one): serving paths of two trees, A/B
    python3 chip_smoke.py --parallel            # phases 1, 10 and 16 only (16 on
                                   # every visible card: a process or replica each)
    python3 chip_smoke.py --commands            # phases 1, 10 and 17 only
    python3 chip_smoke.py --cross-device        # phase 1, then phase 14's
                                   # cross-device exports and their checks only
    python3 chip_smoke.py --tp-trace            # phase 1, then a tensor-parallel
                                   # training step profiled on every card (4+)
    python3 chip_smoke.py --train-time DIR...   # phase 1, then phase 10's train
                                   # command (and the UNet's) from each checkout
                                   # DIR, in turns: wall and fit seconds
    python3 chip_smoke.py --drills              # phase 1, phase 18, then the
                                   # validation, ETL, protocol and stream drills,
                                   # a 16-client HTTP soak and two quickstarts
    python3 chip_smoke.py --multihost           # phase 1, then the multi-process
                                   # rehearsal (2 and 4 processes over NCCL,
                                   # a card each) and the scaling quickstart
    python3 chip_smoke.py --geometries          # phase 1, phase 19, then the
                                   # DDIM sweep tool at HERMES-CR-120's grid
                                   # and the protocol variance tool

Phases, one line of numbers each; any failure raises and the script exits
non-zero without a result line:

  1. device: the card's name and power limit (nvidia-smi), kernel build time;
  2. kernels: each CUDA kernel against its plain twin on the card, at the
     serving paths' shapes, in f32 and bf16, with its plan (route, tiles,
     cluster size), a second call held bitwise equal to the first, device
     times (CUDA events), the host's time to issue a call, bounds and the
     library yardstick (for the resblock, which no single library call
     computes, the unfused PyTorch sequence and the port's own unfused
     composition of its GroupNorm and im2col kernels, at batch 64, 8 and
     1; for the ancestral step, which has none, the launch floor of a
     one-element elementwise op);
  3. DiT serving: ``configs/serving/ATC.yml`` with DDPM-DiT (hidden 256,
     depth 6, DDIM-eta 25 steps + Sparsity) and seeded random weights,
     through ``load_predictor``/``warmup``/``BatchingQueue``, with p50
     latency per bucket and a ``torch.profiler`` trace of one batch-64
     request (device busy time, kernel launches, the top kernels);
  4. DiT ancestral: the same model with ``SAMPLER: DDPM`` (T = 1000);
  5. DiT end to end against the twins: one f32 denoiser forward and one
     25-step DDIM-eta chain, with the kernels and with the twins, on the card;
  6. UNet serving: phase 3 with DDPM-UNet (base 32, mults 1-2-4, attention
     at level 2), whose forward runs the GroupNorm, conv (im2col), fused
     ResnetBlock and attention kernels;
  7. UNet ancestral: phase 4 with DDPM-UNet;
  8. UNet end to end in f32: kernels with ``conv_impl="im2col"``, kernels
     with ``conv_impl="tapgemm"`` (the tap-GEMM kernel's path) and twins,
     each chain free-running;
  9. training, each model: ``configs/ATC.yml`` at full width (batch 64,
     bf16, EMA 0.999) through ``Trainer.fit`` for one short epoch of
     synthetic walker windows, then ``evaluate``: losses, ms per step,
     launches per step, the device busy share of one profiled step; the
     UNet also one step with ``conv_impl="tapgemm"``; and the gradient
     check: one batch through the kernels against the same batch under the
     twins, in f32 (TF32 off, deterministic algorithms: every parameter
     within 1e-4·max|g| of the twins') and in bf16 (each parameter's
     gradient at cosine ≥ 0.99 with the f32 twins', the loss within 2e-2);
     checkpoints: ``fit``'s asynchronously committed best checkpoint
     bitwise equal to the state it ended with, an async save raced by two
     more steps bitwise equal to the state of the call and byte for byte a
     synchronous save's, the save's ms on the loop (sync and async), the
     commit's ms, and one more epoch's wall with async and with sync
     saves; the UNet's fused block's gradient (``FusedResblock``: the
     kernel forward, the twin's VJP backward) at 32→32 and 96→32 against
     autograd through the twin, f32 within 1e-4·max|g|, bf16 at cosine ≥
     0.99, one launch a forward;
 10. the main path through the command line: synthetic walker sequences
     written as reference-layout pickles with a DATA_LIST and a copy of
     ``configs/serving/ATC.yml``; ``python -m crowdmod_tpu_torch.cli train``
     (DDPM-DiT, one epoch of 20 steps) then ``generate-metrics --metric ALL``
     on its checkpoint (1280 samples, 64 pasts × 20, in one sample call):
     every CSV and the manifest under the JAX package's names, finite, the
     launches from the command's log line; ``train``'s asynchronously
     committed checkpoint bitwise equal to the state of the same ``fit``
     run in this process, its files byte for byte that fit's; DDPM-UNet's
     ``Trainer.generate_metrics`` in this process, its metric suite on the
     card held bitwise to a second run and to the CPU's within the CPU
     tests' tolerances; each model's ``generate_metrics`` profiled (device
     busy share) and one f32 forward at batch 1280, kernels vs twins; then
     flow matching: FM-DiT through ``train``, ``generate-metrics`` (50
     Euler steps, cut from the configured 1000, 1280 samples) and
     ``reflow`` (one round),
     its ``RF1`` checkpoint served at Euler 4, and FM-UNet's
     ``Trainer.generate_metrics`` in this process at 50 Euler steps;
 11. flow matching, each of FM-DiT (DiT2D, 216 tokens) and FM-UNet at the
     serving config's width with seeded random weights: serving through
     ``load_predictor``/``BatchingQueue`` at Euler 50 (buckets 1 and 64,
     the p50 of batch 64, a profiled batch-64 request; the configured 1000
     steps cut for time) and one Heun-50 request (the configured 500 steps
     cut for time); one f32
     forward and one 25-step Euler chain, kernels vs twins; one short
     training epoch (phase 9's, without its gradient check) and
     ``evaluate``;
 12. the DDPM fast samplers at the serving config's width, each of
     DDPM-DiT and DDPM-UNet with seeded random weights: DPM-Solver (20
     steps) and Distilled-eta:1.0:8 through ``load_predictor``/
     ``BatchingQueue`` (buckets 1 and 64, p50, a profiled batch-64 request),
     one f32 10-step DPM-Solver chain kernels vs twins; then ``python -m
     crowdmod_tpu_torch.cli distill`` on phase 10's DDPM-DiT checkpoint (8
     → 4 steps, one epoch a phase), its ``D004`` checkpoint served by the
     Distilled sampler at 4 steps, and one UNet ``progressive_distill``
     phase in this process (ms a step, launches a step: two fused teacher
     forwards and one fused student forward, the student in eval mode);
 13. ConvRNN (GRU, 4 channels) at the configs' width: phase 9's training
     (one short epoch, ``evaluate``, ms a step, busy share, peak memory),
     serving at buckets 1 and 64, ``train`` then ``generate-metrics``
     through the command line on phase 10's pickles, and one f32 forward
     (teacher-forced) and one free rollout on the card against the same
     weights on the CPU; no kernel of the port on any of its paths (its
     convolutions are library calls, as they are XLA's in the JAX package).

 14. serving's deployment commands at the serving config's width, DDPM-DiT
     and DDPM-UNet with seeded random weights: ``export`` (ten processes
     at once, one intra-op thread each: each model's DDIM-eta 25 +
     Sparsity sampler at buckets 1 and 64, the DiT's
     T = 1000 ancestral chain at 64, the DiT's DPM-Solver 20 at 64, the
     UNet's Distilled-eta:1.0:8 at 64, the DiT's DDIM-eta 25 with
     mass-preservation guidance at 1, and the UNet's DDIM-eta at 64 and
     the DiT's T = 1000 at 64 again from processes that see no card,
     ``--device cpu --platform cuda``; export seconds, bytes, the
     ``crowdmod::`` nodes of each graph), ``import-checkpoint``,
     ``params`` and the ``serve`` process's start meanwhile; ``serve``
     with both models as a process (/healthz 503 then 200, HTTP p50 per
     bucket 1/8/64, a
     concurrent burst coalesced, a seeded request twice, SIGTERM → drained,
     exit 0, launches from its log); each artifact in this process against
     the un-exported ``sampler_fn`` for the same seed (bitwise, else within
     the bf16 tolerance, said so), its launches held to (forwards + the
     scan's extra body call) forwards, p50 in turns with the ``Predictor``
     of the same sampler, a profiled batch-64 request; ``serve
     --artifact``, its seeded request held to a seeded ``Predictor``
     request of the same checkpoint (bitwise, else within the bf16
     tolerance with the reason); each cross-device artifact loaded on the
     card, its nodes and one request's launches those of the card's
     export, its future bitwise equal to that export's for the same
     bucket and seed.  The ``import-checkpoint`` run takes a
     reference-format ``.pt`` of the DiT's weights; the imported checkpoint
     serves the original's future.
 15. the data path at the size of one hour of one ATC recording day:
     synthetic raw trajectories (``configs/ATC.yml``'s 12 × 36 geometry, 7200
     frames, 8 walkers a row, 2 readings a 500 ms bin: 1,382,400 rows)
     written as a headerless raw CSV; ``python -m crowdmod_tpu_torch.cli
     etl`` on the card (seconds of aggregate, read, preprocess and filter,
     bin, windows and pickle; the windows written); the aggregated file
     binned again in this process twice on the card (bitwise equal, and
     equal to the command's pickle) and once on the CPU (density equal,
     the rest within 1e-5·max|ref|); the pickle through ``load_pickles``
     twice, the second time from its ``.cmb`` sidecar (the native library
     built with g++); one DDPM-UNet ``Trainer.fit`` epoch of phase 9's
     length on the windows, its launches held to phase 9's a step.

 16. the parallel paths over NCCL, a process (or a replica) a visible card
     (a world of one on one card), on phase 10's workspace: ``train --arch
     DDPM-UNet --data-parallel`` through ``--multihost`` and the CROWDMOD_*
     variables (DDP) and through the command's own spawn with ``--fsdp``
     (FSDP), at the same time, each run's per-step losses, checkpoint
     (params and EMA) and launches a step held to a plain ``Trainer.fit`` of
     the same seed and data (bitwise, or within 1e-6 with the reason
     printed; on more cards within ``WORLD_TOL``), ms a step (CUDA events,
     the trainer's history) and peak memory; ``generate-metrics
     --data-parallel`` on phase 10's DDPM-DiT checkpoint, every CSV bitwise
     equal to phase 10's; the data-parallel predictor (two replicas on one
     card, ``load_predictor(data_parallel=True)`` on more), a seeded
     bucket-8 request bitwise equal to its replicas' rows sampled plainly
     and held to the plain predictor's, p50 at batch 64 beside the plain
     one's; a ``FileWindowStream`` of phase 10's pickles through
     ``device_prefetch``, every batch bitwise equal to the resident
     dataset's, and one UNet ``fit`` epoch of phase 9's length fed from a
     stream (launches held a step, ms a step against resident, the busy
     share of a streamed step); tensor parallelism on one card, the ranks
     of a model group of 2 and of 4 as threads (``LocalGroup``): every cut
     module kind of DDPM-DiT, DDPM-UNet (FM-UNet's backbone too), FM-DiT
     (DiT2D) and ConvRNN at the serving width, f32 and
     bf16, each rank's output held against the unsharded module's (f32
     within 1e-6·max|ref| or bitwise, the ConvRNN's cuDNN convs 1e-5, bf16
     2e-2), its launches held to N ×
     the unsharded module's; on four cards or more also ``train
     --data-parallel --model-parallel M [--fsdp]`` (DDPM-DiT and DDPM-UNet
     at data 2 × model 2, with and without FSDP, and DDPM-DiT at model 4)
     held to the plain fit (``WORLD_TOL``), the uncut parameters equal
     across each model group, ms a step and each card's peak memory; with
     ``--parallel`` also
     ``generate-samples --data-parallel``'s sampling (the command's
     ``sample_sequences`` on every rank through ``launch.run_ranks``) on
     phase 10's DDPM-DiT checkpoint, its samples bitwise equal to one
     card's (on more cards within ``WORLD_TOL``).
     Every check of the phase runs; it fails at its end if any did.
 17. the remaining commands on phase 10's workspace: ``generate-samples``'
     device half (checkpoint, test set, ids, the DDIM-eta 25 + Sparsity
     sampler at NSAMPLES4PLOTS = 20, the overlay metrics on the card) for
     DDPM-DiT and DDPM-UNet in this process, launches held per forward, the
     logged L1 norm held to the samples', the overlays to the CPU's from
     the same sequences (PSNR within 1e-4 dB, SSIM and TV 1e-5 of max|CPU|);
     ``sweep --arch DDPM-UNet --trials 2 --epochs-per-trial 1`` as a
     process (every trial's loss finite, the trials numpy's draws of the
     JAX package's search space, ``best.json``, launches from its log);
     ``doctor`` twice as a process (every check ok, the second with
     ``--skip-mesh``; each finds all five kernel libraries that phase 1
     built in the source-hash cache and compiles none, by ``build_all``'s
     own count); ``generate-samples
     --plot-type Static`` and
     ``Dynamic`` whole where matplotlib is installed; then
     ``measure_round_trip``, a ``StepTimer`` over DiT sample calls and a
     ``trace`` of one, with the card's name and power limit.
 18. the operational drills (``tools/*_torch.py``): the training drill —
     DDPM-UNet at ``configs/ATC.yml``'s width through the ``train``
     command, SIGINT at epoch 2 of 6 (the emergency checkpoint whole on
     disk), ``--resume`` to the end, every check of the JAX tool's report
     held (continuity, the learning rate resumed, the best checkpoint the
     global best and loadable, the abort checkpoint swept, retention), the
     resumed run's launches from its log; and the HTTP soak — DDPM-DiT at
     the serving width trained two epochs, served through ``ServingApp``,
     the HTTP server and ``BatchingQueue`` at DDIM-eta 25 + Sparsity to 4
     clients for 10 s: no error, a coalesced dispatch, p50/p95/p99, the
     launches held to its sampling calls; the drill's processes start
     beside phase 17 and run on beside the soak (for time: the card is
     shared meanwhile).
 19. every bundled dataset's geometry: ETHUCY, HERMES-BO, HERMES-BN,
     HERMES-CR-90, HERMES-CR-120 and ATC_medium (the "-OBST" configs
     checked to share CR-90's and CR-120's grid and widths), each config
     with ``configs/serving/ATC.yml``'s sampler settings at its own full
     width, seeded random weights, batch 64: every distinct kernel shape
     of its DDPM-UNet, DDPM-DiT, FM-DiT and FM-UNet (``unet_shape_tables``
     and the DiTs' attention shapes) against the twin, f32 and bf16, a
     second call bitwise, each kernel's largest shape a model timed beside
     its bound and the library call; the ancestral step at its
     (64, F, H, W, 3); each model's f32 forward, kernels against twins;
     one bf16 request each (DDIM-eta 25 + Sparsity, Euler at phase 11's
     steps), launches held exactly; generate-samples' device half for
     DDPM-UNet on a walker-pickle workspace at its grid (overlays card vs
     CPU).

Phase 2 also holds attention at head dims 8 and 16 (a UNet at a base width
of 16, as the quickstarts build it; Dh 8 also streamed at 2500 keys), at
FM-DiT's token counts (216, 336 and 432:
the serving grid, HERMES-CR-120, ATC_medium) and past them (1000 keys).
Each path is driven with the launch counts set to 0 just before it and read
just after: phases 3-4 (DiT), phases 6-7 (UNet), the tap-GEMM run of
phase 8, each model's training (phases 9, 11 and 13), each model's protocol run
(phase 10; the DiT's in its own process, FM-DiT's commands each in theirs),
each FM model's serving (phase 11), each fast sampler's serving, the
distillation runs and the D004 request (phase 12), ConvRNN's serving and
commands (phase 13), the serve process, the artifacts, the cross-device
artifacts and the artifact server (phase 14, the processes' counts from
their log lines), the
training run on the ETL's windows (phase 15), and each parallel path
(phase 16: the commands' counts from their log lines; the tensor-parallel
shard check as one path; the data-parallel sampling from each rank's
counts), each model's generate-samples sampling, the sweep and each doctor
run (phase 17, the processes' counts from their log lines), each
geometry's requests and its generate-samples sampling (phase 19); the counts
are held to the launches each forward, training or distillation step makes
(a CFG forward counts once).  The last two lines are a
JSON object with every kernel's numbers and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

DEVICE = "cuda"
SEED = 0
# PyTorch's TF32 switches as a fresh process has them (the phases below turn
# TF32 off for their f32 checks): the in-process references of phase 16 run
# under these, as the commands they are held to do.
PRECISION_DEFAULTS = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {"attention_f32": 1e-5, "attention_bf16": 2e-2, "step": 1e-6,
       "forward_f32": 1e-4, "chain": 1e-3, "max_flip_share": 1e-3,
       # GroupNorm: absolute; conv and resblock: times max|ref| (K up to
       # 27·256 terms summed in another order); bf16: any kernel's bf16
       # output against the f32 twin on the same bf16 inputs, times max|ref|.
       "gn_f32": 1e-5, "conv_f32": 1e-4, "resblock_f32": 1e-4, "bf16": 2e-2,
       # Training gradients, kernels vs twins: f32 times max|g_ref| (the
       # tensor's own where it is at least grad_own_scale of the model's);
       # bf16 kernels vs the f32 twins: cosine per parameter, loss relative
       # (a tensor under grad_own_scale, a gradient that is 0 up to float
       # noise, within bf16 times the model's max|g_ref| instead).
       "grad_f32": 1e-4, "grad_own_scale": 1e-3, "grad_bf16_cos": 0.99,
       "loss_bf16": 2e-2,
       # The metric suite, card vs CPU: the CPU parity tests' tolerances
       # (tests/test_torch_metrics.py; metric_agreement says which is which).
       "psnr_rel": 1e-4, "psnr_db": 1e-4, "ssim": 1e-5, "sum_rel": 1e-4, "hist1d_rel": 1e-5,
       "bhatt": 1e-6, "max_moved_share": 1e-3}
REPLACES = {
    "fused_attention": "crowdmod_tpu/ops/pallas/attention.py:53",
    "fused_ancestral_update": "crowdmod_tpu/ops/pallas/fused_step.py:59",
    "fused_group_norm": "crowdmod_tpu/ops/pallas/groupnorm.py:81",
    "conv3d_same_im2col": "crowdmod_tpu/ops/pallas/conv3d.py:158",
    "conv3d_same_tapgemm": "crowdmod_tpu/ops/pallas/conv3d.py:99",
    "fused_resblock": "crowdmod_tpu/ops/pallas/resblock.py:253",
}
SOURCES = {
    "fused_attention": "crowdmod_tpu_torch/csrc/attention.cu",
    "fused_ancestral_update": "crowdmod_tpu_torch/csrc/fused_step.cu",
    "fused_group_norm": "crowdmod_tpu_torch/csrc/groupnorm.cu",
    "conv3d_same_im2col": "crowdmod_tpu_torch/csrc/conv3d.cu",
    "conv3d_same_tapgemm": "crowdmod_tpu_torch/csrc/conv3d.cu",
    "fused_resblock": "crowdmod_tpu_torch/csrc/resblock.cu",
}
# Kernel launches of one training step: every standalone forward kernel
# call of the UNet (``unet_shape_tables``), with the fused blocks unfused
# (training mode is not deterministic: 2 GroupNorms and 2 convs each); the
# DiT trains with dropout 0.1, so its attention takes the plain path.  The
# backward is PyTorch ops (the kernels' VJPs) and launches none of them.
def unet_launches(cfg, arch: str, training: bool = False) -> dict:
    """Launches of one UNet forward of ``arch`` (``training``: a training
    step's) by kernel, from :func:`unet_shape_tables`."""
    tables = unet_shape_tables(cfg, arch)
    fused = len(tables["resblock"])
    counts = {"conv3d_same_im2col": sum(tables["conv"].values()),
              "fused_group_norm": sum(tables["gn"].values()),
              "fused_attention": sum(tables["attention"].values())}
    if training:
        counts["conv3d_same_im2col"] += 2 * fused
        counts["fused_group_norm"] += 2 * fused
    else:
        counts["fused_resblock"] = fused
    return counts


TRAIN_PER_STEP = {
    "DDPM-DiT": lambda cfg: {},
    "DDPM-UNet": lambda cfg: unet_launches(cfg, "DDPM-UNet", training=True),
    # FM-DiT (DiT2D) trains with dropout 0.1 too.  ConvRNN's convolutions
    # are library calls: no kernel of the port.
    "FM-DiT": lambda cfg: {},
    "FM-UNet": lambda cfg: unet_launches(cfg, "FM-UNet", training=True),
    "ConvRNN": lambda cfg: {},
}
# Kernel launches of one denoiser forward: the DiT's two attentions a
# block; the UNet's fused blocks, its standalone convs and GroupNorms and
# its attentions (``unet_shape_tables``).
PER_FORWARD = {
    "DDPM-DiT": lambda cfg: {"fused_attention": 2 * cfg.MODEL.DDPM.DIT.DEPTH},
    "DDPM-UNet": lambda cfg: unet_launches(cfg, "DDPM-UNet"),
    # DiT2D: one joint attention over all T·N tokens a block.
    "FM-DiT": lambda cfg: {"fused_attention": cfg.MODEL.FM.DIT.DEPTH},
    "FM-UNet": lambda cfg: unet_launches(cfg, "FM-UNet"),
    "ConvRNN": lambda cfg: {},
}


def log(phase: str, **numbers) -> None:
    print(f"[{phase}] " + json.dumps(numbers), flush=True)


def cuda_ms(fn, *, iters: int = 20, reps: int = 15) -> tuple[float, float]:
    """Device time of one call of ``fn``, from CUDA events, and the host's
    time to issue it.

    Each repetition first queues a ~5 ms spin kernel, so the host has issued
    all ``iters`` calls before the card reaches them: the events then time
    the calls back to back on the card, not the host's launch rate.  Returns
    the medians over ``reps`` of (device ms per call, host ms per call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    device, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host.append(1e3 * (time.perf_counter() - t0) / iters)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / iters)
    return statistics.median(device), statistics.median(host)


def cuda_ms_budget(fn, budget_ms: float = 40.0) -> tuple[float, float]:
    """:func:`cuda_ms` over 5 repetitions of about ``budget_ms`` of device
    time each: at least one call a repetition, at most 20."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = 1e3 * (time.perf_counter() - t0)
    iters = max(1, min(20, int(budget_ms / max(once, 1e-3))))
    return cuda_ms(fn, iters=iters, reps=5)


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate vs operations
    over the type's peak; → (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------

def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    from crowdmod_tpu_torch.ops.kernels import build

    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    built = build.build_all()
    seconds = time.perf_counter() - t0
    regs = {
        n: [ln.strip() for ln in build.library_path(n).with_suffix(".log")
            .read_text().splitlines() if "registers" in ln or "spill" in ln]
        for n in build.SOURCES
    }
    log("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=round(seconds, 3), built=list(built), ptxas=regs)
    return {"kind": name, "smi": smi}


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------

def _randn(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check_attention(label, b, h, sq, sk, dh, dtype, gen, *, packed=False, timing=True):
    """Kernel vs twin at one shape, and a second call bitwise equal to the
    first; times kernel, twin and SDPA where ``timing``."""
    import torch.nn.functional as F

    from crowdmod_tpu_torch.ops.kernels import attention_reference, fused_attention
    from crowdmod_tpu_torch.ops.kernels.attention import attention_plan

    if packed:  # strided views of one (B, S, 3, H, Dh) buffer, as MHA gives
        qkv = _randn((b, sq, 3, h, dh), gen, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q = _randn((b, h, sq, dh), gen, dtype)
        k, v = _randn((b, h, sk, dh), gen, dtype), _randn((b, h, sk, dh), gen, dtype)
    scale = 1.0 / dh**0.5
    out = fused_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    ref = attention_reference(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref).abs().max().item()
    tol = TOL["attention_f32" if dtype == torch.float32 else "attention_bf16"]
    if not err <= tol:
        raise AssertionError(f"attention {label}: max abs err {err} > {tol}")
    plan = attention_plan(b, h, sq, sk, dh, dtype)
    again = fused_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"attention {label}: a second call gave other bits ({plan})")
    elsize = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elsize
    b_ms, b_by = bound(nbytes, 4 * b * h * sq * sk * dh, dtype)
    res = dict(
        shape=[b, h, sq, sk, dh], dtype=str(dtype).split(".")[1],
        max_abs_err=err, tolerance=tol, bitwise_repeat=True,
        plan=dataclasses.asdict(plan), bound_ms=b_ms, bound_by=b_by)
    if timing:
        ms, host_ms = cuda_ms(lambda: fused_attention(q, k, v, scale=scale))
        res.update(
            ms=ms, host_ms=host_ms,
            plain_ms=cuda_ms(lambda: attention_reference(q, k, v, scale))[0],
            library_ms=cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
            )[0],
        )
    log(f"kernel attention {label}", **res)
    return res


def launch_floor_ms() -> float:
    """Device time of a one-element PyTorch elementwise op timed as the
    kernels are (back to back behind the spin kernel): the launch floor a
    small kernel cannot go under.  A yardstick only, never on the path."""
    one = torch.zeros(1, device="cuda")
    return cuda_ms(lambda: one.add_(1.0))[0]


def check_step(label, shape, sparsity, gen, *, offsets=(0, 0, 0), rho=0, floor_ms=None,
               timing=True):
    """Kernel vs twin at one shape (x, ε̂ and z views ``offsets`` floats into
    their buffers), a second call bitwise equal to the first; times kernel
    and twin beside the launch floor."""
    from crowdmod_tpu_torch.core.schedule import linear_schedule
    from crowdmod_tpu_torch.ops.kernels import (
        ancestral_update_reference,
        fused_ancestral_update,
        step_coefficients,
    )
    from crowdmod_tpu_torch.ops.kernels.build import sm_count
    from crowdmod_tpu_torch.ops.kernels.fused_step import ancestral_update_plan

    n = int(np.prod(shape))
    x, eps, z = (_randn((n + off,), gen)[off:].view(shape) for off in offsets)
    # Coefficients of step t = 500 of the ATC schedule (T = 1000, scale 0.5).
    # (the kernel reads them from a (3,) tensor on the card, a row of the
    # sampler's table).
    s = linear_schedule(1000, scale=0.5)
    coeffs = step_coefficients(s.one_by_sqrt_alpha[500],
                               s.beta[500] / s.sqrt_one_minus_alpha_bar[500],
                               np.sqrt(s.beta[500]), DEVICE)
    kw = dict(lambda_guidance=0.6, sparsity=sparsity, rho_channel=rho)
    twin = dict(inv_sqrt_alpha=coeffs[0], beta_over_somab=coeffs[1], sigma=coeffs[2], **kw)
    out = fused_ancestral_update(x, eps, z, coeffs, **kw)
    again = fused_ancestral_update(x, eps, z, coeffs, **kw)
    torch.cuda.synchronize()
    err = (out - ancestral_update_reference(x, eps, z, **twin)).abs().max().item()
    if not err <= TOL["step"]:
        raise AssertionError(f"ancestral step {label}: max abs err {err}")
    plan = ancestral_update_plan(n, shape[-1], sm_count(x.device),
                                 (x.data_ptr(), eps.data_ptr(), z.data_ptr(), out.data_ptr()))
    if not torch.equal(out, again):
        raise AssertionError(f"ancestral step {label}: a second call gave other bits ({plan})")
    b_ms, b_by = bound(16 * n, (7 if sparsity else 5) * n, torch.float32)
    res = dict(
        shape=list(shape), dtype="float32", sparsity=sparsity, offsets=list(offsets),
        plan=dataclasses.asdict(plan), max_abs_err=err, tolerance=TOL["step"],
        bitwise_repeat=True, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        floor_ms=floor_ms,
    )
    if timing:
        ms, host_ms = cuda_ms(lambda: fused_ancestral_update(x, eps, z, coeffs, **kw))
        res.update(ms=ms, host_ms=host_ms, plain_ms=cuda_ms(
            lambda: ancestral_update_reference(x, eps, z, **twin))[0])
    log(f"kernel ancestral_update {label}", **res)
    return res


# Tokens FM-DiT's attention spans (frames × patches): configs/serving/ATC.yml
# and configs/ATC.yml, configs/HERMES-CR-120.yml, configs/ATC_medium.yml.
FM_DIT_TOKENS = (216, 336, 432)


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    attn = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for batch in (64, 256):
            n_sp, n_tm = batch * 2, batch * 27  # B·T_p, B·N_s problems
            attn[f"spatial_b{batch}_{dn}"] = check_attention(
                f"spatial b{batch} {dn}", n_sp, 4, 27, 27, 64, dtype, gen)
            attn[f"temporal_b{batch}_{dn}"] = check_attention(
                f"temporal b{batch} {dn}", n_tm, 4, 1, 2, 64, dtype, gen)
        attn[f"spatial_b64_packed_{dn}"] = check_attention(
            f"spatial b64 packed {dn}", 128, 4, 27, 27, 64, dtype, gen,
            packed=True)
        attn[f"edge_s216_{dn}"] = check_attention(
            f"edge S216 Dh32 {dn}", 16, 4, 216, 216, 32, dtype, gen)
        # The UNet's level-2 attention: 54 positions, 4 heads of 32.
        attn[f"unet_b64_{dn}"] = check_attention(
            f"unet level-2 b64 {dn}", 64, 4, 54, 54, 32, dtype, gen, packed=True)
        # FM-DiT (DiT2D) attends over all T·N tokens: 8 frames × 27 patches
        # on the serving grid, 8 × 42 on HERMES-CR-120, 16 × 27 on
        # ATC_medium; then Dh 32 at 432 keys, and 1000 keys, past what any
        # block holds (both dtypes stream K and V through shared memory).
        for s_ in FM_DIT_TOKENS:
            attn[f"fm_dit_s{s_}_{dn}"] = check_attention(
                f"FM-DiT S{s_} b64 {dn}", 64, 4, s_, s_, 64, dtype, gen, packed=True)
        attn[f"edge_s432_dh32_{dn}"] = check_attention(
            f"edge S432 Dh32 {dn}", 16, 4, 432, 432, 32, dtype, gen)
        attn[f"edge_s1000_{dn}"] = check_attention(
            f"edge S1000 Dh64 {dn}", 4, 4, 1000, 1000, 64, dtype, gen)
    # Narrow heads: a UNet at a base width of 16 (the quickstarts') attends
    # with 4 heads of 8 over its bottleneck's 96 positions; then Dh 16, and
    # Dh 8 past what a block holds (2500 keys).  Their own generator: the
    # cases above keep the inputs they had before these were added.
    narrow = torch.Generator(device="cuda").manual_seed(SEED + 16)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for dh in (8, 16):
            attn[f"narrow_dh{dh}_{dn}"] = check_attention(
                f"narrow heads Dh{dh} S96 {dn}", 16, 4, 96, 96, dh, dtype, narrow, packed=True)
        attn[f"edge_s2500_dh8_{dn}"] = check_attention(
            f"edge S2500 Dh8 {dn}", 4, 4, 2500, 2500, 8, dtype, narrow)
    # bf16 past 64 keys at Dh 32 and 64 takes the wgmma route; the other
    # bf16 tensor-core cases keep the mma route.
    routes = {"spatial_b64_bfloat16": "mma", "unet_b64_bfloat16": "mma",
              "narrow_dh16_bfloat16": "mma", "edge_s216_bfloat16": "wgmma",
              "edge_s432_dh32_bfloat16": "wgmma",
              **{f"fm_dit_s{s_}_bfloat16": "wgmma" for s_ in FM_DIT_TOKENS}}
    if attn["narrow_dh8_bfloat16"]["plan"]["route"] != "simt":
        raise AssertionError("attention Dh 8: not the SIMT route")
    for key, route in routes.items():
        if attn[key]["plan"]["route"] != route:
            raise AssertionError(f"attention {key}: route {attn[key]['plan']['route']}")
    for key in ("fm_dit_s432_float32", "edge_s1000_float32", "edge_s1000_bfloat16",
                "edge_s2500_dh8_float32", "edge_s2500_dh8_bfloat16"):
        if not attn[key]["plan"]["key_block"] < attn[key]["plan"]["keys_padded"]:
            raise AssertionError(f"attention {key}: not streamed ({attn[key]['plan']})")
    floor = launch_floor_ms()
    log("launch floor (one-element add_, back to back)", ms=floor)
    step = {}
    for batch in (1, 8, 64, 256):
        for sp in (False, True):
            key = f"b{batch}_{'sparsity' if sp else 'none'}"
            step[key] = check_step(key.replace("_", " "), (batch, 3, 12, 36, 3), sp, gen,
                                   floor_ms=floor)
    # n % 4 = 1 and views one float past a 16-byte boundary: a scalar head
    # and tail around the vectors; then ε̂ at another offset than x: scalars.
    step["ragged_offset"] = check_step("ragged offset", (7, 3, 11, 5, 3), True, gen,
                                       offsets=(1, 1, 1), rho=2, floor_ms=floor)
    step["mixed_offsets"] = check_step("mixed offsets", (7, 3, 11, 5, 3), True, gen,
                                       offsets=(1, 2, 1), rho=1, floor_ms=floor)
    if step["ragged_offset"]["plan"]["vec"] != 4 or step["mixed_offsets"]["plan"]["vec"] != 1:
        raise AssertionError("ancestral step: the offset views did not take their paths")
    step["strided_eps"] = check_step_strided(gen)
    return {"attention": attn, "step": step}


def check_step_strided(gen) -> dict:
    """The wrapper on a strided ε̂: the future's time slice of a DiT's
    unpatched ``(B, P + F, H, W, C)`` output, as ancestral sampling of an
    ε-predicting DiT hands it over; kernel vs twin."""
    from crowdmod_tpu_torch.ops.kernels import (
        ancestral_update_reference,
        fused_ancestral_update,
        step_coefficients,
    )

    shape = (64, 3, 12, 36, 3)
    x, z = _randn(shape, gen), _randn(shape, gen)
    eps = _randn((64, 8, 12, 36, 3), gen)[:, 5:]
    coeffs = step_coefficients(1.01, 0.02, 0.03, DEVICE)
    out = fused_ancestral_update(x, eps, z, coeffs, lambda_guidance=0.6, sparsity=True)
    ref = ancestral_update_reference(x, eps, z, inv_sqrt_alpha=coeffs[0],
                                     beta_over_somab=coeffs[1], sigma=coeffs[2],
                                     lambda_guidance=0.6, sparsity=True)
    err = (out - ref).abs().max().item()
    if eps.is_contiguous() or not err <= TOL["step"]:
        raise AssertionError(f"ancestral step on a strided eps: max abs err {err}")
    res = dict(shape=list(shape), eps_strides=list(eps.stride()), max_abs_err=err)
    log("kernel step strided eps", **res)
    return res


# ---------------------------------------------------------------------------
# Phase 2, the UNet kernels
# ---------------------------------------------------------------------------

UNET_BATCH = 64


def unet_shape_tables(cfg, arch: str = "DDPM-UNet") -> dict:
    """The kernel shapes of one inference forward of ``arch``'s UNet built
    from ``cfg``, walked as ``models/backbones/unet3d.py`` builds the model
    and ``fused_apply.eligible`` routes its blocks:

      ``levels``: level → (T, H, W), level 0 the past and future frames on
        the config's grid, each next level the stride-2 downsample's ceil;
      ``conv``: (level, Cin, Cout) → the standalone conv calls a forward
        (the first conv, every unfused block's two, each upsample's, the
        f32 final conv Cout 3);
      ``gn``: (level, C, silu) → the standalone GroupNorm calls (every
        unfused block's two with SiLU, each attention's pre-norm without,
        the final norm);
      ``resblock``: (Cin, Cout) of each fused block, in forward order;
      ``attention``: (tokens, heads, Dh) → attention calls (4 heads over
        every position of the level).

    Each table keeps level order, then the order of first call."""
    from crowdmod_tpu_torch.models.backbones.fused_apply import eligible

    node = (cfg.MODEL.FM if arch.startswith("FM") else cfg.MODEL.DDPM).UNET
    grid = (cfg.DATASET.PAST_LEN + cfg.DATASET.FUTURE_LEN if node.CONDITION == "Past"
            else cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS)
    depth = len(node.BASE_CH_MULT)
    levels = {0: grid}
    for level in range(1, depth):
        levels[level] = tuple(-(-n // 2) for n in levels[level - 1])
    conv, gn, attention, fused = {}, {}, {}, []

    def add(table, key):
        table[key] = table.get(key, 0) + 1

    def block(level, cin, cout, attn):
        t, h, w = levels[level]
        probe = types.SimpleNamespace(attention=object() if attn else None,
                                      out_channels=cout)
        if eligible(probe, torch.empty((1, t, h, w, cin), device="meta"), False):
            fused.append((cin, cout))
            return
        add(gn, (level, cin, True))
        add(conv, (level, cin, cout))
        add(gn, (level, cout, True))
        add(conv, (level, cout, cout))
        if attn:
            add(gn, (level, cout, False))
            add(attention, (t * h * w, 4, cout // 4))

    base = node.BASE_CH
    add(conv, (0, 3, base))
    ch, skips = base, [base]
    for level in range(depth):
        out = base * node.BASE_CH_MULT[level]
        for _ in range(node.NUM_RES_BLOCKS):
            block(level, ch, out, node.APPLY_ATTENTION[level])
            ch = out
            skips.append(ch)
        if level != depth - 1:
            skips.append(ch)  # the stride-2 downsample: a library call
    block(depth - 1, ch, ch, True)  # the bottleneck
    block(depth - 1, ch, ch, False)
    for level in reversed(range(depth)):
        out = base * node.BASE_CH_MULT[level]
        for _ in range(node.NUM_RES_BLOCKS + 1):
            block(level, ch + skips.pop(), out, node.APPLY_ATTENTION[level])
            ch = out
        if level != 0:
            add(conv, (level - 1, ch, ch))  # the upsample's conv
    add(gn, (0, ch, True))
    add(conv, (0, ch, 3))
    order = lambda table: dict(sorted(table.items(), key=lambda kv: kv[0][0]))  # noqa: E731
    return {"levels": levels, "conv": order(conv), "gn": order(gn), "resblock": fused,
            "attention": attention}


class _ServingTables:
    """:func:`unet_shape_tables` of ``configs/serving/ATC.yml``'s DDPM-UNet,
    derived at first use (the port is imported then, not with this
    script): ``SERVING.levels``, ``.conv``, ``.gn``, ``.resblock``,
    ``.attention``.  Phases 2-18 hold their kernel cases and launches to
    these; the module names ``LEVELS``, ``CONV_SHAPES``, ``GN_SHAPES`` and
    ``RESBLOCK_SHAPES`` read them too."""

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        from crowdmod_tpu_torch.config import load_config

        self.__dict__.update(unet_shape_tables(load_config("serving/ATC.yml"), "DDPM-UNet"))
        return self.__dict__[name]


SERVING = _ServingTables()
_SERVING_NAMES = {"LEVELS": "levels", "CONV_SHAPES": "conv", "GN_SHAPES": "gn",
                  "RESBLOCK_SHAPES": "resblock"}


def __getattr__(name: str):
    if name in _SERVING_NAMES:
        return getattr(SERVING, _SERVING_NAMES[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _dn(dtype) -> str:
    return str(dtype).split(".")[1]


def _rel_check(label, out, ref, tol) -> float:
    """max |out − ref|, held to tol·max|ref|; raises beyond it."""
    scale = ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    if not (scale > 0 and err <= tol * scale):
        raise AssertionError(f"{label}: max abs err {err} > {tol} x {scale}")
    return err


def _timings(res, kernel, plain, library, nbytes, flops, dtype):
    b_ms, b_by = bound(nbytes, flops, dtype)
    ms, host_ms = cuda_ms_budget(kernel)
    res.update(ms=ms, host_ms=host_ms, plain_ms=cuda_ms_budget(plain)[0],
               bound_ms=b_ms, bound_by=b_by,
               library_ms=None if library is None else cuda_ms_budget(library)[0])


def check_group_norm(level, c, act, dtype, gen, timing, *, batch=UNET_BATCH, volume=None,
                     levels=None):
    """Kernel vs twin at one shape (``volume`` positions, by default the
    level's in ``levels``, by default the serving grid's), a second call
    bitwise equal to the first, the plan; times kernel, twin and
    ``F.group_norm``."""
    import torch.nn.functional as F

    from crowdmod_tpu_torch.ops.kernels import fused_group_norm, group_norm_reference
    from crowdmod_tpu_torch.ops.kernels.build import sm_count
    from crowdmod_tpu_torch.ops.kernels.groupnorm import group_norm_plan

    positions = volume or int(np.prod((levels or SERVING.levels)[level]))
    x = _randn((batch, positions, c), gen, dtype)
    gamma = 1.0 + 0.1 * _randn((c,), gen)
    beta = 0.1 * _randn((c,), gen)
    out = fused_group_norm(x, gamma, beta, silu=act)
    again = fused_group_norm(x, gamma, beta, silu=act)
    torch.cuda.synchronize()
    plan = group_norm_plan(batch, positions, c, 8, dtype, sm_count(x.device))
    label = (f"group norm S{positions} C{c}{' silu' if act else ''} {_dn(dtype)} b{batch} "
             f"{plan.route} k{plan.cluster}")
    ref = group_norm_reference(x.float(), gamma, beta, 8, 1e-5, act)
    err = (out.float() - ref).abs().max().item()
    if dtype == torch.float32:
        tol = TOL["gn_f32"]
        if not err <= tol:
            raise AssertionError(f"{label}: max abs err {err}")
    else:
        tol = TOL["bf16"]
        _rel_check(label, out, ref, tol)
    # Same inputs, same bits: every sum in a fixed order, no atomics.
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: a second call gave other bits ({plan})")
    res = dict(shape=[batch, positions, c], silu=act, dtype=_dn(dtype),
               max_abs_err=err, tolerance=tol, bitwise_repeat=True,
               plan=dataclasses.asdict(plan))
    if timing:
        # F.group_norm over the (B, C, S) view of the same memory, no SiLU.
        xs = x.transpose(1, 2)
        g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
        _timings(
            res, lambda: fused_group_norm(x, gamma, beta, silu=act),
            lambda: group_norm_reference(x, gamma, beta, 8, 1e-5, act),
            lambda: F.group_norm(xs, 8, g_lib, b_lib),
            2 * x.numel() * x.element_size() + 8 * c,
            x.numel() * (11 if act else 7), dtype)
    log(f"kernel {label}", **res)
    return res


def check_group_norm_extras(gen, timing) -> dict:
    """GroupNorm shapes beyond the batch-64 forward, bf16 as served: the
    final norm at the other serving buckets, a level-1 shape at 256, and a
    sample past a cluster's shared memory (``configs/ATC_medium.yml``'s
    level-0 volume, 16 × 12 × 36, at 192 channels: the stream route), in
    both dtypes."""
    bf16 = torch.bfloat16
    res = {f"final_b{b}": check_group_norm(0, 32, True, bf16, gen, timing, batch=b)
           for b in (1, 8, 256)}
    res["L1_C192_b256"] = check_group_norm(1, 192, True, bf16, gen, timing, batch=256)
    for dtype in (torch.float32, bf16):
        res[f"stream_{_dn(dtype)}"] = check_group_norm(
            0, 192, True, dtype, gen, timing, batch=2, volume=16 * 12 * 36)
        if res[f"stream_{_dn(dtype)}"]["plan"]["route"] != "stream":
            raise AssertionError("group norm: the large sample did not take the stream route")
    return res


def _conv_inputs(level, cin, cout, dtype, gen, batch=UNET_BATCH, levels=None):
    """x, the (3, 3, 3, Cin, Cout) kernel (both in ``dtype``) and an f32
    bias for a conv at ``level`` of ``levels`` (by default the serving
    grid's)."""
    t, h, w = (levels or SERVING.levels)[level]
    x = _randn((batch, t, h, w, cin), gen, dtype)
    kernel = (_randn((3, 3, 3, cin, cout), gen) / (27 * cin) ** 0.5).to(dtype)
    return x, kernel, 0.1 * _randn((cout,), gen)


def check_conv(level, cin, cout, impl, dtype, gen, timing, batch=UNET_BATCH, levels=None):
    import torch.nn.functional as F

    from crowdmod_tpu_torch.ops.kernels import (
        conv3d_same_im2col,
        conv3d_same_reference,
        conv3d_same_tapgemm,
    )
    from crowdmod_tpu_torch.ops.kernels.conv3d import (
        im2col_plan,
        pack_im2col,
        pack_tapgemm,
        smem_bytes,
        tapgemm_plan,
    )

    t, h, w = (levels or SERVING.levels)[level]
    x, kernel, bias = _conv_inputs(level, cin, cout, dtype, gen, batch, levels)
    conv, pack, planner = ((conv3d_same_im2col, pack_im2col, im2col_plan)
                           if impl == "im2col"
                           else (conv3d_same_tapgemm, pack_tapgemm, tapgemm_plan))
    plan = planner(tuple(x.shape), cout, dtype)
    wp = pack(kernel)
    out = conv(x, wp, bias)
    torch.cuda.synchronize()
    label = (f"conv3d {impl} L{level} {cin}->{cout} {_dn(dtype)}"
             + ("" if batch == UNET_BATCH else f" b{batch}")
             + ("" if levels is None else f" {t}x{h}x{w}"))
    ref = conv3d_same_reference(x.float(), kernel.float(), bias)
    tol = TOL["conv_f32" if dtype == torch.float32 else "bf16"]
    err = _rel_check(label, out, ref, tol)
    # Same inputs, same bits: split-K sums its partials in a fixed order.
    again = conv(x, wp, bias)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: a second call gave other bits ({plan})")
    # The plan's shared memory is the library's own count.
    built_smem = smem_bytes(impl, plan, tuple(x.shape))
    if built_smem != plan.smem_bytes:
        raise AssertionError(f"{label}: plan smem {plan.smem_bytes} != built {built_smem}")
    res = dict(shape=[batch, t, h, w, cin, cout], impl=impl,
               dtype=_dn(dtype), max_abs_err=err, tolerance=f"{tol} x max|ref|",
               bitwise_repeat=True, plan=dataclasses.asdict(plan))
    if timing:
        # F.conv3d over the same channels-last memory (NDHWC, cuDNN).
        xc = x.permute(0, 4, 1, 2, 3)
        wc = kernel.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        bc = bias.to(dtype)
        flops = 2 * batch * t * h * w * 27 * cin * cout
        nbytes = (x.numel() + kernel.numel() + batch * t * h * w * cout) \
            * x.element_size() + 4 * cout
        _timings(res, lambda: conv(x, wp, bias),
                 lambda: conv3d_same_reference(x, kernel, bias),
                 lambda: F.conv3d(xc, wc, bc, padding=1), nbytes, flops, dtype)
        res.update(tflops=flops / res["ms"] / 1e9,
                   bound_share=res["bound_ms"] / res["ms"],
                   vs_cudnn=res["ms"] / res["library_ms"])
    log(f"kernel {label}", **res)
    return res


def check_bucket_plans(gen, timing) -> dict:
    """The im2col plans of the other serving buckets: the plan depends on
    the batch (split-K at levels 0-1 for small batches, a last tile only
    partly live), so one shape per plan that batch 64 does not check (route,
    block, chunk, tile, splits, partial tile; bf16, the final conv f32, as
    served) is checked, for bitwise repeats too, and timed."""
    from crowdmod_tpu_torch.ops.kernels.conv3d import im2col_plan
    from crowdmod_tpu_torch.serving import BATCH_BUCKETS

    def key(batch, level, cin, cout):
        dtype = torch.float32 if cout == 3 else torch.bfloat16
        shape = (batch, *SERVING.levels[level])
        p = im2col_plan((*shape, cin), cout, dtype)
        ragged = any(n % k for n, k in zip(shape, p.tile) if k)  # a tile partly live
        return dtype, p.route, p.bm, p.bn, p.kc, p.tile, p.splits, ragged

    seen = {key(UNET_BATCH, *shape) for shape in SERVING.conv}
    res = {}
    for batch in BATCH_BUCKETS:
        for level, cin, cout in SERVING.conv:
            k = key(batch, level, cin, cout)
            if k in seen:
                continue
            seen.add(k)
            res[f"im2col_b{batch}_L{level}_{cin}_{cout}_{_dn(k[0])}"] = check_conv(
                level, cin, cout, "im2col", k[0], gen, timing, batch=batch)
    return res


def _resblock_weights(cin, cout, gen, dtype):
    """A weight dict of the fused kernel's contract, conv weights rounded to
    ``dtype`` (so kernel and f32 twin see the same values)."""
    n = lambda shape, sc: sc * _randn(shape, gen)
    w = {"gn1_scale": 1 + n((cin,), 0.1), "gn1_bias": n((cin,), 0.1),
         "w1": n((3, 3, 3, cin, cout), (27 * cin) ** -0.5), "b1": n((cout,), 0.1),
         "gn2_scale": 1 + n((cout,), 0.1), "gn2_bias": n((cout,), 0.1),
         "w2": n((3, 3, 3, cout, cout), (27 * cout) ** -0.5), "b2": n((cout,), 0.1)}
    if cin != cout:
        w["w_skip"] = n((1, 1, 1, cin, cout), cin ** -0.5)
        w["b_skip"] = n((cout,), 0.1)
    for k in ("w1", "w2", "w_skip"):
        if k in w:
            w[k] = w[k].to(dtype).float()
    return w


def resblock_sequence(x, temb, w):
    """The unfused PyTorch sequence of one ResnetBlock3D on ``x``'s memory
    (``F.group_norm``, ``F.silu``, cuDNN ``F.conv3d`` on the NDHWC view
    twice, the skip ``F.linear``), in x's dtype: a yardstick of time for the
    fused kernel, which no single library call computes.  Never on the
    path."""
    import torch.nn.functional as F

    dt = x.dtype
    cast = lambda k: w[k].to(dt)  # noqa: E731
    conv_w = lambda k: w[k].permute(4, 3, 0, 1, 2).contiguous(  # noqa: E731
        memory_format=torch.channels_last_3d).to(dt)
    w1, w2 = conv_w("w1"), conv_w("w2")
    tb = temb.to(dt)[:, :, None, None, None]
    xc = x.permute(0, 4, 1, 2, 3)
    skip_w = (w["w_skip"].reshape(w["w_skip"].shape[-2:]).t().to(dt)
              if "w_skip" in w else None)

    def run():
        h = F.silu(F.group_norm(xc, 8, cast("gn1_scale"), cast("gn1_bias")))
        h = F.conv3d(h, w1, cast("b1"), padding=1) + tb
        h = F.silu(F.group_norm(h, 8, cast("gn2_scale"), cast("gn2_bias")))
        h = F.conv3d(h, w2, cast("b2"), padding=1)
        if skip_w is None:
            return h + xc
        return h + F.linear(x, skip_w, cast("b_skip")).permute(0, 4, 1, 2, 3)

    return run


def resblock_composition(x, temb, w):
    """The port's own unfused ResnetBlock3D on ``x``: its GroupNorm kernel
    (+ SiLU) and its im2col conv kernel twice, temb_proj added between,
    the skip a ``torch.matmul`` (or x), each in x's dtype; the fused
    kernel's yardstick among the port's kernels.  Never on the path."""
    from crowdmod_tpu_torch.ops.kernels import conv3d_same_im2col, fused_group_norm
    from crowdmod_tpu_torch.ops.kernels.conv3d import pack_im2col

    dt = x.dtype
    w1, w2 = pack_im2col(w["w1"].to(dt)), pack_im2col(w["w2"].to(dt))
    b1, b2 = w["b1"].float().contiguous(), w["b2"].float().contiguous()
    tb = temb.to(dt)[:, None, None, None, :]
    skip = None
    if "w_skip" in w:
        skip = w["w_skip"].reshape(w["w_skip"].shape[-2:]).to(dt), w["b_skip"].to(dt)

    def run():
        h = fused_group_norm(x, w["gn1_scale"], w["gn1_bias"], silu=True)
        h = conv3d_same_im2col(h, w1, b1) + tb
        h = fused_group_norm(h, w["gn2_scale"], w["gn2_bias"], silu=True)
        h = conv3d_same_im2col(h, w2, b2)
        return h + (x if skip is None else torch.matmul(x, skip[0]) + skip[1])

    return run


def resblock_inputs(cin, cout, dtype, gen, batch=UNET_BATCH, grid=None):
    """x, temb_proj and a weight dict of one level-0 block (on ``grid``,
    by default the serving grid's level 0)."""
    t, h, wd = grid or SERVING.levels[0]
    x = _randn((batch, t, h, wd, cin), gen, dtype)
    temb = _randn((batch, cout), gen, dtype)
    return x, temb, _resblock_weights(cin, cout, gen, dtype)


def check_resblock(cin, cout, dtype, gen, timing, batch=UNET_BATCH, grid=None):
    from crowdmod_tpu_torch.ops.kernels import fused_resblock, resblock_reference
    from crowdmod_tpu_torch.ops.kernels.build import sm_count
    from crowdmod_tpu_torch.ops.kernels.resblock import (
        pack_resblock,
        resblock_plan,
        smem_bytes,
    )

    t, h, wd = grid or SERVING.levels[0]
    x, temb, w = resblock_inputs(cin, cout, dtype, gen, batch, grid)
    packed = pack_resblock(w, dtype)
    out = fused_resblock(x, temb, w, packed=packed)
    torch.cuda.synchronize()
    label = (f"resblock {cin}->{cout} {_dn(dtype)}"
             + ("" if batch == UNET_BATCH else f" b{batch}")
             + ("" if grid is None else f" {t}x{h}x{wd}"))
    ref = resblock_reference(x.float(), temb.float(), w)
    tol = TOL["resblock_f32" if dtype == torch.float32 else "bf16"]
    err = _rel_check(label, out, ref, tol)
    plan = resblock_plan(batch, t, h, wd, cin, cout, 8, dtype, sm_count(x.device))
    # Same inputs, same bits: every sum, GN2's moments too, in a fixed order.
    again = fused_resblock(x, temb, w, packed=packed)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{label}: a second call gave other bits ({plan})")
    if dtype == torch.bfloat16 and smem_bytes(plan, wd) != plan.smem_bytes:
        raise AssertionError(f"{label}: plan smem {plan.smem_bytes} != built "
                             f"{smem_bytes(plan, wd)}")
    res = dict(shape=[batch, t, h, wd, cin, cout], dtype=_dn(dtype),
               max_abs_err=err, tolerance=f"{tol} x max|ref|", bitwise_repeat=True,
               launches_per_call=plan.launches, plan=dataclasses.asdict(plan))
    if timing:
        pos = batch * t * h * wd
        flops = 2 * pos * (27 * cin * cout + 27 * cout * cout
                           + (cin * cout if cin != cout else 0))
        nbytes = (x.numel() + pos * cout + packed["w1"].numel()
                  + packed["w2"].numel()) * x.element_size() \
            + 4 * (temb.numel() + 2 * cin + 4 * cout)
        _timings(res, lambda: fused_resblock(x, temb, w, packed=packed),
                 lambda: resblock_reference(x, temb, w), None, nbytes, flops, dtype)
        res.update(tflops=flops / res["ms"] / 1e9,
                   sequence_ms=cuda_ms_budget(resblock_sequence(x, temb, w))[0],
                   composition_ms=cuda_ms_budget(resblock_composition(x, temb, w))[0])
    log(f"kernel {label}", **res)
    return res


RESBLOCK_GRAD_SHAPES = [(32, 32), (96, 32)]  # level 0: enc_0_0, dec_0_0


def _grads_of(fn, x, temb, w, g) -> tuple[torch.Tensor, list]:
    """``fn``'s output and the gradients of ``sum(out * g)`` for x,
    temb_proj and every weight, in that order."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, temb, *w.values())]
    out = fn(leaves[0], leaves[1], dict(zip(w, leaves[2:])))
    out.backward(g)
    torch.cuda.synchronize()
    return out.detach(), [t.grad for t in leaves]


def check_resblock_gradients(gen) -> dict:
    """The fused block's gradient (``FusedResblock``: the kernel forward, the
    VJP of the twin recomputed backward) at the level-0 shapes against
    autograd through the twin on the card, f32 (TF32 off): every input's
    gradient within ``grad_f32`` × its max|g|, the output within
    ``resblock_f32``; bf16 kernels against the f32 twin: cosine ≥
    ``grad_bf16_cos`` per input, the output within ``bf16``.  One kernel
    launch a forward, none in the backward, held exactly."""
    from crowdmod_tpu_torch.ops.kernels import fused_resblock, resblock_reference
    from crowdmod_tpu_torch.ops.kernels.resblock import pack_resblock

    t, h, wd = SERVING.levels[0]
    res = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for cin, cout in RESBLOCK_GRAD_SHAPES:
            x = _randn((UNET_BATCH, t, h, wd, cin), gen)
            temb = _randn((UNET_BATCH, cout), gen)
            w = _resblock_weights(cin, cout, gen, torch.bfloat16)  # both dtypes' values
            g = _randn((UNET_BATCH, t, h, wd, cout), gen)
            names = ["x", "temb_proj", *w]
            ref_out, ref = _grads_of(
                lambda x, tp, w: resblock_reference(x, tp, w), x, temb, w, g)
            for dtype in (torch.float32, torch.bfloat16):
                label = f"resblock gradient {cin}->{cout} {_dn(dtype)}"
                packed = pack_resblock(w, dtype)
                before = fused_resblock.launches
                kinds = []

                def kernel(x, tp, w):
                    out = fused_resblock(x, tp, w, packed=packed)
                    kinds.append(type(out.grad_fn).__name__)
                    return out

                out, got = _grads_of(kernel, x.to(dtype), temb.to(dtype), w, g.to(dtype))
                launches = fused_resblock.launches - before
                if launches != 1 or kinds != ["FusedResblockBackward"]:
                    raise AssertionError(f"{label}: {launches} launches, grad_fn {kinds}")
                tol = TOL["resblock_f32" if dtype == torch.float32 else "bf16"]
                entry = dict(launches=launches,
                             out_err=_rel_check(f"{label} forward", out, ref_out, tol))
                for name, a, r in zip(names, got, ref):
                    scale = r.abs().max().item()
                    if dtype == torch.float32:
                        err = (a - r).abs().max().item()
                        if not err <= TOL["grad_f32"] * scale:
                            raise AssertionError(f"{label} d{name}: {err} > "
                                                 f"{TOL['grad_f32']} x {scale}")
                        entry[f"d{name}"] = err / scale
                    else:
                        cos = torch.nn.functional.cosine_similarity(
                            a.float().flatten(), r.flatten(), dim=0).item()
                        if not cos >= TOL["grad_bf16_cos"]:
                            raise AssertionError(f"{label} d{name}: cosine {cos}")
                        entry[f"d{name}"] = cos
                res[label] = entry
                log(label, **entry)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return res


def phase_unet_kernels(timing: bool = True) -> dict:
    """Every UNet kernel against its twin at every shape of the path, batch
    64, f32 and bf16, with TF32 off; times where ``timing``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    res = {"gn": {}, "gn_extra": {}, "conv": {}, "resblock": {}}
    for dtype in (torch.float32, torch.bfloat16):
        dn = _dn(dtype)
        for level, c, act in SERVING.gn:
            res["gn"][f"L{level}_C{c}_{act}_{dn}"] = check_group_norm(
                level, c, act, dtype, gen, timing)
        if dtype == torch.bfloat16:
            res["gn_extra"] = check_group_norm_extras(gen, timing)
        for impl in ("im2col", "tapgemm"):
            for level, cin, cout in SERVING.conv:
                res["conv"][f"{impl}_L{level}_{cin}_{cout}_{dn}"] = check_conv(
                    level, cin, cout, impl, dtype, gen, timing)
        for cin, cout in SERVING.resblock:
            res["resblock"][f"{cin}_{cout}_{dn}"] = check_resblock(
                cin, cout, dtype, gen, timing)
    # The fused blocks at the serving buckets of 1 and 8 (bf16, as served);
    # their own generator, so the cases after them keep their inputs.
    buckets = torch.Generator(device="cuda").manual_seed(SEED + 18)
    for batch in (1, 8):
        for cin, cout in SERVING.resblock:
            res["resblock"][f"{cin}_{cout}_bfloat16_b{batch}"] = check_resblock(
                cin, cout, torch.bfloat16, buckets, timing, batch=batch)
    res["conv"].update(check_bucket_plans(gen, timing))
    if timing:
        # Device ms of the kernels of one bf16 forward at batch 64 (the
        # served dtype; the final conv counted in f32, as it runs).
        per_fwd = {
            "group_norm": sum(res["gn"][f"L{l}_C{c}_{a}_bfloat16"]["ms"] * n
                              for (l, c, a), n in SERVING.gn.items()),
            **{f"conv3d_{impl}": sum(
                res["conv"][f"{impl}_L{l}_{i}_{o}_{'float32' if o == 3 else 'bfloat16'}"]["ms"]
                * n for (l, i, o), n in SERVING.conv.items()) for impl in ("im2col", "tapgemm")},
            "resblock": sum(res["resblock"][f"{i}_{o}_bfloat16"]["ms"]
                            for i, o in SERVING.resblock),
        }
        log("UNet kernels per bf16 forward at batch 64 (device ms)", **per_fwd,
            group_norm_bound=sum(res["gn"][f"L{l}_C{c}_{a}_bfloat16"]["bound_ms"] * n
                                 for (l, c, a), n in SERVING.gn.items()))
        gn_rows = [[f"L{l} C{c}{' silu' if a else ''}", n]
                   + [round(g[f], 6) for f in ("ms", "bound_ms", "library_ms")]
                   + [g["plan"]["route"], g["plan"]["cluster"], g["plan"]["threads"]]
                   for (l, c, a), n in SERVING.gn.items()
                   for g in [res["gn"][f"L{l}_C{c}_{a}_bfloat16"]]]
        log("group norm table, bf16 b64 [shape, calls a forward, ms, bound_ms, "
            "F.group_norm ms, route, k, threads]", rows=gn_rows)
        table = [[k] + [round(c[f], 5) for f in ("ms", "bound_ms", "library_ms", "tflops")]
                 + [c["plan"][f] for f in ("route", "bm", "bn", "kc", "tile", "stages",
                                           "nbox", "splits", "blocks", "smem_bytes")]
                 for k, c in res["conv"].items()]
        log("conv table [shape, ms, bound_ms, cudnn_ms, tflops, route, bm, bn, kc, tile, "
            "stages, nbox, splits, blocks, smem_bytes]", rows=table)
        table = [[k] + [round(r[f], 5) for f in ("ms", "bound_ms", "sequence_ms",
                                                 "composition_ms", "tflops")]
                 + [r["plan"][f] for f in ("bm", "bn", "tile", "kc", "stages", "nbox",
                                           "m_tiles", "smem_bytes")]
                 for k, r in res["resblock"].items()]
        log("resblock table [shape, ms, bound_ms, sequence_ms, composition_ms, tflops, bm, "
            "bn, tile, kc, stages, nbox, m_tiles, smem_bytes]", rows=table)
    return res



def baseline_conv_plan(impl: str, x_shape, cout: int, dtype, sms: int) -> tuple:
    """The plan arguments commit cdc7807's ``im2col_plan`` / ``tapgemm_plan``
    (``ops/kernels/conv3d.py``) gave its kernels: im2col (bm, bn, bk, kc,
    splits), tap-GEMM (bk, kc); kc is the widest of 64, 32, 16, 8 dividing
    Cin up to bk, 0 where Cin % 8 != 0."""
    b, t, h, w, cin = x_shape
    positions = b * t * h * w
    blocks = lambda bm, bn: -(-positions // bm) * -(-cout // bn)  # noqa: E731
    chunk = lambda bk: next((k for k in (64, 32, 16, 8)  # noqa: E731
                             if k <= bk and cin % k == 0), 0)
    if impl == "tapgemm":
        bk = 16 if dtype == torch.float32 else 64 if cin % 64 == 0 else 32
        return (bk, 0 if dtype == torch.float32 else chunk(bk))
    if dtype == torch.float32:
        if cout <= 4 and cin % 4 == 0 and cin * 4 <= 6144:
            return (256, 4, 16, 0, 1)
        bn = 64 if cout >= 64 and blocks(128, 64) >= 2 * sms else 32 if cout >= 32 else 16
        return (128, bn, 16, 0, 1)
    deep = cin % 64 == 0
    bn = 128 if cout > 64 and deep else 64 if cout > 32 else 32
    bk = 64 if deep and bn >= 64 else 32
    bm = 256 if (bn, bk) == (64, 64) and blocks(256, 64) >= 2 * sms else 128
    tiles = blocks(bm, bn)
    splits = 9 if cin % 8 == 0 and tiles < sms else 1
    return (bm, bn, bk, chunk(bk), splits)


def phase_conv_baseline(src_dir: Path) -> dict:
    """Both conv kernels of this tree against commit cdc7807's (``src_dir``
    holds its ``conv3d.cu``, ``common.cuh`` and ``mma.cuh``, from ``git show
    cdc7807:crowdmod_tpu_torch/csrc/<file>``; its C interface, with the
    plans of :func:`baseline_conv_plan`) at every ``SERVING.conv`` shape, f32
    and bf16, on this card: each output checked against this tree's within
    the conv tolerance, each timed in turns (baseline, this, this,
    baseline), with the host ms of a call: this tree's operator, and each
    tree's C call alone."""
    import ctypes

    from crowdmod_tpu_torch.ops.kernels import build, conv3d_same_im2col, conv3d_same_tapgemm
    from crowdmod_tpu_torch.ops.kernels import conv3d as conv_mod
    from crowdmod_tpu_torch.ops.kernels.build import sm_count
    from crowdmod_tpu_torch.ops.kernels.conv3d import pack_im2col, pack_tapgemm

    lib_path = src_dir / "libconv3d_baseline.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src_dir / "conv3d.cu")], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.crowdmod_conv3d_im2col.argtypes = [i32] + [ptr] * 5 + [i32] * 11 + [ptr]
    lib.crowdmod_conv3d_tapgemm.argtypes = [i32] + [ptr] * 4 + [i32] * 8 + [ptr]
    lib.crowdmod_conv3d_im2col.restype = lib.crowdmod_conv3d_tapgemm.restype = i32
    sms = sm_count(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        for impl in ("im2col", "tapgemm"):
            conv, pack = ((conv3d_same_im2col, pack_im2col) if impl == "im2col"
                          else (conv3d_same_tapgemm, pack_tapgemm))
            for level, cin, cout in SERVING.conv:
                x, kernel, bias = _conv_inputs(level, cin, cout, dtype, gen)
                wp = pack(kernel)
                out_old = torch.empty((*x.shape[:-1], cout), dtype=dtype, device="cuda")
                b, t, h, w, _ = x.shape
                plan = baseline_conv_plan(impl, tuple(x.shape), cout, dtype, sms)
                ws = None
                if impl == "im2col" and plan[-1] > 1:
                    ws = torch.empty(plan[-1] * b * t * h * w * cout, dtype=torch.float32,
                                     device="cuda")
                code = 1 if dtype == torch.bfloat16 else 0
                head = (code, x.data_ptr(), wp.data_ptr(), bias.data_ptr(), out_old.data_ptr())
                if impl == "im2col":
                    head += (None if ws is None else ws.data_ptr(),)

                def old():
                    err = getattr(lib, f"crowdmod_conv3d_{impl}")(
                        *head, b, t, h, w, cin, cout, *plan,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"baseline {impl} launch failed: {err}")

                # This tree's C call alone, its plan and output made once.
                new_plan = (conv_mod.im2col_plan if impl == "im2col" else
                            conv_mod.tapgemm_plan)(tuple(x.shape), cout, dtype)
                out_new = torch.empty_like(out_old)
                ws_new = (torch.empty(new_plan.workspace_elems(b * t * h * w, cout),
                                      dtype=torch.float32, device="cuda")
                          if new_plan.splits > 1 else None)
                new_args = (code, x.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                            out_new.data_ptr(), None if ws_new is None else ws_new.data_ptr(),
                            b, t, h, w, cin, cout, *new_plan.args())
                new_lib = build.load("conv3d", conv_mod._SIGNATURES)

                def new_raw():
                    err = getattr(new_lib, f"crowdmod_conv3d_{impl}")(
                        *new_args, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{impl} launch failed: {err}")

                old()
                new = conv(x, wp, bias)
                torch.cuda.synchronize()
                key = f"{impl}_L{level}_{cin}_{cout}_{_dn(dtype)}"
                tol = TOL["conv_f32" if dtype == torch.float32 else "bf16"]
                ref = new.float()
                err = _rel_check(f"baseline vs this tree {key}", out_old, ref, tol)
                o1, oh1 = cuda_ms_budget(old)
                n1, host1 = cuda_ms_budget(lambda: conv(x, wp, bias))
                raw_host = cuda_ms_budget(new_raw)[1]
                n2, host2 = cuda_ms_budget(lambda: conv(x, wp, bias))
                o2, oh2 = cuda_ms_budget(old)
                rows[key] = dict(baseline_ms=[o1, o2], ms=[n1, n2], host_ms=[host1, host2],
                                 c_call_host_ms=raw_host, baseline_c_call_host_ms=[oh1, oh2],
                                 speedup=(o1 + o2) / (n1 + n2), max_abs_diff=err,
                                 baseline_plan=list(plan))
                log(f"conv baseline {key}", **rows[key])
    per_fwd = {}
    for impl in ("im2col", "tapgemm"):
        for side in ("baseline_ms", "ms"):
            per_fwd[f"{impl}_{side}"] = sum(
                float(np.mean(rows[f"{impl}_L{lv}_{i}_{o}_"
                                   f"{'float32' if o == 3 else 'bfloat16'}"][side])) * n
                for (lv, i, o), n in SERVING.conv.items())
    log("conv baseline per bf16 forward at batch 64 (device ms; final conv f32)", **per_fwd)
    hosts = {side: statistics.median(
        v for r in rows.values() for v in np.ravel([r[side]]))
        for side in ("host_ms", "c_call_host_ms", "baseline_c_call_host_ms")}
    log("conv baseline host ms a call, medians over the shapes", **hosts)
    return rows


def baseline_attention_plan(b, h, sq, sk, dh, dtype) -> tuple:
    """The plan commit ed2c182's ``attention_plan`` gave its kernel: (route,
    problems a block, warps, keys padded, query rows, key block, smem)."""
    from crowdmod_tpu_torch.ops.kernels.attention import MAX_SMEM

    tiles, keys16 = -(-sq // 16), -(-sk // 16) * 16
    mma_smem = lambda n: 2 * (dh + 8) * n * (tiles * 16 + 2 * keys16)  # noqa: E731
    if dtype == torch.bfloat16 and sq >= 16 and dh in (16, 32, 64) and mma_smem(1) <= MAX_SMEM:
        per_block = max(1, 8 // tiles)
        while per_block > 1 and mma_smem(per_block) > MAX_SMEM:
            per_block -= 1
        return (1, per_block, min(per_block * tiles, 16), keys16, sq, keys16,
                mma_smem(per_block))
    keys = -(-sk // 4) * 4
    smem = lambda n: 4 * (n * sk * (2 * dh + 4) + 8 * (dh + keys))  # noqa: E731
    if smem(1) <= MAX_SMEM:
        per_block = max(1, 8 // max(sq, 1))
        while per_block > 1 and smem(per_block) > MAX_SMEM:
            per_block -= 1
        return (0, per_block, 8, keys, sq, keys, smem(per_block))
    rows = 8 * min(4, -(-sq // 8))
    return (0, 1, 8, keys, rows, 128, 4 * (128 * (2 * dh + 4) + 8 * (rows // 8 * dh + 128)))


def kernel_baseline_attention(lib, gen, failed: list) -> dict:
    """This tree's attention against commit ed2c182's (``lib``) at every
    path shape at batch 64, 8 and 1 (bf16, as served) and phase 2's other
    cases: the outputs compared (bitwise where the route did not change),
    times in turns (baseline, this, this, baseline) beside SDPA.  A case
    that fails its check goes to ``failed`` and is not timed."""
    import ctypes

    import torch.nn.functional as F

    from crowdmod_tpu_torch.ops.kernels import attention_reference, fused_attention
    from crowdmod_tpu_torch.ops.kernels.attention import attention_plan

    bf = torch.bfloat16
    cases = {}
    for batch in (64, 8, 1):
        cases[f"dit_spatial_b{batch}"] = (2 * batch, 4, 27, 27, 64, bf, True)
        cases[f"dit_temporal_b{batch}"] = (27 * batch, 4, 1, 2, 64, bf, False)
        cases[f"unet_level2_b{batch}"] = (batch, 4, 54, 54, 32, bf, True)
        for s_ in FM_DIT_TOKENS:
            cases[f"fm_dit_s{s_}_b{batch}"] = (batch, 4, s_, s_, 64, bf, True)
    for dtype in (torch.float32, bf):
        dn = _dn(dtype)
        cases[f"edge_s216_{dn}"] = (16, 4, 216, 216, 32, dtype, False)
        cases[f"edge_s432_dh32_{dn}"] = (16, 4, 432, 432, 32, dtype, False)
        cases[f"edge_s1000_{dn}"] = (4, 4, 1000, 1000, 64, dtype, False)
        cases[f"narrow_dh16_{dn}"] = (16, 4, 96, 96, 16, dtype, True)
        cases[f"narrow_dh8_{dn}"] = (16, 4, 96, 96, 8, dtype, True)
        if dtype == torch.float32:
            cases["dit_spatial_b64_float32"] = (128, 4, 27, 27, 64, dtype, True)
            cases["fm_dit_s216_b64_float32"] = (64, 4, 216, 216, 64, dtype, True)
    rows = {}
    for key, (b, h, sq, sk, dh, dtype, packed) in cases.items():
        if packed:
            qkv = _randn((b, sq, 3, h, dh), gen, dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q = _randn((b, h, sq, dh), gen, dtype)
            k, v = _randn((b, h, sk, dh), gen, dtype), _randn((b, h, sk, dh), gen, dtype)
        scale = dh ** -0.5
        plan = attention_plan(b, h, sq, sk, dh, dtype)
        old_plan = baseline_attention_plan(b, h, sq, sk, dh, dtype)
        out_old = q.new_empty_strided((b, h, sq, dh), (sq * h * dh, dh, h * dh, 1))
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                           *out_old.stride()[:3])
        code = 1 if dtype == bf else 0

        def old():
            err = lib.crowdmod_attention(
                code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out_old.data_ptr(), b, h, sq,
                sk, dh, scale, strides, *old_plan, 1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"baseline attention {key} launch failed: {err}")

        new = lambda: fused_attention(q, k, v, scale=scale)  # noqa: E731
        old()
        out = new()
        torch.cuda.synchronize()
        ref = attention_reference(q.float(), k.float(), v.float(), scale)
        err = (out.float() - ref).abs().max().item()
        tol = TOL["attention_f32" if dtype == torch.float32 else "attention_bf16"]
        same_route = plan.route == ("mma", "simt")[old_plan[0] == 0]
        again = new()
        torch.cuda.synchronize()
        bitwise_old = torch.equal(out, out_old)
        if not (err <= tol and torch.equal(out, again) and (bitwise_old or not same_route)):
            failed.append(f"attention baseline {key}: err {err}, repeat "
                          f"{torch.equal(out, again)}, bitwise ed2c182 {bitwise_old} ({plan})")
            log("kernel baseline FAILED", case=failed[-1])
            continue
        o1 = cuda_ms_budget(old)[0]
        n1 = cuda_ms_budget(new)[0]
        n2 = cuda_ms_budget(new)[0]
        o2 = cuda_ms_budget(old)[0]
        rows[key] = dict(
            shape=[b, h, sq, sk, dh], dtype=_dn(dtype), route=plan.route,
            baseline_route=("simt", "mma")[old_plan[0]], baseline_ms=[o1, o2], ms=[n1, n2],
            speedup=(o1 + o2) / (n1 + n2), max_abs_err=err,
            max_abs_diff_baseline=(out.float() - out_old.float()).abs().max().item(),
            bitwise_baseline=bitwise_old,
            sdpa_ms=cuda_ms_budget(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))[0])
        log(f"kernel baseline attention {key}", **rows[key])
    return rows


def kernel_baseline_resblock(lib, gen, failed: list) -> dict:
    """This tree's fused resblock against commit ed2c182's (``lib``, its C
    interface and plan: 128 × 32 tiles of 32-deep chunks in bf16, the same
    SIMT tile in f32) at the three level-0 shapes at batch 64, 8 and 1 in
    bf16 and at batch 64 in f32: bf16 each within the bf16 tolerance of the
    f32 twin, f32 bitwise ed2c182's; times in turns beside the cuDNN
    sequence and the port's unfused composition.  A case that fails its
    check goes to ``failed`` and is not timed."""
    from crowdmod_tpu_torch.ops.kernels import fused_resblock, resblock_reference
    from crowdmod_tpu_torch.ops.kernels.resblock import pack_resblock, resblock_plan

    t, h, wd = SERVING.levels[0]
    rows = {}
    cases = [(batch, torch.bfloat16) for batch in (64, 8, 1)] + [(64, torch.float32)]
    for batch, dtype in cases:
        for cin, cout in SERVING.resblock:
            key = f"{cin}_{cout}_{_dn(dtype)}_b{batch}"
            x, temb, w = resblock_inputs(cin, cout, dtype, gen, batch)
            p = pack_resblock(w, dtype)
            pos = batch * t * h * wd
            bf = dtype == torch.bfloat16
            plan = resblock_plan(batch, t, h, wd, cin, cout, 8, dtype)
            bm, bn, bk = (128, 32, 32) if bf else (plan.bm, plan.bn, plan.bk)
            m_tiles, n_tiles = -(-pos // bm), -(-cout // bn)
            ws = torch.empty(2 * batch * 8 + (m_tiles * n_tiles * 4 * 8 if bf else 2 * batch * 8),
                             dtype=torch.float32, device="cuda")
            a1 = torch.empty(pos * cin if bf else 1, dtype=torch.bfloat16, device="cuda")
            h1 = torch.empty(pos * cout, dtype=dtype, device="cuda")
            out_old = torch.empty((batch, t, h, wd, cout), dtype=dtype, device="cuda")
            tvec = (temb.float() + p["b1"]).contiguous()

            def old():
                err = lib.crowdmod_resblock(
                    1 if bf else 0, x.data_ptr(), tvec.data_ptr(), p["w1"].data_ptr(),
                    p["w2"].data_ptr(), p["gamma1"].data_ptr(), p["beta1"].data_ptr(),
                    p["gamma2"].data_ptr(), p["beta2"].data_ptr(), p["bias2"].data_ptr(),
                    a1.data_ptr() if bf else None, h1.data_ptr(), ws.data_ptr(),
                    out_old.data_ptr(), batch, t, h, wd, cin, cout, 8, 1e-5,
                    int(p["has_skip"]), bm, bn, bk, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"baseline resblock {key} launch failed: {err}")

            new = lambda: fused_resblock(x, temb, w, packed=p)  # noqa: E731
            old()
            out = new()
            torch.cuda.synchronize()
            ref = resblock_reference(x.float(), temb.float(), w)
            tol = TOL["bf16" if bf else "resblock_f32"]
            err = (out.float() - ref).abs().max().item()
            again = new()
            torch.cuda.synchronize()
            if not (err <= tol * ref.abs().max().item() and torch.equal(out, again)
                    and (bf or torch.equal(out, out_old))):
                failed.append(f"resblock baseline {key}: err {err} (tol {tol} x "
                              f"{ref.abs().max().item()}), repeat {torch.equal(out, again)}, "
                              f"bitwise ed2c182 {torch.equal(out, out_old)} ({plan})")
                log("kernel baseline FAILED", case=failed[-1])
                continue
            o1 = cuda_ms_budget(old)[0]
            n1 = cuda_ms_budget(new)[0]
            n2 = cuda_ms_budget(new)[0]
            o2 = cuda_ms_budget(old)[0]
            rows[key] = dict(
                shape=[batch, t, h, wd, cin, cout], dtype=_dn(dtype), baseline_ms=[o1, o2],
                ms=[n1, n2], speedup=(o1 + o2) / (n1 + n2), max_abs_err=err,
                max_abs_diff_baseline=(out.float() - out_old.float()).abs().max().item(),
                bitwise_baseline=torch.equal(out, out_old),
                sequence_ms=cuda_ms_budget(resblock_sequence(x, temb, w))[0],
                composition_ms=cuda_ms_budget(resblock_composition(x, temb, w))[0],
                plan=dataclasses.asdict(plan))
            log(f"kernel baseline resblock {key}", **rows[key])
    return rows


def kernel_alternatives(gen) -> dict:
    """The data behind the two plans' choices, at batch 64 (bf16): each
    built key split of the attention's wgmma route at the FM-DiT shapes,
    and each built row block (64-row tiles a warpgroup) of the fused
    resblock at the three level-0 shapes, each held to its twin and timed
    through the C call; then the device time of the default resblock's
    launches by kernel (torch.profiler, 20 calls)."""
    import ctypes

    from crowdmod_tpu_torch.ops.kernels import (
        attention_reference,
        build,
        fused_resblock,
        resblock_reference,
    )
    from crowdmod_tpu_torch.ops.kernels import attention as attn_mod
    from crowdmod_tpu_torch.ops.kernels import resblock as res_mod

    rows = {}
    lib = build.load("attention", attn_mod._SIGNATURES)
    for s_ in FM_DIT_TOKENS:
        b, h, dh = 64, 4, 64
        qkv = _randn((b, s_, 3, h, dh), gen, torch.bfloat16)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        ref = attention_reference(q.float(), k.float(), v.float(), dh ** -0.5)
        for split in (1, 2, 3):
            plan = attn_mod._wgmma_plan(b, h, s_, s_, dh, split)
            if plan is None:
                continue
            out = attn_mod._empty_out(q)
            strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                               *v.stride()[:3], *out.stride()[:3])

            def call():
                err = lib.crowdmod_attention(
                    1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s_, s_,
                    dh, dh ** -0.5, strides, 2, 1, plan.warps, plan.keys_padded, s_,
                    plan.key_block, plan.smem_bytes, 1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"attention split {split} launch failed: {err}")

            call()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            key = f"attention_s{s_}_split{split}_nk{plan.key_block}"
            rows[key] = dict(ms=cuda_ms_budget(call)[0], max_abs_err=err,
                             smem_bytes=plan.smem_bytes)
            log(f"kernel alternative {key}", **rows[key])
    lib = build.load("resblock", res_mod._SIGNATURES)
    t, h, wd = SERVING.levels[0]
    for cin, cout in SERVING.resblock:
        x, temb, w = resblock_inputs(cin, cout, torch.bfloat16, gen)
        p = res_mod.pack_resblock(w, torch.bfloat16)
        ref = resblock_reference(x.float(), temb.float(), w)
        temb_bf = temb.to(torch.bfloat16).contiguous()
        for mt in (1, 2, 4):
            try:
                plan = res_mod.resblock_plan(UNET_BATCH, t, h, wd, cin, cout, 8,
                                             torch.bfloat16, mt=mt)
            except ValueError:
                continue
            out = torch.empty((UNET_BATCH, t, h, wd, cout), dtype=torch.bfloat16, device="cuda")
            a1 = torch.empty(plan.a1_elems, dtype=torch.bfloat16, device="cuda")
            h1 = torch.empty(plan.h1_elems, dtype=torch.bfloat16, device="cuda")
            ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device="cuda")
            halo = (ctypes.c_int * 8)(*plan.halo)

            def call():
                err = lib.crowdmod_resblock(
                    1, x.data_ptr(), temb_bf.data_ptr(), p["b1"].data_ptr(),
                    *(p[n].data_ptr() for n in res_mod.PACKED if n != "b1"),
                    a1.data_ptr(), h1.data_ptr(), ws.data_ptr(), out.data_ptr(), UNET_BATCH, t, h,
                    wd, cin, cout, 8, 1e-5, int(p["has_skip"]), plan.bm, plan.bn, plan.bk, halo,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"resblock mt {mt} launch failed: {err}")

            call()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item() / ref.abs().max().item()
            key = f"resblock_{cin}_{cout}_mt{mt}"
            rows[key] = dict(ms=cuda_ms_budget(call)[0], rel_err=err, tile=plan.tile,
                             kc=plan.kc, stages=plan.stages, nbox=plan.nbox,
                             items=plan.m_tiles)
            log(f"kernel alternative {key}", **rows[key])

        def twenty():
            for _ in range(20):
                fused_resblock(x, temb, w, packed=p)
            torch.cuda.synchronize()

        twenty()
        _, by_name, launches = kernel_times(twenty)
        short = lambda n: n.replace("void ", "").replace(  # noqa: E731
            "crowdmod::(anonymous namespace)::", "")[:70]
        rows[f"resblock_{cin}_{cout}_profile"] = {
            short(n): us / 20 for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])}
        log(f"kernel alternative resblock {cin}->{cout} b64 device us a call by kernel",
            launches=launches / 20, **rows[f"resblock_{cin}_{cout}_profile"])
    return rows


def phase_kernel_baseline(src_dir: Path) -> dict:
    """This tree's attention and fused resblock against commit ed2c182's
    (``src_dir`` holds its ``attention.cu``, ``resblock.cu``,
    ``common.cuh``, ``mma.cuh`` and ``hopper.cuh``, from ``git show
    ed2c182:crowdmod_tpu_torch/csrc/<file>``), both built from there, in
    turns on this card: :func:`kernel_baseline_attention` and
    :func:`kernel_baseline_resblock`, then each kernel's per-forward sums."""
    import ctypes

    from crowdmod_tpu_torch.ops.kernels import build

    jobs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(src_dir), "-o",
         str(src_dir / f"lib{name}_baseline.so"), str(src_dir / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("attention", "resblock")}
    libs = {}
    for name, proc in jobs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"baseline {name}.cu failed to build:\n{text}")
        libs[name] = ctypes.CDLL(str(src_dir / f"lib{name}_baseline.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = libs["attention"].crowdmod_attention
    fn.argtypes = ([i32] + [ptr] * 4 + [i32] * 5
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)] + [i32] * 8 + [ptr])
    fn.restype = i32
    fn = libs["resblock"].crowdmod_resblock
    fn.argtypes = [i32] + [ptr] * 13 + [i32] * 7 + [ctypes.c_float] + [i32] * 4 + [ptr]
    fn.restype = i32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    failed = []  # a case off its tolerance is logged, the others still run
    attn = kernel_baseline_attention(libs["attention"], gen, failed)
    res = kernel_baseline_resblock(libs["resblock"], gen, failed)
    kernel_alternatives(gen)
    if failed:
        raise AssertionError(f"{len(failed)} kernel baseline cases failed: {failed}")
    for batch in (64, 8, 1):
        sums = {side: sum(float(np.mean(res[f"{i}_{o}_bfloat16_b{batch}"][side]))
                          for i, o in SERVING.resblock)
                for side in ("baseline_ms", "ms")}
        sums.update({side: sum(res[f"{i}_{o}_bfloat16_b{batch}"][side]
                               for i, o in SERVING.resblock)
                     for side in ("sequence_ms", "composition_ms")})
        log(f"kernel baseline resblocks per bf16 UNet forward at batch {batch} (device ms)",
            **sums)
    table = [[k, r["route"], r["baseline_route"], round(float(np.mean(r["ms"])), 5),
              round(float(np.mean(r["baseline_ms"])), 5), round(r["sdpa_ms"], 5),
              r["bitwise_baseline"]] for k, r in attn.items()]
    log("kernel baseline attention table [case, route, ed2c182 route, ms, ed2c182 ms, "
        "SDPA ms, bitwise ed2c182]", rows=table)
    table = [[k, round(float(np.mean(r["ms"])), 5), round(float(np.mean(r["baseline_ms"])), 5),
              round(r["sequence_ms"], 5), round(r["composition_ms"], 5)]
             for k, r in res.items()]
    log("kernel baseline resblock table [case, ms, ed2c182 ms, cuDNN sequence ms, "
        "composition ms]", rows=table)
    return {"attention": attn, "resblock": res}


def phase_conv_ab(sources: list) -> dict:
    """Builds of variants of ``csrc/conv3d.cu`` (each ``sources`` file, with
    this tree's headers and C interface, into ``_build/ab-<stem>.so``; the
    stems name the variants) against each other at every bf16
    ``SERVING.conv`` shape, both kernels with this tree's plans, in turns
    (A B … B A); a plan with two boxes at levels 0-1 is also timed with one.
    Each output is held to the twin first."""
    import ctypes

    from crowdmod_tpu_torch.ops.kernels import build, conv3d_same_reference
    from crowdmod_tpu_torch.ops.kernels import conv3d as conv_mod

    libs, jobs = {}, []
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for src in sources:
        out = build.BUILD_DIR / f"ab-{src.stem}.so"
        jobs.append((src.stem, out, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, out, proc in jobs:
        text, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text[-3000:]}")
        lib = ctypes.CDLL(str(out))
        for fn, (restype, argtypes) in conv_mod._SIGNATURES.items():
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        libs[name] = lib
        log("conv ab built", variant=name,
            serialised_wgmma=sum("C7515" in ln for ln in text.splitlines()))
    names = list(libs)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    dtype = torch.bfloat16
    rows, forward = {}, dict.fromkeys(names, 0.0)

    def timed(key, impl, plan, x, wp, bias, cout, ref):
        b, t, h, w, cin = x.shape
        out = torch.empty((b, t, h, w, cout), dtype=dtype, device="cuda")
        ws = (torch.empty(plan.workspace_elems(b * t * h * w, cout), dtype=torch.float32,
                          device="cuda") if plan.splits > 1 else None)

        def run(name):
            err = getattr(libs[name], f"crowdmod_conv3d_{impl}")(
                1, x.data_ptr(), wp.data_ptr(), bias.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), b, t, h, w, cin, cout, *plan.args(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name} {impl} launch failed: {err}")
            return out

        ms = {name: [] for name in names}
        for name in names:
            _rel_check(f"{name} {key}", run(name).clone(), ref, TOL["bf16"])
        for name in names + names[::-1]:
            ms[name].append(cuda_ms_budget(lambda name=name: run(name), budget_ms=20.0)[0])
        rows[key] = {name: v for name, v in ms.items()}
        log(f"conv ab {key}", **{name: float(np.mean(v)) for name, v in ms.items()})
        return ms

    for level, cin, cout in SERVING.conv:
        x, kernel, bias = _conv_inputs(level, cin, cout, dtype, gen)
        ref = conv3d_same_reference(x.float(), kernel.float(), bias)
        for impl, planner in (("im2col", conv_mod.im2col_plan),
                              ("tapgemm", conv_mod.tapgemm_plan)):
            wp = (conv_mod.pack_im2col if impl == "im2col" else conv_mod.pack_tapgemm)(kernel)
            plan = planner(tuple(x.shape), cout, dtype)
            ms = timed(f"{impl}_L{level}_{cin}_{cout}", impl, plan, x, wp, bias, cout, ref)
            if impl == "im2col":
                for name in names:
                    forward[name] += float(np.mean(ms[name])) * SERVING.conv[(level, cin, cout)]
            if plan.nbox == 2 and level < 2:
                timed(f"{impl}_L{level}_{cin}_{cout}_nbox1", impl,
                      dataclasses.replace(plan, nbox=1), x, wp, bias, cout, ref)
    log("conv ab im2col sum of one forward, bf16 (device ms)", **forward)
    return rows


def phase_conv_tiles() -> dict:
    """Every bf16 halo block the conv kernels are built with (``HALO_TILES``
    at the plan's channel chunk, with 1, 2, 3 or 9 splits) at every
    ``SERVING.conv`` shape, at batch 64 and at the serving bucket of 1, each
    checked against the twin and timed; ``chosen`` marks the wrappers'
    plan.  The data behind the plan functions' choices."""
    from crowdmod_tpu_torch.ops.kernels import conv3d_same_reference
    from crowdmod_tpu_torch.ops.kernels import conv3d as conv_mod

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    dtype = torch.bfloat16
    rows = {}
    for batch in (UNET_BATCH, 1):
        for level, cin, cout in SERVING.conv:
            x, kernel, bias = _conv_inputs(level, cin, cout, dtype, gen, batch)
            ref = conv3d_same_reference(x.float(), kernel.float(), bias)
            flops = 2 * (x.numel() // cin) * 27 * cin * cout
            packed = {"im2col": conv_mod.pack_im2col(kernel),
                      "tapgemm": conv_mod.pack_tapgemm(kernel)}
            shape = tuple(x.shape)
            chosen = {"im2col": conv_mod.im2col_plan(shape, cout, dtype),
                      "tapgemm": conv_mod.tapgemm_plan(shape, cout, dtype)}
            for impl, bm, bn, kc in sorted(conv_mod.HALO_TILES):
                if kc != chosen[impl].kc:
                    continue
                for splits in (1, 2, 3, 9):
                    try:
                        plan = conv_mod.halo_plan(impl, shape, cout, block=(bm, bn),
                                                  splits=splits)
                    except ValueError:  # no tile of this block fits the shape
                        continue
                    if plan.splits != splits:  # the packed stages take no split
                        continue

                    def fn(impl=impl, plan=plan):
                        return conv_mod._launch(f"crowdmod_conv3d_{impl}", x, packed[impl],
                                                bias, cout, plan)

                    key = f"{impl}_b{batch}_L{level}_{cin}_{cout}_{bm}x{bn}_s{splits}"
                    _rel_check(key, fn(), ref, TOL["bf16"])
                    ms = cuda_ms_budget(fn, budget_ms=20.0)[0]
                    rows[key] = dict(ms=ms, tflops=flops / ms / 1e9, tile=plan.tile,
                                     chosen=plan == chosen[impl])
    log("conv tiles [key, ms, tflops, tile, chosen]",
        rows=[[k, round(r["ms"], 5), round(r["tflops"], 1), r["tile"], r["chosen"]]
              for k, r in rows.items()])
    return rows


def phase_gn_plans() -> dict:
    """Every GroupNorm plan the kernel takes at every ``SERVING.gn`` shape
    and serving bucket in bf16 (float32 has the stream route only): the
    stream route and the cluster route at each cluster size with the plan's
    thread count and twice it, each checked against the twin and timed;
    ``chosen`` is the wrapper's plan.  The data behind ``group_norm_plan``'s
    choices."""
    from crowdmod_tpu_torch.ops.kernels import group_norm_reference
    from crowdmod_tpu_torch.ops.kernels.groupnorm import (
        CLUSTER_SIZES,
        GroupNormPlan,
        cluster_plan,
        group_norm_plan,
        launch,
    )
    from crowdmod_tpu_torch.serving import BATCH_BUCKETS

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = []
    dtype = torch.bfloat16
    for batch in BATCH_BUCKETS:
        for level, c, act in SERVING.gn:
            s = int(np.prod(SERVING.levels[level]))
            x = _randn((batch, s, c), gen, dtype)
            gamma, beta = 1.0 + 0.1 * _randn((c,), gen), 0.1 * _randn((c,), gen)
            ref = group_norm_reference(x.float(), gamma, beta, 8, 1e-5, act)
            out = torch.empty_like(x)
            base = cluster_plan(batch, s, c, 8, dtype, CLUSTER_SIZES[-1])
            plans = [GroupNormPlan("stream", 1, 256, s, 0, 1, batch * 8)] + [
                p for k in CLUSTER_SIZES for t in (base.threads, 2 * base.threads)
                for p in [cluster_plan(batch, s, c, 8, dtype, k, t)] if p]
            times = {}
            for p in plans:
                fn = lambda: launch(x, gamma, beta, out, 8, 1e-5, act, p)  # noqa: E731
                fn()
                _rel_check(f"group norm plan {p}", out, ref, TOL["bf16"])
                times[f"{p.route}{p.cluster}x{p.threads}"] = cuda_ms(fn, iters=20, reps=5)[0]
            chosen = group_norm_plan(batch, s, c, 8, dtype)
            key = f"{chosen.route}{chosen.cluster}x{chosen.threads}"
            best = min(times, key=times.get)
            rows.append([_dn(dtype), batch, f"L{level} C{c}{' silu' if act else ''}", key,
                         round(times[key] * 1e3, 2), best, round(times[best] * 1e3, 2),
                         {k: round(v * 1e3, 2) for k, v in times.items()}])
    log("group norm plans [dtype, batch, shape, chosen, chosen_us, best, best_us, us by plan]",
        rows=rows)
    return {"rows": rows}


# ---------------------------------------------------------------------------
# Phases 3-8
# ---------------------------------------------------------------------------

def write_config(cfg, path: Path) -> Path:
    """``cfg`` as YAML at ``path``; → the path."""
    import yaml

    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return path


def write_checkpoint(cfg, arch: str, workdir: Path, name: str = "ATC.yml") -> tuple[Path, str]:
    """The serving config with SAVE_DIR in ``workdir`` (written there as
    ``name``), and a checkpoint of ``arch`` with seeded random weights,
    every parameter perturbed by N(0, 0.02²) (the zero-init AdaLN and final
    layer would otherwise make the DiT output 0)."""
    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg = cfg.updated({"DATA_FS": {"SAVE_DIR": str(workdir / "ckpts")}})
    cfg_path = write_config(cfg, workdir / name)
    trainer = Trainer(cfg, arch, device=DEVICE, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    for sd in (trainer.params, trainer.ema_params):
        for v in (sd or {}).values():  # FM trains without EMA there
            v.add_(0.02 * torch.randn(v.shape, generator=gen).to(v.device))
    return cfg_path, trainer.save(str(workdir / "ckpts"), "000")


def launch_counts() -> dict:
    from crowdmod_tpu_torch.ops.kernels import KERNELS

    return {fn.__name__: fn.launches for fn in KERNELS}


def check_launches(label, before, per_forward, forwards, extra=None) -> dict:
    """The launches since ``before`` against ``per_forward`` × ``forwards``
    (+ ``extra``), every kernel; raises on any difference."""
    after = launch_counts()
    return hold_launches(label, {k: after[k] - before[k] for k in after},
                         per_forward, forwards, extra)


def hold_launches(label, got, per_forward, forwards, extra=None) -> dict:
    """Launch counts ``got`` (every kernel) against ``per_forward`` ×
    ``forwards`` (+ ``extra``); raises on any difference."""
    want = {k: v * forwards for k, v in per_forward.items()}
    want.update(extra or {})
    bad = {k: [got[k], want.get(k, 0)] for k in got if got[k] != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{label}: launches [got, expected] {bad}")
    return got


def profile_request(pred, past, arch) -> dict:
    """Device busy share of one serving request."""
    pred.predict(past)
    return profile_busy(lambda: pred.predict(past), f"profile serving {arch} b64")


def kernel_times(fn) -> tuple[float, dict, int]:
    """One call of ``fn`` (which ends synchronised) under torch.profiler →
    its wall µs, the card's µs by kernel name, and the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # Device events, less the ranges that user annotations (the optimizer's
    # step) mirror onto the card's timeline: those overlap the kernels.  Read
    # from the raw trace: prof.events() builds an object an event, minutes
    # for the ~2 M events of a 1000-step request.
    by_name: dict[str, float] = {}
    kernels = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        kernels += 1
        by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e3
    return wall_us, by_name, kernels


def profile_busy(fn, label) -> dict:
    """Device busy share of one call of ``fn`` (which ends synchronised),
    from a torch.profiler trace: kernel time on the card over the call's
    wall time."""
    wall_us, by_name, kernels = kernel_times(fn)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    res = dict(wall_ms_profiled=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               busy_share=busy_us / wall_us, kernel_launches=kernels,
               top_kernels_ms=[[n[:80], t / 1e3] for n, t in top])
    log(label, **res)
    return res


def phase_serving(cfg_path: Path, arch: str, f_shape, per_forward) -> dict:
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.serving import BatchingQueue, load_predictor

    before = launch_counts()
    pred = load_predictor(str(cfg_path), arch, device=DEVICE)
    t0 = time.perf_counter()
    pred.warmup()
    warmup_s = time.perf_counter() - t0
    p, f, h, w, c = pred.input_spec
    walkers = synthetic_walkers(256, h, w, p + f)[:, :p]

    queue = BatchingQueue(pred, max_delay_ms=5.0)
    results, errors = [], []
    rng = np.random.default_rng(SEED)
    sizes = [[int(n) for n in rng.integers(1, 9, size=4)] for _ in range(4)]

    def client(ns):
        try:
            for n in ns:
                results.append((n, queue.predict(walkers[:n], timeout=600)))
        except Exception as e:  # re-raised below, after the threads end
            errors.append(e)

    threads = [threading.Thread(target=client, args=(ns,)) for ns in sizes]
    for t in threads:
        t.start()
    big = queue.predict(walkers[:64], timeout=600)
    for t in threads:
        t.join(timeout=900)
    queue.close()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"BatchingQueue clients failed: {errors}")
    results.append((64, big))
    if len(results) != 17:
        raise AssertionError(f"{len(results)} of 17 requests answered")
    for n, out in results:
        if out.shape != (n,) + f_shape or not np.isfinite(out).all():
            raise AssertionError(f"bad output {out.shape} for a batch of {n}")

    p50 = {}
    for b in pred.batch_buckets:
        lat = []
        for _ in range(3 if b < 256 else 2):  # cut from 5 and 3 for time
            t0 = time.perf_counter()
            pred.predict(walkers[:b])
            lat.append(1e3 * (time.perf_counter() - t0))
        p50[b] = statistics.median(lat)
    profile = profile_request(pred, walkers[:64], arch)
    steps = pred.cfg.MODEL.DDPM.ETA_STEPS
    launches = check_launches(f"{arch} serving", before, per_forward,
                              steps * pred.stats.requests)
    res = dict(arch=arch, requests=len(results), dispatches=queue.dispatches,
               coalesced=queue.coalesced_requests, buckets=pred.batch_buckets,
               warmup_s=warmup_s, predictions=pred.stats.requests,
               p50_ms_per_bucket={str(k): v for k, v in p50.items()},
               out_abs_mean=float(np.abs(big).mean()), launches=launches)
    log(f"serving {arch} DDIM-eta {steps} + Sparsity", **res)
    return {**res, "profile": profile}


def phase_ancestral(cfg, arch: str, ckpt_path: str, f_shape, per_forward,
                    batch: int = 64) -> dict:
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.serving import Predictor

    cfg = cfg.updated({"MODEL": {"DDPM": {"SAMPLER": "DDPM"}}})
    node = cfg.MODEL.DDPM
    pred = Predictor(cfg, arch, ckpt_path, device=DEVICE, batch_buckets=(batch,))
    p, f, h, w, c = pred.input_spec
    past = synthetic_walkers(batch, h, w, p + f)[:, :p]
    before = launch_counts()
    t0 = time.perf_counter()
    out = pred.predict(past)
    latency = time.perf_counter() - t0
    T = node.TIMESTEPS
    launches = check_launches(f"{arch} ancestral", before, per_forward, T,
                              {"fused_ancestral_update": T})
    if out.shape != (batch,) + f_shape or not np.isfinite(out).all():
        raise AssertionError(f"bad ancestral output {out.shape}")
    res = dict(arch=arch, batch=batch, timesteps=T, guidance=node.GUIDANCE,
               lambda_guidance=node.LAMBDA_GUIDANCE, latency_s=latency,
               launches=launches)
    log(f"ancestral {arch} DDPM-{T} b{batch}", **res)
    return res


@contextlib.contextmanager
def twins_on_the_card():
    """Route every kernel call site of the models to the plain twins (this
    script's comparison only; the port itself never does this).  The
    DDIM-eta chains compared below run no ancestral step."""
    import crowdmod_tpu_torch.models.backbones.fused_apply as fused_mod
    import crowdmod_tpu_torch.ops.attention as attn_mod
    import crowdmod_tpu_torch.ops.conv3d as conv_mod
    import crowdmod_tpu_torch.ops.norm as norm_mod
    from crowdmod_tpu_torch.ops.kernels import (
        attention_reference,
        conv3d_same_reference,
        group_norm_reference,
        resblock_reference,
    )

    # Each twin is plain PyTorch, so autograd differentiates it directly:
    # under this context a backward pass runs the twins' own VJPs.
    twins = [
        (attn_mod, "fused_attention",
         lambda q, k, v, *, scale: attention_reference(q, k, v, scale)),
        (norm_mod, "fused_group_norm",
         lambda x, g, b, *, num_groups, eps, silu: group_norm_reference(
             x, g, b, num_groups, eps, silu)),
        (conv_mod, "conv3d_same",
         lambda x, weight, bias, packed, impl: conv3d_same_reference(
             x, conv_mod.jax_kernel(weight).to(x.dtype), bias)),
        (fused_mod, "fused_resblock",
         lambda x, temb, w, *, num_groups, eps, packed=None: resblock_reference(
             x, temb, w, num_groups=num_groups, eps=eps)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in twins]
    try:
        for mod, name, fn in twins:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def hold_chain(label, chain_k, chain_t) -> int:
    """A free-running chain's states with the kernels (``chain_k``, x_T
    first) against the twins': each state after x_T within ``TOL["chain"]``,
    except ρ elements whose sign flipped near 0 under Sparsity (at most
    ``TOL["max_flip_share"]`` of a state's elements); → the flips."""
    from crowdmod_tpu_torch.core import layout

    if not torch.isfinite(chain_k).all():
        raise AssertionError(f"{label}: chain output is not finite")
    flips = 0
    for step in range(1, len(chain_k)):
        off = (chain_k[step] - chain_t[step]).abs() > TOL["chain"]
        step_flips = int(off[..., layout.RHO].sum())
        off_other = int(off.sum()) - step_flips
        if off_other or step_flips > TOL["max_flip_share"] * off.numel():
            raise AssertionError(
                f"{label} chain kernels vs twins, step {step}: {off_other} "
                f"non-rho elements and {step_flips} rho flips beyond {TOL['chain']}")
        flips += step_flips
    return flips


def phase_end_to_end(cfg, arch: str, ckpt_path: str) -> dict:
    """One f32 batch-64 forward and one free-running DDIM-eta chain, with
    the kernels (each conv kernel, for the UNet) and with the twins, on the
    card.  The tap-GEMM run is that kernel's path and its launches are
    returned."""
    from crowdmod_tpu_torch.core.schedule import respaced_taus
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.models.diffusion import ddim_eta_sample
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.train.trainer import Trainer

    # f32 end to end, and no TF32 anywhere, so the routes differ only by the
    # kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    node = cfg.MODEL.DDPM
    p, f, h, w = (cfg.DATASET.PAST_LEN, cfg.DATASET.FUTURE_LEN,
                  cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    past = torch.from_numpy(synthetic_walkers(64, h, w, p + f)[:, :p]).to(DEVICE)
    x = torch.randn((64, f, h, w, 3), generator=gen, device=DEVICE)
    t = torch.randint(0, node.TIMESTEPS, (64,), generator=gen, device=DEVICE)
    taus = respaced_taus(node.TIMESTEPS, node.ETA_STEPS)
    draws = {None: x}
    draws.update({int(s): torch.randn(x.shape, generator=gen, device=DEVICE)
                  for s in taus})
    guide = dict(noise=draws.__getitem__, eta=node.ETA, guidance=node.GUIDANCE,
                 lambda_guidance=node.LAMBDA_GUIDANCE)

    def run(conv_impl):
        """The forward and the chain's states, x_T first."""
        trainer = Trainer(cfg, arch, device=DEVICE, compute_dtype=torch.float32,
                          conv_impl=conv_impl)
        trainer.load(ckpt_path)
        denoise = trainer._denoise_fn()  # binds the checkpoint's EMA weights
        with torch.no_grad():
            fwd = trainer.model(x, t, past)
            chain = ddim_eta_sample(denoise, trainer.sched, past, tuple(x.shape),
                                    taus, history=True, **guide)[1]
        torch.cuda.synchronize()
        return fwd, chain

    with twins_on_the_card():
        fwd_t, chain_t = run("im2col")
    impls = ("im2col", "tapgemm") if arch == "DDPM-UNet" else ("im2col",)
    res, tap_launches = {"arch": arch, "chain": "free-running"}, None
    for impl in impls:
        if impl == "tapgemm":
            reset_launch_counts()  # the tap-GEMM kernel's path
        fwd_k, chain_k = run(impl)
        if impl == "tapgemm":
            tap_launches = launch_counts()["conv3d_same_tapgemm"]
            want = PER_FORWARD[arch](cfg)["conv3d_same_im2col"] * (1 + len(taus))
            if tap_launches != want or launch_counts()["conv3d_same_im2col"]:
                raise AssertionError(
                    f"tap-GEMM path launched {tap_launches} tap-GEMM convs "
                    f"(expected {want}) and "
                    f"{launch_counts()['conv3d_same_im2col']} im2col convs")
        fwd_err = (fwd_k - fwd_t).abs().max().item()
        if not fwd_k.abs().max().item() > 1e-3:
            raise AssertionError(f"{arch}: the denoiser output is all but zero")
        if not fwd_err <= TOL["forward_f32"]:
            raise AssertionError(f"{arch} {impl} forward kernels vs twins: {fwd_err}")
        flips = hold_chain(f"{arch} {impl}", chain_k, chain_t)
        res[impl] = dict(forward_max_abs_diff=fwd_err,
                         forward_abs_max=fwd_k.abs().max().item(),
                         chain_max_abs_diff=(chain_k - chain_t).abs().max().item(),
                         chain_rho_flips=flips, chain_steps=len(chain_k) - 1,
                         state_elements=chain_k[0].numel())
    res["tapgemm_path_launches"] = tap_launches
    log(f"end to end {arch} kernels vs twins (f32)", **res)
    return res


# ---------------------------------------------------------------------------
# Phase 9: training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6  # one epoch of 6 batches


def training_config(workdir: Path):
    """``configs/ATC.yml`` (batch 64, bf16 compute) with EMA 0.999 (ConvRNN:
    none, as configured), one epoch, no late checkpoints, files under
    ``workdir``."""
    from crowdmod_tpu_torch.config import load_config

    train = {"TRAIN": {"EPOCHS": 1, "EMA_DECAY": 0.999}}
    return load_config("ATC.yml", overrides={
        "DATA_FS": {"SAVE_DIR": str(workdir / "ckpts"), "OUTPUT_DIR": str(workdir / "out")},
        "MODEL": {"DDPM": {"CHECKPOINTS_TO_KEEP": 0, "UNET": train, "DIT": train},
                  "FM": {"CHECKPOINTS_TO_KEEP": 0, "UNET": train, "DIT": train},
                  "CONVRNN": {"CHECKPOINTS_TO_KEEP": 0, "TRAIN": {"EPOCHS": 1}}},
    })


def walker_windows(cfg, n_windows: int, seed: int, channels: int = 3):
    """``n_windows`` synthetic walker windows (two a 16-frame sequence, plus
    N(0, 0.05²) so the rows differ) on the card; ``channels=4`` adds a
    σ²_v channel of |N(0, 0.05²)| (ρ kept ≥ 0 there too)."""
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.data.windows import WindowDataset

    h, w = cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS
    raw = synthetic_walkers(n_windows // 2, h, w, 16)
    if channels == 4:
        raw = np.concatenate([raw, np.zeros(raw.shape[:-1] + (1,), np.float32)], -1)
    noise = np.random.default_rng(seed).normal(0, 0.05, raw.shape).astype(np.float32)
    if channels == 4:
        noise[..., (0, 3)] = np.abs(noise[..., (0, 3)])
    raw = raw + noise
    return WindowDataset(torch.from_numpy(raw).to(DEVICE), past_len=cfg.DATASET.PAST_LEN,
                         future_len=cfg.DATASET.FUTURE_LEN, stride=8)


def perturb_(model, seed: int) -> None:
    """Every parameter + N(0, 0.02²): the zero-init AdaLN and final layer
    would otherwise give most DiT parameters a zero gradient."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen).to(p.device))


def batch_gradients(trainer, batch, t, eps) -> tuple[float, dict]:
    """Loss and every parameter's gradient (None where it got none) for one
    batch with fixed t, ε and dropout masks (a generator of fixed seed)."""
    from crowdmod_tpu_torch.train.trainer import StepDraws

    trainer.model.zero_grad(set_to_none=True)
    draws = StepDraws(t=t, eps=eps,
                      generator=torch.Generator(device=DEVICE).manual_seed(SEED + 7))
    loss = trainer._loss_fn()(batch, draws)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {n: None if p.grad is None else p.grad.detach().clone()
                         for n, p in trainer.model.named_parameters()}


def check_gradients(cfg, arch: str, workdir: Path) -> dict:
    """One batch of 64 through the kernels against the same batch under the
    twins: f32 (TF32 off, deterministic algorithms, for this check only) and
    bf16 kernels against the f32 twins.  The DiT runs at dropout 0, so its
    spatial and temporal (Sq ≠ Sk) attention take the kernel."""
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.train.trainer import Trainer

    if arch == "DDPM-DiT":
        cfg = cfg.updated({"MODEL": {"DDPM": {"DIT": {"DROPOUT_RATE": 0.0}}}})
    ds = walker_windows(cfg, 64, SEED + 5)
    batch = next(ds.batches(64, shuffle=False))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    t = torch.randint(0, cfg.MODEL.DDPM.TIMESTEPS, (64,), generator=gen, device=DEVICE)
    eps = torch.randn(batch[1].shape, generator=gen, device=DEVICE)

    def grads(dtype, twins):
        tr = Trainer(cfg, arch, device=DEVICE, compute_dtype=dtype, seed=SEED,
                     run_dir=str(workdir / "grad_run"))
        perturb_(tr.model, SEED + 8)
        reset_launch_counts()
        with twins_on_the_card() if twins else contextlib.nullcontext():
            out = batch_gradients(tr, batch, t, eps)
        return out, launch_counts()

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (loss_k, g_k), launches = grads(torch.float32, False)
        (loss_t, g_t), twin_launches = grads(torch.float32, True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (loss_b, g_b), _ = grads(torch.bfloat16, False)

    want = {"DDPM-DiT": ("fused_attention",),
            "DDPM-UNet": ("fused_attention", "fused_group_norm", "conv3d_same_im2col")}[arch]
    if not all(launches[k] for k in want) or any(twin_launches.values()):
        raise AssertionError(f"{arch} gradient check: kernels {launches}, twins {twin_launches}")
    missing = [n for n, g in {**g_k, **g_b}.items() if g is None]
    if missing:
        raise AssertionError(f"{arch}: no gradient for {missing}")
    g_max = max(g.abs().max().item() for g in g_t.values())
    worst_f32, worst_cos, noise = (0.0, ""), (1.0, ""), 0
    for name, ref in g_t.items():
        own = ref.abs().max().item()
        at_noise = own < TOL["grad_own_scale"] * g_max  # 0 up to float noise
        scale = g_max if at_noise else own
        err = (g_k[name] - ref).abs().max().item()
        if not err <= TOL["grad_f32"] * scale:
            raise AssertionError(f"{arch} f32 gradient {name}: {err} > "
                                 f"{TOL['grad_f32']} x {scale}")
        worst_f32 = max(worst_f32, (err / scale, name))
        if at_noise:  # no direction to compare
            noise += 1
            err = (g_b[name].float() - ref).abs().max().item()
            if not err <= TOL["bf16"] * g_max:
                raise AssertionError(f"{arch} bf16 gradient {name}: {err} > "
                                     f"{TOL['bf16']} x {g_max}")
            continue
        cos = torch.nn.functional.cosine_similarity(
            g_b[name].float().flatten(), ref.flatten(), dim=0).item()
        if not cos >= TOL["grad_bf16_cos"]:
            raise AssertionError(f"{arch} bf16 gradient {name}: cosine {cos}")
        worst_cos = min(worst_cos, (cos, name))
    loss_rel = abs(loss_b - loss_t) / abs(loss_t)
    if not (abs(loss_k - loss_t) <= 1e-5 * abs(loss_t) and loss_rel <= TOL["loss_bf16"]):
        raise AssertionError(f"{arch} losses: kernels f32 {loss_k}, bf16 {loss_b}, "
                             f"twins {loss_t}")
    res = dict(arch=arch, params=len(g_t), loss_f32=loss_k, loss_twins=loss_t,
               loss_bf16=loss_b, loss_bf16_rel=loss_rel, grad_max=g_max,
               worst_f32_err_over_scale=worst_f32, worst_bf16_cosine=worst_cos,
               params_at_noise=noise,
               kernel_launches=launches)
    log(f"gradient check {arch} kernels vs twins", **res)
    return res


def train_state(tr) -> dict:
    """A copy on the host of everything a checkpoint of ``tr`` holds."""
    import copy

    from crowdmod_tpu_torch.train import checkpoint as ckpt

    return copy.deepcopy(ckpt._to_cpu({
        "params": tr.params, "ema_params": tr.ema_params, "step": tr.state.step,
        "optimizer": tr.state.optimizer.state_dict()}))


def hold_checkpoint(label: str, path, want: dict) -> dict:
    """The checkpoint at ``path`` against a kept copy of the state
    (:func:`train_state`): weights, EMA, step and Adam's state, bitwise."""
    from crowdmod_tpu_torch.train import checkpoint as ckpt

    payload, _ = ckpt.load_checkpoint(path)
    parts = [part for part in ("params", "ema_params") if want[part] is not None]
    if ("ema_params" in payload) != ("ema_params" in parts):
        raise AssertionError(f"{label}: EMA in the checkpoint: {'ema_params' in payload}")
    bad = [f"{part}.{k}" for part in parts
           for k, v in want[part].items() if not torch.equal(payload[part][k], v)]
    opt, got = want["optimizer"], payload["optimizer"]
    bad += [f"optimizer.{i}.{k}" for i, m in opt["state"].items() for k, v in m.items()
            if not (torch.equal(got["state"][i][k], v) if isinstance(v, torch.Tensor)
                    else got["state"][i][k] == v)]
    if bad or payload["step"] != want["step"] or got["param_groups"] != opt["param_groups"]:
        raise AssertionError(f"{label}: the checkpoint is not the kept state: "
                             f"{bad[:8]}, step {payload['step']} vs {want['step']}")
    return {"bitwise": True, "tensors": sum(len(want[p]) for p in parts)}


def check_async_saves(tr, cfg, train_ds, workdir: Path) -> dict:
    """Checkpoints on the card.  An async save raced by two more training
    steps (Adam and the EMA update the saved tensors in place) loads
    bitwise to the state of the call, in the bytes of a synchronous save of
    that state; the save's ms on the loop (sync, async) and the commit's
    ms; one more epoch's wall with async saves and one with sync ones."""
    import filecmp

    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import StepDraws

    save_dir = cfg.DATA_FS.SAVE_DIR
    kept = train_state(tr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync = Path(tr.save(str(workdir / "sync"), "race"))
    sync_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    path = Path(tr.save(save_dir, "race", async_save=True))
    async_ms = 1e3 * (time.perf_counter() - t0)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 17)
    batches = train_ds.batches(cfg.DATASET.BATCH_SIZE, shuffle=False)
    for _ in range(2):
        tr._train_step(next(batches), StepDraws(generator=gen))
    ckpt.wait_for_saves()
    res = {"raced": hold_checkpoint(f"{tr.arch} async save raced by 2 steps", path, kept)}
    for name in (ckpt.STATE_FILE, ckpt.METADATA_FILE):
        if not filecmp.cmp(path / name, sync / name, shallow=False):
            raise AssertionError(f"{tr.arch} async save: {name} differs from the sync save's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.save(save_dir, "commit", async_save=True)
    ckpt.wait_for_saves()
    commit_ms = 1e3 * (time.perf_counter() - t0)
    epoch_s = {}
    save = tr.save
    for mode in ("async", "sync"):
        if mode == "sync":
            tr.save = lambda *a, async_save=False, **kw: save(*a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.fit(train_ds, epochs=1)
        torch.cuda.synchronize()
        epoch_s[mode] = time.perf_counter() - t0
    tr.save = save
    res.update(same_bytes_as_sync=True, state_mb=(path / ckpt.STATE_FILE).stat().st_size / 2**20,
               sync_save_ms=sync_ms, async_save_ms_on_loop=async_ms, commit_ms=commit_ms,
               epoch_s=epoch_s, epoch_steps=TRAIN_STEPS)
    log(f"checkpoints {tr.arch}", **res)
    return res


def phase_training(arch: str, workdir: Path) -> dict:
    """``Trainer.fit`` for one epoch and ``evaluate`` at full width, batch
    64, bf16, with the launch counts set to 0 just before and read just
    after; then one profiled step, the UNet's tap-GEMM step, and the
    gradient check."""
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.train.trainer import StepDraws, Trainer

    cfg = training_config(workdir)
    batch = cfg.DATASET.BATCH_SIZE
    channels = 4 if arch == "ConvRNN" else 3
    train_ds = walker_windows(cfg, TRAIN_STEPS * batch, SEED + 3, channels)
    val_ds = walker_windows(cfg, batch, SEED + 4, channels)
    tr = Trainer(cfg, arch, device=DEVICE, seed=SEED, run_dir=str(workdir / "run"))
    step, step_ms = tr._train_step, []

    def timed_step(b, draws):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(b, draws)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return loss

    tr._train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # this arch's training path: fit + evaluate
    before = launch_counts()
    hist = tr.fit(train_ds, epochs=1)
    per_step = TRAIN_PER_STEP[arch](cfg)
    train_launches = check_launches(f"{arch} training", before, per_step, TRAIN_STEPS)
    from crowdmod_tpu_torch.train import checkpoint as ckpt

    # fit's best checkpoint, saved asynchronously after the last step.
    fit_ckpt = hold_checkpoint(f"{arch} fit's async 000", Path(cfg.DATA_FS.SAVE_DIR) / ckpt.
                               checkpoint_name(cfg, arch, "000"), train_state(tr))
    before = launch_counts()
    val = tr.evaluate(val_ds)  # one batch: one forward, the fused blocks included
    eval_launches = check_launches(f"{arch} evaluate", before, PER_FORWARD[arch](cfg), 1)
    path = launch_counts()
    losses = hist["train_loss"]
    if not (np.isfinite(losses).all() and np.isfinite(val) and tr.state.step == TRAIN_STEPS):
        raise AssertionError(f"{arch} training: losses {losses}, val {val}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    b = next(train_ds.batches(batch, seed=SEED))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    profile = profile_busy(lambda: (step(b, StepDraws(generator=gen)), torch.cuda.synchronize()),
                           f"profile training step {arch} b64")
    res = dict(arch=arch, batch=batch, dtype=str(tr.compute_dtype), steps=TRAIN_STEPS,
               train_loss=losses, val_loss=val, step_ms=step_ms,
               step_ms_median=statistics.median(step_ms[1:]),
               launches_per_step={k: v // TRAIN_STEPS for k, v in train_launches.items()},
               eval_launches=eval_launches, peak_memory_gb=peak_gb,
               busy_share=profile["busy_share"], device_busy_ms=profile["device_busy_ms"],
               kernel_launches_profiled=profile["kernel_launches"])
    if arch == "DDPM-UNet":
        tap = Trainer(cfg, arch, device=DEVICE, seed=SEED, conv_impl="tapgemm",
                      run_dir=str(workdir / "tap_run")).setup()
        before = launch_counts()  # the tap-GEMM kernel's training step
        loss = tap._train_step(b, StepDraws(generator=gen)).item()
        want = dict(per_step)
        want["conv3d_same_tapgemm"] = want.pop("conv3d_same_im2col")
        tap_launches = check_launches("UNet tap-GEMM training step", before, want, 1)
        if not np.isfinite(loss):
            raise AssertionError(f"tap-GEMM training step loss {loss}")
        res.update(tapgemm_step_loss=loss, tapgemm_step_launches=tap_launches)
        path = {k: path[k] + tap_launches[k] for k in path}
    log(f"training {arch} ATC b{batch}", **res)
    if arch.startswith("DDPM"):  # the FM family's loss runs the same kernels
        res["checkpoints"] = dict(fit_000=fit_ckpt,
                                  **check_async_saves(tr, cfg, train_ds, workdir))
        res["gradients"] = check_gradients(cfg, arch, workdir)
    if arch == "DDPM-UNet":
        res["resblock_gradients"] = check_resblock_gradients(
            torch.Generator(device=DEVICE).manual_seed(SEED + 18))
    res["path_launches"] = path
    return res


# ---------------------------------------------------------------------------
# Phase 10: the main path through the command line, and the metric suite
# ---------------------------------------------------------------------------

CLI_SEED = 42
METRIC_CHUNK = 20  # samples a repeated past (the configs' CHUNK_REPD_PAST_SEQ)
# Sequences a pickle: 16 frames, two 8-frame windows each at stride 8, so
# 1280 windows a file: an epoch of 20 training steps of 64, and one protocol
# batch of BATCH_SIZE × METRIC_CHUNK = 1280.
CLI_SEQS = 640
TWIN_CHUNK = 160  # rows a twin forward takes at once at batch 1280


def write_pickle_workspace(workdir: Path, cfg=None, seqs: int = CLI_SEQS):
    """Three reference-layout ``(N, C, H, W, L)`` macroprop pickles of
    ``seqs`` synthetic walker sequences each at ``cfg``'s grid (by default
    ``configs/serving/ATC.yml``; + N(0, 0.05²) noise, its magnitude on ρ
    and σ²_v), one each for the train, val and test splits, their
    DATA_LIST, and a copy of the config pointing at them, as ``ATC.yml``
    and ``ATC_datafiles.yml`` → (config path, list path, the loaded
    config)."""
    import pickle

    import yaml

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers

    cfg = cfg or load_config("serving/ATC.yml")
    h, w, seq_len = cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, cfg.DATASET.RAW_SEQ_LEN
    pkl = workdir / "pickle"
    pkl.mkdir(parents=True)
    rng, n_seqs, entries = np.random.default_rng(SEED + 9), seqs, []
    for k in range(3):
        native = np.concatenate([synthetic_walkers(n_seqs, h, w, seq_len),
                                 np.zeros((n_seqs, seq_len, h, w, 1), np.float32)], -1)
        noise = rng.normal(0, 0.05, native.shape).astype(np.float32)
        noise[..., (0, 3)] = np.abs(noise[..., (0, 3)])  # ρ, σ²_v ≥ 0
        native += noise
        with open(pkl / f"walkers{k}.pkl", "wb") as f:
            pickle.dump(np.ascontiguousarray(native.transpose(0, 4, 2, 3, 1)), f)
        entries.append([f"walkers{k}.csv", n_seqs])
    cfg = cfg.updated({
        "DATA_FS": {"PICKLE_DIR": str(pkl), "SAVE_DIR": str(workdir / "ckpts"),
                    "OUTPUT_DIR": str(workdir / "out")},
        "DATASET": {"TRAIN_FILE_COUNT": 1, "VAL_FILE_COUNT": 1, "TEST_FILE_COUNT": 1},
        "MODEL": {"DDPM": {"CHECKPOINTS_TO_KEEP": 0}, "FM": {"CHECKPOINTS_TO_KEEP": 0}},
    })
    cfg_path, list_path = workdir / "ATC.yml", workdir / "ATC_datafiles.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    list_path.write_text(yaml.safe_dump({"DATA_LIST": entries}))
    return cfg_path, list_path, load_config(str(cfg_path), str(list_path))


def run_cli(*args, env=None) -> tuple[float, str]:
    """``python -m crowdmod_tpu_torch.cli *args --device DEVICE`` from this
    checkout, ``env`` added to the environment → (wall seconds, its
    standard output); raises on a non-zero exit."""
    import os

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "crowdmod_tpu_torch.cli", *args,
                        "--device", DEVICE], capture_output=True, text=True,
                       cwd=Path(__file__).resolve().parent, timeout=600,
                       env={**os.environ, **(env or {})})
    wall = time.perf_counter() - t0
    if r.returncode:
        raise RuntimeError(f"cli {args[0]} exited {r.returncode}:\n"
                           f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    return wall, r.stdout


def logged(stdout: str, prefix: str) -> str:
    """The rest of the last log line holding ``prefix``."""
    lines = [ln.split(prefix, 1)[1] for ln in stdout.splitlines() if prefix in ln]
    if not lines:
        raise AssertionError(f"no {prefix!r} line in the command's log")
    return lines[-1]


def check_metric_files(out_dir: Path, cfg, arch: str, nsamples: int) -> int:
    """Every CSV of the JAX package's ``HEADERS`` under its name
    (``{metric}_NS{n}_{run_tag}.csv``), with its header, a row a sample (a
    repeated past for the MAX/MIN files) and finite values, and
    ``metrics_files.json`` naming them all; → how many.  The walker data
    leave no frame without density, so no masked PSNR is NaN, on the JAX
    package's side either."""
    from crowdmod_tpu_torch.metrics import generator
    from crowdmod_tpu_torch.train import checkpoint as ckpt

    manifest = json.loads((out_dir / "metrics_files.json").read_text())
    if set(manifest) != {"title", *generator.HEADERS}:
        raise AssertionError(f"{arch} manifest keys {sorted(manifest)}")
    tag, frames = ckpt.run_tag(cfg, arch, "000"), cfg.DATASET.FUTURE_LEN
    for name, fixed in generator.HEADERS.items():
        path = out_dir / f"{name}_NS{nsamples}_{tag}.csv"
        header = fixed or (generator._re_header if "RE_DENSITY" in name
                           else generator._ot_header)(frames, cfg.DATASET.PAST_LEN)
        with open(path) as f:
            got_header = f.readline().strip()
        values = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
        rows = nsamples // (METRIC_CHUNK if name.startswith(("MAX", "MIN")) else 1)
        if (got_header != header or manifest[name] != str(path)
                or values.shape != (rows, len(header.split(",")))
                or not np.isfinite(values).all()):
            raise AssertionError(f"{arch} {path.name}: header {got_header!r}, shape "
                                 f"{values.shape}, all finite {np.isfinite(values).all()}")
    return len(generator.HEADERS)


def _moved_elements(seqs_card, seqs_cpu) -> np.ndarray:
    """Per sequence, the elements whose 2-D or 1-D histogram bin differs
    between the card's and the CPU's magnitude and angle (a value within
    float error of a bin edge: ``log2``, ``atan2`` and ``sqrt`` differ in
    the last bits)."""
    from crowdmod_tpu_torch.metrics import functional as F

    a = [b.cpu() for b in F.motion_bins(*F.motion_volumes(seqs_card))]
    b = list(F.motion_bins(*F.motion_volumes(seqs_cpu)))
    moved = 0
    for bins, valid in ((0, 1), (2, 3)):
        moved = moved + (((a[bins] != b[bins]) & (a[valid] | b[valid]))
                         | (a[valid] != b[valid])).long()
    return moved.flatten(1).sum(1).numpy()


def metric_agreement(card: dict, cpu: dict, pred, gt) -> dict:
    """The card's metric arrays against the CPU's from the same (pred, gt),
    with the tolerances of the CPU parity tests
    (``tests/test_torch_metrics.py``): PSNR 1e-4 relative + 1e-4 dB, SSIM 1e-5
    absolute, TV and RE_DENSITY 1e-4 of the sums they compare, ENERGY and
    MF_MSE 1e-4 relative, the Bhattacharyya numbers 1e-6 absolute + 1e-5
    relative; NaNs in the same places; the MF rows of a sequence with an
    element that moved a histogram bin excepted (counted: at most 1e-3 of
    the elements)."""
    moved = _moved_elements(pred, pred.cpu()) + _moved_elements(gt, gt.cpu())
    if not moved.sum() <= TOL["max_moved_share"] * pred[..., 0].numel():
        raise AssertionError(f"metric suite: {moved.sum()} elements moved bin")
    # |Δ re| for re = |P − G| / (G + eps), P and G sums of ρ: the sums'
    # errors over |G + eps|, times (1 + re).
    p, g, sum_g = (x.double().sum((2, 3)).cpu().numpy()
                   for x in (pred[..., 0].abs(), gt[..., 0].abs(), gt[..., 0]))
    re = (p + g) / np.abs(sum_g + 1e-6) * (1 + cpu["RE_DENSITY"])

    def tv(x):
        x = x.double()
        return (x.diff(dim=2).abs().sum((2, 3)) + x.diff(dim=3).abs().sum((2, 3))).cpu().numpy()

    scales = {"TV_OVER_TIME": (tv(pred) + tv(gt)).reshape(len(p), -1), "RE_DENSITY": re,
              "MIN_RE_DENSITY": re.reshape(-1, METRIC_CHUNK, re.shape[1]).max(1)}
    if set(card) != set(cpu):
        raise AssertionError(f"metric suite: arrays {sorted(card)} vs {sorted(cpu)}")
    worst = {}
    for name, want in cpu.items():
        got = card[name]
        if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)):
            raise AssertionError(f"metric suite {name}: shapes or NaNs differ")
        scale = scales.get(name)
        if name.startswith("MF_"):
            got, want = got[moved == 0], want[moved == 0]
        ok = ~np.isnan(want)
        err = np.abs(got - want)[ok]
        if scale is not None:
            bound = TOL["sum_rel"] * scale[ok]
        elif "PSNR" in name:
            bound = TOL["psnr_db"] + TOL["psnr_rel"] * np.abs(want[ok])
        elif "SSIM" in name:
            bound = np.full_like(err, TOL["ssim"])
        elif name.startswith("MF_BHATT"):
            bound = TOL["bhatt"] + TOL["hist1d_rel"] * np.abs(want[ok])
        else:  # ENERGY, MIN-ENERGY, MF_MSE
            bound = TOL["sum_rel"] * np.abs(want[ok])
        if not (err <= bound).all():
            raise AssertionError(f"metric suite {name}: card vs CPU {err.max()}")
        worst[name] = float(err.max()) if err.size else 0.0
    return dict(moved_elements=int(moved.sum()), moved_sequences=int((moved > 0).sum()),
                max_abs_err=worst)


def metric_suite(cfg, pred, gt) -> dict:
    """The whole suite (``ALL``) on ``pred``/``gt``'s device, nothing
    written."""
    from crowdmod_tpu_torch.metrics.generator import MetricsEngine, compute_metrics

    engine = MetricsEngine(pred, gt, cfg.METRICS, past_len=cfg.DATASET.PAST_LEN)
    return compute_metrics(engine, "ALL", METRIC_CHUNK, eps=cfg.MACROPROPS.EPS,
                           save=False)


def check_forward_batch(cfg, arch: str, ckpt_path: str, past) -> dict:
    """One f32 denoiser forward at the protocol batch with the kernels,
    against the twins on the same inputs (TF32 off; the twins ``TWIN_CHUNK``
    rows at a time: the conv twin's patch matrix of 1280 rows would not fit,
    and every op is per sample, so a chunk's rows come out as in the whole
    batch)."""
    from crowdmod_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = Trainer(cfg, arch, device=DEVICE, compute_dtype=torch.float32, seed=SEED)
    tr.load(ckpt_path)
    n = past.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    x = torch.randn((n, cfg.DATASET.FUTURE_LEN, *past.shape[2:4], 3), generator=gen,
                    device=DEVICE)
    t = torch.randint(0, cfg.MODEL.DDPM.TIMESTEPS, (n,), generator=gen, device=DEVICE)
    before = launch_counts()
    with torch.no_grad():
        out = tr.model(x, t, past)
        launches = check_launches(f"{arch} f32 forward b{n}", before,
                                  PER_FORWARD[arch](cfg), 1)
        with twins_on_the_card():
            twin = torch.cat([tr.model(x[i:i + TWIN_CHUNK], t[i:i + TWIN_CHUNK],
                                       past[i:i + TWIN_CHUNK])
                              for i in range(0, n, TWIN_CHUNK)])
    torch.cuda.synchronize()
    err = (out - twin).abs().max().item()
    if not out.abs().max().item() > 1e-3:
        raise AssertionError(f"{arch} b{n}: the denoiser output is all but zero")
    if not err <= TOL["forward_f32"]:
        raise AssertionError(f"{arch} f32 forward b{n} kernels vs twins: {err}")
    res = dict(arch=arch, batch=n, max_abs_err=err, tolerance=TOL["forward_f32"],
               out_abs_max=out.abs().max().item(), launches=launches)
    log(f"forward {arch} b{n} kernels vs twins (f32)", **res)
    return res


def train_checkpoint(workdir: Path, cfg) -> dict:
    """``train``'s asynchronously saved checkpoint (the DiT's, phase 10)
    against a kept copy of the state of the same ``fit`` in this process
    (same seed and data, the command's TF32 switches), bitwise, and its
    files against that fit's (also saved asynchronously) byte for byte; no
    staged directory or sidecar left."""
    import filecmp

    from crowdmod_tpu_torch.data import ingest
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import Trainer

    name = ckpt.checkpoint_name(cfg, "DDPM-DiT", "000")
    save_dir = Path(cfg.DATA_FS.SAVE_DIR)
    left = [p.name for p in save_dir.iterdir()
            if p.name.endswith((ckpt.STAGE_SUFFIX, ckpt.SIDECAR_SUFFIX))]
    kept_cfg = cfg.updated({"DATA_FS": {"SAVE_DIR": str(workdir / "kept")}})
    train_ds, val_ds = ingest.get_training_dataset(kept_cfg, 3, seed=CLI_SEED, device=DEVICE)
    tr = Trainer(kept_cfg, "DDPM-DiT", device=DEVICE, seed=CLI_SEED,
                 run_dir=str(workdir / "kept_run"))
    t0 = time.perf_counter()
    with command_precision():
        tr.fit(train_ds, val_ds, epochs=1)
    fit_s = time.perf_counter() - t0
    res = hold_checkpoint("train's async checkpoint", save_dir / name, train_state(tr))
    same = [f for f in (ckpt.STATE_FILE, ckpt.METADATA_FILE) if filecmp.cmp(
        save_dir / name / f, workdir / "kept" / name / f, shallow=False)]
    if left or len(same) != 2:
        raise AssertionError(f"train's checkpoint: left {left}, same files {same}")
    res.update(same_files_as_in_process_fit=same, in_process_fit_s=fit_s)
    log("cli DDPM-DiT: train's async checkpoint", **res)
    return res


def phase_cli(workdir: Path) -> dict:
    """Phase 10.  The DiT through ``train`` and ``generate-metrics``, each a
    subprocess whose launches come from the command's log line; the UNet's
    ``generate_metrics`` in this process, its launches held per forward;
    the metric suite of the UNet's samples on the card against the CPU and
    against itself; the batch-1280 f32 forwards against the twins; the
    device busy share of each model's ``generate_metrics``.  → the main
    paths' launch counts."""
    from crowdmod_tpu_torch.data import ingest
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg_path, list_path, cfg = write_pickle_workspace(workdir)
    common = ["--config-yml-file", str(cfg_path), "--configList-yml-file",
              str(list_path), "--seed", str(CLI_SEED)]
    nsamples = cfg.DATASET.BATCH_SIZE * METRIC_CHUNK
    steps = cfg.MODEL.DDPM.ETA_STEPS
    protocol = dict(metric="ALL", chunk=METRIC_CHUNK, batches_to_use=1, seed=CLI_SEED)
    paths = {}

    # The DiT: the user's two commands.
    train_s, train_out = run_cli("train", "--arch", "DDPM-DiT", "--epochs", "1", *common)
    gen_s, gen_out = run_cli(
        "generate-metrics", "--arch", "DDPM-DiT", "--metric", "ALL",
        "--chunk-repd-past-seq", str(METRIC_CHUNK), "--batches-to-use", "1",
        "--output-dir", str(workdir / "metrics_dit"), *common)
    files = check_metric_files(workdir / "metrics_dit", cfg, "DDPM-DiT", nsamples)
    paths["cli DDPM-DiT"] = hold_launches(
        "DiT generate-metrics", json.loads(logged(gen_out, "kernel launches: ")),
        PER_FORWARD["DDPM-DiT"](cfg), steps)
    events = [json.loads(ln) for ln in open(
        Path(cfg.DATA_FS.OUTPUT_DIR) / "runs" / "DDPM-DiT" / "events.jsonl")]
    if not (len(events) == 1 and np.isfinite([events[0]["train_loss"],
                                              events[0]["val_loss"]]).all()):
        raise AssertionError(f"DiT training events {events}")
    log("cli DDPM-DiT: train -> generate-metrics ALL", train_wall_s=train_s,
        generate_metrics_wall_s=gen_s, protocol=logged(gen_out, "metric protocol: "),
        train_windows=logged(train_out, "train windows: "), epoch=events[0],
        csv_files=files, launches=paths["cli DDPM-DiT"])
    train_checkpoint(workdir, cfg)

    # The UNet: Trainer.generate_metrics in this process, seeded random
    # weights (EMA = weights).
    tr = Trainer(cfg, "DDPM-UNet", device=DEVICE, seed=SEED, run_dir=str(workdir / "unet"))
    perturb_(tr.model, SEED + 10)
    tr.ema_model.load_state_dict(tr.model.state_dict())
    test_ds = ingest.get_test_dataset(cfg, tr.mprops_count, seed=CLI_SEED, device=DEVICE)
    select, sample, seen, sampled = tr.select_past, tr.sample, [], []

    def timed_sample(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(*a, **kw)
        torch.cuda.synchronize()
        sampled.append((time.perf_counter() - t0, out))
        return out

    tr.sample = timed_sample
    tr.select_past = lambda *a, **kw: seen.append(select(*a, **kw)) or seen[-1]
    reset_launch_counts()  # the UNet's protocol path
    before = launch_counts()
    t0 = time.perf_counter()
    data = tr.generate_metrics(test_ds, output_dir=str(workdir / "metrics_unet"), **protocol)
    wall = time.perf_counter() - t0
    paths["metrics DDPM-UNet"] = check_launches("UNet generate_metrics", before,
                                                PER_FORWARD["DDPM-UNet"](cfg), steps)
    files = check_metric_files(workdir / "metrics_unet", cfg, "DDPM-UNet", nsamples)
    if len(sampled) != 1 or sampled[0][1].shape[0] != nsamples:
        raise AssertionError(f"UNet protocol: {len(sampled)} sample calls")
    tr.sample, tr.select_past = sample, select

    # The suite on the card (twice, bitwise) and on the CPU, from the same
    # (pred, gt); generate_metrics computed the same arrays on the card.
    pred, gt = sampled[0][1][..., :3], seen[0][1][..., :3]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = metric_suite(cfg, pred, gt)
    suite_s = time.perf_counter() - t0
    again = metric_suite(cfg, pred, gt)
    for name, arr in card.items():
        if not (arr.tobytes() == again[name].tobytes() == data[name].tobytes()):
            raise AssertionError(f"metric suite {name}: a second run on the card gave other bits")
    agree = metric_agreement(card, metric_suite(cfg, pred.cpu(), gt.cpu()), pred, gt)
    log(f"metrics DDPM-UNet: generate_metrics ALL b{nsamples}", generate_metrics_wall_s=wall,
        sampling_s=sampled[0][0], metric_suite_s=suite_s, csv_files=files,
        bitwise_repeat=True, card_vs_cpu=agree, launches=paths["metrics DDPM-UNet"])

    # Each model's generate_metrics under the profiler, then its batch-1280
    # f32 forward against the twins (neither on a counted path).
    unet_ckpt = tr.save(str(workdir / "ckpts"), "000")
    dit_ckpt = str(workdir / "ckpts" / ckpt.checkpoint_name(cfg, "DDPM-DiT", "000"))
    dit = Trainer(cfg, "DDPM-DiT", device=DEVICE, seed=SEED, run_dir=str(workdir / "dit"))
    dit.load(dit_ckpt)
    for arch, trainer in (("DDPM-DiT", dit), ("DDPM-UNet", tr)):
        out_dir = str(workdir / f"profiled_{arch}")
        profile_busy(lambda: (trainer.generate_metrics(test_ds, output_dir=out_dir, **protocol),
                              torch.cuda.synchronize()),
                     f"profile generate_metrics {arch} b{nsamples}")
    past = test_ds.gather(np.arange(nsamples))[0]
    for arch, path in (("DDPM-DiT", dit_ckpt), ("DDPM-UNet", unet_ckpt)):
        check_forward_batch(cfg, arch, path, past)
    return paths


# ---------------------------------------------------------------------------
# Phase 11: flow matching (FM-DiT, FM-UNet) and phase 10's FM commands
# ---------------------------------------------------------------------------

FM_BUCKETS = (1, 64)
FM_P50_REPS = 1  # cut from 3, then 2, to make room for phases 14-15
FM_P50_BUCKETS = (64,)  # cut from (1, 64) to make room for phase 16
FM_HEUN_STEPS = 50  # the Heun request's steps, cut from the configured 500 for phase 16
FM_F32_STEPS = 25      # the f32 Euler chain held against the twins
RF_COUPLING_STEPS = 4  # the teacher's Euler steps in phase 10's reflow
RF_EULER_STEPS = 4     # the RF1 checkpoint's sampler
FM_UNET_METRIC_STEPS = 50  # FM-UNet's protocol: Euler cut from 1000
FM_DIT_METRIC_STEPS = 50  # FM-DiT's generate-metrics: Euler cut from 1000 (then 100) for time
# Phase 11's Euler serving and phase 19's FM requests: cut from the
# configured 1000 (then 250) for time.
FM_SERVE_STEPS = 50


def fm_forwards(cfg, requests: int) -> int:
    """Denoiser forwards of ``requests`` samples with the configured
    integrator (Heun: two a step; CFG is one forward of twice the batch)."""
    node = cfg.MODEL.FM
    steps = getattr(node.INTEGRATOR_STEPS, node.INTEGRATOR.upper())
    return requests * steps * (2 if node.INTEGRATOR == "Heun" else 1)


def serve_buckets(pred, arch: str, f_shape, buckets, label: str, p50_buckets=None) -> dict:
    """A ``BatchingQueue`` over ``pred`` taking three small clients beside
    one request of the largest bucket, then the p50 of each of
    ``p50_buckets`` (default: every bucket) over ``FM_P50_REPS`` requests
    and one profiled request of the largest bucket; every output finite and
    of ``f_shape``."""
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.serving import BatchingQueue

    p, f, h, w, c = pred.input_spec
    big_b = buckets[-1]
    walkers = synthetic_walkers(max(big_b, 8), h, w, p + f)[:, :p]
    if c == 4:  # ConvRNN: a σ²_v channel
        walkers = np.concatenate([walkers, np.full(walkers.shape[:-1] + (1,), 0.05,
                                                   np.float32)], -1)

    queue = BatchingQueue(pred, max_delay_ms=5.0)
    results, errors = [], []
    sizes = [int(n) for n in np.random.default_rng(SEED).integers(1, 9, size=3)]

    def client(n):
        try:
            results.append((n, queue.predict(walkers[:n], timeout=600)))
        except Exception as e:  # re-raised below, after the threads end
            errors.append(e)

    threads = [threading.Thread(target=client, args=(n,)) for n in sizes]
    for t in threads:
        t.start()
    big = queue.predict(walkers[:big_b], timeout=600)
    for t in threads:
        t.join(timeout=900)
    queue.close()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"BatchingQueue clients failed: {errors}")
    results.append((big_b, big))
    for n, out in results:
        if out.shape != (n,) + f_shape or not np.isfinite(out).all():
            raise AssertionError(f"{arch}: bad output {out.shape} for a batch of {n}")
    p50 = {}
    for b in p50_buckets or buckets:
        lat = []
        for _ in range(FM_P50_REPS):
            t0 = time.perf_counter()
            pred.predict(walkers[:b])
            lat.append(1e3 * (time.perf_counter() - t0))
        p50[b] = statistics.median(lat)
    profile = profile_busy(lambda: pred.predict(walkers[:big_b]),
                           f"profile serving {label} b{big_b}")
    return dict(requests=len(results), dispatches=queue.dispatches,
                coalesced=queue.coalesced_requests,
                p50_ms_per_bucket={str(k): v for k, v in p50.items()},
                out_abs_mean=float(np.abs(big).mean()), profile=profile,
                walkers=walkers[:big_b])


def phase_fm_serving(cfg, cfg_path: Path, arch: str, ckpt_path: str, f_shape) -> dict:
    """``load_predictor`` at buckets 1 and 64 and a ``BatchingQueue`` at
    the configured Euler steps, the p50 of ``FM_P50_BUCKETS``, a profiled batch-64 request,
    then one Heun request of ``FM_HEUN_STEPS``; launches held per
    forward."""
    from crowdmod_tpu_torch.serving import Predictor, load_predictor

    per_forward = PER_FORWARD[arch](cfg)
    before = launch_counts()
    pred = load_predictor(str(cfg_path), arch, device=DEVICE, batch_buckets=FM_BUCKETS)
    big_b = FM_BUCKETS[-1]
    served = serve_buckets(pred, arch, f_shape, FM_BUCKETS, f"{arch} Euler", FM_P50_BUCKETS)
    walkers, profile = served["walkers"], served["profile"]
    euler = check_launches(f"{arch} serving Euler", before, per_forward,
                           fm_forwards(cfg, pred.stats.requests))

    heun_cfg = cfg.updated({"MODEL": {"FM": {"INTEGRATOR": "Heun",
                                             "INTEGRATOR_STEPS": {"HEUN": FM_HEUN_STEPS}}}})
    heun = Predictor(heun_cfg, arch, ckpt_path, device=DEVICE, batch_buckets=(big_b,))
    before = launch_counts()
    t0 = time.perf_counter()
    out = heun.predict(walkers)
    heun_s = time.perf_counter() - t0
    heun_launches = check_launches(f"{arch} serving Heun", before, per_forward,
                                   fm_forwards(heun_cfg, 1))
    if out.shape != (big_b,) + f_shape or not np.isfinite(out).all():
        raise AssertionError(f"{arch}: bad Heun output {out.shape}")
    node = cfg.MODEL.FM
    res = dict(arch=arch, integrator=node.INTEGRATOR, steps=node.INTEGRATOR_STEPS.EULER,
               requests=served["requests"], dispatches=served["dispatches"],
               coalesced=served["coalesced"], buckets=FM_BUCKETS,
               predictions=pred.stats.requests,
               p50_ms_per_bucket=served["p50_ms_per_bucket"],
               out_abs_mean=served["out_abs_mean"], launches=euler,
               heun_steps=heun_cfg.MODEL.FM.INTEGRATOR_STEPS.HEUN, heun_s=heun_s,
               heun_launches=heun_launches, busy_share=profile["busy_share"],
               device_busy_ms=profile["device_busy_ms"],
               kernel_launches_profiled=profile["kernel_launches"])
    log(f"serving {arch} Euler-{node.INTEGRATOR_STEPS.EULER}", **res)
    return {**res, "profile": profile}


def phase_fm_end_to_end(cfg, arch: str, ckpt_path: str) -> dict:
    """One f32 batch-64 forward and one free-running Euler chain of
    ``FM_F32_STEPS`` steps from the same x0, with the kernels and with the
    twins, on the card (TF32 off)."""
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.models.flow_matching import euler_sample
    from crowdmod_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, f, h, w = (cfg.DATASET.PAST_LEN, cfg.DATASET.FUTURE_LEN,
                  cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    past = torch.from_numpy(synthetic_walkers(64, h, w, p + f)[:, :p]).to(DEVICE)
    x0 = torch.randn((64, f, h, w, 3), generator=gen, device=DEVICE)
    t = torch.floor(torch.rand((64,), generator=gen, device=DEVICE) * cfg.MODEL.FM.TIME_MAX_POS)

    def run():
        tr = Trainer(cfg, arch, device=DEVICE, compute_dtype=torch.float32)
        tr.load(ckpt_path)
        u = tr._denoise_fn()
        with torch.no_grad():
            fwd = tr.model(x0, t, past)
            x1 = euler_sample(u, past, tuple(x0.shape), steps=FM_F32_STEPS,
                              time_max_pos=cfg.MODEL.FM.TIME_MAX_POS, noise=lambda _: x0)
        torch.cuda.synchronize()
        return fwd, x1

    with twins_on_the_card():
        fwd_t, x1_t = run()
    before = launch_counts()
    fwd_k, x1_k = run()
    launches = check_launches(f"{arch} f32 kernels", before, PER_FORWARD[arch](cfg),
                              1 + FM_F32_STEPS)
    fwd_err = (fwd_k - fwd_t).abs().max().item()
    chain_err = (x1_k - x1_t).abs().max().item()
    if not fwd_k.abs().max().item() > 1e-3:
        raise AssertionError(f"{arch}: the velocity output is all but zero")
    if not (fwd_err <= TOL["forward_f32"] and chain_err <= TOL["chain"]
            and torch.isfinite(x1_k).all()):
        raise AssertionError(f"{arch} f32 kernels vs twins: forward {fwd_err}, "
                             f"{FM_F32_STEPS}-step Euler chain {chain_err}")
    res = dict(arch=arch, forward_max_abs_diff=fwd_err, forward_abs_max=fwd_k.abs().max().item(),
               chain_steps=FM_F32_STEPS, chain_max_abs_diff=chain_err,
               moved=(x1_k - x0).abs().max().item(),
               tolerances=[TOL["forward_f32"], TOL["chain"]], launches=launches)
    log(f"end to end {arch} kernels vs twins (f32)", **res)
    return res


def phase_fm(tmp: Path, cfg) -> dict:
    """Phase 11, each FM model at the serving config's width: serving
    (Euler at ``FM_SERVE_STEPS`` and Heun), the f32 check, then training;
    → each model's path launches (serving, then training)."""
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts

    f_shape = (cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    cfg = cfg.updated({"MODEL": {"FM": {"INTEGRATOR_STEPS": {"EULER": FM_SERVE_STEPS}}}})
    paths = {}
    for arch in ("FM-DiT", "FM-UNet"):
        work = tmp / arch
        work.mkdir()
        cfg_path, ckpt_path = write_checkpoint(cfg, arch, work)
        reset_launch_counts()  # this arch's serving path
        phase_fm_serving(cfg, cfg_path, arch, ckpt_path, f_shape)
        paths[f"serving {arch}"] = launch_counts()
        log("main path launches", arch=arch, **paths[f"serving {arch}"])
        phase_fm_end_to_end(cfg, arch, ckpt_path)
        paths[f"train {arch}"] = phase_training(arch, work / "train")["path_launches"]
    return paths


def phase_cli_fm(workdir: Path) -> dict:
    """Phase 10 for FM: FM-DiT through ``train``, ``generate-metrics``
    (``FM_DIT_METRIC_STEPS`` Euler steps, 1280 samples) and ``reflow`` as
    subprocesses, launches from each command's log line; the ``RF1``
    checkpoint served at Euler ``RF_EULER_STEPS``; FM-UNet's
    ``Trainer.generate_metrics`` in this process at
    ``FM_UNET_METRIC_STEPS`` Euler steps.  → the paths' launch counts."""
    from crowdmod_tpu_torch.data import ingest
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.serving import load_predictor
    from crowdmod_tpu_torch.train.distiller import reflow_tag
    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg_path, list_path, cfg = write_pickle_workspace(workdir)
    arch = "FM-DiT"
    common = ["--config-yml-file", str(cfg_path), "--configList-yml-file",
              str(list_path), "--seed", str(CLI_SEED), "--arch", arch]
    nsamples = cfg.DATASET.BATCH_SIZE * METRIC_CHUNK
    per_forward = PER_FORWARD[arch](cfg)
    batches = CLI_SEQS * 2 // cfg.DATASET.BATCH_SIZE  # train and val batches alike
    paths = {}

    train_s, train_out = run_cli("train", "--epochs", "1", *common)
    # Dropout 0.1: no kernel in a training step; evaluate's forwards run it.
    paths["cli train FM-DiT"] = hold_launches(
        "FM-DiT train", json.loads(logged(train_out, "kernel launches: ")),
        per_forward, batches)
    gm_cfg = cfg.updated({"MODEL": {"FM": {"INTEGRATOR_STEPS": {
        "EULER": FM_DIT_METRIC_STEPS}}}})
    gen_s, gen_out = run_cli(
        "generate-metrics", "--metric", "ALL", "--chunk-repd-past-seq", str(METRIC_CHUNK),
        "--batches-to-use", "1", "--output-dir", str(workdir / "metrics_fm_dit"), *common,
        "--config-yml-file", str(write_config(gm_cfg, workdir / "ATC_metrics.yml")))
    files = check_metric_files(workdir / "metrics_fm_dit", cfg, arch, nsamples)
    paths["cli generate-metrics FM-DiT"] = hold_launches(
        "FM-DiT generate-metrics", json.loads(logged(gen_out, "kernel launches: ")),
        per_forward, fm_forwards(gm_cfg, 1))
    rf_s, rf_out = run_cli("reflow", "--rounds", "1", "--epochs-per-round", "1",
                           "--coupling-steps", str(RF_COUPLING_STEPS), *common)
    # The teacher's coupling forwards and the student's training forwards
    # (no dropout in ReFlow: each runs the kernel, with its gradient).
    paths["cli reflow FM-DiT"] = hold_launches(
        "FM-DiT reflow", json.loads(logged(rf_out, "kernel launches: ")),
        per_forward, batches * (RF_COUPLING_STEPS + 1))
    log("cli FM-DiT: train -> generate-metrics ALL -> reflow", train_wall_s=train_s,
        generate_metrics_wall_s=gen_s, reflow_wall_s=rf_s,
        protocol=logged(gen_out, "metric protocol: "), csv_files=files,
        reflow=logged(rf_out, "reflow complete: "),
        launches={k: v for k, v in paths.items()})

    # The rectified checkpoint through the ordinary serving surface.
    rf_cfg = cfg.updated({"MODEL": {"FM": {"INTEGRATOR_STEPS": {"EULER": RF_EULER_STEPS}}}})
    rf_cfg_path = write_config(rf_cfg, workdir / "ATC_rf.yml")
    test_ds = ingest.get_test_dataset(cfg, 3, seed=CLI_SEED, device=DEVICE)
    past = test_ds.gather(np.arange(64))[0]
    before = launch_counts()
    pred = load_predictor(str(rf_cfg_path), arch, epoch_tag=reflow_tag(1), device=DEVICE,
                          batch_buckets=(64,))
    t0 = time.perf_counter()
    out = pred.predict(past.cpu().numpy())
    rf_ms = 1e3 * (time.perf_counter() - t0)
    paths["RF1 FM-DiT"] = check_launches("RF1 Euler-4", before, per_forward, RF_EULER_STEPS)
    if out.shape != (64, cfg.DATASET.FUTURE_LEN, *past.shape[2:]) or not np.isfinite(out).all():
        raise AssertionError(f"RF1 sampling: {out.shape}")
    log("RF1 FM-DiT Euler-4 b64", latency_ms=rf_ms, out_abs_mean=float(np.abs(out).mean()),
        launches=paths["RF1 FM-DiT"])

    # FM-UNet's protocol in this process, seeded random weights, its Euler
    # steps cut.
    ucfg = cfg.updated({"MODEL": {"FM": {"INTEGRATOR_STEPS": {"EULER": FM_UNET_METRIC_STEPS}}}})
    tr = Trainer(ucfg, "FM-UNet", device=DEVICE, seed=SEED, run_dir=str(workdir / "fm_unet"))
    perturb_(tr.model, SEED + 13)  # no EMA: sampling takes these weights
    reset_launch_counts()  # FM-UNet's protocol path
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = tr.generate_metrics(test_ds, metric="ALL", chunk=METRIC_CHUNK, batches_to_use=1,
                               seed=CLI_SEED, output_dir=str(workdir / "metrics_fm_unet"))
    wall = time.perf_counter() - t0
    paths["metrics FM-UNet"] = check_launches("FM-UNet generate_metrics", before,
                                              PER_FORWARD["FM-UNet"](ucfg),
                                              fm_forwards(ucfg, 1))
    files = check_metric_files(workdir / "metrics_fm_unet", ucfg, "FM-UNet", nsamples)
    log(f"metrics FM-UNet: generate_metrics ALL b{nsamples}", generate_metrics_wall_s=wall,
        euler_steps=FM_UNET_METRIC_STEPS,
        euler_steps_configured=cfg.MODEL.FM.INTEGRATOR_STEPS.EULER, csv_files=files,
        arrays=len(data), launches=paths["metrics FM-UNet"])
    return paths


# ---------------------------------------------------------------------------
# Phase 12: the DDPM fast samplers and progressive distillation
# ---------------------------------------------------------------------------

FAST_SPECS = ("DPM-Solver", "Distilled-eta:1.0:8")  # DPM_STEPS 20 (the default)
FAST_BUCKETS = (1, 64)
DPM_F32_STEPS = 10     # the f32 DPM-Solver chain held against the twins
# `distill` on phase 10's DiT: 8 -> 4 steps, one epoch a phase (cut from the
# command's 64 -> 8 and 8 epochs); the UNet's one phase in process, 4 steps.
DISTILL_START, DISTILL_TARGET = 8, 4


def fast_config(cfg, spec: str):
    """``cfg`` serving the sampler ``spec`` (``utils.sampler_spec``), without
    guidance: both fast samplers refuse it."""
    from crowdmod_tpu_torch.utils.sampler_spec import sampler_overrides

    return cfg.updated({"MODEL": {"DDPM": {**sampler_overrides(spec), "GUIDANCE": "None"}}})


def sampler_forwards(cfg) -> int:
    """Denoiser forwards of one fast-sampler request."""
    node = cfg.MODEL.DDPM
    return node.get("DPM_STEPS", 20) if node.SAMPLER == "DPM-Solver" else node.DISTILL_STEPS


def phase_fast_serving(cfg, workdir: Path, arch: str, spec: str, f_shape) -> dict:
    """``load_predictor`` with the sampler ``spec`` at buckets 1 and 64
    through ``serve_buckets``; launches held per forward × the sampler's
    forwards a request."""
    from crowdmod_tpu_torch.serving import load_predictor

    fcfg = fast_config(cfg, spec)
    cfg_path = write_config(fcfg, workdir / f"ATC_{spec.split('-')[0]}.yml")
    before = launch_counts()
    pred = load_predictor(str(cfg_path), arch, device=DEVICE, batch_buckets=FAST_BUCKETS)
    served = serve_buckets(pred, arch, f_shape, FAST_BUCKETS, f"{arch} {spec}")
    forwards = sampler_forwards(fcfg)
    launches = check_launches(f"{arch} {spec}", before, PER_FORWARD[arch](cfg),
                              forwards * pred.stats.requests)
    profile = served.pop("profile")
    served.pop("walkers")
    res = dict(arch=arch, spec=spec, forwards_per_request=forwards,
               predictions=pred.stats.requests, **served, launches=launches,
               busy_share=profile["busy_share"], device_busy_ms=profile["device_busy_ms"],
               kernel_launches_profiled=profile["kernel_launches"])
    log(f"serving {arch} {spec}", **res)
    return res


def phase_dpm_end_to_end(cfg, arch: str, ckpt_path: str) -> dict:
    """One free-running f32 DPM-Solver chain of ``DPM_F32_STEPS`` steps from
    the same x_T, with the kernels and with the twins, on the card (TF32
    off), every state held as phase 8's."""
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.models.diffusion import dpm_solver_sample
    from crowdmod_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, f, h, w = (cfg.DATASET.PAST_LEN, cfg.DATASET.FUTURE_LEN,
                  cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS)
    past = torch.from_numpy(synthetic_walkers(64, h, w, p + f)[:, :p]).to(DEVICE)
    x_t = torch.randn((64, f, h, w, 3), generator=torch.Generator(device=DEVICE)
                      .manual_seed(SEED + 14), device=DEVICE)
    fcfg = fast_config(cfg, "DPM-Solver")

    def run():
        tr = Trainer(fcfg, arch, device=DEVICE, compute_dtype=torch.float32)
        tr.load(ckpt_path)
        with torch.no_grad():
            chain = dpm_solver_sample(tr._denoise_fn(), tr.sched, past, tuple(x_t.shape),
                                      steps=DPM_F32_STEPS, noise=lambda _: x_t,
                                      history=True)[1]
        torch.cuda.synchronize()
        return chain

    with twins_on_the_card():
        chain_t = run()
    before = launch_counts()
    chain_k = run()
    launches = check_launches(f"{arch} f32 DPM-Solver", before, PER_FORWARD[arch](cfg),
                              DPM_F32_STEPS)
    flips = hold_chain(f"{arch} DPM-Solver", chain_k, chain_t)
    res = dict(arch=arch, steps=DPM_F32_STEPS, chain="free-running",
               chain_max_abs_diff=(chain_k - chain_t).abs().max().item(),
               chain_rho_flips=flips, moved=(chain_k[-1] - x_t).abs().max().item(),
               tolerance=TOL["chain"], launches=launches)
    log(f"end to end {arch} DPM-Solver-{DPM_F32_STEPS} kernels vs twins (f32)", **res)
    return res


def step_timer(draws):
    """``draws`` that also records the card-synchronised time of each
    distillation step's first draw ("k"): the steps' durations are the
    differences."""
    stamps = []

    def timed(kind, shape, n=None):
        if kind == "k":
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        return draws(kind, shape, n)

    return timed, stamps


def phase_unet_distill(cli_dir: Path) -> dict:
    """One UNet ``progressive_distill`` phase in this process (4 steps, one
    epoch of phase 10's training windows, seeded random weights): ms per
    step and launches held per step (two fused teacher forwards, one
    fused student forward)."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data import ingest
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.train.distiller import progressive_distill
    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg = load_config(str(cli_dir / "ATC.yml"), str(cli_dir / "ATC_datafiles.yml"))
    arch = "DDPM-UNet"
    tr = Trainer(cfg, arch, device=DEVICE, seed=SEED, run_dir=str(cli_dir / "unet_distill"))
    tr.setup()
    perturb_(tr.model, SEED + 15)
    tr.ema_model.load_state_dict(tr.model.state_dict())
    train_ds, _ = ingest.get_training_dataset(cfg, 3, seed=CLI_SEED, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)

    def draws(kind, shape, n=None):
        if kind == "k":
            return torch.randint(1, n + 1, shape, generator=gen, device=DEVICE)
        return torch.randn(shape, generator=gen, device=DEVICE)

    timed, stamps = step_timer(draws)
    reset_launch_counts()  # the UNet's distillation path
    t0 = time.perf_counter()
    hist = progressive_distill(tr, train_ds, target_steps=DISTILL_TARGET,
                               start_steps=DISTILL_TARGET, epochs_per_phase=1, draws=timed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(stamps)
    # The student is in eval mode, so its level-0 blocks fuse too (the
    # kernel forward, the twin's VJP backward): three fused forwards a step.
    per_step = {k: 3 * v for k, v in PER_FORWARD[arch](cfg).items()}
    launches = hold_launches("UNet progressive_distill", launch_counts(), per_step, steps)
    if not (steps == len(train_ds) // cfg.DATASET.BATCH_SIZE
            and np.isfinite(hist["loss"][DISTILL_TARGET]).all()):
        raise AssertionError(f"UNet distillation: {steps} steps, history {hist}")
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    res = dict(arch=arch, phase_steps=DISTILL_TARGET, batch=cfg.DATASET.BATCH_SIZE,
               steps=steps, loss=hist["loss"][DISTILL_TARGET], wall_s=wall,
               step_ms_median=statistics.median(step_ms[1:]),
               launches_per_step=per_step, launches=launches)
    log("progressive_distill DDPM-UNet b64", **res)
    return res


def phase_cli_distill(cli_dir: Path) -> dict:
    """``python -m crowdmod_tpu_torch.cli distill`` on phase 10's DDPM-DiT
    checkpoint (``DISTILL_START`` → ``DISTILL_TARGET`` steps, one epoch a
    phase), launches from its log line, then its ``D004`` checkpoint served
    by the Distilled sampler at ``DISTILL_TARGET`` steps."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data import ingest
    from crowdmod_tpu_torch.serving import load_predictor
    from crowdmod_tpu_torch.train.distiller import distilled_tag

    arch = "DDPM-DiT"
    cfg = load_config(str(cli_dir / "ATC.yml"), str(cli_dir / "ATC_datafiles.yml"))
    common = ["--config-yml-file", str(cli_dir / "ATC.yml"), "--configList-yml-file",
              str(cli_dir / "ATC_datafiles.yml"), "--seed", str(CLI_SEED), "--arch", arch]
    wall, out = run_cli("distill", "--start-steps", str(DISTILL_START), "--steps",
                        str(DISTILL_TARGET), "--epochs-per-phase", "1", *common)
    phases = int(np.log2(DISTILL_START // DISTILL_TARGET)) + 1
    batches = CLI_SEQS * 2 // cfg.DATASET.BATCH_SIZE
    # Each step: two teacher forwards and one student forward (eval mode, so
    # the DiT's attention takes the kernel, with its gradient).
    paths = {"cli distill DDPM-DiT": hold_launches(
        "DiT distill", json.loads(logged(out, "kernel launches: ")),
        PER_FORWARD[arch](cfg), 3 * batches * phases)}
    # ms a step: the last phase's steps, between the two last phases' epoch
    # log lines (their timestamps).
    ends = [datetime.datetime.strptime(ln[:23], "%Y-%m-%d %H:%M:%S,%f")
            for ln in out.splitlines() if "-step phase, epoch" in ln]
    step_ms = 1e3 * (ends[-1] - ends[-2]).total_seconds() / batches

    dcfg = cfg.updated({"MODEL": {"DDPM": {"SAMPLER": "Distilled", "GUIDANCE": "None",
                                           "DISTILL_STEPS": DISTILL_TARGET,
                                           "DISTILL_ETA": 1.0}}})
    dcfg_path = write_config(dcfg, cli_dir / "ATC_distilled.yml")
    past = ingest.get_test_dataset(cfg, 3, seed=CLI_SEED, device=DEVICE).gather(
        np.arange(64))[0].cpu().numpy()
    before = launch_counts()
    pred = load_predictor(str(dcfg_path), arch, epoch_tag=distilled_tag(DISTILL_TARGET),
                          device=DEVICE, batch_buckets=(64,))
    pred.predict(past)  # first request: setup
    t0 = time.perf_counter()
    sample = pred.predict(past)
    ms = 1e3 * (time.perf_counter() - t0)
    paths["D004 DDPM-DiT"] = check_launches("D004 Distilled", before, PER_FORWARD[arch](cfg),
                                            2 * DISTILL_TARGET)
    if sample.shape != (64, cfg.DATASET.FUTURE_LEN, *past.shape[2:]) \
            or not np.isfinite(sample).all():
        raise AssertionError(f"D004 sampling: {sample.shape}")
    log(f"cli DDPM-DiT: distill {DISTILL_START} -> {DISTILL_TARGET}", wall_s=wall,
        steps=phases * batches, step_ms_last_phase=step_ms,
        result=logged(out, "distillation complete: "),
        launches=paths["cli distill DDPM-DiT"], d004_latency_ms=ms,
        d004_out_abs_mean=float(np.abs(sample).mean()), d004_launches=paths["D004 DDPM-DiT"])
    return paths


def phase_fast(tmp: Path, cfg) -> dict:
    """Phase 12, each DDPM model at the serving config's width: DPM-Solver
    and Distilled-eta serving, the f32 DPM-Solver chain; then ``distill``
    through the command line on phase 10's DiT and the UNet's distillation
    phase in process.  → the paths' launch counts."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts

    f_shape = (cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    paths = {}
    for arch in ("DDPM-DiT", "DDPM-UNet"):
        work = tmp / f"fast_{arch}"
        work.mkdir()
        cfg_path, ckpt_path = write_checkpoint(cfg, arch, work)
        for spec in FAST_SPECS:
            reset_launch_counts()  # this sampler's serving path
            phase_fast_serving(load_config(str(cfg_path)), work, arch, spec, f_shape)
            paths[f"serving {arch} {spec}"] = launch_counts()
        phase_dpm_end_to_end(cfg, arch, ckpt_path)
    reset_launch_counts()
    paths.update(phase_cli_distill(tmp / "cli"))
    paths["distill DDPM-UNet"] = phase_unet_distill(tmp / "cli")["launches"]
    return paths


# ---------------------------------------------------------------------------
# Phase 13: ConvRNN
# ---------------------------------------------------------------------------

CONVRNN_CHECK_BATCH = 16  # the f32 card-vs-CPU rows


def phase_convrnn_cpu(cfg, ckpt_path: str) -> dict:
    """The f32 forward (teacher-forced) and the free rollout (``sample``) on
    the card against the same weights on the CPU (TF32 off): within 1e-4 and
    1e-3 of max|CPU|."""
    from crowdmod_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = walker_windows(cfg, CONVRNN_CHECK_BATCH, SEED + 17, channels=4)
    past, future = (x.cpu() for x in next(ds.batches(CONVRNN_CHECK_BATCH, shuffle=False)))
    out = {}
    for device in (DEVICE, "cpu"):
        tr = Trainer(cfg, "ConvRNN", device=device, compute_dtype=torch.float32)
        tr.load(ckpt_path)
        with torch.no_grad():
            fwd = tr.model(past.to(device), target=future.to(device), teacher_forcing=True)
        out[device] = (fwd.cpu(), tr.sample(past).cpu())
    res = {}
    for i, (name, tol) in enumerate((("forward", TOL["forward_f32"]), ("rollout", TOL["chain"]))):
        card, cpu = out[DEVICE][i], out["cpu"][i]
        scale = cpu.abs().max().item()
        err = (card - cpu).abs().max().item()
        if not (torch.isfinite(card).all() and scale > 1e-3 and err <= tol * scale):
            raise AssertionError(f"ConvRNN f32 {name} card vs CPU: {err} > {tol} x {scale}")
        res[name] = dict(max_abs_err=err, scale=scale, tolerance=tol)
    log(f"ConvRNN f32 card vs CPU b{CONVRNN_CHECK_BATCH}", **res)
    return res


def phase_convrnn(tmp: Path, cfg) -> dict:
    """Phase 13: ConvRNN (GRU, 4 channels) at the configs' width: phase 9's
    training, serving at buckets 1 and 64, ``train`` then
    ``generate-metrics`` through the command line on phase 10's pickles,
    and the f32 card-vs-CPU check; no kernel of the port launched on any
    of its paths.  → the paths' launch counts."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.serving import load_predictor

    arch = "ConvRNN"
    work = tmp / arch
    work.mkdir()
    paths = {f"train {arch}": phase_training(arch, work / "train")["path_launches"]}

    f_shape = (cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 4)
    cfg_path, ckpt_path = write_checkpoint(cfg, arch, work)
    reset_launch_counts()  # ConvRNN's serving path
    pred = load_predictor(str(cfg_path), arch, device=DEVICE, batch_buckets=FAST_BUCKETS)
    served = serve_buckets(pred, arch, f_shape, FAST_BUCKETS, arch)
    paths[f"serving {arch}"] = hold_launches(f"{arch} serving", launch_counts(), {}, 0)
    profile = served.pop("profile")
    served.pop("walkers")
    log(f"serving {arch}", predictions=pred.stats.requests, **served,
        busy_share=profile["busy_share"], device_busy_ms=profile["device_busy_ms"],
        kernel_launches_profiled=profile["kernel_launches"], launches=paths[f"serving {arch}"])

    cli = tmp / "cli"
    ccfg = load_config(str(cli / "ATC.yml"), str(cli / "ATC_datafiles.yml"))
    common = ["--config-yml-file", str(cli / "ATC.yml"), "--configList-yml-file",
              str(cli / "ATC_datafiles.yml"), "--seed", str(CLI_SEED), "--arch", arch]
    train_s, train_out = run_cli("train", "--epochs", "1", *common)
    gen_s, gen_out = run_cli(
        "generate-metrics", "--metric", "ALL", "--chunk-repd-past-seq", str(METRIC_CHUNK),
        "--batches-to-use", "1", "--output-dir", str(work / "metrics"), *common)
    nsamples = ccfg.DATASET.BATCH_SIZE * METRIC_CHUNK
    files = check_metric_files(work / "metrics", ccfg, arch, nsamples)
    for cmd, out in (("train", train_out), ("generate-metrics", gen_out)):
        paths[f"cli {cmd} {arch}"] = hold_launches(
            f"{arch} {cmd}", json.loads(logged(out, "kernel launches: ")), {}, 0)
    log(f"cli {arch}: train -> generate-metrics ALL", train_wall_s=train_s,
        generate_metrics_wall_s=gen_s, protocol=logged(gen_out, "metric protocol: "),
        train_windows=logged(train_out, "train windows: "),
        mprops=logged(train_out, "loading training data "), csv_files=files)
    phase_convrnn_cpu(cfg, ckpt_path)
    return paths


# ---------------------------------------------------------------------------
# Phase 14: serving's deployment commands
# ---------------------------------------------------------------------------

EXPORT_BUCKETS = (1, 64)
SERVE_BUCKETS = (1, 8, 64)
SERVE_REPS = 3       # sequential HTTP requests a bucket for the p50 (cut from 5)
BURST = 16           # concurrent one-row requests a model (coalescing)
ARTIFACT_REPS = 1    # artifact and Predictor requests a bucket, in turns (cut from 5, then 3, 2)
DEPLOY_SEED = 3
# Exports beside each model's serving sampler and the DiT's T = 1000 chain:
# name → (arch, the sampler's config overrides, bucket).
MASS = {"MODEL": {"DDPM": {"GUIDANCE": "mass_preservation"}}}  # DDIM-eta 25
EXTRA_EXPORTS = {
    "DDPM-DiT DPM-20": ("DDPM-DiT", "DPM-Solver", 64),
    "DDPM-UNet Distilled-eta:1.0:8": ("DDPM-UNet", "Distilled-eta:1.0:8", 64),
    "DDPM-DiT DDIM-eta mass": ("DDPM-DiT", MASS, 1),
}
# Phase 14's export processes and the two commands beside them share the
# host's cores: one intra-op thread each, not a pool each that contend.
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
# Cross-device exports: (name, bucket) of an export above, exported again in
# a process that sees no card (``--device cpu --platform cuda``) and held to
# the artifact exported on the card.
CROSS_EXPORTS = (("DDPM-UNet", 64), ("DDPM-DiT T1000", 64))


def scan_extra_calls() -> int:
    """Body calls beyond one a step that this PyTorch's scan makes: torch
    2.11's ``generic_scan`` runs the body once more on step 0 to learn the
    outputs' shapes; every artifact request's launches count it."""
    from torch._higher_order_ops.scan import scan

    from crowdmod_tpu_torch.ops.kernels import fused_ancestral_update, step_coefficients

    x, c = torch.zeros(4, device=DEVICE), step_coefficients(1.0, 0.0, 0.0, DEVICE)
    before = fused_ancestral_update.launches
    scan(lambda x, xs: (fused_ancestral_update(x, x, x, c), []), x,
         (torch.zeros(3, device=DEVICE),))
    torch.cuda.synchronize()
    return fused_ancestral_update.launches - before - 3


def request_forwards(cfg) -> int:
    """Denoiser forwards of one DDPM request with ``cfg``'s sampler."""
    node = cfg.MODEL.DDPM
    if node.SAMPLER == "DDPM":
        return node.TIMESTEPS
    if node.SAMPLER == "DDIM-eta":
        return node.ETA_STEPS
    return sampler_forwards(cfg)


def per_request(cfg, arch: str, forwards: int) -> dict:
    """Launches of ``forwards`` denoiser forwards of ``arch``."""
    return {k: v * forwards for k, v in PER_FORWARD[arch](cfg).items()}


def add_launches(*counts) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def http(base: str, path: str, payload=None, timeout: float = 600):
    """``(status, parsed JSON or text)`` of a GET or, with ``payload``, a
    POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(base + path, data=data),
                                    timeout=timeout) as r:
            code, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    try:
        return code, json.loads(body)
    except json.JSONDecodeError:
        return code, body


def start_server(*args, wait: bool = True) -> tuple:
    """``python -m crowdmod_tpu_torch.cli serve *args`` on a free port →
    (process, base URL, the /healthz codes seen until it answered 200).
    The codes are polled on a thread from the start; with ``wait=False``
    the third element is instead ``ready()``, which waits for that thread
    and returns them (the server starts while other work runs)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log_file = tempfile.TemporaryFile("w+")  # never a full pipe in front of the server
    proc = subprocess.Popen(
        [sys.executable, "-m", "crowdmod_tpu_torch.cli", "serve", *args, "--port",
         str(port), "--device", DEVICE],
        cwd=Path(__file__).resolve().parent, stdout=log_file,
        stderr=subprocess.STDOUT, text=True)
    proc.log_file = log_file
    base, seen, up = f"http://127.0.0.1:{port}", [], threading.Event()

    def poll():
        deadline = time.perf_counter() + 300
        while time.perf_counter() < deadline and proc.poll() is None:
            try:
                code = http(base, "/healthz", timeout=5)[0]
            except OSError:
                code = None  # not listening yet
            if code is not None and (not seen or seen[-1] != code):
                seen.append(code)
            if code == 200:
                up.set()
                return
            time.sleep(0.05)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()

    def ready() -> list:
        thread.join()
        if not up.is_set():
            proc.kill()
            raise RuntimeError(f"serve never became ready:\n{server_log(proc)[-4000:]}")
        return seen

    return (proc, base, ready) if not wait else (proc, base, ready())


def server_log(proc) -> str:
    proc.wait(timeout=120)
    proc.log_file.seek(0)
    return proc.log_file.read()


def stop_server(proc) -> str:
    """SIGTERM; the server drains and must exit 0 → its output."""
    import signal

    proc.send_signal(signal.SIGTERM)
    out = server_log(proc)
    if proc.returncode != 0:
        raise RuntimeError(f"serve exited {proc.returncode} on SIGTERM:\n{out[-4000:]}")
    return out


def model_metric(text: str, name: str, model: str) -> float:
    label = f'{name}{{model="{model}"}} '
    return float(next(ln for ln in text.splitlines() if ln.startswith(label)).split()[-1])


SERVE_ARCHS = ("DDPM-DiT", "DDPM-UNet")


def launch_serve_command(cfg_path: Path) -> tuple:
    """``serve`` with both DDPM models, started (:func:`start_server`,
    ``wait=False``)."""
    return start_server("--arch", SERVE_ARCHS[0], "--extra-arch", SERVE_ARCHS[1],
                        "--config-yml-file", str(cfg_path), "--batch-buckets",
                        *map(str, SERVE_BUCKETS), wait=False)


def phase_serve_command(cfg, server, walkers, f_shape) -> dict:
    """``serve`` with both DDPM models (``server``: from
    :func:`launch_serve_command`): /healthz 503 then 200; p50 of the HTTP
    latency per bucket; a concurrent burst (coalescing, from /metrics); a
    seeded request twice; SIGTERM → drained, exit 0; the launches from its
    log line held to 25 forwards a predictor call."""
    from concurrent.futures import ThreadPoolExecutor

    archs = SERVE_ARCHS
    proc, base, ready = server
    try:
        seen = ready()
        if seen[0] != 503:
            raise AssertionError(f"/healthz before warmup: {seen} (expected 503 first)")
        res = {"healthz": seen, "p50_ms": {}}
        for arch in archs:
            model, p50 = arch.lower(), {}
            for b in SERVE_BUCKETS:
                lat = []
                for _ in range(SERVE_REPS):
                    t0 = time.perf_counter()
                    code, body = http(base, "/predict", {"past": walkers[:b].tolist(),
                                                         "model": model})
                    lat.append(1e3 * (time.perf_counter() - t0))
                    out = np.asarray(body["future"]) if code == 200 else None
                    if out is None or out.shape != (b,) + f_shape or not np.isfinite(out).all():
                        raise AssertionError(f"serve {arch} b{b}: {code} {str(body)[:300]}")
                p50[str(b)] = statistics.median(lat)
            res["p50_ms"][arch] = p50
            with ThreadPoolExecutor(BURST) as pool:
                codes = list(pool.map(lambda i: http(base, "/predict", {
                    "past": walkers[i:i + 1].tolist(), "model": model})[0], range(BURST)))
            if codes != [200] * BURST:
                raise AssertionError(f"serve {arch} burst: {codes}")
            a, b_ = (http(base, "/predict", {"past": walkers[:2].tolist(), "model": model,
                                             "seed": 7})[1]["future"] for _ in range(2))
            if a != b_:
                raise AssertionError(f"serve {arch}: a seeded request gave two futures")
        metrics = http(base, "/metrics")[1]
    except BaseException:
        proc.kill()
        raise
    out = stop_server(proc)
    steps = cfg.MODEL.DDPM.ETA_STEPS
    calls = {a: int(model_metric(metrics, "crowdmod_requests_total", a.lower())) for a in archs}
    launches = hold_launches("serve DiT + UNet", json.loads(logged(out, "kernel launches: ")),
                             add_launches(*(per_request(cfg, a, steps * calls[a])
                                            for a in archs)), 1)
    res.update(
        predictor_calls=calls, launches=launches,
        dispatches={a: model_metric(metrics, "crowdmod_dispatches_total", a.lower())
                    for a in archs},
        coalesced={a: model_metric(metrics, "crowdmod_coalesced_requests_total", a.lower())
                   for a in archs})
    log("serve command DDPM-DiT + DDPM-UNet", **res)
    return res


def start_exports(workdir: Path, jobs) -> dict:
    """``export`` as one process an artifact, all at once; ``jobs`` are
    (name, arch, config path, bucket[, cross]) →
    {(name, bucket): (process, output path)}.  A ``cross`` job exports the card's program from a
    process that sees no card (``CUDA_VISIBLE_DEVICES`` empty, ``--device
    cpu --platform cuda``), under the name ``"<name> cross"``."""
    import os

    procs = {}
    for name, arch, path, b, *cross in jobs:
        name = f"{name} cross" if cross and cross[0] else name
        out = workdir / "artifacts" / f"{name.replace(' ', '_')}.b{b}.pt2"
        log_file = tempfile.TemporaryFile("w+")
        device = ["--device", "cpu", "--platform", "cuda"] if name.endswith(" cross") \
            else ["--device", DEVICE]
        env = {**os.environ, **ONE_THREAD}
        if name.endswith(" cross"):
            env["CUDA_VISIBLE_DEVICES"] = ""
        proc = subprocess.Popen(
            [sys.executable, "-m", "crowdmod_tpu_torch.cli", "export", "--arch", arch,
             "--config-yml-file", str(path), "--batch", str(b), "--output", str(out),
             *device],
            cwd=Path(__file__).resolve().parent, stdout=log_file,
            stderr=subprocess.STDOUT, text=True, env=env)
        proc.log_file = log_file
        procs[(name, b)] = (proc, out)
    return procs


def finish_exports(procs: dict) -> dict:
    """Wait for :func:`start_exports`' processes → each artifact's path,
    export seconds (from the command's log) and sidecar."""
    artifacts = {}
    for key, (proc, out) in procs.items():
        proc.wait(timeout=900)  # server_log's own wait is 120 s
        stdout = server_log(proc)
        if proc.returncode:
            raise RuntimeError(f"export {key} exited {proc.returncode}:\n{stdout[-4000:]}")
        line = logged(stdout, f"exported {out} in ")
        artifacts[key] = dict(path=out, export_s=float(line.split(" s: ", 1)[0]),
                              meta=json.loads(out.with_name(out.name + ".json").read_text()))
    return artifacts


def crowdmod_nodes(path: Path) -> dict:
    """``crowdmod::`` operator nodes of an exported program, by operator."""
    program = torch.export.load(str(path))
    counts: dict[str, int] = {}
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for n in gm.graph.nodes:
                if n.op == "call_function" and str(n.target).startswith("crowdmod."):
                    key = str(n.target).split(".")[1]
                    counts[key] = counts.get(key, 0) + 1
    return counts


def hold_artifact(label, out, ref) -> dict:
    """An artifact's output against the un-exported ``sampler_fn``'s for the
    same seed: bitwise, else (said so) within the bf16 tolerance."""
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: artifact output is not finite")
    if torch.equal(out, ref):
        return {"bitwise": True, "max_abs_diff": 0.0}
    diff = (out - ref).abs().max().item()
    if not diff <= TOL["bf16"] * ref.abs().max().item():
        raise AssertionError(f"{label}: artifact vs sampler_fn {diff}")
    return {"bitwise": False, "max_abs_diff": diff}


def phase_artifacts(configs: dict, ckpts: dict, artifacts: dict, walkers, extra: int,
                    outputs: dict | None = None) -> dict:
    """Each artifact in this process (``configs``: export name → its
    config): its crowdmod:: nodes, load seconds, one request's launches held
    to (forwards + ``extra``) forwards, its output against the un-exported
    ``sampler_fn`` (same seed; kept in ``outputs`` by (name, bucket)), p50
    per bucket in turns with the ``Predictor`` on the same checkpoint and
    sampler (not the T = 1000 chain), the busy share of a batch-64 request.
    → each artifact's numbers."""
    from crowdmod_tpu_torch.export_artifact import load_sampler, sampler_fn
    from crowdmod_tpu_torch.serving import Predictor
    from crowdmod_tpu_torch.train.trainer import Trainer

    res = {}
    outputs = {} if outputs is None else outputs
    for name, c in configs.items():
        arch = name.split()[0]
        ancestral = c.MODEL.DDPM.SAMPLER == "DDPM"
        steps = request_forwards(c)
        buckets = [b for (n, b) in artifacts if n == name]
        pred = (None if ancestral else
                Predictor(c, arch, ckpts[arch], device=DEVICE, batch_buckets=tuple(buckets)))
        if pred is None:
            trainer = Trainer(c, arch, device=DEVICE)
            trainer.load(ckpts[arch])
        direct = sampler_fn(trainer if pred is None else pred._trainer)
        for b in buckets:
            art = artifacts[(name, b)]
            t0 = time.perf_counter()
            sample, _ = load_sampler(art["path"])
            load_s = time.perf_counter() - t0
            past = torch.from_numpy(walkers[:b]).to(DEVICE)
            before = launch_counts()
            out = sample(past, DEPLOY_SEED)
            torch.cuda.synchronize()
            want = request_launches(c, name, extra)
            launches = check_launches(f"artifact {name} b{b}", before, want, 1)
            outputs[(name, b)] = out
            ref = direct(past, torch.tensor(DEPLOY_SEED))
            torch.cuda.synchronize()
            entry = dict(sampler=c.MODEL.DDPM.SAMPLER, guidance=c.MODEL.DDPM.GUIDANCE,
                         forwards=steps, export_s=art["export_s"], bytes=art["meta"]["bytes"],
                         load_s=load_s, nodes=crowdmod_nodes(art["path"]), launches=launches,
                         **hold_artifact(f"{name} b{b}", out, ref))
            if pred is not None:
                lat_a, lat_p = [], []
                for _ in range(ARTIFACT_REPS):
                    for fn, lat in ((lambda: sample(past, DEPLOY_SEED), lat_a),
                                    (lambda: pred.predict(walkers[:b], seed=DEPLOY_SEED), lat_p)):
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        lat.append(1e3 * (time.perf_counter() - t0))
                entry.update(p50_ms=statistics.median(lat_a),
                             predictor_p50_ms=statistics.median(lat_p))
            if b == 64 and pred is not None:
                entry["profile"] = profile_busy(
                    lambda: (sample(past, DEPLOY_SEED), torch.cuda.synchronize()),
                    f"profile artifact {name} b64")
            res[f"{name} b{b}"] = entry
            log(f"artifact {name} b{b}", **{k: v for k, v in entry.items() if k != "profile"})
    return res


def request_launches(c, name: str, extra: int) -> dict:
    """The launches one request of export ``name`` (config ``c``) makes."""
    arch = name.split()[0]
    steps = request_forwards(c)
    want = per_request(c, arch, steps + extra)
    if arch == "DDPM-DiT" and c.MODEL.DDPM.SAMPLER == "DDPM":
        want["fused_ancestral_update"] = steps + extra
    return want


def phase_cross(configs: dict, artifacts: dict, outputs: dict, walkers, extra: int) -> dict:
    """Each cross-device artifact (the card's program exported by a process
    that saw no card) on the card: its sidecar names ``cuda`` alone, its
    graph holds the ``crowdmod::`` nodes of the artifact exported on the
    card from the same checkpoint, one request launches what that
    artifact's does (held exactly), and its future equals that artifact's
    for the same bucket and seed, bitwise."""
    from crowdmod_tpu_torch.export_artifact import load_sampler

    res = {}
    for name, b in CROSS_EXPORTS:
        card, cross = artifacts[(name, b)], artifacts[(f"{name} cross", b)]
        label = f"cross artifact {name} b{b}"
        nodes, card_nodes = crowdmod_nodes(cross["path"]), crowdmod_nodes(card["path"])
        if cross["meta"]["platforms"] != ["cuda"] or nodes != card_nodes:
            raise AssertionError(f"{label}: platforms {cross['meta']['platforms']}, "
                                 f"nodes {nodes} vs the card's {card_nodes}")
        t0 = time.perf_counter()
        sample, _ = load_sampler(cross["path"])
        load_s = time.perf_counter() - t0
        past = torch.from_numpy(walkers[:b]).to(DEVICE)
        before = launch_counts()
        out = sample(past, DEPLOY_SEED)
        torch.cuda.synchronize()
        launches = check_launches(label, before, request_launches(configs[name], name, extra), 1)
        if not torch.equal(out, outputs[(name, b)]):
            raise AssertionError(f"{label}: differs from the card's export by "
                                 f"{(out - outputs[(name, b)]).abs().max().item()}")
        res[f"{name} b{b}"] = entry = dict(
            bitwise=True, export_s=cross["export_s"], card_export_s=card["export_s"],
            bytes=cross["meta"]["bytes"], card_bytes=card["meta"]["bytes"], load_s=load_s,
            nodes=nodes, launches=launches)
        log(label, **entry)
    return res


def hold_seeded(label, got, want) -> dict:
    """A seeded ``Predictor`` request (the eager sampler) against the
    artifact's future for the same seed: bitwise, else within the bf16
    tolerance with the reason.  Both draw ``normal(seed, step)``; the eager
    DDIM step takes its coefficients as a device tensor, as the scan does,
    so the two run the same arithmetic."""
    if not np.isfinite(got).all():
        raise AssertionError(f"{label}: seeded Predictor output is not finite")
    if np.array_equal(got, want):
        return {"bitwise": True, "max_abs_diff": 0.0}
    diff = float(np.abs(got - want).max())
    if not diff <= TOL["bf16"] * float(np.abs(want).max()):
        raise AssertionError(f"{label}: seeded Predictor vs serve --artifact {diff}")
    return {"bitwise": False, "max_abs_diff": diff,
            "reason": "the eager chain and the exported scan differ in the last bits "
                      "(bf16 compute), and the chain carries the difference"}


def launch_artifact_server(artifacts: dict) -> tuple:
    """``serve --artifact`` with the DiT's two buckets, started
    (:func:`start_server`, ``wait=False``)."""
    paths = [str(artifacts[("DDPM-DiT", b)]["path"]) for b in EXPORT_BUCKETS]
    return start_server("--arch", "DDPM-DiT", "--artifact", *paths, wait=False)


def phase_artifact_server(cfg, ckpt_path: str, server, walkers, f_shape,
                          extra: int) -> dict:
    """``serve --artifact`` (``server``: from :func:`launch_artifact_server`):
    one seeded request of 2 rows (padded to 64), held to the same request
    to a ``Predictor`` of the checkpoint the artifacts came from (the seed
    check), SIGTERM → exit 0, launches from its log."""
    from crowdmod_tpu_torch.serving import Predictor

    proc, base, ready = server
    try:
        seen = ready()
        code, body = http(base, "/predict", {"past": walkers[:2].tolist(), "seed": 5})
        out = np.asarray(body["future"]) if code == 200 else None
        if out is None or out.shape != (2,) + f_shape or not np.isfinite(out).all():
            raise AssertionError(f"serve --artifact: {code} {str(body)[:300]}")
        info = http(base, "/models")[1]
    except BaseException:
        proc.kill()
        raise
    stdout = stop_server(proc)
    calls = len(EXPORT_BUCKETS) + 1  # warmup, then the request
    launches = hold_launches(
        "serve --artifact", json.loads(logged(stdout, "kernel launches: ")),
        per_request(cfg, "DDPM-DiT", (cfg.MODEL.DDPM.ETA_STEPS + extra) * calls), 1)
    pred = Predictor(cfg, "DDPM-DiT", ckpt_path, device=DEVICE, batch_buckets=EXPORT_BUCKETS)
    seed = hold_seeded("seed 5", pred.predict(walkers[:2], seed=5), out.astype(np.float32))
    res = dict(healthz=seen, models=info, launches=launches, seeded_predictor=seed)
    log("serve --artifact DDPM-DiT", **res)
    return res


def phase_import(cfg, workdir: Path, ckpt_path: str, walkers) -> dict:
    """A reference-format ``.pt`` of the DiT checkpoint's sampling (EMA)
    weights through ``import-checkpoint`` (tag 001), then served: its
    future equals the original checkpoint's for the same seed."""
    from crowdmod_tpu_torch.serving import Predictor
    from crowdmod_tpu_torch.train import checkpoint as ckpt

    payload, _ = ckpt.load_checkpoint(ckpt_path)
    ref_pt = workdir / "reference_dit.pt"
    torch.save({"opt": {}, "model": payload["ema_params"]}, ref_pt)
    cfg_path = workdir / "ATC.yml"
    wall, out = run_cli("import-checkpoint", "--arch", "DDPM-DiT", "--config-yml-file",
                        str(cfg_path), "--torch-ckpt", str(ref_pt), "--epoch-label", "001",
                        env=ONE_THREAD)
    imported = out.strip().splitlines()[-1]
    meta = ckpt.read_metadata(imported)
    if meta["source"] != f"torch-import:{ref_pt.resolve()}":
        raise AssertionError(f"import-checkpoint metadata: {meta}")
    past = walkers[:8]
    got = Predictor(cfg, "DDPM-DiT", imported, device=DEVICE, batch_buckets=(8,)).predict(
        past, seed=11)
    want = Predictor(cfg, "DDPM-DiT", ckpt_path, device=DEVICE, batch_buckets=(8,)).predict(
        past, seed=11)
    if not np.array_equal(got, want):
        raise AssertionError(f"imported checkpoint's future differs: "
                             f"{np.abs(got - want).max()}")
    res = dict(wall_s=wall, path=imported, future_equal=True)
    log("import-checkpoint DDPM-DiT", **res)
    return res


def phase_params(proc, t0: float) -> dict:
    """``params --all-archs``, started at ``t0`` as ``proc``
    (:func:`start_cli`): every model's count."""
    out = finish_cli(proc, "params --all-archs")
    wall = time.perf_counter() - t0
    totals = {ln.split(":")[0]: int(ln.split(":")[1].split()[0].replace(",", ""))
              for ln in out.splitlines() if "trainable params" in ln}
    if len(totals) != 5 or not all(totals.values()):
        raise AssertionError(f"params --all-archs: {out[-2000:]}")
    res = dict(wall_s=wall, totals=totals)
    log("params --all-archs", **res)
    return res


def on_card(artifacts: dict) -> dict:
    return {k: a for k, a in artifacts.items() if not k[0].endswith(" cross")}


def deploy_setup(tmp: Path, cfg):
    """Phase 14's checkpoints of both models, the configs of its exports and
    the export jobs, and the walkers whose pasts its requests take."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers

    work = tmp / "deploy"
    work.mkdir()
    ckpts = {}
    for arch in ("DDPM-DiT", "DDPM-UNet"):
        cfg_path, ckpts[arch] = write_checkpoint(cfg, arch, work)
    cfg = load_config(str(cfg_path))
    configs = {"DDPM-DiT": cfg, "DDPM-UNet": cfg,
               "DDPM-DiT T1000": cfg.updated({"MODEL": {"DDPM": {"SAMPLER": "DDPM"}}})}
    jobs = [(arch, arch, cfg_path, b) for arch in ("DDPM-DiT", "DDPM-UNet")
            for b in EXPORT_BUCKETS]
    jobs.append(("DDPM-DiT T1000", "DDPM-DiT", write_config(configs["DDPM-DiT T1000"],
                                                            work / "ancestral.yml"), 64))
    for k, (name, (arch, sampler, b)) in enumerate(EXTRA_EXPORTS.items()):
        configs[name] = (cfg.updated(sampler) if isinstance(sampler, dict)
                         else fast_config(cfg, sampler))
        jobs.append((name, arch, write_config(configs[name], work / f"extra{k}.yml"), b))
    jobs += [(*job, True) for job in jobs if tuple(job[::3]) in CROSS_EXPORTS]
    p, f, h, w = (cfg.DATASET.PAST_LEN, cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS,
                  cfg.MACROPROPS.COLS)
    walkers = synthetic_walkers(64, h, w, p + f)[:, :p]
    return work, cfg, cfg_path, ckpts, configs, jobs, walkers


def phase_cross_device(tmp: Path, cfg) -> dict:
    """``--cross-device``: phase 14's cross-device checks alone: the
    exports :data:`CROSS_EXPORTS` names, on the card and from a process
    that sees no card, each on-card artifact in this process
    (:func:`phase_artifacts`), then :func:`phase_cross`."""
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts

    work, cfg, _, ckpts, configs, jobs, walkers = deploy_setup(tmp, cfg)
    jobs = [job for job in jobs if tuple(job[::3]) in CROSS_EXPORTS]
    extra = scan_extra_calls()
    t0 = time.perf_counter()
    artifacts = finish_exports(start_exports(work, jobs))
    export_wall = time.perf_counter() - t0
    outputs = {}
    phase_artifacts({name: configs[name] for name, _ in CROSS_EXPORTS}, ckpts,
                    on_card(artifacts), walkers, extra, outputs)
    reset_launch_counts()  # the cross-device artifacts' path
    res = phase_cross(configs, artifacts, outputs, walkers, extra)
    log("cross-device exports", wall_s=export_wall, processes=len(artifacts),
        launches=launch_counts())
    return res


def phase_deploy(tmp: Path, cfg) -> dict:
    """Phase 14 → its paths' launch counts (each read from its own run)."""
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts

    work, cfg, cfg_path, ckpts, configs, jobs, walkers = deploy_setup(tmp, cfg)
    f_shape = (cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    extra = scan_extra_calls()
    log("scan", extra_body_calls=extra, torch=torch.__version__)

    # The exports trace on the host; import-checkpoint and params run
    # meanwhile, each a process.  Nothing timed runs until they are done.
    t0 = time.perf_counter()
    procs = start_exports(work, jobs)
    params = start_cli("params", "--all-archs", "--config-yml-file", str(cfg_path),
                       env=ONE_THREAD)
    server = launch_serve_command(cfg_path)  # starts up meanwhile; measured after
    try:
        try:
            phase_import(cfg, work, ckpts["DDPM-DiT"], walkers)
            phase_params(params, t0)
        finally:
            artifacts = finish_exports(procs)
    except BaseException:
        server[0].kill()
        raise
    parts = {"exports, import-checkpoint, params": time.perf_counter() - t0}
    paths = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t0
        return out

    paths["serve command"] = part("serve command", phase_serve_command, cfg, server,
                                  walkers, f_shape)["launches"]
    reset_launch_counts()  # the artifacts' path, in this process
    outputs = {}
    part("artifacts", phase_artifacts, configs, ckpts, on_card(artifacts), walkers, extra,
         outputs)
    paths["artifacts"] = launch_counts()
    server = launch_artifact_server(artifacts)  # starts up during the cross checks
    reset_launch_counts()  # the cross-device artifacts' path
    try:
        part("cross artifacts", phase_cross, configs, artifacts, outputs, walkers, extra)
    except BaseException:
        server[0].kill()
        raise
    paths["cross artifacts"] = launch_counts()
    paths["serve --artifact"] = part("serve --artifact", phase_artifact_server, cfg,
                                     ckpts["DDPM-DiT"], server, walkers, f_shape,
                                     extra)["launches"]
    log("deploy exports", seconds=parts, processes=len(artifacts),
        export_s={f"{n} b{b}": a["export_s"] for (n, b), a in artifacts.items()},
        bytes={f"{n} b{b}": a["meta"]["bytes"] for (n, b), a in artifacts.items()})
    paths = {f"14 {k}": v for k, v in paths.items()}
    log("phase 14 launches", **add_launches(*paths.values()))
    return paths


# ---------------------------------------------------------------------------
# Phase 15: the data path at the size of one hour of one ATC recording day
# ---------------------------------------------------------------------------

ETL_FRAMES = 7200     # one hour at TIME_RES 0.5 s
ETL_WALKERS = 8       # pedestrians a grid row
ETL_SUBSAMPLES = 2    # sensor readings a pedestrian a 500 ms bin


def held_macroprops(label, got, ref) -> dict:
    """Card windows against the CPU's: density exactly, the other channels
    within 1e-5·max|ref|."""
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: {got.shape} vs {ref.shape}, finite "
                             f"{np.isfinite(got).all()}")
    if not np.array_equal(got[..., 0], ref[..., 0]):
        raise AssertionError(f"{label}: density differs at "
                             f"{int((got[..., 0] != ref[..., 0]).sum())} elements")
    diff = float(np.abs(got[..., 1:] - ref[..., 1:]).max(initial=0.0))
    scale = float(np.abs(ref[..., 1:]).max(initial=0.0))
    if not diff <= 1e-5 * scale:
        raise AssertionError(f"{label}: velocity/variance channels differ by {diff}")
    return {"density_equal": True, "max_abs_diff": diff, "bitwise": bool(np.array_equal(got, ref))}


def phase_data(tmp: Path) -> dict:
    """Phase 15: raw trajectories of an hour at the ATC geometry →
    ``python -m crowdmod_tpu_torch.cli etl`` on the card (stage seconds from
    its log) → the same aggregated file binned again on the card (bitwise
    equal) and on the CPU (density equal, the rest within 1e-5·max|ref|) →
    the pickle loaded twice through ``load_pickles`` (the second time from
    its ``.cmb`` sidecar) → one ``Trainer.fit`` epoch of phase 9's length on
    the windows.  → the training run's launch counts."""
    import pickle

    from crowdmod_tpu_torch.data import etl
    from crowdmod_tpu_torch.data.ingest import load_pickles
    from crowdmod_tpu_torch.data.synthetic import synthetic_raw_trajectories, write_atc_raw_csv
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.native import build, native_available
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.train.trainer import Trainer

    work = tmp / "data"
    raw_dir, agg_dir, pkl_dir = work / "raw", work / "agg", work / "pkl"
    raw_dir.mkdir(parents=True)
    base = training_config(work)
    window = base.DATASET.PAST_LEN + base.DATASET.FUTURE_LEN
    cfg = base.updated({"DATASET": {"RAW_SEQ_LEN": window}})  # a pickle row is a window
    m = cfg.MACROPROPS
    t0 = time.perf_counter()
    raw = synthetic_raw_trajectories(
        n_frames=ETL_FRAMES, rows=m.ROWS, cols=m.COLS, lu=list(m.LU), theta=m.THETA,
        dx=m.DX, dy=m.DY, time_res=m.TIME_RES, walkers_per_row=ETL_WALKERS,
        subsamples=ETL_SUBSAMPLES, seed=SEED)
    t1 = time.perf_counter()
    write_atc_raw_csv(raw, str(raw_dir / "ATC_hour.csv"))
    res = dict(raw_rows=len(raw["time"]), generate_s=t1 - t0,
               write_raw_csv_s=time.perf_counter() - t1,
               raw_csv_bytes=(raw_dir / "ATC_hour.csv").stat().st_size)
    cfg_path = write_config(cfg, work / "ATC.yml")
    wall, out = run_cli("etl", "--config-yml-file", str(cfg_path), "--raw-dir", str(raw_dir),
                        "--agg-dir", str(agg_dir), "--pickle-dir", str(pkl_dir),
                        "--data-list-out", str(work / "list.yml"))
    stages = json.loads(logged(out, "etl stages ATC_hour.csv: "))
    res.update(etl_wall_s=wall, aggregate_s=float(logged(out, "aggregate: ").split()[0]),
               **{f"card_{k}": v for k, v in stages.items()})
    pkl = pkl_dir / "ATC_hour.pkl"
    with open(pkl, "rb") as f:
        card = pickle.load(f).transpose(0, 4, 2, 3, 1)  # → (N, T, H, W, 4)
    if card.shape != (stages["windows"], window, m.ROWS, m.COLS, 4) or not card.shape[0]:
        raise AssertionError(f"etl windows {card.shape}, stages {stages}")

    df = etl.read_aggregated_csv(str(agg_dir / "ATC_hour.csv"))
    pre, rlu = etl.preprocess_trajectories(df, cfg)
    filt = etl.filter_by_grid(pre, cfg, rlu)
    span = dict(t_init=pre["time"].min(), t_final=pre["time"].max())
    binned, seconds = {}, {}
    for device in (DEVICE, DEVICE, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = etl.macroprop_frames(filt, cfg, rlu, device=device, **span)
        torch.cuda.synchronize()
        seconds.setdefault(device, []).append(time.perf_counter() - t0)
        binned.setdefault(device, []).append(etl.macroprop_windows(frames, cfg))
    if not np.array_equal(binned[DEVICE][0], binned[DEVICE][1]):
        raise AssertionError("the card's second binning differs from its first")
    if not np.array_equal(binned[DEVICE][0], card):
        raise AssertionError("the card's binning in process differs from the etl command's")
    res.update(aggregated_rows=len(df["time"]), in_grid_rows=len(filt["time"]),
               bin_card_s=seconds[DEVICE], bin_cpu_s=seconds["cpu"][0], card_repeat_bitwise=True,
               card_vs_cpu=held_macroprops("etl card vs CPU", card, binned["cpu"][0]))

    if not native_available():
        raise AssertionError("the native library did not build")
    loads = []
    for _ in range(2):
        t0 = time.perf_counter()
        loads.append(load_pickles([(str(pkl), len(card))], 4, (m.ROWS, m.COLS, window)))
        loads[-1] += (time.perf_counter() - t0, Path(str(pkl) + ".cmb").exists())
    (first, _, first_s, cmb_after_first), (second, _, second_s, _) = loads
    if not (cmb_after_first and np.array_equal(first, second) and np.array_equal(first, card)):
        raise AssertionError(f"load_pickles: sidecar {cmb_after_first}, equal "
                             f"{np.array_equal(first, second)}, {np.array_equal(first, card)}")
    res.update(load_pickle_s=first_s, load_cmb_s=second_s, native_library=build.library_path().name)

    batch = cfg.DATASET.BATCH_SIZE
    ds = WindowDataset(torch.from_numpy(np.ascontiguousarray(first[:TRAIN_STEPS * batch, ..., :3]))
                       .to(DEVICE), past_len=cfg.DATASET.PAST_LEN,
                       future_len=cfg.DATASET.FUTURE_LEN, stride=m.STRIDE)
    tr = Trainer(cfg, "DDPM-UNet", device=DEVICE, seed=SEED, run_dir=str(work / "run"))
    reset_launch_counts()  # the data path's training run
    before = launch_counts()
    t0 = time.perf_counter()
    hist = tr.fit(ds, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = check_launches("fit on the etl windows", before,
                              TRAIN_PER_STEP["DDPM-UNet"](cfg), TRAIN_STEPS)
    losses = hist["train_loss"]
    if not (np.isfinite(losses).all() and tr.state.step == TRAIN_STEPS):
        raise AssertionError(f"fit on the etl windows: losses {losses}, step {tr.state.step}")
    res.update(fit_steps=tr.state.step, fit_s=fit_s, train_loss=losses)
    log("data path ATC hour", **res)
    return {"15 data fit": launches}


# ---------------------------------------------------------------------------
# Phase 16: the parallel paths, a world of one on the card
# ---------------------------------------------------------------------------

STREAM_SEQS = 96  # sequences a stream file: 192 windows, 3 batches of 64
DP_P50_REPS = 2   # batch-64 requests a predictor, each predictor's in a block (cut from 3)
# Why a data-parallel series may part from its plain reference in the last
# bits (held then within 1e-6 relative, the reason printed with the numbers).
DP_REASON = {
    "DDP": "DDP copies the gradients through its buckets and all-reduces them",
    "FSDP": "FSDP all-gathers the parameters into fresh buffers, reduce-scatters "
            "the gradients and steps Adam on DTensor shards",
}
# FSDP's reference is the plain fit with FSDP's autograd graph
# (:func:`fsdp_graph`), which only reorders the sums of the gradients that
# several blocks share: the plain losses move by it within this relative
# bound (4.3e-5 measured), else the graph is not only a reordering.
FSDP_GRAPH_TOL = 1e-4
# A world of W > 1 cards: each process's backward sums over its 64/W rows
# (its weight gradients rounded to bf16 before the sum) and NCCL adds the
# processes' sums in its own order; in bf16 those last-bit differences flip
# roundings in the later steps (the FSDP graph alone, which reorders only the
# time embedding's sums, moves the losses by 4.3e-5).  So the loss series is
# held within "loss" relative, the samples within "sample"·max|ref| and each
# metric cell within "metric" relative ("metric_abs" near 0).  The weights
# and EMA: Adam's first steps are sign-like, so an element whose gradient's
# parts nearly cancel parts by up to 2·lr a step (4 cards: 1.9e-4·max|p| in
# 20 steps); each element is held within 2·lr·steps, and the whole state's
# parting, ‖p_W − p_1‖, within "state_share" of how far training moved it,
# ‖p_1 − p_0‖.  A process training on other rows, or without the
# all-reduce, parts the losses by 1e-2 and more and the state by a share of
# order 1.
WORLD_TOL = {"loss": 1e-3, "state_share": 0.1, "sample": 1e-3, "metric": 1e-3,
             "metric_abs": 1e-5}
WORLD_REASON = ("each process sums its own rows and NCCL adds the sums in "
                "another order")
_FAILURES: list | None = None  # phase 16 collects its failures, then raises


def fail(msg: str) -> None:
    """Raise ``msg``, or, inside :func:`collecting`, keep it for the end."""
    if _FAILURES is None:
        raise AssertionError(msg)
    print(f"[FAILED] {msg}", flush=True)
    _FAILURES.append(msg)


@contextlib.contextmanager
def collecting(label: str):
    """Run every check of a phase before failing: each failure is printed
    as it comes, and the phase raises with all of them at the end."""
    global _FAILURES
    _FAILURES = []
    try:
        yield
    finally:
        failures, _FAILURES = _FAILURES, None
    if failures:
        raise AssertionError(f"{label}: {len(failures)} checks failed: {failures}")


@contextlib.contextmanager
def command_precision():
    """TF32 as a fresh process has it (:data:`PRECISION_DEFAULTS`), restored
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = PRECISION_DEFAULTS
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _UnitInputs(torch.autograd.Function):
    """The identity on a block's inputs, as FSDP2 puts one in front of each
    unit (to run its reduce-scatter when their gradients arrive)."""

    @staticmethod
    def forward(ctx, *xs):
        return xs

    @staticmethod
    def backward(ctx, *gs):
        return gs


def fsdp_graph(model) -> list:
    """Give a plain ``model`` FSDP's autograd graph: the identity of
    :class:`_UnitInputs` on each unit's inputs that require grad.  Tensors
    that several blocks read (the time embedding) then sum their gradients
    in FSDP's order, so the plain run computes FSDP's gradients bit for bit
    (the graph alone moves them in the last bits; FSDP with the root as its
    only unit equals the plain model).  → the hooks' handles."""
    from crowdmod_tpu_torch.parallel.sharding import fsdp_units

    def pre(mod, args):
        live = [a for a in args if torch.is_tensor(a) and a.requires_grad]
        if not live:
            return None
        out = iter(_UnitInputs.apply(*live))
        return tuple(next(out) if torch.is_tensor(a) and a.requires_grad else a for a in args)

    return [unit.register_forward_pre_hook(pre) for unit in fsdp_units(model)]


def start_cli(*args, env=None) -> subprocess.Popen:
    """``python -m crowdmod_tpu_torch.cli *args --device DEVICE`` started from
    this checkout in a session of its own (so that its spawned processes end
    with it), its output in a temporary file (never a full pipe)."""
    import os

    log_file = tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "crowdmod_tpu_torch.cli", *args, "--device", DEVICE],
        cwd=Path(__file__).resolve().parent, stdout=log_file, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, **(env or {})}, start_new_session=True)
    proc.log_file = log_file
    return proc


def finish_cli(proc, label: str, timeout: float = 600) -> str:
    """The output of a :func:`start_cli` process; raises unless it exits 0
    within ``timeout`` s (then it is killed)."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if proc.poll() is None:  # the command and the processes it spawned
            import os
            import signal

            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    proc.log_file.seek(0)
    out = proc.log_file.read()
    if proc.returncode:
        raise RuntimeError(f"{label} exited {proc.returncode}:\n{out[-6000:]}")
    return out


def hold_series(label, got, want, reason: str, scale=None, tol: float = 1e-6,
                quiet: bool = False) -> dict:
    """``got`` against ``want`` (arrays or tensors): bitwise, or else within
    ``tol`` of ``scale`` (default: each element's own magnitude), the reason
    printed beside the numbers (unless ``quiet``); :func:`fail` beyond."""
    g = torch.as_tensor(np.asarray(got, np.float64) if not torch.is_tensor(got) else got)
    w = torch.as_tensor(np.asarray(want, np.float64) if not torch.is_tensor(want) else want)
    g, w = g.double().cpu(), w.double().cpu()
    if g.shape != w.shape:
        fail(f"{label}: shape {tuple(g.shape)} against {tuple(w.shape)}")
        return {"bitwise": False, "max_rel": float("inf"), "reason": "shape"}
    if torch.equal(g, w):
        return {"bitwise": True}
    err = (g - w).abs()
    ref = w.abs() if scale is None else torch.full_like(w, float(scale))
    rel = float((err / ref.clamp_min(1e-30)).max())
    if not rel <= tol:
        fail(f"{label}: relative difference {rel} > {tol}")
    elif not quiet:
        print(f"[{label}] not bitwise, within {tol} (max relative {rel}): {reason}",
              flush=True)
    return {"bitwise": False, "max_rel": rel, "reason": reason}


def hold_state(label, sd, want, reason: str, noise: dict, noise_bound: float) -> dict:
    """Every tensor of state_dict ``sd`` against ``want`` under
    :func:`hold_series` (within 1e-6), scaled by the state's max|p|,
    except the elements ``noise`` marks: there the step-1 gradient is float
    noise (the key bias of attention, whose true gradient is 0), Adam's step
    is sign-like, and two runs whose gradients differ in the last bits part
    by up to ``noise_bound`` (2·lr·steps).  One line for the state."""
    scale = max(float(v.abs().max()) for v in want.values())
    held, noisy = [], 0
    for k, v in want.items():
        got = sd[k].double().cpu()
        mask = noise[k].cpu() if k in noise else torch.zeros(v.shape, dtype=torch.bool)
        diff = (got - v.double().cpu()).abs()
        if mask.any() and not float(diff[mask].max()) <= noise_bound:
            fail(f"{label} {k}: a float-noise element moved past {noise_bound}")
        noisy += int((diff[mask] > 0).sum())
        held.append(hold_series(f"{label} {k}", torch.where(mask, v.double().cpu(), got), v,
                                reason, scale, quiet=True))
    res = {"tensors": len(held), "bitwise": all(h["bitwise"] for h in held),
           "max_rel": max(h.get("max_rel", 0.0) for h in held),
           "float_noise_elements_differing": noisy, "max_p": scale}
    if not res["bitwise"] and res["max_rel"] <= 1e-6:
        print(f"[{label}] not bitwise, within 1e-6·max|p| (max {res['max_rel']}): "
              f"{reason}", flush=True)
    return res


def hold_state_share(label, sd, want, init, bound: float) -> dict:
    """A W-card run's state_dict ``sd`` against the plain run's ``want``
    (both trained from ``init``): every element within ``bound``
    (2·lr·steps), and ‖sd − want‖ within ``WORLD_TOL["state_share"]`` of
    ‖want − init‖ over the whole state."""
    parted = moved = 0.0
    worst = 0.0
    for k, v in want.items():
        w, i = v.double().cpu(), init[k].double().cpu()
        diff = sd[k].double().cpu() - w
        worst = max(worst, float(diff.abs().max()))
        parted += float((diff * diff).sum())
        moved += float(((w - i) ** 2).sum())
    share = (parted / moved) ** 0.5
    if not worst <= bound:
        fail(f"{label}: an element parted by {worst} > {bound} (2·lr·steps)")
    if not share <= WORLD_TOL["state_share"]:
        fail(f"{label}: parted by {share} of the training's movement "
             f"> {WORLD_TOL['state_share']}")
    return {"bitwise": parted == 0.0, "share_of_movement": share, "max_abs": worst,
            "element_bound": bound, "share_tol": WORLD_TOL["state_share"]}


def dp_training(cli_cfg, workdir: Path, world: int) -> dict:
    """(a) DDP through ``--multihost`` with the CROWDMOD_* variables (one
    process a card, ``world`` of them) and (b) FSDP through the command's
    own spawn (one process a card), both ``train --arch DDPM-UNet
    --data-parallel --epochs 1`` on phase 10's pickles at the serving width
    (batch 64, bf16, EMA 0.999), at the same time; then the plain
    ``Trainer.fit`` of the same seed and data in this process, under the
    commands' TF32 switches: DDP's reference as it is, FSDP's with FSDP's
    autograd graph (:func:`fsdp_graph`, which moves the plain losses within
    :data:`FSDP_GRAPH_TOL`).  Each run's per-step losses, its checkpoint in
    a plain ``Trainer`` and its launches a step are held to its reference:
    bitwise or within 1e-6 on one card, within :data:`WORLD_TOL` on more."""
    import socket

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data import ingest
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import Trainer

    list_path = workdir / "ATC_datafiles.yml"
    cfgs = {}
    for name in ("ddp", "fsdp", "plain"):
        (workdir / name).mkdir()
        cfgs[name] = write_config(cli_cfg.updated({
            "DATA_FS": {"SAVE_DIR": str(workdir / name / "ckpts"),
                        "OUTPUT_DIR": str(workdir / name / "out")},
            "MODEL": {"DDPM": {"UNET": {"TRAIN": {"EPOCHS": 1, "EMA_DECAY": 0.999}}}}}),
            workdir / name / "ATC.yml")
    common = ["--arch", "DDPM-UNet", "--epochs", "1", "--seed", str(CLI_SEED),
              "--configList-yml-file", str(list_path), "--data-parallel"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    ddp = [start_cli("train", *common, "--multihost", "--config-yml-file", str(cfgs["ddp"]),
                     env={"CROWDMOD_COORDINATOR": f"127.0.0.1:{port}",
                          "CROWDMOD_NUM_PROCESSES": str(world),
                          "CROWDMOD_PROCESS_ID": str(rank)})
           for rank in range(world)]
    fsdp = start_cli("train", *common, "--fsdp", "--config-yml-file", str(cfgs["fsdp"]))
    # Process 0's output (FSDP's spawned processes share the command's).
    # Once one process of a world failed, the others would wait for it in
    # their next collective: they are ended 30 s later.
    deadline, failed_at = time.monotonic() + 600, None
    while any(p.poll() is None for p in [*ddp, fsdp]) and time.monotonic() < deadline:
        if failed_at is None and any(p.poll() for p in [*ddp, fsdp]):
            failed_at = time.monotonic()
        if failed_at is not None and time.monotonic() - failed_at > 30:
            break
        time.sleep(0.5)
    outs = {"DDP": [finish_cli(p, f"train --data-parallel --multihost (DDP process {k})",
                               timeout=0) for k, p in enumerate(ddp)][0],
            "FSDP": finish_cli(fsdp, "train --data-parallel --fsdp", timeout=0)}
    both_s = time.perf_counter() - t0

    cfg = load_config(str(cfgs["plain"]), str(list_path))
    train_ds, val_ds = ingest.get_training_dataset(cfg, 3, seed=CLI_SEED, device=DEVICE)

    def plain_fit(graph: bool):
        """The plain ``fit`` of the same seed and data (with FSDP's graph
        for FSDP's reference) → (history, params, EMA, step 1's gradients)."""
        tr = Trainer(cfg, "DDPM-UNet", device=DEVICE, seed=CLI_SEED,
                     run_dir=str(workdir / f"plain_run{int(graph)}"))
        if graph:
            fsdp_graph(tr.model)
        step, first_grads = tr._train_step, {}

        def first_step(b, d):  # keeps step 1's gradients: which elements are float noise
            loss = step(b, d)
            if not first_grads:
                first_grads.update({n: p.grad.detach().clone()
                                    for n, p in tr.model.named_parameters()})
            return loss

        tr._train_step = first_step
        init = {k: v.detach().clone() for k, v in tr.params.items()}
        with command_precision():
            hist = tr.fit(train_ds, val_ds, epochs=1)
        return hist, tr.params, tr.ema_params, first_grads, tr.plateau.lr, init

    reset_launch_counts()  # not a path of this phase: the plain references
    refs = {"DDP": plain_fit(False), "FSDP": plain_fit(True)}
    hist, _, _, first_grads, lr, init = refs["DDP"]
    g_max = max(float(g.abs().max()) for g in first_grads.values())
    noise = {n: g.abs() < 1e-6 * g_max for n, g in first_grads.items()}
    noise_bound = 2 * lr * len(hist["step_loss"][0])
    steps, evals = len(hist["step_loss"][0]), len(val_ds) // cfg.DATASET.BATCH_SIZE
    if steps < TRAIN_STEPS:
        raise AssertionError(f"a data-parallel epoch of {steps} steps")
    per_step, per_fwd = TRAIN_PER_STEP["DDPM-UNet"](cfg), PER_FORWARD["DDPM-UNet"](cfg)
    want = {k: per_step.get(k, 0) * steps + per_fwd.get(k, 0) * evals
            for k in set(per_step) | set(per_fwd)}
    plain_losses = np.asarray(hist["step_loss"], np.float64)
    graph_losses = np.asarray(refs["FSDP"][0]["step_loss"], np.float64)
    drift = float(np.max(np.abs(graph_losses - plain_losses) / np.abs(plain_losses)))
    if not drift <= FSDP_GRAPH_TOL:
        fail(f"FSDP's graph moves the plain losses by {drift} > {FSDP_GRAPH_TOL}")
    loss_tol = 1e-6 if world == 1 else WORLD_TOL["loss"]
    res, paths = {"world": world, "concurrent_wall_s": both_s, "steps": steps,
                  "eval_batches": evals, "plain_step_loss": hist["step_loss"][0],
                  "plain_step_ms": hist["step_ms"][0],
                  "fsdp_graph_vs_plain_max_rel": drift,
                  "fsdp_graph_tol": FSDP_GRAPH_TOL, "loss_tol": loss_tol}, {}
    for mode, out in outs.items():
        run = json.loads(logged(out, "train steps: "))
        reason = DP_REASON[mode] + ("" if world == 1 else "; " + WORLD_REASON)
        ref_hist, ref_params, ref_ema = refs[mode][:3]
        paths[f"16 train {mode}"] = hold_launches(
            f"train --data-parallel {mode}", json.loads(logged(out, "kernel launches: ")),
            want, 1)
        name = ckpt.checkpoint_name(cfg, "DDPM-UNet", "000")
        back = Trainer(cfg, "DDPM-UNet", device=DEVICE, seed=SEED)
        back.load(str(workdir / mode.lower() / "ckpts" / name))
        step_ms = [ms for epoch in run["step_ms"] for ms in epoch]
        if world == 1:
            states = {key: hold_state(f"{mode} checkpoint {key}", got, ref, reason, noise,
                                      noise_bound)
                      for key, got, ref in (("params", back.params, ref_params),
                                            ("EMA", back.ema_params, ref_ema))}
        else:
            states = {key: hold_state_share(f"{mode} checkpoint {key}", got, ref, init,
                                            noise_bound)
                      for key, got, ref in (("params", back.params, ref_params),
                                            ("EMA", back.ema_params, ref_ema))}
        res[mode] = dict(
            group=logged(out, "data parallel: "),
            losses=hold_series(f"{mode} step losses", run["step_loss"], ref_hist["step_loss"],
                               reason, tol=loss_tol),
            params=states["params"], ema=states["EMA"],
            step_ms_median=statistics.median(step_ms[1:]), step_ms=step_ms,
            peak_memory_gb=run["peak_memory_gb"],
            launches_per_step={k: per_step.get(k, 0) for k in paths[f"16 train {mode}"]})
    log(f"parallel training DDPM-UNet b64 (DDP --multihost, FSDP spawn; world of {world})",
        **res)
    return paths


def csv_cells_close(got: Path, want: Path, rtol: float, atol: float) -> float:
    """Two metric CSVs cell by cell: text cells equal, numeric cells within
    ``rtol`` of the reference (``atol`` near 0) → the largest relative
    difference; :func:`fail` beyond."""
    import csv

    g_rows, w_rows = (list(csv.reader(open(x))) for x in (got, want))
    if [len(r) for r in g_rows] != [len(r) for r in w_rows]:
        fail(f"{got.name}: {len(g_rows)} rows against {len(w_rows)}")
        return float("inf")
    worst = 0.0
    for g_row, w_row in zip(g_rows, w_rows):
        for g, w in zip(g_row, w_row):
            try:
                gv, wv = float(g), float(w)
            except ValueError:
                if g != w:
                    fail(f"{got.name}: cell {g!r} against {w!r}")
                continue
            err = abs(gv - wv)
            if err > atol:
                worst = max(worst, err / max(abs(wv), 1e-30))
            if not (err <= atol + rtol * abs(wv) or (np.isnan(gv) and np.isnan(wv))):
                fail(f"{got.name}: {gv!r} against {wv!r}")
    return worst


def dp_metrics(workdir: Path, world: int) -> dict:
    """(c) ``generate-metrics --data-parallel`` (one process a card) on
    phase 10's DDPM-DiT checkpoint with phase 10's arguments: every CSV
    bitwise equal to phase 10's (on more cards, each cell within
    :data:`WORLD_TOL` unless bitwise); its launches from the command's log
    line."""
    from crowdmod_tpu_torch.config import load_config

    cfg = load_config(str(workdir / "ATC.yml"), str(workdir / "ATC_datafiles.yml"))
    out_dir = workdir / "metrics_dit_dp"
    wall, out = run_cli(
        "generate-metrics", "--arch", "DDPM-DiT", "--metric", "ALL",
        "--chunk-repd-past-seq", str(METRIC_CHUNK), "--batches-to-use", "1",
        "--output-dir", str(out_dir), "--config-yml-file", str(workdir / "ATC.yml"),
        "--configList-yml-file", str(workdir / "ATC_datafiles.yml"), "--seed", str(CLI_SEED),
        "--data-parallel")
    want = sorted((workdir / "metrics_dit").glob("*.csv"))
    got = sorted(out_dir.glob("*.csv"))
    if [p.name for p in got] != [p.name for p in want] or not want:
        raise AssertionError(f"generate-metrics --data-parallel files {[p.name for p in got]}")
    differ = {p.name: q for p, q in zip(got, want) if p.read_bytes() != q.read_bytes()}
    if differ and world == 1:
        fail(f"generate-metrics --data-parallel CSVs differ from phase 10's: {sorted(differ)}")
    worst = {p.name: csv_cells_close(p, differ[p.name], WORLD_TOL["metric"],
                                     WORLD_TOL["metric_abs"])
             for p in got if p.name in differ and world > 1}
    launches = hold_launches("generate-metrics --data-parallel",
                             json.loads(logged(out, "kernel launches: ")),
                             PER_FORWARD["DDPM-DiT"](cfg), cfg.MODEL.DDPM.ETA_STEPS)
    log("parallel generate-metrics DDPM-DiT --data-parallel", world=world, wall_s=wall,
        csv_files=len(got), bitwise_vs_phase_10=not differ,
        csv_files_not_bitwise=len(differ), max_rel_per_file=worst,
        group=logged(out, "batch-parallel sampling: "),
        protocol=logged(out, "metric protocol: "), launches=launches)
    return {"16 metrics DDPM-DiT": launches}


def dp_serving(workdir: Path, world: int) -> dict:
    """(d) The data-parallel predictor with phase 10's DDPM-DiT checkpoint:
    ``load_predictor(data_parallel=True)`` (one replica a card) on more
    cards, two replicas on the one card (``Predictor(mesh=[cuda:0] * 2)``)
    on one, so that the bucket's split, the shared draws and the gather run.
    A seeded bucket-8 request held bitwise to each replica's rows sampled
    plainly with their slice of the bucket's draws, and against the plain
    predictor's; the p50 of batch 64 beside the plain one's; launches held
    per forward of each replica, counted over the data-parallel requests
    alone."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.ops.kernels.library import seeded_noise
    from crowdmod_tpu_torch.serving import Predictor, load_predictor
    from crowdmod_tpu_torch.train import checkpoint as ckpt

    cfg = load_config(str(workdir / "ATC.yml"))
    kw = dict(datafiles_yml=str(workdir / "ATC_datafiles.yml"), device=DEVICE,
              batch_buckets=(8, 64))
    plain = load_predictor(str(workdir / "ATC.yml"), "DDPM-DiT", **kw)
    if world > 1:
        dp = load_predictor(str(workdir / "ATC.yml"), "DDPM-DiT", data_parallel=True, **kw)
    else:
        path = Path(cfg.DATA_FS.SAVE_DIR) / ckpt.checkpoint_name(cfg, "DDPM-DiT", "000")
        dp = Predictor(cfg, "DDPM-DiT", str(path), mesh=[torch.device(DEVICE, 0)] * 2,
                       batch_buckets=(8, 64))
    replicas = len(dp._replicas)
    if replicas < 2 or dp._pool is None:
        raise AssertionError(f"a data-parallel predictor of {replicas} replica(s)")
    p, f, h, w, c = dp.input_spec
    past = synthetic_walkers(64, h, w, p + f)[:, :p]
    dp.predict(past)  # each replica's first request (its buffers)
    lat = {"plain": [], "data_parallel": []}
    reset_launch_counts()  # the data-parallel predictor's own requests
    seeded = dp.predict(past[:8], seed=DEPLOY_SEED)
    for _ in range(DP_P50_REPS):
        t0 = time.perf_counter()
        dp.predict(past)
        lat["data_parallel"].append(1e3 * (time.perf_counter() - t0))
    launches = hold_launches("data-parallel serving", launch_counts(),
                             PER_FORWARD["DDPM-DiT"](cfg),
                             replicas * (1 + DP_P50_REPS) * cfg.MODEL.DDPM.ETA_STEPS)

    want = plain.predict(past[:8], seed=DEPLOY_SEED)
    for _ in range(DP_P50_REPS):
        t0 = time.perf_counter()
        plain.predict(past)
        lat["plain"].append(1e3 * (time.perf_counter() - t0))
    rows, parts = 8 // replicas, []
    draws = seeded_noise(DEPLOY_SEED, (8, f, h, w, c), plain.device)
    for k in range(replicas):  # each replica's rows, sampled plainly
        part = slice(k * rows, (k + 1) * rows)
        parts.append(plain._trainer.sample(past[part], noise=lambda t, part=part: draws(t)[part])
                     .cpu().numpy())
    rows_bitwise = np.array_equal(seeded, np.concatenate(parts))
    if not rows_bitwise:
        fail("a seeded data-parallel request differs from its replicas' rows sampled plainly")
    vs_plain = hold_series("seeded data-parallel b8 against the plain predictor", seeded, want,
                           f"each replica samples {rows} rows where the plain predictor "
                           "samples 8", scale=float(np.abs(want).max()),
                           tol=WORLD_TOL["sample"])
    log("parallel serving DDPM-DiT data-parallel predictor", world=world, replicas=replicas,
        devices=[str(t.device) for t in dp._replicas], buckets=dp.batch_buckets,
        seeded_b8_vs_replica_rows_bitwise=rows_bitwise, seeded_b8_vs_plain=vs_plain,
        p50_ms_b64={k: statistics.median(v) for k, v in lat.items()}, latency_ms=lat,
        launches=launches)
    return {"16 serving DDPM-DiT": launches}


def build_parser():
    """``generate-samples``' flags and ``--samples-out``: this script is the
    command module that :func:`dp_samples` gives ``launch.run_ranks`` (each
    rank runs :func:`run_rank`)."""
    from crowdmod_tpu_torch.cli import generate_samples

    p = generate_samples.build_parser()
    p.add_argument("--samples-out", required=True)
    return p


def run_rank(args, device) -> int:
    """One rank of ``generate-samples --data-parallel``'s device half
    (:func:`~crowdmod_tpu_torch.cli.generate_samples.sample_sequences`, the
    command's own): rank r saves its launches, and rank 0 the gathered
    samples and their L1 norm, to ``--samples-out``.r (the card's machine
    may have no matplotlib, so the command's drawing half is not run)."""
    from crowdmod_tpu_torch.cli import generate_samples
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.parallel import multiprocess

    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    out = generate_samples.sample_sequences(cfg, args, device)
    rank = multiprocess.process_index()
    torch.save({"pred": out["pred"].cpu() if rank == 0 else None, "l1": out["l1"],
                "launches": out["launches"]}, f"{args.samples_out}.{rank}")
    return 0


def dp_samples(workdir: Path, world: int) -> dict:
    """(f) ``generate-samples --data-parallel``'s sampling (one process a
    card, the command's ``sample_sequences`` through ``launch.run_ranks``)
    on phase 10's DDPM-DiT checkpoint, its samples bitwise equal to the same
    sampling on one card in this process (on more cards within
    :data:`WORLD_TOL`), its launches each rank's (per forward × the
    sampler's steps)."""
    from crowdmod_tpu_torch.cli import generate_samples
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.parallel import launch

    argv = [*sample_args(workdir, "DDPM-DiT"), "--device", DEVICE]
    cfg = load_config(str(workdir / "ATC.yml"), str(workdir / "ATC_datafiles.yml"))
    reset_launch_counts()
    plain = generate_samples.sample_sequences(
        cfg, generate_samples.build_parser().parse_args(argv), DEVICE)
    plain_launches = launch_counts()
    out = workdir / "dp_samples.pt"
    t0 = time.perf_counter()
    code = launch.run_ranks("chip_smoke", [*argv, "--data-parallel", "--samples-out",
                                           str(out)], DEVICE, False)
    wall = time.perf_counter() - t0
    if code:
        raise RuntimeError(f"generate-samples --data-parallel sampling exited {code}")
    ranks = [torch.load(f"{out}.{r}", weights_only=True) for r in range(world)]
    steps = cfg.MODEL.DDPM.ETA_STEPS
    per_forward = PER_FORWARD["DDPM-DiT"](cfg)
    for r, got in enumerate(ranks):
        hold_launches(f"generate-samples --data-parallel rank {r}", got["launches"],
                      per_forward, steps)
    launches = {k: sum(got["launches"][k] for got in ranks) for k in plain_launches}
    hold_launches("generate-samples one card", plain_launches, per_forward, steps)
    pred = ranks[0]["pred"]
    if world == 1:
        vs_one = {"bitwise": torch.equal(pred, plain["pred"].cpu())}
        if not vs_one["bitwise"]:
            fail("generate-samples --data-parallel samples differ from one card's")
    else:
        vs_one = hold_series("generate-samples --data-parallel against one card", pred,
                             plain["pred"], f"each card samples {pred.shape[0] // world} of "
                             f"the {pred.shape[0]} rows", scale=float(pred.abs().max()),
                             tol=WORLD_TOL["sample"])
    log("parallel generate-samples DDPM-DiT --data-parallel", world=world, wall_s=wall,
        samples=list(pred.shape), l1=ranks[0]["l1"], l1_one_card=plain["l1"],
        vs_one_card=vs_one, launches=launches)
    return {"16 generate-samples DDPM-DiT": launches,
            "16 generate-samples DDPM-DiT one card": plain_launches}


def dp_stream(workdir: Path, cli_cfg) -> dict:
    """(e) ``FileWindowStream`` over phase 10's three pickles through
    ``device_prefetch`` onto the card: every batch bitwise equal to each
    file's resident ``WindowDataset`` batch, in order; then one UNet
    ``Trainer.fit`` epoch of ``TRAIN_STEPS`` fed from a stream of two small
    files (launches held a step) against the same steps from a resident
    dataset, and the busy share of one profiled streamed step."""
    import pickle

    from crowdmod_tpu_torch.data.ingest import load_pickle_native
    from crowdmod_tpu_torch.data.prefetch import FileWindowStream
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.train.trainer import StepDraws, Trainer

    c = cli_cfg
    batch, stride = c.DATASET.BATCH_SIZE, c.MACROPROPS.STRIDE
    win = dict(past_len=c.DATASET.PAST_LEN, future_len=c.DATASET.FUTURE_LEN, stride=stride)
    files = sorted(str(x) for x in (workdir / "pickle").glob("walkers*.pkl"))
    t0 = time.perf_counter()
    got = list(FileWindowStream(files, mprops_count=3, device=DEVICE, **win)
               .batches(batch, seed=SEED))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    n = 0
    for k, path in enumerate(files):
        ds = WindowDataset(torch.from_numpy(load_pickle_native(path, 3)).to(DEVICE), **win)
        for past, future in ds.batches(batch, seed=SEED + k):
            gp, gf = got[n]
            if not (gp.device.type == torch.device(DEVICE).type and torch.equal(gp, past)
                    and torch.equal(gf, future)):
                raise AssertionError(f"streamed batch {n} differs from file {k}'s resident batch")
            n += 1
    if n != len(got):
        raise AssertionError(f"the stream gave {len(got)} batches, the files {n}")

    small = workdir / "stream"
    small.mkdir()
    h, w, seq_len = c.MACROPROPS.ROWS, c.MACROPROPS.COLS, c.DATASET.RAW_SEQ_LEN
    rng, natives, paths = np.random.default_rng(SEED + 16), [], []
    for k in range(TRAIN_STEPS // 3):
        native = synthetic_walkers(STREAM_SEQS, h, w, seq_len)
        native = native + np.abs(rng.normal(0, 0.05, native.shape)).astype(np.float32)
        natives.append(native)
        paths.append(small / f"stream{k}.pkl")
        with open(paths[-1], "wb") as fh:
            pickle.dump(np.ascontiguousarray(native.transpose(0, 4, 2, 3, 1)), fh)
    cfg = c.updated({"DATA_FS": {"SAVE_DIR": str(small / "ckpts")},
                     "MODEL": {"DDPM": {"CHECKPOINTS_TO_KEEP": 0}}})
    stream = FileWindowStream([str(x) for x in paths], mprops_count=3, device=DEVICE, **win)
    resident = WindowDataset(torch.from_numpy(np.concatenate(natives)).to(DEVICE), **win)
    res, paths_out = {"stream_batches_checked": n, "stream_epoch_s": stream_s}, {}
    for name, data in (("streamed", stream), ("resident", resident)):
        tr = Trainer(cfg, "DDPM-UNet", device=DEVICE, seed=SEED, run_dir=str(small / name))
        reset_launch_counts()  # the streamed fit is this phase's path; resident its yardstick
        before = launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hist = tr.fit(data, epochs=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        launches = check_launches(f"{name} fit", before, TRAIN_PER_STEP["DDPM-UNet"](cfg),
                                  TRAIN_STEPS)
        if not (tr.state.step == TRAIN_STEPS and np.isfinite(hist["train_loss"]).all()):
            raise AssertionError(f"{name} fit: {tr.state.step} steps, {hist['train_loss']}")
        step_ms = hist["step_ms"][0]
        res[name] = dict(fit_s=fit_s, ms_per_step_fit=1e3 * fit_s / TRAIN_STEPS,
                         step_ms_median=statistics.median(step_ms[1:]), step_ms=step_ms,
                         train_loss=hist["train_loss"])
        if name == "streamed":
            paths_out["16 stream fit"] = launches
            it = iter(stream.batches(batch, seed=SEED + 1))
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            res["profile"] = profile_busy(
                lambda: (tr._train_step(next(it), StepDraws(generator=gen)),
                         torch.cuda.synchronize()),
                "profile streamed training step DDPM-UNet b64")
            it.close()
    log("parallel stream FileWindowStream -> device_prefetch -> fit", **res)
    return paths_out


# Tensor parallelism on one card: each rank of a model group of TP_SIZES[k]
# as a thread (``LocalGroup``: NCCL refuses two ranks on one card), each
# sharded module kind of the serving width at TP_BATCH rows held against
# the unsharded module: f32 within TP_TOL["f32"]·max|ref| (or bitwise),
# bf16 within TP_TOL["bf16"]·max|ref|; launches held to N × the
# unsharded module's.  "" is the whole model (f32 within forward_f32:
# many layers' reduction orders in a row).  The ConvRNN's convs are
# cuDNN's, whose algorithm for O/N output channels sums each output's
# 9·C_in terms in another order: f32 within TP_TOL["f32_cudnn"] (measured
# up to 1.37e-6·max|ref| through a GRU cell and the 5-frame encoder, PR 13
# call 6).
TP_SIZES = (2, 4)
TP_BATCH = 64
TP_TOL = {"f32": 1e-6, "f32_cudnn": 1e-5, "bf16": 2e-2}
TP_KINDS = {
    "DDPM-DiT": ("dif_time_embeddings", "patch_embed", "blocks.0.spatial_attn",
                 "blocks.0.temporal_attn", "blocks.0.mlp", "blocks.0", "final_layer", ""),
    "DDPM-UNet": ("time_embeddings", "encoder_blocks.0", "encoder_blocks.0.conv_1",
                  "encoder_blocks.1", "encoder_blocks.2", "encoder_blocks.4",
                  "encoder_blocks.4.attention", "decoder_blocks.2", ""),
    # The per-frame DiT2D: one attention a block over the frame's tokens.
    "FM-DiT": ("time_embeddings", "patch_embed", "blocks.0.attn", "blocks.0.mlp",
               "blocks.0", "final_layer", ""),
    # Library convs only (no kernel of the port): GRU cells, whose fused
    # gate conv leaves each rank of 2 or 4 no part of one gate, an up conv
    # (cut on torch dim 1), the encoder and the rollout.
    "ConvRNN": ("encoder.encoder_cell_list.1", "encoder", "forecaster_cell_list.0",
                "forecaster_cell_list.1", ""),
}
# A kind whose module the forward calls through its parent's fused kernel
# takes its parent's input.
TP_INPUT_OF = {"encoder_blocks.0.conv_1": "encoder_blocks.0"}


class LocalGroup:
    """``size`` ranks of a model group as threads of this process
    (:meth:`run`), exchanging tensors by reference: the group a
    ``ModelShard`` gathers over when there is no process group (NCCL
    refuses two ranks on one card).  One rank runs at a time (a turn passes
    at each gather), so the ranks' work reaches the card in a fixed order
    and the kernels' launch counts stay exact.  Forward only: the autograd
    engine runs a device's backwards on one thread, where the ranks would
    wait for each other."""

    def __init__(self, size: int):
        self.size = size
        self._barrier = threading.Barrier(size)
        self._turn = threading.Lock()
        self._slots: list = [None] * size

    def _wait(self) -> None:
        self._turn.release()
        try:
            self._barrier.wait()
        finally:
            self._turn.acquire()

    def all_gather(self, x: torch.Tensor, rank: int) -> list:
        self._slots[rank] = x
        self._wait()
        parts = list(self._slots)
        self._wait()
        return parts

    def run(self, fn) -> list:
        """``fn(rank)`` on every rank, each on its own thread → the results
        by rank; the first failure re-raised."""
        out: list = [None] * self.size
        errors: list = []

        def body(rank):
            try:
                with self._turn:
                    out[rank] = fn(rank)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def _tensors(out) -> list:
    """The tensors of a module's output, nested tuples and lists flattened
    in order (None skipped)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in (out or ()) for t in _tensors(o)]


def tp_shards(cfg) -> dict:
    """Phase 16 (a): for N in :data:`TP_SIZES`, each model of the serving
    config (DDPM-DiT, DDPM-UNet, FM-DiT, ConvRNN; seeded, perturbed
    weights) in f32 and bf16 cut over N ranks
    (``sharding.cut_model``), every kind of :data:`TP_KINDS` run by the N
    ranks on the card on the inputs the unsharded forward gives it; each
    rank's output (its slices joined by the gather rule inside the module)
    held against the unsharded module's.  The conv kernel runs on O/N output
    channels, attention on H/N heads (one head a rank at N = 4), GroupNorm
    and the fused resblock on gathered activations and weights.  → the
    launch counts of the check (a path)."""
    import copy

    from crowdmod_tpu_torch.models import factory
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.parallel import sharding, tensor

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    f, h, w = cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS
    future = torch.randn(TP_BATCH, f, h, w, 3, generator=gen).to(DEVICE)
    past = torch.randn(TP_BATCH, cfg.DATASET.PAST_LEN, h, w, 4, generator=gen).to(DEVICE)
    t = torch.randint(0, cfg.MODEL.DDPM.TIMESTEPS, (TP_BATCH,), generator=gen).to(DEVICE)
    t_fm = torch.floor(torch.rand(TP_BATCH, generator=gen) * cfg.MODEL.FM.TIME_MAX_POS)
    inputs = {  # arch → (channels, args, kwargs) of the whole model
        "DDPM-DiT": (3, (future, t, past[..., :3]), {}),
        "DDPM-UNet": (3, (future, t, past[..., :3]), {}),
        "FM-DiT": (3, (future, t_fm.to(DEVICE), past[..., :3]), {}),
        "ConvRNN": (4, (past,), {"future_len": f}),
    }
    total, res = {k: 0 for k in launch_counts()}, {}
    try:
        for arch, kinds in TP_KINDS.items():
            channels, model_args, model_kwargs = inputs[arch]
            for dtype in (torch.float32, torch.bfloat16):
                model = factory.build_backbone(cfg, arch, channels, dtype=dtype)
                model.reset_parameters(torch.Generator().manual_seed(SEED))
                perturb_(model, SEED + 1)
                model.to(DEVICE).eval()
                seen, hooks = {}, []

                def keep(name):  # each kind's first call: (args, kwargs, outputs)
                    # Lists copied: the ConvRNN's rollout refills its state lists.
                    def hook(mod, args, kwargs, out):
                        args = tuple(list(a) if isinstance(a, list) else a for a in args)
                        seen.setdefault(name, (args, kwargs, _tensors(out)))
                    return hook

                for name in kinds:
                    if name and name not in TP_INPUT_OF:
                        hooks.append(model.get_submodule(name).register_forward_hook(
                            keep(name), with_kwargs=True))
                with torch.no_grad():
                    seen[""] = (model_args, model_kwargs, model(*model_args, **model_kwargs))
                for hk in hooks:
                    hk.remove()
                for name in set(kinds) & set(TP_INPUT_OF):
                    parent = TP_INPUT_OF[name]
                    with torch.no_grad():
                        x = seen[parent][0][0]
                        seen[name] = ((x,), {}, model.get_submodule(name)(x))
                for n in TP_SIZES:
                    group = LocalGroup(n)
                    ranks = [sharding.cut_model(copy.deepcopy(model), n, r, group)
                             for r in range(n)]
                    for name in kinds:
                        args, kwargs, ref = seen[name]
                        reset_launch_counts()
                        with torch.no_grad():
                            model.get_submodule(name)(*args, **kwargs)
                        torch.cuda.synchronize()
                        one = launch_counts()
                        reset_launch_counts()

                        def rank_call(r):  # grad mode is per thread
                            with torch.no_grad():
                                return ranks[r].get_submodule(name)(*args, **kwargs)

                        outs = group.run(rank_call)
                        torch.cuda.synchronize()
                        got = launch_counts()
                        want = {k: n * v for k, v in one.items()}
                        if got != want:
                            fail(f"TP {arch} {name or 'model'} N={n}: launches {got}, "
                                 f"want {want}")
                        for k, v in got.items():
                            total[k] += v
                        refs = _tensors(ref)  # a cell's or the encoder's state too
                        scale = max(float(r.float().abs().max()) for r in refs)
                        err = max(float((o.float() - r.float()).abs().max())
                                  for out in outs for o, r in zip(_tensors(out), refs))
                        bitwise = all(torch.equal(o, r) for out in outs
                                      for o, r in zip(_tensors(out), refs))
                        tol = (TP_TOL["bf16"] if dtype == torch.bfloat16
                               else TOL["forward_f32"] if not name
                               else TP_TOL["f32_cudnn"] if arch == "ConvRNN"
                               else TP_TOL["f32"])
                        if not (bitwise or err <= tol * scale):
                            fail(f"TP {arch} {name or 'model'} N={n} {_dn(dtype)}: "
                                 f"{err} > {tol}·{scale}")
                        res[f"{arch} {name or 'model'} N{n} {_dn(dtype)}"] = dict(
                            bitwise=bitwise, max_rel=err / max(scale, 1e-30), tol=tol,
                            cut=len(tensor.model_shards(ranks[0].get_submodule(name))),
                            launches_per_rank={k: v for k, v in one.items() if v})
                    del ranks
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    log("parallel tensor shards on one card (ranks as threads)", checks=len(res),
        bitwise=sum(r["bitwise"] for r in res.values()), launches=total, **res)
    return {"16 tensor shards": total}


TP_RUNS = (("DDPM-DiT", 2, False), ("DDPM-DiT", 2, True), ("DDPM-UNet", 2, False),
           ("DDPM-UNet", 2, True), ("DDPM-DiT", 4, False))


def tp_training(cli_cfg, workdir: Path, world: int) -> dict:
    """Phase 16 (b), on four cards or more: ``train --data-parallel
    --model-parallel M [--fsdp]`` (one process a card, data world/M ×
    model M) for each run of :data:`TP_RUNS`, one after another, on phase
    10's pickles at the serving width (batch 64, bf16, EMA 0.999); then
    each model's plain ``Trainer.fit`` of the same seed and data on one
    card, under the commands' TF32 switches.  Each run's per-step losses
    (within ``WORLD_TOL["loss"]``), its checkpoint in a plain ``Trainer``
    (each state within ``WORLD_TOL["state_share"]`` of its training's
    movement), the uncut parameters equal across each model group (the
    command's ``model group`` line) and its launches a step are held;
    ms a step and each card's peak memory are recorded."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data import ingest
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import Trainer

    list_path = workdir / "ATC_datafiles.yml"
    epochs = {"TRAIN": {"EPOCHS": 1, "EMA_DECAY": 0.999}}

    def config(name):
        (workdir / name).mkdir()
        return write_config(cli_cfg.updated({
            "DATA_FS": {"SAVE_DIR": str(workdir / name / "ckpts"),
                        "OUTPUT_DIR": str(workdir / name / "out")},
            "MODEL": {"DDPM": {"UNET": epochs, "DIT": epochs}}}), workdir / name / "ATC.yml")

    outs, paths, res = {}, {}, {"world": world}
    for arch, m, fsdp in TP_RUNS:
        label = f"{arch} data {world // m} x model {m}{' FSDP' if fsdp else ''}"
        cfg_path = config(label.replace(" ", "_"))
        t0 = time.perf_counter()
        proc = start_cli("train", "--arch", arch, "--epochs", "1", "--seed", str(CLI_SEED),
                         "--configList-yml-file", str(list_path), "--config-yml-file",
                         str(cfg_path), "--data-parallel", "--model-parallel", str(m),
                         *(["--fsdp"] if fsdp else []))
        outs[label] = (arch, cfg_path, finish_cli(proc, f"train {label}"),
                       time.perf_counter() - t0)

    refs = {}
    reset_launch_counts()  # not a path of this phase: the plain references
    for arch in ("DDPM-DiT", "DDPM-UNet"):
        cfg = load_config(str(config(f"plain_{arch}")), str(list_path))
        train_ds, val_ds = ingest.get_training_dataset(cfg, 3, seed=CLI_SEED, device=DEVICE)
        tr = Trainer(cfg, arch, device=DEVICE, seed=CLI_SEED,
                     run_dir=str(workdir / f"plain_{arch}" / "run"))
        init = {k: v.detach().clone() for k, v in tr.params.items()}
        with command_precision():
            hist = tr.fit(train_ds, val_ds, epochs=1)
        refs[arch] = (cfg, hist, tr.params, tr.ema_params, init, tr.plateau.lr,
                      len(val_ds) // cfg.DATASET.BATCH_SIZE)
    for label, (arch, cfg_path, out, wall) in outs.items():
        cfg, hist, params, ema, init, lr, evals = refs[arch]
        steps = len(hist["step_loss"][0])
        per_step, per_fwd = TRAIN_PER_STEP[arch](cfg), PER_FORWARD[arch](cfg)
        want = {k: per_step.get(k, 0) * steps + per_fwd.get(k, 0) * evals
                for k in set(per_step) | set(per_fwd)}
        paths[f"16 train TP {label}"] = hold_launches(
            f"train {label}", json.loads(logged(out, "kernel launches: ")), want, 1)
        group = json.loads(logged(out, "model group: "))
        if not group["uncut_equal"]:
            fail(f"{label}: the uncut parameters parted within a model group")
        runs = [json.loads(ln.split("train steps: ", 1)[1]) for ln in out.splitlines()
                if "train steps: " in ln]
        back = Trainer(cfg, arch, device=DEVICE, seed=SEED)
        back.load(str(Path(load_config(str(cfg_path)).DATA_FS.SAVE_DIR)
                      / ckpt.checkpoint_name(cfg, arch, "000")))
        bound = 2 * lr * steps
        step_ms = [ms for epoch in runs[0]["step_ms"] for ms in epoch]
        res[label] = dict(
            mesh=logged(out, "mesh: "), model_group=group, wall_s=wall,
            losses=hold_series(f"{label} step losses", runs[0]["step_loss"], hist["step_loss"],
                               WORLD_REASON, tol=WORLD_TOL["loss"]),
            params=hold_state_share(f"{label} params", back.params, params, init, bound),
            ema=hold_state_share(f"{label} EMA", back.ema_params, ema, init, bound),
            step_ms_median=statistics.median(step_ms[1:]), step_ms=step_ms,
            plain_step_ms_median=statistics.median(hist["step_ms"][0][1:]),
            peak_memory_gb_per_card=[r["peak_memory_gb"] for r in runs])
    log(f"parallel tensor-parallel training b64 ({world} cards)", **res)
    return paths


# ``--tp-trace`` (four cards or more): where a tensor-parallel step's time
# goes.  DDPM-DiT at the serving width, batch TP_TRACE_BATCH, data world/2 ×
# model 2 without and with FSDP, TP_TRACE_STEPS steps profiled on every
# rank after TP_TRACE_WARM; then the plain step on one card.
TP_TRACE_BATCH = 64
TP_TRACE_WARM, TP_TRACE_STEPS = 3, 5


def step_trace(fn) -> dict:
    """One call of ``fn`` (ending synchronised) under the profiler: its wall
    ms, the card's kernel ms, of them NCCL's (its kernels wait on the card
    for their peers, so this holds the ranks' waits for each other too),
    and the launches."""
    wall_us, by_name, launches = kernel_times(fn)
    nccl = sum(t for name, t in by_name.items() if "nccl" in name.lower())
    return dict(wall_ms=wall_us / 1e3, busy_ms=sum(by_name.values()) / 1e3,
                nccl_ms=nccl / 1e3, launches=launches)


def tp_trace_rank(rank: int, world: int, port: int, device: str, overrides: dict,
                  out: str) -> None:
    """One process of :func:`tp_trace` → rank 0 writes every rank's traces
    (and its plain step's) as JSON to ``out``."""
    import torch.distributed as dist

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.parallel import multiprocess
    from crowdmod_tpu_torch.parallel.mesh import make_mesh
    from crowdmod_tpu_torch.train.trainer import StepDraws, Trainer

    dev = multiprocess.initialize(init_method=f"tcp://localhost:{port}", num_processes=world,
                                  process_id=rank, device_type=device, timeout_s=300)
    cfg = load_config("serving/ATC.yml", overrides=overrides)
    p, f = cfg.DATASET.PAST_LEN, cfg.DATASET.FUTURE_LEN
    h, w = cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS
    gen = torch.Generator().manual_seed(SEED)
    batch = tuple(torch.randn(TP_TRACE_BATCH, n, h, w, 3, generator=gen).to(dev)
                  for n in (p, f))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def trace(mesh, mode):
        with tempfile.TemporaryDirectory() as tmp:
            tr = Trainer(cfg, "DDPM-DiT", device=dev, seed=SEED, mesh=mesh,
                         param_sharding=mode, run_dir=tmp).setup()
            draws = StepDraws(generator=torch.Generator(device=dev).manual_seed(SEED))

            def steps(n):
                for _ in range(n):
                    tr._train_step(*tr._rank_args(batch, draws))
                sync()

            with command_precision():
                steps(TP_TRACE_WARM)
                return step_trace(lambda: steps(TP_TRACE_STEPS))

    mesh = make_mesh(data=world // 2, model=2)
    res = {mode: trace(mesh, mode) for mode in ("tp", "fsdp")}
    if rank == 0:
        res["plain"] = trace(None, "tp")
    seen = [None] * world
    dist.all_gather_object(seen, res)
    if rank == 0:
        Path(out).write_text(json.dumps(seen))
    dist.barrier()
    dist.destroy_process_group()


def tp_trace(world: int, overrides: dict | None = None) -> dict:
    """``--tp-trace``: :func:`tp_trace_rank` on ``world`` processes, a card
    each → a step's wall ms, the busy share and NCCL's share of each rank,
    TP (data world/2 × model 2) and TP + FSDP beside the plain step."""
    import socket

    import torch.multiprocessing as mp

    if world < 4 or world % 2:
        raise AssertionError(f"--tp-trace needs an even world of 4 or more, not {world}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out = Path(tmp) / "trace.json"
        mp.spawn(tp_trace_rank, args=(world, port, DEVICE, overrides or {}, str(out)),
                 nprocs=world, join=True)
        ranks = json.loads(out.read_text())
    res = {"world": world, "steps": TP_TRACE_STEPS}
    for mode in ("plain", "tp", "fsdp"):
        runs = [r[mode] for r in ranks if mode in r]
        res[mode] = dict(
            step_ms=[r["wall_ms"] / TP_TRACE_STEPS for r in runs],
            busy_share=[r["busy_ms"] / r["wall_ms"] for r in runs],
            nccl_share_of_wall=[r["nccl_ms"] / r["wall_ms"] for r in runs],
            launches_per_step=[r["launches"] / TP_TRACE_STEPS for r in runs])
    log(f"tensor-parallel step traced DDPM-DiT b{TP_TRACE_BATCH} "
        f"(data {world // 2} x model 2, {world} cards)", **res)
    return res


def phase_parallel(workdir: Path, samples: bool = False) -> dict:
    """Phase 16 on phase 10's workspace: a process (or a replica) a card
    over NCCL, a world of one on one card; with ``samples`` (``--parallel``)
    also generate-samples' data-parallel sampling.  Every check runs; the
    phase fails at its end if any did.  → each path's launch counts."""
    from crowdmod_tpu_torch.config import load_config

    import torch.distributed as dist

    world = torch.cuda.device_count()
    log("parallel", backend="nccl", world_size=world, nccl=list(torch.cuda.nccl.version()),
        nvidia_smi=nvidia_smi(), nccl_available=dist.is_nccl_available())
    cli_cfg = load_config(str(workdir / "ATC.yml"), str(workdir / "ATC_datafiles.yml"))
    paths = {}
    parts = [("train", dp_training, (cli_cfg, workdir, world)),
             ("metrics", dp_metrics, (workdir, world)),
             ("serving", dp_serving, (workdir, world)),
             ("stream", dp_stream, (workdir, cli_cfg)),
             ("tensor shards", tp_shards, (load_config("serving/ATC.yml"),))]
    if samples:
        parts.insert(4, ("samples", dp_samples, (workdir, world)))
    if world >= 4:  # data 2 x model 2 needs four cards: NCCL takes one rank a card
        parts.append(("tensor training", tp_training, (cli_cfg, workdir, world)))
    with collecting("phase 16"):
        for part, fn, args in parts:
            t0 = time.perf_counter()
            paths.update(fn(*args))
            log("parallel part done", part=part, seconds=time.perf_counter() - t0)
    return paths


# ---------------------------------------------------------------------------
# Phase 17: the remaining commands (generate-samples, sweep, doctor) and the
# profiling hooks
# ---------------------------------------------------------------------------

# Overlay metrics on the card against the CPU's from the same sequences:
# PSNR and masked PSNR in dB (absolute), SSIM and TV relative to max|CPU|.
OVERLAY_TOL = {"psnr": 1e-4, "mpsnr": 1e-4, "ssim": 1e-5, "tv": 1e-5}
SWEEP_TRIALS = 2
TIMER_REQUESTS = 5  # the StepTimer's DiT sample calls


def sample_args(workdir: Path, arch: str) -> list[str]:
    """``generate-samples`` arguments on phase 10's workspace (no device)."""
    return ["--config-yml-file", str(workdir / "ATC.yml"), "--configList-yml-file",
            str(workdir / "ATC_datafiles.yml"), "--arch", arch, "--seed", str(CLI_SEED)]


def hold_overlays(label, card: dict, cpu: dict) -> dict:
    """The card's overlay metrics against the CPU's (NaN where both are:
    a frame with an empty density mask) → the worst error of each."""
    worst = {}
    for name, tol in OVERLAY_TOL.items():
        got, want = card[name], cpu[name]
        if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)):
            raise AssertionError(f"{label} {name}: shapes or NaNs differ")
        err = np.nan_to_num(np.abs(got.astype(np.float64) - want), nan=0.0)
        scale = 1.0 if name in ("psnr", "mpsnr") else float(np.nanmax(np.abs(want)))
        worst[name] = float(err.max()) / scale
        if not worst[name] <= tol:
            raise AssertionError(f"{label} {name}: {worst[name]} > {tol}")
    return worst


def check_doctor(out: str, run: int) -> dict:
    """One ``doctor`` report: every check ``ok`` (six on the first run,
    five on the second, ``--skip-mesh``), no warning or failure, and every
    kernel library found in the source-hash cache (phase 1 built them in
    this checkout; ``build_all`` compiled none) → the kernel probes'
    launches (from its kernels line)."""
    lines = [ln for ln in out.splitlines() if ln.startswith("  ") and "[" in ln]
    checks = 6 if run == 1 else 5
    if len(lines) != checks or not all("[ok]" in ln for ln in lines) \
            or f"{checks} ok, 0 warnings, 0 failures" not in out:
        raise AssertionError(f"doctor run {run}: not every check ok:\n{out}")
    if "5/5 libraries from the source-hash cache, 0 built" not in out:
        raise AssertionError(f"doctor run {run} built a kernel library:\n{out}")
    return json.loads(logged(out, "launches "))


def commands_sampling(workdir: Path, cfg, arch: str, label: str = "17") -> dict:
    """``generate-samples``' device half for ``arch`` in this process (the
    command's ``sample_sequences``: checkpoint, test set, ids, sampler,
    overlays on the card): launches held per forward × the sampler's
    steps, the logged L1 norm held to the samples', the card's overlays
    to the CPU's from the same sequences."""
    from crowdmod_tpu_torch.cli import generate_samples
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.viz.plot_samples import overlay_metrics

    args = generate_samples.build_parser().parse_args(
        [*sample_args(workdir, arch), "--device", DEVICE])
    reset_launch_counts()  # this arch's generate-samples path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate_samples.sample_sequences(cfg, args, DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hold_launches(f"generate-samples {arch}", launch_counts(),
                             PER_FORWARD[arch](cfg), cfg.MODEL.DDPM.ETA_STEPS)
    if out["launches"] != launches:
        raise AssertionError(f"generate-samples {arch}: logged launches {out['launches']}")
    pred, seqs = out["pred"], out["seqs"]
    n = cfg.MODEL.NSAMPLES4PLOTS
    f_shape = (cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    if tuple(pred.shape) != (n, *f_shape) or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"generate-samples {arch}: samples {tuple(pred.shape)}, finite "
                             f"{bool(torch.isfinite(pred).all())}")
    l1_f64 = float(pred.double().abs().sum())
    if out["l1"] != float(pred.abs().sum()) or abs(out["l1"] - l1_f64) > 1e-5 * l1_f64:
        raise AssertionError(f"generate-samples {arch}: logged L1 {out['l1']} against "
                             f"{l1_f64} (float64)")
    cpu_seqs = seqs.cpu()
    cpu = overlay_metrics(cpu_seqs[0::2], cpu_seqs[1::2], cfg.METRICS, cfg.MACROPROPS.EPS)
    worst = hold_overlays(f"generate-samples {arch} overlays", out["overlays"], cpu)
    log(f"commands generate-samples {arch}: sample_sequences b{n} {f_shape}", wall_s=wall,
        l1=out["l1"], l1_float64=l1_f64, overlays_card_vs_cpu=worst,
        overlay_tolerance=OVERLAY_TOL, launches=launches)
    return {f"{label} generate-samples {arch}": launches}


def commands_timing(workdir: Path, cfg) -> dict:
    """``utils.profiling`` on the card: ``measure_round_trip``, a
    ``StepTimer`` over DDPM-DiT sample calls (the generate-samples batch,
    stopped on the samples' device) and a ``trace`` of one (its Chrome
    trace's events and kernel time)."""
    from crowdmod_tpu_torch.data import ingest
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import Trainer
    from crowdmod_tpu_torch.utils import StepTimer, trace
    from crowdmod_tpu_torch.utils.profiling import measure_round_trip

    round_trip = measure_round_trip(iters=20, device=DEVICE)
    tr = Trainer(cfg, "DDPM-DiT", device=DEVICE, seed=SEED)
    tr.load(str(workdir / "ckpts" / ckpt.checkpoint_name(cfg, "DDPM-DiT", "000")))
    test_ds = ingest.get_test_dataset(cfg, tr.mprops_count, seed=CLI_SEED, device=DEVICE)
    past = test_ds.gather(np.arange(cfg.MODEL.NSAMPLES4PLOTS))[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    tr.sample(past, gen)  # warm
    timer = StepTimer()
    for _ in range(TIMER_REQUESTS):
        timer.start()
        out = tr.sample(past, gen)
        timer.stop(block_on=out)
    trace_dir = workdir / "trace"
    with trace(str(trace_dir)):
        out = tr.sample(past, gen)
        torch.cuda.synchronize()
    events = json.loads((trace_dir / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    res = dict(round_trip_ms=1e3 * round_trip,
               sample_b=past.shape[0], step_timer=timer.summary(),
               trace_events=len(events), trace_kernels=len(kernels),
               trace_kernel_ms=sum(e.get("dur", 0) for e in kernels) / 1e3,
               trace_bytes=(trace_dir / "trace.json").stat().st_size,
               nvidia_smi=nvidia_smi())
    if not kernels:
        raise AssertionError("profiling.trace recorded no kernel on the card")
    log("commands profiling: round trip, StepTimer and trace of DiT sample calls", **res)
    return res


def phase_commands(workdir: Path) -> dict:
    """Phase 17 on phase 10's workspace (its DDPM-DiT checkpoint from
    ``train``, its DDPM-UNet checkpoint): ``sweep`` (2 trials of one epoch)
    and ``doctor`` as processes while generate-samples' device half runs
    here for both models; ``doctor --skip-mesh`` a second time (neither
    builds a kernel library); ``generate-samples`` whole where matplotlib is
    installed; then
    the profiling hooks.  → each path's launch counts."""
    from crowdmod_tpu_torch.cli.sweep import sample_trial, sweep_space
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.viz import plotting_unavailable

    cfg = load_config(str(workdir / "ATC.yml"), str(workdir / "ATC_datafiles.yml"))
    plots = plotting_unavailable() is None
    log("commands", matplotlib=plots, nvidia_smi=nvidia_smi())
    common = ["--config-yml-file", str(workdir / "ATC.yml"), "--configList-yml-file",
              str(workdir / "ATC_datafiles.yml"), "--seed", str(CLI_SEED)]
    t0 = time.perf_counter()
    sweep_proc = start_cli("sweep", "--arch", "DDPM-UNet", "--trials", str(SWEEP_TRIALS),
                           "--epochs-per-trial", "1", "--sweep-dir", str(workdir / "sweep"),
                           *common)
    doctor_procs = [start_cli("doctor")]
    drawn = []
    if plots:  # the whole command, each plot type, as a user runs it
        drawn = [(kind, start_cli("generate-samples", *sample_args(workdir, "DDPM-DiT"),
                                  "--plot-type", kind, "--output-dir",
                                  str(workdir / f"samples_{kind}")))
                 for kind in ("Static", "Dynamic")]
    paths = {}
    for arch in ("DDPM-DiT", "DDPM-UNet"):
        paths.update(commands_sampling(workdir, cfg, arch))

    doctors = [finish_cli(doctor_procs[0], "doctor")]
    # The mesh was checked by the first run.
    doctors.append(finish_cli(start_cli("doctor", "--skip-mesh"), "doctor (second run)"))
    for i, out in enumerate(doctors):
        paths[f"17 doctor {i + 1}"] = check_doctor(out, i + 1)
    log("commands doctor", runs=2, kernels=[logged(o, "kernels ").strip() for o in doctors],
        mesh=logged(doctors[0], "mesh (2 processes)").strip())

    sweep_out = finish_cli(sweep_proc, "sweep")
    records = [json.loads(ln) for ln in open(workdir / "sweep" / "sweep_results.jsonl")]
    rng = np.random.default_rng(CLI_SEED)
    want = [json.loads(json.dumps(sample_trial(sweep_space("DDPM-UNet"), rng)))
            for _ in range(SWEEP_TRIALS)]
    if [r["params"] for r in records] != want:
        raise AssertionError(f"sweep trials {[r['params'] for r in records]} != {want}")
    if not all(np.isfinite(r["train_loss"]) for r in records):
        raise AssertionError(f"sweep: a trial's loss is not finite: {records}")
    best = json.loads((workdir / "sweep" / "best.json").read_text())
    paths["17 sweep DDPM-UNet"] = json.loads(logged(sweep_out, "kernel launches: "))
    log("commands sweep DDPM-UNet", trials=[{k: r[k] for k in ("params", "train_loss",
                                                               "val_loss", "wall_s")}
                                            for r in records],
        best=best, launches=paths["17 sweep DDPM-UNet"])

    for kind, proc in drawn:
        out = finish_cli(proc, f"generate-samples {kind}")
        files = sorted(p.name for p in (workdir / f"samples_{kind}").iterdir())
        n = cfg.MODEL.NSAMPLES4PLOTS
        want_files = ({f"rho_seq_{i + 1}.png" for i in range(n)}
                      | ({f"mprops_seq_{i + 1}.gif" for i in range(n)}
                         | {f"mprops_GT_seq_{i + 1}.gif" for i in range(n)}
                         if kind == "Dynamic" else set()))
        if not want_files <= set(files) or (kind == "Static"
                                            and not any(f.endswith(".svg") for f in files)):
            raise AssertionError(f"generate-samples {kind}: files {files}")
        paths[f"17 generate-samples {kind}"] = json.loads(logged(out, "kernel launches: "))
        log(f"commands generate-samples DDPM-DiT --plot-type {kind}", files=len(files),
            launches=paths[f"17 generate-samples {kind}"])
    log("commands processes done", seconds=time.perf_counter() - t0)
    commands_timing(workdir, cfg)
    return paths


def _log_time(line: str) -> datetime.datetime:
    """The timestamp of a command's log line (``%(asctime)s`` first)."""
    return datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f")


def phase_train_time(trees: list[Path]) -> dict:
    """Phase 10's ``train`` command (DDPM-DiT, one epoch of 20 steps) and
    the same for DDPM-UNet, from the port package of each checkout in
    ``trees``, in the order trees then trees reversed, on one pickle
    workspace: each run's wall seconds and its fit seconds (from its log's
    ``train windows`` line to its ``kernel launches`` line: the epoch, the
    evaluation and the checkpoint)."""
    for tree in trees:  # each tree's kernels, before any timing
        subprocess.run([sys.executable, "-c", "from crowdmod_tpu_torch.ops.kernels "
                        "import build; build.build_all()"], cwd=tree, check=True, timeout=600)
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path, list_path, _ = write_pickle_workspace(Path(tmp) / "cli")
        for arch in ("DDPM-DiT", "DDPM-UNet"):
            runs = {str(t): {"wall_s": [], "fit_s": []} for t in trees}
            for tree in [*trees, *reversed(trees)]:
                t0 = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, "-m", "crowdmod_tpu_torch.cli", "train", "--arch", arch,
                     "--epochs", "1", "--config-yml-file", str(cfg_path),
                     "--configList-yml-file", str(list_path), "--seed", str(CLI_SEED),
                     "--device", DEVICE], cwd=tree, capture_output=True, text=True, timeout=600)
                wall = time.perf_counter() - t0
                if r.returncode:
                    raise RuntimeError(f"train ({tree}) exited {r.returncode}:\n"
                                       f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
                lines = r.stdout.splitlines()
                start = [ln for ln in lines if "train windows: " in ln][-1]
                end = [ln for ln in lines if "kernel launches: " in ln][-1]
                runs[str(tree)]["wall_s"].append(wall)
                runs[str(tree)]["fit_s"].append(
                    (_log_time(end) - _log_time(start)).total_seconds())
            res[arch] = runs
            log(f"train time {arch}", order=[str(t) for t in [*trees, *reversed(trees)]],
                **runs)
    return res


# ---------------------------------------------------------------------------
# Phase 18: the operational drills (tools/*_torch.py)
# ---------------------------------------------------------------------------

DRILL_EPOCHS, DRILL_KILL = 6, 2   # the training drill: SIGINT at epoch 2 of 6
DRILL_FILES, DRILL_PER_FILE = 4, 32  # 2 train files: 192 windows, 3 steps of 64
SOAK_CLIENTS, SOAK_S, SOAK_RAMP_S = 4, 10.0, 2.0
SERVING_SAMPLER = "DDIM-eta:1.0:25+Sparsity:0.6"  # configs/serving/ATC.yml's


def drill_training(tmp: Path) -> dict:
    """``tools/training_drill_torch.py``: DDPM-UNet at ``configs/ATC.yml``'s
    width (base 32, mults 1-2-4, batch 64, bf16) through the ``train``
    command, SIGINT at epoch 2 of 6, ``--resume`` to the end; every check
    of its report held, the resumed run's launches (its log line) held to
    its steps and evaluations."""
    from crowdmod_tpu_torch.config import load_config
    from tools import training_drill_torch

    out = tmp / "training_drill"
    t0 = time.perf_counter()
    rc = training_drill_torch.main([
        "--out", str(out), "--epochs", str(DRILL_EPOCHS), "--kill-epoch", str(DRILL_KILL),
        "--files", str(DRILL_FILES), "--per-file", str(DRILL_PER_FILE),
        "--timeout", "600", "--device", DEVICE])
    wall = time.perf_counter() - t0
    report = json.loads((out / "report.json").read_text())
    if rc or not all(report["checks"].values()):
        raise AssertionError(f"training drill failed (rc {rc}): {report['checks']}")
    log2 = (out / "phase2.log").read_text()
    train_n, val_n = (int(v) for v in re.search(
        r"train windows: (\d+), val windows: (\d+)", log2).groups())
    cfg = load_config(str(out / "cfg.yml"))
    batch, epochs = cfg.DATASET.BATCH_SIZE, report["phase2"]["epochs_logged"]
    steps = epochs * (train_n // batch)
    evals = epochs * max(val_n // batch, 1)
    want = add_launches(
        {k: v * steps for k, v in TRAIN_PER_STEP["DDPM-UNet"](cfg).items()},
        {k: v * evals for k, v in PER_FORWARD["DDPM-UNet"](cfg).items()})
    launches = hold_launches("training drill (resumed run)",
                             json.loads(logged(log2, "kernel launches: ")), {}, 0, want)
    log("drill training DDPM-UNet ATC b64", wall_s=wall, checks=report["checks"],
        phase1=report["phase1"], phase2=report["phase2"], lr=report["lr"],
        numbered=report["numbered_checkpoints"], train_windows=train_n,
        val_windows=val_n, resumed_steps=steps, launches=launches)
    return launches


def drill_soak(tmp: Path) -> dict:
    """``tools/soak_http_torch.py``: DDPM-DiT at the serving config's width
    (hidden 256, depth 6) trained 2 epochs on walkers, served through
    ``ServingApp`` + ``ThreadingHTTPServer`` + ``BatchingQueue`` at DDIM-eta
    25 + Sparsity, 4 clients for 10 s: no error, a coalesced dispatch, the
    launches held to the predictor's sampling calls (warmup included)."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from tools import soak_http_torch

    out = tmp / "soak_http"
    reset_launch_counts()  # the soak's path: DiT training (no kernel) + serving
    rc = soak_http_torch.main([
        "--config-yml-file", "serving/ATC.yml", "--sampler", SERVING_SAMPLER,
        "--clients", str(SOAK_CLIENTS), "--duration", str(SOAK_S),
        "--ramp-s", str(SOAK_RAMP_S), "--workdir", str(out),
        "--out", str(out / "report.json"), "--device", DEVICE])
    report = json.loads((out / "report.json").read_text())
    if rc or report["errors"] or not report["coalesced_requests"]:
        raise AssertionError(f"HTTP soak failed (rc {rc}): {report}")
    cfg = load_config("serving/ATC.yml")
    launches = hold_launches("HTTP soak", launch_counts(), PER_FORWARD["DDPM-DiT"](cfg),
                             cfg.MODEL.DDPM.ETA_STEPS * int(report["predictions"]))
    log("drill soak_http DDPM-DiT serving DDIM-eta 25 + Sparsity", **report,
        nvidia_smi=nvidia_smi(), launches=launches)
    return launches


def start_drill(tmp: Path) -> tuple:
    """The training drill on a thread → (thread, its result dict: the
    launch counts under ``"launches"``, or the error under ``"error"``).
    Its ``train`` processes count their own launches: the counts of this
    process, which other phases hold meanwhile, see none of them."""
    drill: dict = {}

    def run():
        try:
            drill["launches"] = drill_training(tmp)
        except BaseException as e:  # noqa: BLE001 - re-raised by phase_drills
            drill["error"] = e

    thread = threading.Thread(target=run, name="training-drill")
    thread.start()
    return thread, drill


def phase_drills(tmp: Path, drill: tuple | None = None) -> dict:
    """Phase 18: the HTTP soak in this process while the training drill
    (``start_drill``; the default run starts it beside phase 17, for time)
    runs its ``train`` processes, then the drill's end.  The card is
    shared meanwhile, so the soak's latencies here are not serving's alone
    (the ``--drills`` soak runs by itself).  → each path's launch counts."""
    thread, result = drill or start_drill(tmp)
    try:
        soak = drill_soak(tmp)
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    return {"18 training drill": result["launches"], "18 HTTP soak": soak}


def run_tool(label: str, *argv, timeout: float = 900) -> float:
    """``python *argv`` from this checkout → wall seconds; raises on a
    non-zero exit with the end of its output."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                       cwd=Path(__file__).resolve().parent, timeout=timeout)
    wall = time.perf_counter() - t0
    print(r.stdout[-6000:], flush=True)
    if r.returncode:
        raise RuntimeError(f"{label} exited {r.returncode}:\n{r.stdout[-4000:]}\n"
                           f"{r.stderr[-4000:]}")
    return wall


def phase_drills_full(tmp: Path) -> dict:
    """``--drills``: the end-to-end validation (DDPM-UNet, 60 epochs, the
    ≥ 3 dB criterion), the ETL drill at the ATC grid with the config's
    UNet (the same criterion), the 1280-sample protocol over DDPM, DDIM and
    DPM-Solver, the stream soak over 2 GB, the HTTP soak at 16 clients, the
    library and serving quickstarts; each tool's checks held (its exit
    status) → each report."""
    reports = {}
    validate = tmp / "validate.json"
    wall = run_tool("validate_e2e", "tools/validate_e2e_torch.py", "--out", str(validate),
                    "--device", DEVICE)
    reports["validate_e2e"] = {**json.loads(validate.read_text()), "wall_s_process": wall}
    etl = tmp / "etl.json"
    wall = run_tool("etl_drill", "tools/etl_drill_torch.py", "--out", str(tmp / "etl"),
                    "--full-width", "--rows", "12", "--cols", "36",
                    "--report", str(etl), "--device", DEVICE)
    reports["etl_drill"] = {**json.loads(etl.read_text()), "wall_s_process": wall}
    wall = run_tool("eval_protocol_full", "tools/eval_protocol_full_torch.py", "--out",
                    str(tmp / "protocol"), "--device", DEVICE, timeout=1500)
    reports["eval_protocol_full"] = {**json.loads((tmp / "protocol" / "report.json")
                                                  .read_text()), "wall_s_process": wall}
    stream = tmp / "stream.json"
    wall = run_tool("soak_stream", "tools/soak_stream_torch.py", "--dir", str(tmp / "stream"),
                    "--out", str(stream), "--device", DEVICE)
    reports["soak_stream"] = {**json.loads(stream.read_text()), "wall_s_process": wall}
    soak = tmp / "soak.json"
    wall = run_tool("soak_http", "tools/soak_http_torch.py", "--config-yml-file",
                    "serving/ATC.yml", "--sampler", SERVING_SAMPLER, "--duration", "30",
                    "--ramp-s", "5", "--workdir", str(tmp / "soak"), "--out", str(soak),
                    "--device", DEVICE)
    reports["soak_http_16"] = {**json.loads(soak.read_text()), "wall_s_process": wall}
    for name in ("quickstart", "serving_quickstart"):
        reports[name] = {"wall_s_process": run_tool(
            name, f"examples/{name}_torch.py", "--out", str(tmp / name), "--device", DEVICE)}
    for name, report in reports.items():
        log(f"drills {name}", **report)
    log("drills", nvidia_smi=nvidia_smi())
    return reports


def phase_multihost(tmp: Path) -> dict:
    """``--multihost`` (a card a process; four cards): the multi-process
    rehearsal over NCCL at the serving config's width, 2 processes (DDP)
    and 4 (FSDP), each with ``train`` and ``generate-metrics --multihost``
    on every rank; then the scaling quickstart at data 2 × model 2 with
    FSDP and remat → each rehearsal's report."""
    reports = {}
    for nprocs, extra in ((2, []), (4, ["--fsdp"])):
        out = tmp / f"dryrun_{nprocs}"
        wall = run_tool(f"dryrun_multihost {nprocs}", "tools/dryrun_multihost_torch.py",
                        "--nprocs", str(nprocs), *extra, "--cli", "--metrics",
                        "--config", "serving/ATC.yml", "--out", str(out),
                        "--device", DEVICE, timeout=1200)
        report = json.loads((out / "report.json").read_text())
        if not report["ok"]:
            raise AssertionError(f"rehearsal of {nprocs} processes: {report}")
        reports[f"{nprocs}{' fsdp' if extra else ''}"] = report
        log(f"multihost rehearsal {nprocs} processes{' FSDP' if extra else ''}",
            wall_s_process=wall, **report)
    wall = run_tool("scaling_quickstart", "examples/scaling_quickstart_torch.py", "--data",
                    "2", "--model", "2", "--out", str(tmp / "sq"), "--device", DEVICE)
    log("multihost scaling quickstart 2x2", wall_s_process=wall, nvidia_smi=nvidia_smi())
    return reports


# ---------------------------------------------------------------------------
# Phase 19: every bundled dataset's geometry
# ---------------------------------------------------------------------------

# The dataset configs of tools/sample_all_datasets_torch.sh other than ATC,
# and ATC_medium (8 past + 8 future frames, a UNet of base 64).  Each
# "-OBST" config shares its base config's grid and widths (checked, then
# not run twice).
GEOMETRIES = ("ETHUCY", "HERMES-BO", "HERMES-BN", "HERMES-CR-90", "HERMES-CR-120",
              "ATC_medium")
SHARED_GEOMETRY = {"HERMES-CR-90-OBST": "HERMES-CR-90",
                   "HERMES-CR-120-OBST": "HERMES-CR-120"}
GEOMETRY_ARCHS = ("DDPM-UNet", "DDPM-DiT", "FM-DiT", "FM-UNet")
# configs/serving/ATC.yml's settings over configs/ATC.yml (DDIM-eta 25 +
# Sparsity, v-prediction, EMA 0.999), laid over each dataset's config; FM
# at phase 11's Euler steps.
SERVING_OVERLAY = {"MODEL": {
    "DDPM": {"SAMPLER": "DDIM-eta", "ETA": 1.0, "ETA_STEPS": 25, "GUIDANCE": "Sparsity",
             "LAMBDA_GUIDANCE": 0.6, "PRED_TYPE": "v",
             "UNET": {"TRAIN": {"EMA_DECAY": 0.999}}, "DIT": {"TRAIN": {"EMA_DECAY": 0.999}}},
    "FM": {"INTEGRATOR_STEPS": {"EULER": FM_SERVE_STEPS}}}}
GEOMETRY_SEQS = 32  # walker sequences a pickle of a geometry's workspace
GEOMETRY_TOOL = "HERMES-CR-120"  # the grid --geometries runs the sweep tool at
GEOMETRY_DIVIDERS = ("50", "100")  # its DDIM dividers: 20 and 10 steps of T = 1000


def geometry_config(name: str):
    """``configs/<name>.yml`` with :data:`SERVING_OVERLAY`."""
    from crowdmod_tpu_torch.config import load_config

    return load_config(f"{name}.yml").updated(SERVING_OVERLAY)


def geometry_key(cfg) -> tuple:
    """What the port's kernels see of a config: its grid, its frames and
    the four denoisers' nodes."""
    nodes = (cfg.MODEL.DDPM.UNET, cfg.MODEL.DDPM.DIT, cfg.MODEL.FM.UNET, cfg.MODEL.FM.DIT)
    return (cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, cfg.DATASET.PAST_LEN,
            cfg.DATASET.FUTURE_LEN, cfg.TPU.COMPUTE_DTYPE,
            json.dumps([n.to_dict() for n in nodes], sort_keys=True))


def check_shared_geometries() -> dict:
    """Each "-OBST" config against its base: the same :func:`geometry_key`,
    or raise."""
    from crowdmod_tpu_torch.config import load_config

    res = {}
    for obst, base in SHARED_GEOMETRY.items():
        if geometry_key(load_config(f"{obst}.yml")) != geometry_key(load_config(f"{base}.yml")):
            raise AssertionError(f"{obst}: its grid or widths differ from {base}'s")
        res[obst] = base
    log("geometries shared (not run twice)", **res)
    return res


def dit_attention_shapes(cfg, arch: str, batch: int = UNET_BATCH) -> dict:
    """(problems, heads, queries, keys, Dh) → attention calls of one
    forward of ``arch``'s DiT on ``cfg``'s grid: DiT4D (DDPM-DiT) a spatial
    self-attention over each temporal slot's patches and a temporal
    attention of the future slots over all slots a block; DiT2D (FM-DiT)
    one joint attention over every frame's patches a block."""
    frames = cfg.DATASET.PAST_LEN + cfg.DATASET.FUTURE_LEN
    node = cfg.MODEL.DDPM.DIT if arch == "DDPM-DiT" else cfg.MODEL.FM.DIT
    patches = (cfg.MACROPROPS.ROWS // node.PATCH_SIZE) * (cfg.MACROPROPS.COLS // node.PATCH_SIZE)
    heads, dh = node.NUM_HEADS, node.HIDDEN_SIZE // node.NUM_HEADS
    if arch == "FM-DiT":
        return {(batch, heads, frames * patches, frames * patches, dh): node.DEPTH}
    slots = frames // node.T_PATCH_SIZE
    future = slots - cfg.DATASET.PAST_LEN // node.T_PATCH_SIZE
    return {(batch * slots, heads, patches, patches, dh): node.DEPTH,
            (batch * patches, heads, future, slots, dh): node.DEPTH}


def geometry_cases(cfg) -> dict:
    """The distinct kernel shapes of the config's four models at batch 64,
    each with the models that run it, and the shape timed for each
    (kernel, model): its largest."""
    cases = {"gn": {}, "conv": {}, "resblock": {}, "attention": {}}
    timed = set()
    levels = None
    for arch in GEOMETRY_ARCHS:
        if arch.endswith("DiT"):
            attn = dit_attention_shapes(cfg, arch, UNET_BATCH)
        else:
            tables = unet_shape_tables(cfg, arch)
            levels = tables["levels"]
            vol = lambda level: int(np.prod(levels[level]))  # noqa: E731
            attn = {(UNET_BATCH, h, s, s, dh): n for (s, h, dh), n in tables["attention"].items()}
            for kind, size in (("gn", lambda k: vol(k[0]) * k[1]),
                               ("conv", lambda k: vol(k[0]) * k[1] * k[2] * (k[2] != 3)),
                               ("resblock", lambda k: k[0] * k[1] + k[1] * k[1])):
                keys = list(tables[kind])
                for k in keys:
                    cases[kind].setdefault(k, []).append(arch)
                if keys:
                    timed.add((kind, max(keys, key=size)))
        for k in attn:
            cases["attention"].setdefault(k, []).append(arch)
        timed.add(("attention", max(attn, key=lambda k: k[0] * k[2] * k[3] * k[4])))
    return {"cases": cases, "timed": timed, "levels": levels}


def geometry_kernels(name: str, cfg, gen) -> dict:
    """Every distinct kernel shape of the config's four models at batch 64
    against its twin, f32 and bf16, a second call bitwise (phase 2's
    checks and tolerances; each prints its plan); each kernel's largest
    shape a model timed in bf16 beside its bound and the library call; the
    ancestral step at the config's (64, F, H, W, 3) → {case: result}."""
    plan = geometry_cases(cfg)
    cases, timed, levels = plan["cases"], plan["timed"], plan["levels"]
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = _dn(dtype)
        for key in cases["gn"]:
            level, c, act = key
            res[f"gn L{level} C{c} {act} {dn}"] = check_group_norm(
                level, c, act, dtype, gen, dtype == torch.bfloat16 and ("gn", key) in timed,
                levels=levels)
        for key in cases["conv"]:
            res[f"conv L{key[0]} {key[1]}->{key[2]} {dn}"] = check_conv(
                *key, "im2col", dtype, gen, dtype == torch.bfloat16 and ("conv", key) in timed,
                levels=levels)
        for key in cases["resblock"]:
            res[f"resblock {key[0]}->{key[1]} {dn}"] = check_resblock(
                *key, dtype, gen, dtype == torch.bfloat16 and ("resblock", key) in timed,
                grid=levels[0])
        for key, archs in cases["attention"].items():
            b, h, sq, sk, dh = key
            res[f"attention {b}x{h} {sq}x{sk} Dh{dh} {dn}"] = check_attention(
                f"{name} {'/'.join(archs)} {key} {dn}", b, h, sq, sk, dh, dtype, gen,
                packed=sq == sk, timing=dtype == torch.bfloat16 and ("attention", key) in timed)
    shape = (UNET_BATCH, cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    for sp in (False, True):
        res[f"step {'sparsity' if sp else 'none'}"] = check_step(
            f"{name} {shape} {'sparsity' if sp else 'none'}", shape, sp, gen, timing=sp)
    rows = [[k, r["shape"], r["ms"], r["bound_ms"], r["bound_by"], r["library_ms"],
             r.get("sequence_ms")] for k, r in res.items() if "ms" in r]
    log(f"geometry {name} kernel table, NVIDIA card as in phase 1 [case, shape, ms, bound_ms, "
        "bound_by, library_ms, resblock cuDNN sequence ms]", rows=rows,
        cases=len(res), nvidia_smi=nvidia_smi())
    return res


def geometry_forward(cfg, arch: str, ckpt_path: str) -> dict:
    """One f32 batch-64 forward of ``arch`` with the kernels against the
    same under :func:`twins_on_the_card` (TF32 off), within
    ``forward_f32``; the kernels' launches held to one forward."""
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, f, h, w = (cfg.DATASET.PAST_LEN, cfg.DATASET.FUTURE_LEN,
                  cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    past = torch.from_numpy(synthetic_walkers(UNET_BATCH, h, w, p + f)[:, :p]).to(DEVICE)
    x = torch.randn((UNET_BATCH, f, h, w, 3), generator=gen, device=DEVICE)
    if arch.startswith("FM"):
        t = torch.floor(torch.rand((UNET_BATCH,), generator=gen, device=DEVICE)
                        * cfg.MODEL.FM.TIME_MAX_POS)
    else:
        t = torch.randint(0, cfg.MODEL.DDPM.TIMESTEPS, (UNET_BATCH,), generator=gen,
                          device=DEVICE)

    tr = Trainer(cfg, arch, device=DEVICE, compute_dtype=torch.float32)
    tr.load(ckpt_path)

    def run():
        with torch.no_grad():
            out = tr.model(x, t, past)
        torch.cuda.synchronize()
        return out

    with twins_on_the_card():
        ref = run()
    before = launch_counts()
    out = run()
    launches = check_launches(f"{arch} f32 forward", before, PER_FORWARD[arch](cfg), 1)
    err = (out - ref).abs().max().item()
    if not out.abs().max().item() > 1e-3:
        raise AssertionError(f"{arch}: the denoiser output is all but zero")
    if not (err <= TOL["forward_f32"] and bool(torch.isfinite(out).all())):
        raise AssertionError(f"{arch} f32 forward kernels vs twins: {err}")
    return dict(forward_max_abs_diff=err, forward_abs_max=out.abs().max().item(),
                launches={k: n for k, n in launches.items() if n})


def geometry_request(cfg, arch: str, ckpt_path: str) -> dict:
    """One bf16 batch-64 request through a ``Predictor``: DDIM-eta 25 +
    Sparsity (DDPM) or Euler at ``FM_SERVE_STEPS`` (FM); its launches held
    to :data:`PER_FORWARD` × the forwards, its future finite and of the
    config's shape."""
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.serving import Predictor

    pred = Predictor(cfg, arch, ckpt_path, device=DEVICE, batch_buckets=(UNET_BATCH,))
    p, f, h, w, _ = pred.input_spec
    past = synthetic_walkers(UNET_BATCH, h, w, p + f)[:, :p]
    forwards = (fm_forwards(cfg, 1) if arch.startswith("FM")
                else cfg.MODEL.DDPM.ETA_STEPS)
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pred.predict(past)
    latency = time.perf_counter() - t0
    launches = check_launches(f"{arch} request", before, PER_FORWARD[arch](cfg), forwards)
    if out.shape != (UNET_BATCH, f, h, w, 3) or not np.isfinite(out).all():
        raise AssertionError(f"{arch}: bad output {out.shape}")
    return dict(forwards=forwards, latency_s=latency, out_abs_mean=float(np.abs(out).mean()),
                launches={k: n for k, n in launches.items() if n})


def phase_geometry(name: str, work: Path) -> dict:
    """Phase 19 at one config: its kernels, each model's f32 forward and
    bf16 request, and generate-samples' device half for DDPM-UNet on a
    walker-pickle workspace at its grid → its paths' launch counts."""
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts

    t0 = time.perf_counter()
    cfg = geometry_config(name)
    _, _, ws_cfg = write_pickle_workspace(work, cfg, seqs=GEOMETRY_SEQS)
    ckpts = {arch: write_checkpoint(ws_cfg, arch, work, name=f"{arch}.yml")[1]
             for arch in GEOMETRY_ARCHS}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    kernels = geometry_kernels(name, cfg, gen)
    forwards = {arch: geometry_forward(ws_cfg, arch, ckpts[arch]) for arch in GEOMETRY_ARCHS}
    reset_launch_counts()  # this config's requests
    requests = {arch: geometry_request(ws_cfg, arch, ckpts[arch]) for arch in GEOMETRY_ARCHS}
    paths = {f"19 {name} requests": launch_counts()}
    paths.update(commands_sampling(work, ws_cfg, "DDPM-UNet", label=f"19 {name}"))
    log(f"geometry {name}", grid=[cfg.DATASET.PAST_LEN + cfg.DATASET.FUTURE_LEN,
                                  cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS],
        kernel_cases=len(kernels), forwards=forwards, requests=requests,
        seconds=time.perf_counter() - t0)
    return paths


def phase_geometries(tmp: Path) -> dict:
    """Phase 19: :data:`GEOMETRIES` one by one (the "-OBST" configs checked
    to share their base's) → every path's launch counts."""
    check_shared_geometries()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = {}
    for name in GEOMETRIES:
        paths.update(phase_geometry(name, tmp / "geometries" / name))
    return paths


def geometry_tools(tmp: Path) -> dict:
    """The card-side tools as processes, each exit status its checks:
    ``tools/ddim_sweep_torch.py --skip-samples`` on a walker-pickle
    workspace at :data:`GEOMETRY_TOOL`'s grid (DDPM-UNet, seeded random
    weights) and ``tools/protocol_variance_torch.py --runs 2``."""
    work = tmp / "geometry_tool"
    cfg_path, list_path, ws_cfg = write_pickle_workspace(work, geometry_config(GEOMETRY_TOOL))
    write_checkpoint(ws_cfg, "DDPM-UNet", work, name="DDPM-UNet.yml")
    root = work / "ddim_sweep"
    wall = run_tool("ddim_sweep", "tools/ddim_sweep_torch.py", "--config-yml-file",
                    str(cfg_path), "--configList-yml-file", str(list_path), "--arch",
                    "DDPM-UNet", "--dividers", *GEOMETRY_DIVIDERS, "--skip-samples",
                    "--output-root", str(root), "--device", DEVICE)
    for d in GEOMETRY_DIVIDERS:
        manifest = json.loads((root / f"DDIM_{d}" / "metrics_files.json").read_text())
        missing = [f for k, f in manifest.items() if k != "title" and not Path(f).exists()]
        if len(manifest) != 21 or missing:
            raise AssertionError(f"ddim_sweep divider {d}: {len(manifest)} manifest "
                                 f"entries, missing {missing}")
    log(f"geometry tool ddim_sweep at {GEOMETRY_TOOL}", wall_s_process=wall,
        dividers=GEOMETRY_DIVIDERS)
    out = tmp / "protocol_variance"
    wall_pv = run_tool("protocol_variance", "tools/protocol_variance_torch.py", "--runs", "2",
                       "--out", str(out), "--device", DEVICE, timeout=1200)
    summary = json.loads((out / "summary.json").read_text())
    log("geometry tool protocol_variance --runs 2", wall_s_process=wall_pv,
        stats=summary["stats"], suggested_floors=summary["suggested_floors"])
    return {"ddim_sweep_s": wall, "protocol_variance_s": wall_pv}


def kernel_entry(name, route, measured, launches) -> dict:
    return dict(name=name, route=route, source=SOURCES[name],
                replaces=REPLACES[name], launches=launches,
                **{k: measured[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "host_ms", "shape", "dtype")},
                **{k: measured[k] for k in ("floor_ms", "plan") if k in measured})


def serving_paths(tmp: Path, cfg, end_to_end: bool) -> dict:
    """Phases 3-4 and 6-7 (and 5, 8 with ``end_to_end``) for both models;
    → each model's main-path launch counts (and ``"e2e"``, the UNet's
    phase 8)."""
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts

    f_shape = (cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    paths = {}
    for arch in ("DDPM-DiT", "DDPM-UNet"):
        cfg_path, ckpt_path = write_checkpoint(cfg, arch, tmp)
        per_forward = PER_FORWARD[arch](cfg)
        reset_launch_counts()  # this arch's main path: serving + ancestral
        phase_serving(cfg_path, arch, f_shape, per_forward)
        phase_ancestral(cfg, arch, ckpt_path, f_shape, per_forward)
        paths[arch] = launch_counts()
        log("main path launches", arch=arch, **paths[arch])
        if end_to_end:
            paths["e2e"] = phase_end_to_end(cfg, arch, ckpt_path)
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--serving"] and len(sys.argv) == 3:
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))  # that tree's port
    from crowdmod_tpu_torch.config import load_config

    t_start = time.perf_counter()
    device = phase_device()
    if len(sys.argv) == 3 and sys.argv[1] == "--conv-baseline":
        rows = phase_conv_baseline(Path(sys.argv[2]).resolve())
        log("conv baseline done", seconds=time.perf_counter() - t_start, shapes=len(rows))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--kernel-baseline":
        rows = phase_kernel_baseline(Path(sys.argv[2]).resolve())
        log("kernel baseline done", seconds=time.perf_counter() - t_start,
            cases=sum(len(r) for r in rows.values()))
        return 0
    if sys.argv[1:2] == ["--conv-ab"] and len(sys.argv) > 2:
        rows = phase_conv_ab([Path(f).resolve() for f in sys.argv[2:]])
        log("conv ab done", seconds=time.perf_counter() - t_start, shapes=len(rows))
        return 0
    if sys.argv[1:] == ["--conv-tiles"]:
        rows = phase_conv_tiles()
        log("conv tiles done", seconds=time.perf_counter() - t_start, cases=len(rows))
        return 0
    if sys.argv[1:] == ["--gn-plans"]:
        rows = phase_gn_plans()["rows"]
        log("group norm plans done", seconds=time.perf_counter() - t_start, cases=len(rows))
        return 0
    if sys.argv[1:2] == ["--train-time"] and len(sys.argv) > 2:
        phase_train_time([Path(t).resolve() for t in sys.argv[2:]])
        log("train time done", seconds=time.perf_counter() - t_start)
        return 0
    if sys.argv[1:] == ["--tp-trace"]:
        tp_trace(torch.cuda.device_count())
        log("tp trace done", seconds=time.perf_counter() - t_start)
        return 0
    if sys.argv[1:] == ["--commands"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_cli(Path(tmp) / "cli")
            t0 = time.perf_counter()
            phase_commands(Path(tmp) / "cli")
        log("commands done", seconds=time.perf_counter() - t_start,
            phase_17_s=time.perf_counter() - t0)
        return 0
    if sys.argv[1:] == ["--cross-device"]:
        cfg = load_config("serving/ATC.yml")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_cross_device(Path(tmp), cfg)
        log("cross-device done", seconds=time.perf_counter() - t_start)
        return 0
    if sys.argv[1:] == ["--drills"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            t0 = time.perf_counter()
            phase_drills(Path(tmp))
            t1 = time.perf_counter()
            phase_drills_full(Path(tmp))
        log("drills done", seconds=time.perf_counter() - t_start, phase_18_s=t1 - t0,
            drills_s=time.perf_counter() - t1)
        return 0
    if sys.argv[1:] == ["--multihost"]:
        if torch.cuda.device_count() < 4:
            raise SystemExit("--multihost needs four cards (a process a card)")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_multihost(Path(tmp))
        log("multihost done", seconds=time.perf_counter() - t_start)
        return 0
    if sys.argv[1:] == ["--geometries"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            t0 = time.perf_counter()
            paths = phase_geometries(Path(tmp))
            t1 = time.perf_counter()
            geometry_tools(Path(tmp))
        log("geometries done", seconds=time.perf_counter() - t_start, phase_19_s=t1 - t0,
            tools_s=time.perf_counter() - t1, paths=sorted(paths))
        return 0
    if sys.argv[1:] == ["--parallel"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            phase_cli(Path(tmp) / "cli")
            t0 = time.perf_counter()
            phase_parallel(Path(tmp) / "cli", samples=True)
        log("parallel done", seconds=time.perf_counter() - t_start,
            phase_16_s=time.perf_counter() - t0)
        return 0
    cfg = load_config("serving/ATC.yml")
    if sys.argv[1:2] == ["--serving"]:
        import crowdmod_tpu_torch

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serving_paths(Path(tmp), cfg, end_to_end=False)
        log("serving done", seconds=time.perf_counter() - t_start,
            package=str(Path(crowdmod_tpu_torch.__file__).parent))
        return 0
    seconds = {"build": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log("phase done", name=name, seconds=seconds[name],
            since_start=time.perf_counter() - t_start)
        return out

    kernels = timed("2 kernels", phase_kernels)
    unet = timed("2 unet kernels", phase_unet_kernels)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = timed("3-8 serving", serving_paths, Path(tmp), cfg, True)
        e2e = paths.pop("e2e")
        for arch in ("DDPM-DiT", "DDPM-UNet"):
            paths[f"train {arch}"] = timed(f"9 {arch}", phase_training, arch,
                                           Path(tmp) / arch)["path_launches"]
        paths.update(timed("10 cli", phase_cli, Path(tmp) / "cli"))
        paths.update(timed("10 cli fm", phase_cli_fm, Path(tmp) / "cli_fm"))
        paths.update(timed("11 fm", phase_fm, Path(tmp), cfg))
        paths.update(timed("12 fast", phase_fast, Path(tmp), cfg))
        paths.update(timed("13 convrnn", phase_convrnn, Path(tmp), cfg))
        paths.update(timed("14 deploy", phase_deploy, Path(tmp), cfg))
        paths.update(timed("15 data", phase_data, Path(tmp)))
        paths.update(timed("16 parallel", phase_parallel, Path(tmp) / "cli"))
        # The training drill's processes run beside phase 17 and the soak.
        drill = start_drill(Path(tmp))
        paths.update(timed("17 commands", phase_commands, Path(tmp) / "cli"))
        paths.update(timed("18 drills", phase_drills, Path(tmp), drill))
        paths.update(timed("19 geometries", phase_geometries, Path(tmp)))
    launches = {k: sum(p[k] for p in paths.values()) for k in paths["DDPM-DiT"]}
    launches["conv3d_same_tapgemm"] += e2e["tapgemm_path_launches"]
    log("launches on the paths", **launches)
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")

    # The serving paths compute in bf16 on the card (TPU.COMPUTE_DTYPE), so
    # each kernel is reported at a batch-64 shape in bf16: the DiT's spatial
    # attention, the UNet's final norm, its level-0 64->64 conv and its
    # widest fused block (dec_0_0, 96->32).
    measured = {
        "fused_attention": kernels["attention"]["spatial_b64_bfloat16"],
        "fused_ancestral_update": kernels["step"]["b64_sparsity"],
        "fused_group_norm": unet["gn"]["L0_C32_True_bfloat16"],
        "conv3d_same_im2col": unet["conv"]["im2col_L0_64_64_bfloat16"],
        "conv3d_same_tapgemm": unet["conv"]["tapgemm_L0_64_64_bfloat16"],
        "fused_resblock": unet["resblock"]["96_32_bfloat16"],
    }
    line = {"kernels": [kernel_entry(n, "cuda", measured[n], launches[n])
                        for n in measured]}
    log("done", seconds=time.perf_counter() - t_start, phase_seconds=seconds,
        paths=sorted(paths))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
