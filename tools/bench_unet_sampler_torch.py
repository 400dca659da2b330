#!/usr/bin/env python
"""UNet ancestral-sampler perf lab of the port on one GPU — the twin of
``tools/bench_unet_sampler.py``.

A 4096³ bf16 GEMM calibration must read below the card's published dense
bf16 peak (:data:`PEAK_BF16_TFLOPS`, keyed on the name ``nvidia-smi``
gives; a card the table does not know is refused) or the run is rejected:
a rate above it means the timing is broken.  Then a table of the UNet's
conv shapes (µs a conv: cuDNN f32 and bf16, the port's im2col kernel f32
and bf16) and the T-step ancestral sampler for each conv kernel
(``--impls``: ``im2col``, ``tapgemm``, the ``UNet3D(conv_impl=)`` choice;
the JAX tool's ``direct``/``pallas`` lowerings have no counterpart) and
dtype, through ``Trainer.sample`` as a request runs it.

Timing (``utils/profiling.py::time_calls``): the GEMMs and convs between
CUDA events behind a spin kernel (the card's time, not the host's); each
chain after a warm-up and a profiled chain, between CUDA events, with its
busy share (the profiled chain's kernel seconds over the chain's).
Nothing is subtracted: the card is local, so there is no dispatch round
trip to remove (the JAX tool looped on a remote TPU and subtracted one).  A failing kernel or sampler
raises: the tool exits non-zero (the JAX tool printed the failure and went
on).

Run alone on the card — concurrent work invalidates every number.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Published dense bf16 tensor-core peaks (NVIDIA data sheets), TFLOP/s, by
# the name nvidia-smi gives: the H100 SXM.
PEAK_BF16_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}
CONV_CASES = [
    ("L0 first", (8, 12, 36), 3, 32),
    ("L0 rb", (8, 12, 36), 32, 32),
    ("L0 dec-cat", (8, 12, 36), 96, 32),
    ("L1 rb", (4, 6, 18), 64, 64),
    ("L2 rb", (2, 3, 9), 128, 128),
]
# The JAX tool's conv-table columns → this tool's: XLA's conv → cuDNN's,
# Pallas → the port's kernel.
COLUMNS = {"xla32": "cudnn32", "xla16": "cudnn16", "pl32": "kern32", "pl16": "kern16"}
REPORT_KEYS = ("backend", "device", "calibration", "conv_table", "samplers")


def card_peak(identity: str) -> float:
    """The published dense bf16 peak of the card ``nvidia-smi`` names in
    ``identity`` ("name, power limit"); raises for a card not in the
    table."""
    name = identity.split(",")[0].strip()
    if name not in PEAK_BF16_TFLOPS:
        raise SystemExit(f"calibration: no published bf16 peak for {name!r} "
                         f"(known: {sorted(PEAK_BF16_TFLOPS)}); refusing to time")
    return PEAK_BF16_TFLOPS[name]


def calibrate(device) -> dict:
    import torch

    from crowdmod_tpu_torch.utils.profiling import card_identity, time_calls

    peak = card_peak(card_identity() or "")
    n, iters = 4096, 50
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((n, n), generator=gen).to(device, torch.bfloat16)
    b = (torch.randn((n, n), generator=gen) / n ** 0.5).to(device, torch.bfloat16)

    def loop():
        acc = a
        for _ in range(iters):
            acc = acc @ b
        return acc

    dt = time_calls(loop, reps=3, device=device, queued=True)["seconds"] / iters
    tf = 2 * n ** 3 / dt / 1e12
    print(f"CALIBRATION bf16 {n}^3 GEMM: {dt*1e6:.0f}us = {tf:.0f} TF/s "
          f"(sane iff < {peak})", flush=True)
    if tf > peak:
        raise SystemExit("calibration exceeds the card's peak — timing broken")
    return {"gemm_us": dt * 1e6, "tflops": tf, "peak_tflops": peak}


def conv_table(device) -> list:
    import torch
    import torch.nn.functional as F

    from crowdmod_tpu_torch.ops.kernels import conv3d_same_im2col
    from crowdmod_tpu_torch.ops.kernels.conv3d import pack_im2col
    from crowdmod_tpu_torch.utils.profiling import time_calls

    gen = torch.Generator().manual_seed(0)
    b, iters = 64, 30
    print(f"{'case':>11} {'shape':>11} {'Cin->Cout':>9}   "
          f"cudnn32  cudnn16  kern32   kern16   (us/conv)", flush=True)
    rows = []
    for name, (t, h, w), cin, cout in CONV_CASES:
        x = torch.randn((b, t, h, w, cin), generator=gen).to(device)
        k = (0.1 * torch.randn((3, 3, 3, cin, cout), generator=gen)).to(device)
        us = {}
        for bits, dtype in (("32", torch.float32), ("16", torch.bfloat16)):
            xd, kd = x.to(dtype), k.to(dtype)
            wp = pack_im2col(kd)
            xc = xd.permute(0, 4, 1, 2, 3)
            kc = kd.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
            for key, fn in ((f"cudnn{bits}", lambda: F.conv3d(xc, kc, padding=1)),
                            (f"kern{bits}", lambda: conv3d_same_im2col(xd, wp))):
                us[key] = 1e6 * time_calls(fn, reps=2, iters=iters, device=device,
                                           queued=True)["seconds"]
        print(f"{name:>11} {str((t, h, w)):>11} {cin:>4}->{cout:<4}"
              + " ".join(f"{us[k]:8.1f}" for k in COLUMNS.values()),
              flush=True)
        rows.append({"case": name, "shape": [b, t, h, w], "cin": cin, "cout": cout, "us": us})
    return rows


def sampler(dname: str, conv_impl: str, timesteps: int, device, reps: int = 3) -> dict:
    import torch

    from bench_torch import bench_config, bench_trainer, measure

    dtype = getattr(torch, dname)
    cfg = bench_config(timesteps)
    trainer = bench_trainer(cfg, "DDPM-UNet", device, conv_impl=conv_impl,
                            compute_dtype=dtype if device.type == "cuda" else torch.float32)
    r = measure(trainer, reps=reps)
    print(f"SAMPLER dtype={dname:>9} conv={conv_impl:>7} T={timesteps}: "
          f"{r['steps_per_sec']:,.0f} steps/s ({r['chain_s']*1e3:.0f} ms/chain, "
          f"busy {r['busy_share']})", flush=True)
    return {"dtype": dname, "conv": conv_impl, "timesteps": timesteps, **r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timesteps", type=int, default=1000)
    ap.add_argument("--skip-table", action="store_true")
    ap.add_argument("--impls", nargs="*", default=["im2col", "tapgemm"],
                    choices=["im2col", "tapgemm"])
    ap.add_argument("--dtypes", nargs="*", default=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from crowdmod_tpu_torch.train.trainer import resolve_device
    from crowdmod_tpu_torch.utils.profiling import card_identity

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    ident = card_identity() if on_card else "cpu"
    print("backend:", device.type, "device:", ident, flush=True)
    report = {"backend": device.type, "device": ident,
              "calibration": calibrate(device) if on_card else None,
              "conv_table": None if args.skip_table else conv_table(device),
              "samplers": [sampler(d, impl, args.timesteps, device)
                           for d in args.dtypes for impl in args.impls]}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
