#!/usr/bin/env python
"""Measure the port's im2col Conv3D kernel against cuDNN on one GPU — the
twin of ``tools/bench_conv_kernel.py``.

A table of µs/conv and effective TF/s for each (Cin, Cout) level of the
reference UNet at the ATC sampling workload (B=64, 3×12×36 grid, the 64-
and 128-channel levels at their halved volumes): cuDNN (``F.conv3d`` on
the same channels-last memory, PyTorch's default TF32 setting for the f32
column) against the port's kernel (``ops.kernels.conv3d_same_im2col``,
f32 and bf16).  XLA's ``direct`` conv of the JAX tool has no counterpart
(``crowdmod_tpu_torch/ops/conv3d.py``); cuDNN takes its place as the
library call.

Before any time is taken, each kernel output is held against the kernel's
plain twin (``conv3d_same_reference``) on the same inputs: f32 within
1e-4·max|ref|, bf16 (the bf16 inputs, the twin in f32) within
2e-2·max|ref|.  A kernel that fails to build, launch or agree raises: the
tool exits non-zero (the JAX tool printed NaN and went on).

Times: each variant's calls ``ITERS`` at a time between CUDA events, behind
a spin kernel so the host has issued them first
(``utils/profiling.py::time_calls(queued=True)``): the card's time a call,
not the host's.  Nothing is subtracted (the card is local).

Run on the card: ``python tools/bench_conv_kernel_torch.py``.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

B, T, H, W = 64, 3, 12, 36
SHAPES = [(32, 32), (64, 32), (96, 32), (3, 32), (64, 64), (128, 128)]
ITERS = 50
TOL = {"f32": 1e-4, "bf16": 2e-2}  # times max|ref|
# The JAX tool's columns → this tool's: XLA's conv → cuDNN's, Pallas → the
# port's kernel.
COLUMNS = {"xla32": "cudnn32", "xla16": "cudnn16", "pl32": "kernel32", "pl16": "kernel16"}
REPORT_KEYS = ("backend", "device", "rows")
ROW_KEYS = ("cin", "cout", "shape", "us", "tflops", "err")


def volume(cin: int, cout: int) -> tuple[int, int, int]:
    """64-ch levels run at T,H,W/2; 128 at /4 — the real volumes."""
    scale = 1 if cout <= 32 else (2 if cout == 64 else 4)
    return max(T // scale, 1), H // scale, W // scale


def bench_shape(cin: int, cout: int, device, gen) -> dict:
    import torch
    import torch.nn.functional as F

    from crowdmod_tpu_torch.ops.kernels import conv3d_same_im2col, conv3d_same_reference
    from crowdmod_tpu_torch.ops.kernels.conv3d import pack_im2col
    from crowdmod_tpu_torch.utils.profiling import time_calls

    tt, hh, ww = volume(cin, cout)
    x = torch.randn((B, tt, hh, ww, cin), generator=gen).to(device)
    k = (0.1 * torch.randn((3, 3, 3, cin, cout), generator=gen)).to(device)
    flops = 2 * B * tt * hh * ww * 27 * cin * cout
    res, err = {}, {}
    for bits, dtype in (("32", torch.float32), ("16", torch.bfloat16)):
        xd, kd = x.to(dtype), k.to(dtype)
        wp = pack_im2col(kd)
        xc = xd.permute(0, 4, 1, 2, 3)
        kc = kd.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        out = conv3d_same_im2col(xd, wp)
        ref = conv3d_same_reference(xd.float(), kd.float())
        scale = ref.abs().max().item()
        e = (out.float() - ref).abs().max().item()
        tol = TOL["f32" if bits == "32" else "bf16"]
        if not (scale > 0 and e <= tol * scale):
            raise AssertionError(f"conv {cin}->{cout} {dtype}: max abs err {e} > "
                                 f"{tol} x {scale}")
        err[f"kernel{bits}"] = e / scale
        for name, fn in ((f"cudnn{bits}", lambda: F.conv3d(xc, kc, padding=1)),
                         (f"kernel{bits}", lambda: conv3d_same_im2col(xd, wp))):
            res[name] = time_calls(fn, reps=3, iters=ITERS, device=device,
                                   queued=True)["seconds"]
    return {"cin": cin, "cout": cout, "shape": [B, tt, hh, ww],
            "us": {n: 1e6 * s for n, s in res.items()},
            "tflops": {n: flops / s / 1e12 for n, s in res.items()},
            "err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import torch

    from crowdmod_tpu_torch.train.trainer import resolve_device
    from crowdmod_tpu_torch.utils.profiling import card_identity

    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    ident = card_identity() if device.type == "cuda" else "cpu"
    print(f"B={B} vol=({T},{H},{W})  iters={ITERS}  backend={device.type}  "
          f"device={ident}")
    print(f"{'Cin->Cout':>10} {'cuDNN f32':>9} {'cuDNN bf16':>9} "
          f"{'kernel f32':>10} {'kernel bf16':>11}  (µs, eff TF/s)")
    rows = []
    for cin, cout in SHAPES:
        row = bench_shape(cin, cout, device, gen)
        rows.append(row)
        line = f"{cin:>6}->{cout:<3}"
        for key in COLUMNS.values():
            line += f" {row['us'][key]:7.1f}({row['tflops'][key]:5.1f})"
        print(line + f"  |err/max|ref|: f32 {row['err']['kernel32']:.2e} "
              f"bf16 {row['err']['kernel16']:.2e}", flush=True)
    print(json.dumps({"backend": device.type, "device": ident, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
