#!/usr/bin/env python
"""Measure the port's fused resblock kernel against the unfused paths on
one GPU — the twin of ``tools/bench_resblock.py``.

The fused GN→conv→temb→GN→conv→skip kernel (``ops.kernels.fused_resblock``,
``csrc/resblock.cu``) against the unfused PyTorch sequence (cuDNN: what the
JAX tool's XLA op chain is to its kernel) and the port's own unfused
composition of its GroupNorm and im2col kernels, at every (Cin→Cout,
volume) the reference UNet instantiates on the ATC geometry (BASE_CH 32,
mult [1,2,4] — configs/ATC.yml), batch 64, bf16.

Before timing, each case holds the kernel's output against its plain twin
(``resblock_reference``, f32, on the same bf16 inputs) within
2e-2·max|ref|; a case that fails to build, launch or agree raises and the
tool exits non-zero (the JAX tool printed the failure and went on).  The
kernel takes volumes of at least ``MIN_VOLUME`` (128) positions
(``csrc/resblock.cu``: a bf16 tile is whole rows of one sample); ``mid_1``
(2×3×9 = 54) is under it, where the JAX kernel computes: there the tool
says so and times the two unfused paths only (``fused_us`` null).  No model
path fuses a volume under 1024 (``fused_apply.eligible``, the JAX
package's ``_eligible``).

Times: ``ITERS`` calls between CUDA events behind a spin kernel
(``utils/profiling.py::time_calls(queued=True)``), the card's time a call;
nothing is subtracted (the card is local: no dispatch round trip).

Run on the card: ``python tools/bench_resblock_torch.py [--filter dec_0]``.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

B = 64
# Calls between the events: the spin kernel queued ahead must outlast the
# host's issue of them and the launch queue hold them (five launches a
# fused call, more unfused); the JAX tool's 200 ran in one on-device loop.
ITERS = 20
TOL = 2e-2  # bf16, times max|ref|

# (label, Cin, Cout, T, H, W) — every ResnetBlock3D instance of the ATC UNet
# (level-2 attention blocks excluded: the kernel doesn't cover attention).
CASES = [
    ("enc_0_0 32->32 @(8,12,36)", 32, 32, 8, 12, 36),
    ("dec_0_0 96->32 @(8,12,36)", 96, 32, 8, 12, 36),
    ("dec_0_1 64->32 @(8,12,36)", 64, 32, 8, 12, 36),
    ("enc_1_0 32->64 @(4,6,18)", 32, 64, 4, 6, 18),
    ("dec_1_0 192->64 @(4,6,18)", 192, 64, 4, 6, 18),
    ("dec_1_1 96->64 @(4,6,18)", 96, 64, 4, 6, 18),
    ("mid_1 128->128 @(2,3,9)", 128, 128, 2, 3, 9),
]
# The JAX tool's XLA chain → the cuDNN sequence; its fused kernel → ours;
# the port's unfused composition is this tool's own.
REPORT_KEYS = ("backend", "device", "rows")
ROW_KEYS = ("label", "sequence_us", "fused_us", "composition_us", "speedup",
               "tflops", "parity_rel")


def make_weights(gen, cin, cout):
    """The JAX tool's weight dict, drawn from ``gen``; conv weights rounded
    to bf16, so kernel and f32 twin see the same values."""
    import torch

    def n(shape, sc):
        return torch.randn(shape, generator=gen) * sc

    w = {
        "gn1_scale": n((cin,), 0.1) + 1.0,
        "gn1_bias": n((cin,), 0.1),
        "w1": n((3, 3, 3, cin, cout), 0.05),
        "b1": n((cout,), 0.1),
        "gn2_scale": n((cout,), 0.1) + 1.0,
        "gn2_bias": n((cout,), 0.1),
        "w2": n((3, 3, 3, cout, cout), 0.05),
        "b2": n((cout,), 0.1),
    }
    if cin != cout:
        w["w_skip"] = n((1, 1, 1, cin, cout), 0.1)
        w["b_skip"] = n((cout,), 0.1)
    for k in ("w1", "w2", "w_skip"):
        if k in w:
            w[k] = w[k].to(torch.bfloat16).float()
    return w


def resblock_sequence(x, temb, w):
    """The unfused PyTorch sequence of one ResnetBlock3D on ``x``'s memory
    (``F.group_norm``, ``F.silu``, cuDNN ``F.conv3d`` on the NDHWC view
    twice, the skip ``F.linear``), in x's dtype: a yardstick of time for the
    fused kernel, which no single library call computes."""
    import torch
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
    the skip a ``torch.matmul`` (or x), each in x's dtype."""
    import torch

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


def bench_case(label, cin, cout, t, h, wd, device) -> dict:
    import torch

    from crowdmod_tpu_torch.ops.kernels import fused_resblock, resblock_reference
    from crowdmod_tpu_torch.ops.kernels.resblock import MIN_VOLUME, pack_resblock
    from crowdmod_tpu_torch.utils.profiling import time_calls

    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn((B, t, h, wd, cin), generator=gen).to(device, dtype)
    temb = torch.randn((B, cout), generator=gen).to(device, dtype)
    w = {k: v.to(device) for k, v in make_weights(gen, cin, cout).items()}

    def timed(fn):
        return time_calls(fn, reps=3, iters=ITERS, device=device, queued=True)["seconds"]

    row = {"label": label, "sequence_us": 1e6 * timed(resblock_sequence(x0, temb, w)),
           "fused_us": None, "composition_us": 1e6 * timed(resblock_composition(x0, temb, w)),
           "speedup": None, "tflops": None, "parity_rel": None}
    if t * h * wd < MIN_VOLUME:
        print(f"{label:>28}  cuDNN seq {row['sequence_us']:7.1f}us  fused: not taken "
              f"(volume {t * h * wd} < {MIN_VOLUME}, the kernel's least)  unfused kernels "
              f"{row['composition_us']:7.1f}us", flush=True)
        return row
    packed = pack_resblock(w, dtype)
    # Parity gate before the kernel is timed.
    ref = resblock_reference(x0.float(), temb.float(), w)
    out = fused_resblock(x0, temb, w, packed=packed)
    scale = ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    if not (scale > 0 and err <= TOL * scale):
        raise AssertionError(f"{label}: max abs err {err} > {TOL} x {scale}")
    t_fused = timed(lambda: fused_resblock(x0, temb, w, packed=packed))
    flops = 2 * B * t * h * wd * 27 * (cin * cout + cout * cout)
    row.update(fused_us=1e6 * t_fused, speedup=row["sequence_us"] / (1e6 * t_fused),
               tflops=flops / t_fused / 1e12, parity_rel=err / scale)
    print(
        f"{label:>28}  cuDNN seq {row['sequence_us']:7.1f}us  fused {t_fused*1e6:7.1f}us  "
        f"unfused kernels {row['composition_us']:7.1f}us  speedup {row['speedup']:5.2f}x  "
        f"(fused {row['tflops']:5.1f} TF/s-eff, parity rel {err / scale:.1e})",
        flush=True,
    )
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--filter", default="", help="substring case filter")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from crowdmod_tpu_torch.train.trainer import resolve_device
    from crowdmod_tpu_torch.utils.profiling import card_identity

    device = resolve_device(args.device)
    ident = card_identity() if device.type == "cuda" else "cpu"
    cases = [c for c in CASES if args.filter in c[0]]
    print(f"backend={device.type}  device={ident}  B={B}  iters={ITERS}  bf16",
          flush=True)
    rows = [bench_case(*case, device) for case in cases]
    fused = [r for r in rows if r["fused_us"] is not None]
    totals = [sum(r[k] for r in fused) for k in ("sequence_us", "fused_us", "composition_us")]
    print(f"{'TOTAL (fused blocks)':>28}  cuDNN seq {totals[0]:7.1f}us  "
          f"fused {totals[1]:7.1f}us  unfused kernels {totals[2]:7.1f}us", flush=True)
    print(json.dumps({"backend": device.type, "device": ident, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
