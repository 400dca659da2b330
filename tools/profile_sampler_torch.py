#!/usr/bin/env python
"""Sampler performance lab of the port: measure the knob that matters on
the card — the twin of ``tools/profile_sampler.py``.

Measures end-to-end 1000-step ancestral-sampling throughput of the
reference UNet (``bench_torch.py``'s, bf16 on the card, batch 64) for each
conv kernel (``--conv``: ``im2col`` or ``tapgemm``, the
``UNet3D(conv_impl=)`` choice; the JAX tool's ``direct``/``split_t``/
``fold_t`` XLA lowerings have no counterpart), each chain through
``Trainer.sample`` as a request runs it.

The JAX tool's other two knobs have no counterpart, by design: ``--pallas
off|compiled`` (the port routes a kernel by the tensor's device only,
with no switch: ROADMAP.md, "Kernels") and ``--unroll`` (eager PyTorch has
no scan to unroll).

Timing (``utils/profiling.py::time_calls``): a warm-up chain, one chain
under ``torch.profiler``, then ``--reps`` chains between CUDA events;
nothing is subtracted (the card is local: no dispatch round trip in the
time).  Each rate carries its busy share (the card's kernel seconds of a
warm chain over the timed chain's); the report, the card's name and power
limit (``device``).

Usage::

    python tools/profile_sampler_torch.py                  # default sweep
    python tools/profile_sampler_torch.py --quick          # one config, T=200
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

REPORT_KEYS = ("rows", "best")
ADDED_KEYS = ("device",)


def measure(conv_impl: str, timesteps: int, reps: int, device) -> dict:
    from bench_torch import bench_config, bench_trainer
    from bench_torch import measure as chains

    trainer = bench_trainer(bench_config(timesteps), "DDPM-UNet", device,
                            conv_impl=conv_impl)
    return chains(trainer, reps=reps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--timesteps", type=int, default=None)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--conv", nargs="*", default=None, choices=["im2col", "tapgemm"])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    from crowdmod_tpu_torch.train.trainer import resolve_device
    from crowdmod_tpu_torch.utils.profiling import card_identity

    device = resolve_device(args.device)
    timesteps = args.timesteps or (200 if args.quick else 1000)
    conv_opts = args.conv or (["im2col"] if args.quick else ["im2col", "tapgemm"])

    rows, best = [], (None, 0.0)
    for cv in conv_opts:
        r = measure(cv, timesteps, args.reps, device)
        tag = f"conv={cv}"
        print(f"{tag}: {r['steps_per_sec']:.0f} denoise steps/s "
              f"(busy {r['busy_share']})", flush=True)
        rows.append({"conv": cv, "timesteps": timesteps, **r})
        if r["steps_per_sec"] > best[1]:
            best = (tag, r["steps_per_sec"])
    print(f"best: {best[0]} @ {best[1]:.0f} steps/s")
    print(json.dumps({"rows": rows, "best": best[0],
                      "device": card_identity() if device.type == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
