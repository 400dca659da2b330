#!/usr/bin/env python
"""Direct-path serving latency of the port across samplers, on one GPU —
the twin of ``tools/bench_serving.py``.

Measures :class:`crowdmod_tpu_torch.serving.Predictor` end-to-end request
latency (host→device, full reverse chain, device→host) per batch bucket,
for each requested sampler, after training the model ``--train-epochs``
on synthetic walkers (``tools/soak_http_torch.py::ensure_checkpoint``) —
so the quality-pinned serving default (DDIM-eta η=1.0, 25 steps,
``configs/serving/``) is benchmarked as the configuration the quality
study validated.

Each bucket's latency comes from ``utils/profiling.py::time_calls``, as
every bench twin's time: after ``Predictor.warmup`` has run every bucket
once, one request under ``torch.profiler`` gives the card's kernel seconds
of a warm request, then ``--reps`` requests, each between two CUDA events
recorded after a synchronize (``predict`` returns host arrays, so the end
event follows the read back: what a caller waits for).  Nothing is
subtracted: the card is local, so no dispatch round trip sits in it (the
JAX tool's targets were remote TPUs).  Beside each p50, ``busy_share``: the
kernel seconds of the profiled request over the p50 — serving is
host-bound where it is well under 1.

``--workdir`` defaults to a new directory under the temporary directory,
so no two runs serve each other's checkpoint.

    python tools/bench_serving_torch.py --samplers DDIM-eta:1.0:25 DPM-Solver DDPM
    python tools/bench_serving_torch.py --quick   # smoke: 4test config, 3 reps, batch 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

REPORT_KEYS = ("backend", "arch", "reps", "samplers")
SAMPLER_KEYS = ("warmup_s", "buckets")
BUCKET_KEYS = ("p50_ms", "p95_ms", "samples_per_sec")
ADDED_KEYS = ("device",)
ADDED_BUCKET_KEYS = ("busy_share",)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samplers", nargs="+",
                   default=["DDIM-eta:1.0:25", "DPM-Solver", "DDPM"])
    p.add_argument("--arch", default="DDPM-DiT")
    p.add_argument("--config-yml-file", default="ATC.yml")
    p.add_argument("--batches", type=int, nargs="+", default=[8, 64])
    p.add_argument("--reps", type=int, default=30)
    p.add_argument("--train-epochs", type=int, default=2)
    p.add_argument("--workdir", default=None,
                   help="checkpoint and output directory (default: a new one)")
    p.add_argument("--quick", action="store_true",
                   help="smoke run: 4test config, 3 reps, batch 8 only")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    from crowdmod_tpu_torch.train.trainer import resolve_device

    device = resolve_device(args.device)
    if args.quick:
        args.config_yml_file = "4test/ATC.yml"
        args.reps = 3
        args.batches = [8]

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.serving import Predictor
    from crowdmod_tpu_torch.utils.profiling import card_identity, time_calls
    from crowdmod_tpu_torch.utils.sampler_spec import sampler_overrides
    from tools.soak_http_torch import ensure_checkpoint

    args.workdir = args.workdir or tempfile.mkdtemp(prefix="bench_serving_")
    os.makedirs(args.workdir, exist_ok=True)
    base = load_config(args.config_yml_file).updated({
        "DATA_FS": {"SAVE_DIR": os.path.join(args.workdir, "ckpts"),
                    "OUTPUT_DIR": os.path.join(args.workdir, "out")},
        "MODEL": {"DDPM": {
            "DIT": {"TRAIN": {"EPOCHS": args.train_epochs}},
            "UNET": {"TRAIN": {"EPOCHS": args.train_epochs}},
        }},
    })
    ckpt = ensure_checkpoint(base, args.arch, args.workdir, args.train_epochs, device)

    on_card = device.type == "cuda"
    results = {"backend": device.type, "arch": args.arch, "reps": args.reps,
               "samplers": {}, "device": card_identity() if on_card else "cpu"}
    for spec in args.samplers:
        cfg = base.updated({"MODEL": {"DDPM": sampler_overrides(spec)}})
        predictor = Predictor(cfg, args.arch, ckpt, device=device,
                              batch_buckets=tuple(args.batches))
        t0 = time.time()
        predictor.warmup()
        warm_s = time.time() - t0
        p_len, _, h, w, c = predictor.input_spec
        per_bucket = {}
        for b in args.batches:
            past = np.zeros((b, p_len, h, w, c), np.float32)
            past[:, :, h // 2, ::4, 0] = 1.0
            t = time_calls(lambda: predictor.predict(past), reps=args.reps,
                           device=device, warmup=False)
            lat = np.asarray(t["reps_s"])
            p50 = float(np.median(lat))
            busy = t["kernel_s"] / p50 if on_card else None
            per_bucket[str(b)] = {
                "p50_ms": round(1e3 * p50, 1),
                "p95_ms": round(1e3 * float(np.percentile(lat, 95)), 1),
                "samples_per_sec": round(b / p50, 1),
                "busy_share": busy,
            }
            print(f"{spec} @batch {b}: p50 {per_bucket[str(b)]['p50_ms']} ms"
                  f" = {per_bucket[str(b)]['samples_per_sec']} samples/s"
                  f" (busy {busy})", flush=True)
        results["samplers"][spec] = {"warmup_s": round(warm_s, 1),
                                     "buckets": per_bucket}
        # Release this sampler's trainer (weights, packs) before the next.
        del predictor
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
