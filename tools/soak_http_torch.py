#!/usr/bin/env python
"""Sustained HTTP serving soak for the port's ``serve`` stack
(``crowdmod_tpu_torch``) on the GPU.

Trains a small DDPM-DiT at the canonical ATC geometry (DDIM divider-10
sampler by default), serves it through the full HTTP path
(:class:`~crowdmod_tpu_torch.cli.serve.ServingApp` + ThreadingHTTPServer +
:class:`~crowdmod_tpu_torch.serving.BatchingQueue`), then hammers it with
concurrent clients for ``--duration`` seconds and reports steady-state
request throughput, client-observed latency percentiles, and coalescing
stats scraped from ``/metrics``.

The reference has no serving layer at all (SURVEY.md §1).

    python tools/soak_http_torch.py --clients 16 --duration 120
    python tools/soak_http_torch.py --config-yml-file serving/ATC.yml \
        --sampler DDIM-eta:1.0:25+Sparsity:0.6 --clients 4 --duration 12 --ramp-s 2
    python tools/soak_http_torch.py --device cpu ...   # no GPU

The trained checkpoint is cached under --workdir, so A/B bucket runs skip
retraining.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def ensure_checkpoint(cfg, arch: str, workdir: str, epochs: int,
                      device) -> str:
    """Train (once) a small model on the walker fixture; return ckpt path."""
    import torch

    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.train.checkpoint import checkpoint_name
    from crowdmod_tpu_torch.train.trainer import Trainer

    path = os.path.join(cfg.DATA_FS.SAVE_DIR, checkpoint_name(cfg, arch, "000"))
    if os.path.isdir(path):
        print(f"reusing checkpoint {path}", flush=True)
        return path
    h, w = int(cfg.MACROPROPS.ROWS), int(cfg.MACROPROPS.COLS)
    raw = synthetic_walkers(128, h, w, 16)
    trainer = Trainer(cfg, arch, run_dir=os.path.join(workdir, "run"),
                      device=device)
    ds = WindowDataset(torch.from_numpy(raw).to(trainer.device), past_len=5,
                       future_len=3, stride=8)
    t0 = time.time()
    trainer.fit(ds, epochs=epochs)
    print(f"trained {arch} {epochs} epochs in {time.time() - t0:.1f}s",
          flush=True)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--req-batch", type=int, default=1,
                   help="sequences per request (raises offered rows/s "
                        "without more client threads)")
    p.add_argument("--duration", type=float, default=120.0)
    p.add_argument("--ramp-s", type=float, default=10.0,
                   help="initial seconds excluded from steady-state stats")
    p.add_argument("--batch-buckets", type=int, nargs="+",
                   default=[1, 8, 64, 256])
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--train-epochs", type=int, default=2)
    p.add_argument("--arch", default="DDPM-DiT")
    p.add_argument("--config-yml-file", default="ATC.yml",
                   help="base config (the CPU smoke test passes 4test/ATC.yml)")
    p.add_argument("--ddim-divider", type=int, default=10)
    p.add_argument("--sampler", default=None,
                   help="override the sampler, e.g. 'DDIM-eta:1.0:25' (the "
                        "quality-pinned serving default, configs/serving/) "
                        "or any MODEL.DDPM.SAMPLER name; default keeps the "
                        "DDIM + --ddim-divider soak configuration")
    p.add_argument("--workdir", default="/tmp/soak_http")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    if args.duration <= args.ramp_s:
        p.error(f"--duration ({args.duration}s) must exceed --ramp-s "
                f"({args.ramp_s}s): no steady-state window to measure")

    from crowdmod_tpu_torch.cli.serve import ServingApp, make_server
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.serving import Predictor
    from crowdmod_tpu_torch.train.trainer import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    arch = args.arch
    if args.sampler:
        from crowdmod_tpu_torch.utils.sampler_spec import sampler_overrides

        sampler_over = sampler_overrides(args.sampler)
    else:
        sampler_over = {"SAMPLER": "DDIM", "DDIM_DIVIDER": args.ddim_divider}
    cfg = load_config(args.config_yml_file).updated({
        "DATA_FS": {"SAVE_DIR": os.path.join(args.workdir, "ckpts"),
                    "OUTPUT_DIR": os.path.join(args.workdir, "out")},
        "MODEL": {"DDPM": {
            **sampler_over,
            "DIT": {"TRAIN": {"EPOCHS": args.train_epochs}},
            "UNET": {"TRAIN": {"EPOCHS": args.train_epochs}},
        }},
    })
    ckpt = ensure_checkpoint(cfg, arch, args.workdir, args.train_epochs,
                             device)

    predictor = Predictor(cfg, arch, ckpt, device=device,
                          batch_buckets=tuple(args.batch_buckets))
    app = ServingApp(predictor, max_delay_ms=args.max_delay_ms)
    server = make_server(app, port=0)
    host, port = server.server_address
    threading.Thread(target=server.serve_forever, daemon=True).start()
    t0 = time.time()
    app.warmup()
    print(f"warmed buckets {tuple(args.batch_buckets)} in "
          f"{time.time() - t0:.1f}s; serving on {host}:{port}", flush=True)
    base = f"http://{host}:{port}"

    p_len, _, h, w, c = predictor.input_spec
    past = np.zeros((args.req_batch, p_len, h, w, c), np.float32)
    past[:, :, h // 2, ::4, 0] = 1.0  # a sparse but non-trivial scene
    body = json.dumps({"past": past.tolist()}).encode()

    records: list[tuple[float, float, bool]] = []  # (t_done, latency_s, ok)
    rec_lock = threading.Lock()
    deadline = time.time() + args.duration

    def client():
        while time.time() < deadline:
            t1 = time.perf_counter()
            ok = True
            try:
                req = urllib.request.Request(f"{base}/predict", data=body)
                with urllib.request.urlopen(req, timeout=60) as resp:
                    resp.read()
                    ok = resp.status == 200
            except (urllib.error.URLError, OSError):  # refused, 5xx, timeout
                ok = False
            with rec_lock:
                records.append((time.time(), time.perf_counter() - t1, ok))

    threads = [threading.Thread(target=client) for _ in range(args.clients)]
    t_start = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    window = time.time() - t_start - args.ramp_s

    steady = [r for r in records if r[0] >= t_start + args.ramp_s]
    lat = np.array([r[1] for r in steady if r[2]])
    errors = sum(1 for r in records if not r[2])
    with urllib.request.urlopen(f"{base}/metrics") as resp:
        metrics = resp.read().decode()
    scraped = {}
    for line in metrics.splitlines():
        if line.startswith("crowdmod_") and " " in line:
            k, v = line.rsplit(" ", 1)
            scraped[k] = float(v)

    report = {
        "clients": args.clients,
        "req_batch": args.req_batch,
        "batch_buckets": list(args.batch_buckets),
        "duration_s": round(args.duration, 1),
        "steady_window_s": round(window, 1),
        "requests_total": len(records),
        "errors": errors,
        "steady_req_per_s": round(len(steady) / window, 2),
        "steady_seq_per_s": round(len(steady) * args.req_batch / window, 2),
        "latency_ms": {
            "p50": round(1e3 * float(np.percentile(lat, 50)), 1),
            "p95": round(1e3 * float(np.percentile(lat, 95)), 1),
            "p99": round(1e3 * float(np.percentile(lat, 99)), 1),
        } if lat.size else None,
        "dispatches": scraped.get("crowdmod_dispatches_total"),
        "coalesced_requests": scraped.get("crowdmod_coalesced_requests_total"),
        # The predictor's sampling calls, warmup included.
        "predictions": scraped.get("crowdmod_requests_total"),
        "sampler": cfg.MODEL.DDPM.SAMPLER,
        "backend": device.type,
    }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    server.shutdown()
    app.close()
    server.server_close()
    return 0 if errors == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
