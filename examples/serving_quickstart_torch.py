#!/usr/bin/env python
"""Serving quickstart of the PyTorch port: train a small model, serve it
over HTTP, query it.

Covers the production inference surface the reference lacks entirely
(SURVEY.md §1 — its control flow ends at CLI scripts):

  1. train a DDPM on the synthetic walker fixture,
  2. stand up the bucketed predictor behind the HTTP server
     (micro-batching queue, readiness probe, Prometheus metrics),
  3. fire concurrent requests and read back predictions + metrics.

    python examples/serving_quickstart_torch.py                # on the GPU
    python examples/serving_quickstart_torch.py --device cpu   # anywhere
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from crowdmod_tpu_torch.cli.serve import ServingApp, make_server  # noqa: E402
from crowdmod_tpu_torch.config import load_config  # noqa: E402
from crowdmod_tpu_torch.data.synthetic import synthetic_walkers  # noqa: E402
from crowdmod_tpu_torch.data.windows import WindowDataset  # noqa: E402
from crowdmod_tpu_torch.serving import Predictor  # noqa: E402
from crowdmod_tpu_torch.train.checkpoint import checkpoint_name  # noqa: E402
from crowdmod_tpu_torch.train.trainer import Trainer  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--timesteps", type=int, default=50)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "serve_qs"))
    args = p.parse_args(argv)

    h, w = 8, 12
    cfg = load_config("4test/ATC.yml").updated({
        "DATA_FS": {"SAVE_DIR": os.path.join(args.out, "ckpts"),
                    "OUTPUT_DIR": os.path.join(args.out, "out")},
        "DATASET": {"BATCH_SIZE": 16},
        "MACROPROPS": {"ROWS": h, "COLS": w},
        "MODEL": {"DDPM": {"TIMESTEPS": args.timesteps,
                           "UNET": {"BASE_CH": 16, "BASE_CH_MULT": [1, 2],
                                    "APPLY_ATTENTION": [False, False],
                                    "TRAIN": {"EPOCHS": args.epochs}}}},
    })

    # 1. Train on the walker fixture and checkpoint.
    trainer = Trainer(cfg, "DDPM-UNet", device=args.device,
                      run_dir=os.path.join(args.out, "run"))
    raw = synthetic_walkers(24, h, w, 16)
    ds = WindowDataset(torch.from_numpy(raw).to(trainer.device), past_len=5,
                       future_len=3, stride=8)
    trainer.fit(ds)  # saves best checkpoint "000" into SAVE_DIR

    # 2. Serve it.  warmup() runs each batch bucket once before /healthz
    #    flips to ready; max_delay_ms is the micro-batching window.
    ckpt = os.path.join(
        cfg.DATA_FS.SAVE_DIR, checkpoint_name(cfg, "DDPM-UNet", "000")
    )
    predictor = Predictor(cfg, "DDPM-UNet", ckpt, device=args.device,
                          batch_buckets=(1, 8))
    app = ServingApp(predictor, max_delay_ms=3.0).warmup()
    server = make_server(app, port=0)          # port=0 → pick a free port
    host, port = server.server_address
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://{host}:{port}"
    print(f"serving on {base}")

    # 3. Concurrent clients: these coalesce into shared device dispatches.
    past, _ = ds.gather(np.arange(4))
    past = past.cpu().numpy()
    results = [None] * 4

    def client(i):
        req = urllib.request.Request(
            f"{base}/predict",
            data=json.dumps({"past": past[i:i + 1].tolist()}).encode(),
        )
        with urllib.request.urlopen(req) as resp:
            results[i] = json.loads(resp.read())

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    for i, r in enumerate(results):
        fut = np.asarray(r["future"])
        print(f"request {i}: future {fut.shape}, "
              f"latency {r['latency_ms']:.0f} ms")

    with urllib.request.urlopen(f"{base}/metrics") as r:
        print("--- /metrics ---")
        print(r.read().decode())
    server.shutdown()
    app.close()
    server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
