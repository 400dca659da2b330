#!/usr/bin/env python
"""Streaming-input soak of the PyTorch port (``crowdmod_tpu_torch``) on the
GPU: train through a corpus bigger than you'd ever hold resident, one file
at a time.

Generates (once) N pickle files of synthetic macroprops in the reference
layout, then runs a full epoch of ``FileWindowStream → device_prefetch →
train step`` (DDPM-UNet at the ATC width) and reports throughput plus how
completely file IO was hidden behind compute: the loader thread's read
seconds against the seconds the train loop waited for its next batch.  Use
``--gb`` to size the corpus (files are ~510 MB each at the default
``--per-file``); peak host memory stays at ~2 files regardless of corpus
size.

    python tools/soak_stream_torch.py --gb 6
    python tools/soak_stream_torch.py --device cpu --gb 0.001 --per-file 4 --batch 4
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def ensure_corpus(root: str, n_files: int, n_per: int, h: int, w: int,
                  L: int) -> list[str]:
    os.makedirs(root, exist_ok=True)
    paths = []
    rng = np.random.default_rng(0)
    for k in range(n_files):
        p = os.path.join(root, f"soak{k}.pkl")
        if not os.path.exists(p):
            t0 = time.perf_counter()
            arr = np.abs(
                rng.normal(size=(n_per, 4, h, w, L))
            ).astype(np.float32)
            with open(p, "wb") as f:
                pickle.dump(arr, f, protocol=4)
            print(f"  wrote {p} ({arr.nbytes/1e6:.0f} MB, "
                  f"{time.perf_counter()-t0:.1f}s)", flush=True)
        paths.append(p)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gb", type=float, default=2.0,
                    help="approximate corpus size to generate/stream")
    ap.add_argument("--dir", type=str, default="/tmp/crowdmod_soak")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--per-file", type=int, default=4608,
                    help="sequences a file (4608: ~510 MB)")
    ap.add_argument("--out", default=None, help="write a JSON report here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import torch

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.prefetch import FileWindowStream
    from crowdmod_tpu_torch.ops.kernels import KERNELS, reset_launch_counts
    from crowdmod_tpu_torch.train.trainer import StepDraws, Trainer, resolve_device

    device = resolve_device(args.device)
    h, w, L = 12, 36, 16
    per_sample = 4 * h * w * L * 4                      # bytes
    n_per = args.per_file
    n_files = max(1, round(args.gb * 1e9 / (n_per * per_sample)))
    print(f"corpus: {n_files} files x {n_per*per_sample/1e6:.0f} MB "
          f"({n_files*n_per*per_sample/1e9:.1f} GB)")
    files = ensure_corpus(args.dir, n_files, n_per, h, w, L)

    b, p_len, f_len = args.batch, 5, 3
    # configs/ATC.yml's DDPM-UNet (base 32, mults 1-2-4, attention at level
    # 2, dropout 0.1, T = 1000 at scale 0.5), Adam 1e-4 without decay; bf16
    # on the card, float32 on the CPU.
    cfg = load_config("ATC.yml").updated({
        "DATA_FS": {"SAVE_DIR": os.path.join(args.dir, "ckpts"),
                    "OUTPUT_DIR": os.path.join(args.dir, "out")},
        "DATASET": {"BATCH_SIZE": b},
        "MODEL": {"DDPM": {"UNET": {"TRAIN": {"SOLVER": {
            "LR": 1e-4, "BETAS": [0.9, 0.999], "WEIGHT_DECAY": 0.0}}}}},
    })
    trainer = Trainer(cfg, "DDPM-UNet", device=device, seed=0,
                      run_dir=os.path.join(args.dir, "run")).setup()
    gen = torch.Generator(device=device).manual_seed(1)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    past0 = torch.zeros((b, p_len, h, w, 3), device=device)
    fut0 = torch.zeros((b, f_len, h, w, 3), device=device)
    t0 = time.perf_counter()
    trainer._train_step((past0, fut0), StepDraws(generator=gen))
    sync()
    first_step_s = time.perf_counter() - t0
    print(f"first step: {first_step_s:.1f}s", flush=True)

    class TimedStream(FileWindowStream):
        """The stream, with its loader thread's file-read seconds."""

        io_s = 0.0

        def _load_host(self, path):
            t1 = time.perf_counter()
            arr = super()._load_host(path)
            self.io_s += time.perf_counter() - t1
            return arr

    stream = TimedStream(
        files, past_len=p_len, future_len=f_len, stride=args.stride,
        mprops_count=3, device=device,
    )
    reset_launch_counts()
    nb, wait_s, loss = 0, 0.0, None
    t0 = time.perf_counter()
    batches = stream.batches(b, shuffle=True)
    while True:
        t1 = time.perf_counter()
        batch = next(batches, None)
        wait_s += time.perf_counter() - t1
        if batch is None:
            break
        loss = trainer._train_step(batch, StepDraws(generator=gen))
        nb += 1
        if nb % 200 == 0:
            print(f"  {nb} batches...", flush=True)
    sync()
    wall = time.perf_counter() - t0
    final_loss = float(loss) if loss is not None else float("nan")
    print(f"streamed epoch: {nb} batches ({nb*b:,} samples) in {wall:.1f}s "
          f"= {nb*b/wall:,.0f} samples/s; final loss {final_loss:.4f}")
    report = {
        "files": n_files,
        "corpus_gb": n_files * n_per * per_sample / 1e9,
        "batches": nb,
        "samples": nb * b,
        "wall_s": wall,
        "samples_per_s": nb * b / wall,
        "first_step_s": first_step_s,
        "final_loss": final_loss,
        # The loader reads file k+1 while file k trains: the loop waits only
        # for the first file and for reads slower than a file's training.
        "io_s": stream.io_s,
        "stall_s": wait_s,
        "hidden_io_share": (max(0.0, 1.0 - wait_s / stream.io_s)
                            if stream.io_s > 0 else None),
        "launches": {fn.__name__: fn.launches for fn in KERNELS},
        "backend": device.type,
    }
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0 if nb and np.isfinite(final_loss) else 1


if __name__ == "__main__":
    raise SystemExit(main())
