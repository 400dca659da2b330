#!/usr/bin/env python
"""Generate the synthetic diagonal-walker dataset pickles with the PyTorch
port (``crowdmod_tpu_torch``).

Draws ``--samples`` random test sequences, saves them as ``true_data.pkl``,
adds the deterministic walker field (forward / backward / both), and saves
``synthetic_data.pkl`` — both in the reference pickle layout ``(B, C, H, W,
L)`` so they interop with the standard ingestion path.  The JAX tool's
flags and pickles (byte for byte for the same arguments), plus
``--device``; the work is numpy on the host.

Usage::

    python tools/generate_synthetic_data_torch.py \
        --config-yml-file configs/ATC.yml \
        --configList-yml-file ATC_datafiles.yml --samples 64 --kind ALL
    python tools/generate_synthetic_data_torch.py --device cpu ...   # no GPU
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-yml-file", default="configs/ATC.yml")
    p.add_argument("--configList-yml-file", default=None)
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--kind", choices=("FORWARD", "BACKWARD", "ALL"),
                   default="ALL")
    p.add_argument("--vel-x", type=float, default=0.8)
    p.add_argument("--row", type=int, default=6)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.ingest import filenames_with_counts, load_pickles
    from crowdmod_tpu_torch.data.synthetic import synthetic_dataset
    from crowdmod_tpu_torch.train.trainer import resolve_device

    resolve_device(args.device)
    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    out_dir = args.out_dir or os.path.join(
        "datasets", f"{cfg.DATASET.NAME}_SYNTHETIC"
    )
    os.makedirs(out_dir, exist_ok=True)

    shape = (cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, cfg.DATASET.RAW_SEQ_LEN)
    raw, _ = load_pickles(filenames_with_counts(cfg), 3, shape)
    rng = np.random.default_rng(args.seed)
    idx = rng.permutation(raw.shape[0])[: args.samples]
    true_native = raw[idx]  # (B, T, H, W, 3)
    synth_native = synthetic_dataset(
        true_native, vel_x=args.vel_x, row=args.row, kind=args.kind
    )

    # Back to the reference pickle layout (B, C, H, W, L).
    to_ref = lambda a: np.ascontiguousarray(np.transpose(a, (0, 4, 2, 3, 1)))  # noqa: E731
    for name, arr in [("true_data", true_native), ("synthetic_data", synth_native)]:
        path = os.path.join(out_dir, f"{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(to_ref(arr), f)
        print(path, arr.shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
