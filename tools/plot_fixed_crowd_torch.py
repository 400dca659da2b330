#!/usr/bin/env python
"""Fixed-timestamp crowd plots with the PyTorch port
(``crowdmod_tpu_torch``): raw trajectories + binned macroprops.

Given an aggregated trajectory CSV and a start time, render (a) the raw
pedestrian scatter with the macroprop grid overlaid and (b) the binned
macroprop field (density + velocity quiver + σ circles) for each frame of
one (PAST_LEN+FUTURE_LEN)-window.  The CSV is read with numpy (no pandas),
the frames binned by the native host library.  The JAX tool's flags and
figures, plus ``--device``.

Usage::

    python tools/plot_fixed_crowd_torch.py --config-yml-file configs/ATC.yml \
        --agg-csv datasets/ATC/agg/atc-20121024.csv \
        --t-init "2012-10-24 10:00:00" --out-dir fixed_crowd/
    python tools/plot_fixed_crowd_torch.py --device cpu ...   # no GPU
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-yml-file", default="configs/ATC.yml")
    p.add_argument("--agg-csv", required=True,
                   help="Aggregated trajectory CSV (time, personID, pos, vel).")
    p.add_argument("--t-init", required=True,
                   help="Window start timestamp, e.g. '2012-10-24 10:00:00'.")
    p.add_argument("--out-dir", default="fixed_crowd")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data import etl
    from crowdmod_tpu_torch.native import bin_frames
    from crowdmod_tpu_torch.train.trainer import resolve_device
    from crowdmod_tpu_torch.viz.plot_crowd import Crowd, draw_macroprops, plot_people_density

    resolve_device(args.device)
    cfg = load_config(args.config_yml_file)
    os.makedirs(args.out_dir, exist_ok=True)

    df = etl.read_aggregated_csv(args.agg_csv)
    df, lu = etl.preprocess_trajectories(df, cfg)
    df = etl.filter_by_grid(df, cfg, lu)
    df = etl._rows(df, np.argsort(df["time"], kind="stable"))

    n_frames = cfg.DATASET.PAST_LEN + cfg.DATASET.FUTURE_LEN
    t0 = np.datetime64(args.t_init, "ns")
    frames = etl._frames_from_df(df, t0, n_frames, cfg.MACROPROPS.TIME_RES)

    # Raw crowd scatter with the grid overlaid.
    t_end = t0 + np.timedelta64(int(n_frames * cfg.MACROPROPS.TIME_RES * 1e9), "ns")
    win = etl._rows(df, (df["time"] >= t0) & (df["time"] < t_end))
    plot_people_density(
        win["pos_x"], win["pos_y"], lu,
        f"raw crowd @ {args.t_init} (+{n_frames} frames)",
        save_path=os.path.join(args.out_dir, "raw_crowd.png"),
        grid_hw=(cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS),
        cell=(cfg.MACROPROPS.DX, cfg.MACROPROPS.DY),
    )

    # Per-frame macroprops via the native binner.
    flat = {
        c: np.concatenate([f[c] for f in frames]) if frames else np.zeros(0)
        for c in ("pos_x", "pos_y", "vel_x", "vel_y", "vel_norm")
    }
    offsets = np.concatenate(
        [[0], np.cumsum([len(f["pos_x"]) for f in frames])]
    )
    grids = bin_frames(
        flat["pos_x"], flat["pos_y"], flat["vel_x"], flat["vel_y"],
        flat["vel_norm"], offsets,
        rows=cfg.MACROPROPS.ROWS, cols=cfg.MACROPROPS.COLS,
        dx=cfg.MACROPROPS.DX, dy=cfg.MACROPROPS.DY, lu=lu,
        eps=cfg.MACROPROPS.EPS,
    )

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rho_max = max(float(grids[..., 0].max()), 1.0)
    for t in range(n_frames):
        fig, ax = plt.subplots(figsize=(7, 4), facecolor="white")
        im = draw_macroprops(
            ax, Crowd.from_frame(grids[t]), f"frame {t + 1}/{n_frames}",
            rho_max, draw_unc=True,
        )
        fig.colorbar(im, ax=ax, fraction=0.02)
        fig.savefig(os.path.join(args.out_dir, f"macroprops_f{t + 1}.png"),
                    bbox_inches="tight")
        plt.close(fig)
    print(args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
