"""Offline ETL command: raw sensor CSVs → aggregated CSVs → macroprop pickles
(port of the JAX package's ``cli/etl.py``, the same flags and exit codes).

One command chaining the three offline stages:

  * 500 ms per-pedestrian aggregation;
  * preprocess → LU filter → bin (on ``--device``) → sliding windows → a
    pickle a file;
  * per-file sample counting → the DATA_LIST yml;

so the raw-trajectory → trainable-pickle chain is one invocation:

    python -m crowdmod_tpu_torch.cli etl --config-yml-file configs/ATC.yml \\
        --raw-dir datasets/raw --pickle-dir datasets/pickle \\
        --data-list-out configs/ATC_datafiles.yml

Directories default to DATA_FS.{RAW_DATA_DIR,AGG_DATA_DIR,PICKLE_DIR}.
``--skip-aggregate`` starts from already-aggregated CSVs in --agg-dir.  Each
file's stage seconds are logged as ``etl stages <file>: {json}``.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import time

from crowdmod_tpu_torch.cli import common_parser, setup_logging


def build_parser():
    p = common_parser(__doc__)
    p.add_argument("--raw-dir", type=str, default=None,
                   help="Raw headerless ATC sensor CSVs (default "
                        "DATA_FS.RAW_DATA_DIR).")
    p.add_argument("--agg-dir", type=str, default=None,
                   help="Aggregated-CSV directory (default "
                        "DATA_FS.AGG_DATA_DIR).")
    p.add_argument("--pickle-dir", type=str, default=None,
                   help="Output macroprop pickles (default "
                        "DATA_FS.PICKLE_DIR).")
    p.add_argument("--data-list-out", type=str, default=None,
                   help="Write the DATA_LIST yml of per-file sample counts "
                        "here.")
    p.add_argument("--files", nargs="*", default=None,
                   help="Specific CSV filenames (default: every *.csv in "
                        "the input directory).")
    p.add_argument("--skip-aggregate", action="store_true",
                   help="Inputs in --agg-dir are already aggregated.")
    return p


def _require_dir(path, what, how) -> bool:
    if not path:
        logging.error("no %s dir: set %s", what, how)
        return False
    if not os.path.isdir(path):
        logging.error("%s dir %s does not exist (%s)", what, path, how)
        return False
    return True


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data import etl
    from crowdmod_tpu_torch.train.trainer import resolve_device

    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    setup_logging(os.path.join(cfg.DATA_FS.OUTPUT_DIR, "logs", "etl.log"))
    device = resolve_device(args.device)

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    agg_dir = args.agg_dir or cfg.DATA_FS.AGG_DATA_DIR
    pkl_dir = args.pickle_dir or cfg.DATA_FS.PICKLE_DIR
    if not pkl_dir:
        logging.error("no pickle dir: set DATA_FS.PICKLE_DIR or --pickle-dir")
        return 2
    os.makedirs(pkl_dir, exist_ok=True)

    aggregate_s = 0.0
    if not args.skip_aggregate:
        raw_dir = args.raw_dir or cfg.DATA_FS.RAW_DATA_DIR
        if not _require_dir(raw_dir, "raw", "DATA_FS.RAW_DATA_DIR or --raw-dir "
                                            "(or pass --skip-aggregate)"):
            return 2
        files = args.files or sorted(f for f in os.listdir(raw_dir) if f.endswith(".csv"))
        if not agg_dir:
            logging.error("no agg dir: set DATA_FS.AGG_DATA_DIR or --agg-dir")
            return 2
        logging.info("aggregating %d raw files %s → %s", len(files), raw_dir, agg_dir)
        t0 = time.perf_counter()
        etl.aggregate_atc_files(cfg, files, in_dir=raw_dir, out_dir=agg_dir)
        aggregate_s = time.perf_counter() - t0
    else:
        if not _require_dir(agg_dir, "agg", "DATA_FS.AGG_DATA_DIR or --agg-dir"):
            return 2
        files = args.files or sorted(f for f in os.listdir(agg_dir) if f.endswith(".csv"))

    total = 0
    for fn in files:
        t0 = time.perf_counter()
        df = etl.read_aggregated_csv(os.path.join(agg_dir, fn))
        t1 = time.perf_counter()
        pre, rlu = etl.preprocess_trajectories(df, cfg)
        filt = etl.filter_by_grid(pre, cfg, rlu)
        t2 = synced()
        frames = etl.macroprop_frames(filt, cfg, rlu, t_init=pre["time"].min(),
                                      t_final=pre["time"].max(), device=device)
        t3 = synced()
        seqs = etl.macroprop_windows(frames, cfg)
        out = os.path.join(pkl_dir, os.path.splitext(fn)[0] + ".pkl")
        with open(out, "wb") as f:
            pickle.dump(etl.to_reference_pickle_layout(seqs), f)
        t4 = time.perf_counter()
        total += len(seqs)
        logging.info("%s: %d windows of %s → %s", fn, len(seqs), seqs.shape[1:], out)
        logging.info("etl stages %s: %s", fn, json.dumps({
            "rows": len(df["time"]), "frames": int(frames.shape[0]), "windows": len(seqs),
            "read_s": t1 - t0, "preprocess_s": t2 - t1, "bin_s": t3 - t2,
            "windows_s": t4 - t3}))

    entries = etl.count_samples(pkl_dir, args.data_list_out)
    logging.info("aggregate: %.3f s", aggregate_s)
    logging.info("ETL done: %d windows across %d pickles%s", total, len(entries),
                 f"; DATA_LIST → {args.data_list_out}" if args.data_list_out else "")
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
