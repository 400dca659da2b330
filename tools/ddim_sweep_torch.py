#!/usr/bin/env python
"""DDIM-divider sweep: sampling + metrics across step-count reductions, with
the PyTorch port (``crowdmod_tpu_torch``) on the GPU.

The JAX tool's flags, output tree and log, plus ``--device``.  The divider
is a config *override* — no file mutation — and each divider writes into
its own output directory, ready for the λ/model HTML viewers and
compare_models tooling.

Usage::

    python tools/ddim_sweep_torch.py --config-yml-file configs/ATC.yml \
        --configList-yml-file configs/ATC_datafiles.yml \
        --arch DDPM-UNet --dividers 2 4 5 10 20 50 100 200 300
    python tools/ddim_sweep_torch.py --device cpu ...   # no GPU
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

DEFAULT_DIVIDERS = (2, 4, 5, 10, 20, 50, 100, 200, 300)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-yml-file", required=True)
    p.add_argument("--configList-yml-file", default=None)
    p.add_argument("--arch", default="DDPM-UNet")
    p.add_argument("--dividers", nargs="*", type=int,
                   default=list(DEFAULT_DIVIDERS))
    p.add_argument("--model-sample-to-load", default="000")
    p.add_argument("--metric", default="ALL")
    p.add_argument("--chunk-repd-past-seq", type=int, default=None)
    p.add_argument("--batches-to-use", type=int, default=1)
    p.add_argument("--skip-samples", action="store_true")
    p.add_argument("--skip-metrics", action="store_true")
    p.add_argument("--output-root", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    import yaml

    from crowdmod_tpu_torch.cli import generate_metrics, generate_samples, setup_logging
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.train.trainer import resolve_device

    resolve_device(args.device)
    base = load_config(args.config_yml_file, args.configList_yml_file)
    root = args.output_root or os.path.join(
        base.DATA_FS.OUTPUT_DIR, "ddim_sweep", args.arch
    )
    os.makedirs(root, exist_ok=True)
    setup_logging(os.path.join(root, "sweep.log"))

    for divider in args.dividers:
        logging.info("=== DDIM divider %d ===", divider)
        cfg = base.updated({
            "MODEL": {"DDPM": {"SAMPLER": "DDIM", "DDIM_DIVIDER": divider}}
        })
        # The commands read config files: the override is written once per
        # divider beside its outputs.
        cfg_path = os.path.join(root, f"cfg_ddim{divider}.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg.to_dict(), f)
        common = [
            "--config-yml-file", cfg_path,
            "--arch", args.arch,
            "--model-sample-to-load", args.model_sample_to_load,
            "--device", args.device,
        ]
        out_dir = os.path.join(root, f"DDIM_{divider}")
        if not args.skip_samples:
            rc = generate_samples.run(
                common + ["--plot-type", "Dynamic", "--output-dir", out_dir]
            )
            if rc:
                return rc
        if not args.skip_metrics:
            extra = ["--metric", args.metric,
                     "--batches-to-use", str(args.batches_to_use),
                     "--output-dir", out_dir]
            if args.chunk_repd_past_seq:
                extra += ["--chunk-repd-past-seq", str(args.chunk_repd_past_seq)]
            rc = generate_metrics.run(common + extra)
            if rc:
                return rc
    logging.info("sweep artifacts under %s", root)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
