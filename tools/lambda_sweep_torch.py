#!/usr/bin/env python
"""Guidance-λ ablation sweep with the PyTorch port (``crowdmod_tpu_torch``):
sample with a ladder of LAMBDA_GUIDANCE values.

Producer side of the λ comparison viewer
(``python -m crowdmod_tpu_torch.cli view <root> --mode lambda``): for each
λ, samples with sparsity guidance into ``<root>/run_lambda_<λ>/`` so the
synchronized HTML grid can compare the ablation.  The JAX tool's flags and
output tree, plus ``--device``.

    python tools/lambda_sweep_torch.py --config-yml-file configs/ATC.yml \
        --arch DDPM-UNet --lambdas 0.0 0.001 0.004 0.01
    python tools/lambda_sweep_torch.py --device cpu ...   # no GPU
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-yml-file", required=True)
    p.add_argument("--configList-yml-file", default=None)
    p.add_argument("--arch", default="DDPM-UNet")
    p.add_argument("--lambdas", nargs="*", type=float,
                   default=[0.0, 0.001, 0.004, 0.01])
    p.add_argument("--guidance", default="Sparsity",
                   choices=("Sparsity", "mass_preservation"))
    p.add_argument("--model-sample-to-load", default="000")
    p.add_argument("--output-root", default=None)
    p.add_argument("--view", action="store_true",
                   help="Emit the synchronized HTML viewer afterwards.")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    from crowdmod_tpu_torch.cli import generate_samples, setup_logging
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.train.trainer import resolve_device

    resolve_device(args.device)
    base = load_config(args.config_yml_file, args.configList_yml_file)
    root = args.output_root or os.path.join(
        base.DATA_FS.OUTPUT_DIR, "lambda_sweep", args.arch
    )
    os.makedirs(root, exist_ok=True)
    setup_logging(os.path.join(root, "sweep.log"))

    for lam in args.lambdas:
        logging.info("=== lambda %g ===", lam)
        cfg = base.updated({"MODEL": {"DDPM": {
            "GUIDANCE": args.guidance, "LAMBDA_GUIDANCE": lam,
        }}})
        cfg_path = os.path.join(root, f"cfg_lambda_{lam}.yml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg.to_dict(), f)
        out_dir = os.path.join(root, f"run_lambda_{lam}")
        rc = generate_samples.run([
            "--config-yml-file", cfg_path,
            "--arch", args.arch,
            "--model-sample-to-load", args.model_sample_to_load,
            "--plot-type", "Dynamic",
            "--output-dir", out_dir,
            "--device", args.device,
        ])
        if rc:
            return rc

    if args.view:
        from crowdmod_tpu_torch.viz.html_viewer import run as view_run

        view_run([root, "--mode", "lambda",
                  "--output", os.path.join(root, "lambda_viewer.html")])
    logging.info("lambda sweep artifacts under %s", root)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
