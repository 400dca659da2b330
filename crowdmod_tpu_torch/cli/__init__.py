"""Command-line entry points of the port (the JAX package's ``cli``).

``python -m crowdmod_tpu_torch.cli <command> ...`` runs:

  * ``train``            — train DDPM-UNet, DDPM-DiT, FM-UNet, FM-DiT or ConvRNN on
    the macroprop pickles of a config's DATA_LIST;
  * ``generate-metrics`` — the repeated-past protocol and the metric suite
    of a trained checkpoint → CSVs and the ``metrics_files.json`` manifest;
  * ``reflow``           — rectify a trained FM model (ReFlow) → its ``RF<n>``
    checkpoint, which samples in a few Euler steps;
  * ``distill``          — progressively distill a trained DDPM → its
    ``D<steps>`` checkpoint, which samples with the Distilled sampler;
  * ``serve``            — HTTP inference server (batching, health, metrics),
    from checkpoints or from exported artifacts (``--artifact``);
  * ``export``           — the configured sampler as ``torch.export``
    artifacts, one a batch bucket, that call the port's kernels;
  * ``import-checkpoint`` — migrate a reference torch checkpoint into a port
    checkpoint that ``serve`` and ``generate-metrics`` resolve;
  * ``params``           — trainable parameters per architecture;
  * ``etl``              — raw trajectory CSVs → aggregated CSVs → macroprop
    pickles (binned on the device) and their DATA_LIST;
  * ``generate-samples`` — sample a trained model on the device and draw the
    static SVG grid or the GIFs (overlay metrics computed on the device)
    and the density curves;
  * ``sweep``            — random-search hyperparameter sweeps;
  * ``compare``          — cross-model metric comparison figures;
  * ``view``             — the synchronized HTML GIF viewer;
  * ``doctor``           — deployment environment self-check.

Each runs on the GPU unless given ``--device cpu`` (``compare`` and ``view``
run on the host only).  The plots need matplotlib: ``generate-samples``
exits 2 without it, ``train`` and ``generate-metrics`` skip their PNGs and
log why.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import os
import sys

COMMANDS = {
    "train": "crowdmod_tpu_torch.cli.train",
    "generate-metrics": "crowdmod_tpu_torch.cli.generate_metrics",
    "reflow": "crowdmod_tpu_torch.cli.reflow",
    "distill": "crowdmod_tpu_torch.cli.distill",
    "serve": "crowdmod_tpu_torch.cli.serve",
    "export": "crowdmod_tpu_torch.export_artifact",
    "import-checkpoint": "crowdmod_tpu_torch.cli.import_checkpoint",
    "params": "crowdmod_tpu_torch.utils.model_info",
    "etl": "crowdmod_tpu_torch.cli.etl",
    "generate-samples": "crowdmod_tpu_torch.cli.generate_samples",
    "sweep": "crowdmod_tpu_torch.cli.sweep",
    "compare": "crowdmod_tpu_torch.viz.compare_models",
    "view": "crowdmod_tpu_torch.viz.html_viewer",
    "doctor": "crowdmod_tpu_torch.cli.doctor",
}


def common_parser(description: str) -> argparse.ArgumentParser:
    """Flags shared by every entry point."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument(
        "--config-yml-file", type=str, default="configs/4test/ATC.yml",
        help="Configuration YML file for specific dataset.",
    )
    p.add_argument(
        "--configList-yml-file", type=str, default=None,
        help="Optional YML with the DATA_LIST of macroprop pickles.",
    )
    p.add_argument(
        "--arch", type=str, default="DDPM-UNet",
        help="DDPM-UNet|DDPM-DiT|FM-UNet|FM-DiT|ConvRNN",
    )
    p.add_argument("--seed", type=int, default=42)
    p.add_argument(
        "--device", type=str, default="cuda",
        help="cuda (the default; raises without a GPU) or cpu.",
    )
    return p


def setup_logging(logfile: str | None = None):
    handlers = [logging.StreamHandler(sys.stdout)]
    if logfile:
        os.makedirs(os.path.dirname(logfile) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(logfile))
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=handlers,
        force=True,
    )


def main(argv: list[str] | None = None) -> int:
    """Dispatch ``python -m crowdmod_tpu_torch.cli <command> ...``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m crowdmod_tpu_torch.cli {"
              + ",".join(COMMANDS) + "} [args...]")
        return 0
    cmd = argv.pop(0)
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; expected one of {list(COMMANDS)}",
              file=sys.stderr)
        return 2
    return importlib.import_module(COMMANDS[cmd]).run(argv) or 0
