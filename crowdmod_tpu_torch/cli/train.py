"""Training entry point (the JAX package's ``cli/train.py``).

Trains DDPM-UNet, DDPM-DiT, FM-UNet, FM-DiT or ConvRNN (which reads all 4
channels of the pickles) through :class:`~crowdmod_tpu_torch.train.
trainer.Trainer` on the config's macroprop pickles, logging through
:class:`~crowdmod_tpu_torch.utils.tracker.RunTracker` (``events.jsonl`` and
``config.json`` in the run directory) and keeping the best-loss checkpoint
under ``DATA_FS.SAVE_DIR``; a log line gives the kernel launches of the
run.  The JAX command's loss-curve plot
(``losses.png``) waits for the plotting module (ROADMAP.md Queue 1 item
17), its parallel flags for item 16.  Exit status 1 when the NaN watchdog
aborts the run.

    python -m crowdmod_tpu_torch.cli train --arch DDPM-DiT \\
        --config-yml-file ATC.yml --configList-yml-file ATC_datafiles.yml
"""

from __future__ import annotations

import json
import logging
import os

from crowdmod_tpu_torch.cli import common_parser, setup_logging


def build_parser():
    p = common_parser("Train a crowd macroprop model on the GPU.")
    p.add_argument(
        "--baseline-ckpt", type=str, default=None,
        help="Warm-start model weights from this checkpoint "
             "(optimizer state is NOT restored).",
    )
    p.add_argument("--epochs", type=int, default=None,
                   help="Override the config's epoch budget.")
    p.add_argument("--resume", action="store_true",
                   help="Resume model state from the emergency 'abort' "
                        "checkpoint if one exists.")
    p.add_argument("--run-dir", type=str, default=None)
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.config.validate import require_valid
    from crowdmod_tpu_torch.data.ingest import get_training_dataset
    from crowdmod_tpu_torch.ops.kernels import KERNELS
    from crowdmod_tpu_torch.train.trainer import Trainer
    from crowdmod_tpu_torch.utils.tracker import RunTracker

    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    require_valid(cfg, args.arch)
    setup_logging(os.path.join(cfg.DATA_FS.OUTPUT_DIR, "logs", "train.log"))

    trainer = Trainer(cfg, args.arch, device=args.device, run_dir=args.run_dir,
                      seed=args.seed)
    if args.resume and trainer.resume_from_abort():
        logging.info("resumed from emergency checkpoint")
    mprops = trainer.mprops_count
    logging.info("loading training data (mprops_count=%d) onto %s", mprops,
                 trainer.device)
    train_ds, val_ds = get_training_dataset(cfg, mprops, seed=args.seed,
                                            device=trainer.device)
    logging.info("train windows: %d, val windows: %d",
                 len(train_ds), len(val_ds) if val_ds else 0)

    with RunTracker(trainer.run_dir, config=cfg) as tracker:
        history = trainer.fit(
            train_ds, val_ds,
            baseline_ckpt=args.baseline_ckpt,
            epochs=args.epochs,
            tracker=tracker,
        )
    logging.info("kernel launches: %s",
                 json.dumps({fn.__name__: fn.launches for fn in KERNELS}))
    logging.info("losses.png not written: plots are not ported yet "
                 "(ROADMAP.md Queue 1 item 17); the losses are in %s",
                 os.path.join(trainer.run_dir, "events.jsonl"))
    if history.get("aborted"):
        logging.error(
            "training ABORTED (NaN watchdog); checkpoints in %s are from "
            "before the divergence", cfg.DATA_FS.SAVE_DIR,
        )
        return 1
    logging.info("training done; best checkpoints in %s", cfg.DATA_FS.SAVE_DIR)
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
