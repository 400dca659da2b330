"""ReFlow entry point (the JAX package's ``cli/reflow.py``): rectify a trained
flow-matching model for few-step Euler sampling.

The rectified ``RF<n>`` checkpoint samples through the ordinary surfaces
(``generate-metrics --model-sample-to-load RF1``, ``load_predictor(...,
epoch_tag="RF1")``); set a small step count to cash in the straightened
trajectories, e.g. ``MODEL.FM.INTEGRATOR_STEPS.EULER: 4``.  The last log line
gives the kernel launches of the run.

    python -m crowdmod_tpu_torch.cli reflow --arch FM-DiT --rounds 1 \\
        --config-yml-file ATC.yml --configList-yml-file ATC_datafiles.yml
"""

from __future__ import annotations

import json
import logging
import os

from crowdmod_tpu_torch.cli import common_parser, setup_logging


def build_parser():
    p = common_parser("Rectify a trained FM model (ReFlow).")
    p.add_argument("--rounds", type=int, default=1,
                   help="Rectification rounds (1 is usually enough).")
    p.add_argument("--coupling-steps", type=int, default=100,
                   help="Teacher Euler steps when generating coupled pairs.")
    p.add_argument("--epochs-per-round", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--model-to-load", type=str, default="000",
                   help="Teacher checkpoint epoch tag; 000 = best-loss.")
    p.add_argument("--save-intermediate", action="store_true",
                   help="Also save each round's rectified checkpoint.")
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.config.validate import require_valid
    from crowdmod_tpu_torch.data.ingest import get_training_dataset
    from crowdmod_tpu_torch.ops.kernels import KERNELS
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.distiller import reflow, reflow_tag
    from crowdmod_tpu_torch.train.trainer import Trainer
    from crowdmod_tpu_torch.utils.tracker import RunTracker

    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    require_valid(cfg, args.arch)
    setup_logging(os.path.join(cfg.DATA_FS.OUTPUT_DIR, "logs", "reflow.log"))

    trainer = Trainer(cfg, args.arch, device=args.device, seed=args.seed)
    path = os.path.join(
        cfg.DATA_FS.SAVE_DIR,
        ckpt.checkpoint_name(cfg, args.arch, args.model_to_load),
    )
    trainer.load(path)
    logging.info("teacher checkpoint restored from %s", path)

    train_ds, _ = get_training_dataset(cfg, trainer.mprops_count, seed=args.seed,
                                       device=trainer.device)
    with RunTracker(trainer.run_dir, config=cfg, use_wandb=False) as tracker:
        history = reflow(
            trainer, train_ds,
            rounds=args.rounds,
            coupling_steps=args.coupling_steps,
            epochs_per_round=args.epochs_per_round,
            lr=args.lr,
            save_dir=cfg.DATA_FS.SAVE_DIR,
            save_intermediate=args.save_intermediate,
            tracker=tracker,
            seed=args.seed,
        )

    final = history["loss"][args.rounds][-1]
    logging.info(
        "reflow complete: %d round(s), final loss %.5f; sample checkpoint "
        "tag %s with a small MODEL.FM.INTEGRATOR_STEPS (e.g. EULER: 4)",
        args.rounds, final, reflow_tag(args.rounds),
    )
    logging.info("kernel launches: %s",
                 json.dumps({fn.__name__: fn.launches for fn in KERNELS}))
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
