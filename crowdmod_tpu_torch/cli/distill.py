"""Progressive-distillation entry point (the JAX package's ``cli/distill.py``).

Restores a trained DDPM checkpoint, runs the halving phases of
:func:`~crowdmod_tpu_torch.train.distiller.progressive_distill` on the
training data, and saves the few-step student under the ``D<steps>``
checkpoint tag.  Sample it through the ordinary surfaces
(``generate-metrics --model-sample-to-load D008``, ``load_predictor(...,
epoch_tag="D008")``) with ``MODEL.DDPM.SAMPLER: Distilled`` and
``DISTILL_STEPS`` set to the student's step count.  The last log line gives
the kernel launches of the run.

    python -m crowdmod_tpu_torch.cli distill --arch DDPM-DiT --steps 8 \\
        --config-yml-file ATC.yml --configList-yml-file ATC_datafiles.yml
"""

from __future__ import annotations

import json
import logging
import os

from crowdmod_tpu_torch.cli import common_parser, setup_logging


def build_parser():
    p = common_parser("Distill a trained DDPM into a few-step sampler.")
    p.add_argument("--steps", type=int, default=8,
                   help="Target sampler step count for the final student.")
    p.add_argument("--start-steps", type=int, default=64,
                   help="First student's step count; must be a power-of-two "
                        "multiple of --steps.")
    p.add_argument("--epochs-per-phase", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--model-to-load", type=str, default="000",
                   help="Teacher checkpoint epoch tag; 000 = best-loss.")
    p.add_argument("--save-intermediate", action="store_true",
                   help="Also save each phase's student checkpoint.")
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.config.validate import require_valid
    from crowdmod_tpu_torch.data.ingest import get_training_dataset
    from crowdmod_tpu_torch.ops.kernels import KERNELS
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.distiller import distilled_tag, progressive_distill
    from crowdmod_tpu_torch.train.trainer import Trainer
    from crowdmod_tpu_torch.utils.tracker import RunTracker

    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    require_valid(cfg, args.arch)
    setup_logging(os.path.join(cfg.DATA_FS.OUTPUT_DIR, "logs", "distill.log"))

    trainer = Trainer(cfg, args.arch, device=args.device, seed=args.seed)
    path = os.path.join(
        cfg.DATA_FS.SAVE_DIR,
        ckpt.checkpoint_name(cfg, args.arch, args.model_to_load),
    )
    trainer.load(path)
    logging.info("teacher checkpoint restored from %s", path)

    train_ds, _ = get_training_dataset(cfg, trainer.mprops_count, seed=args.seed,
                                       device=trainer.device)
    with RunTracker(trainer.run_dir, config=cfg) as tracker:
        history = progressive_distill(
            trainer, train_ds,
            target_steps=args.steps,
            start_steps=args.start_steps,
            epochs_per_phase=args.epochs_per_phase,
            lr=args.lr,
            save_dir=cfg.DATA_FS.SAVE_DIR,
            save_intermediate=args.save_intermediate,
            tracker=tracker,
            seed=args.seed,
        )

    final = history["loss"][args.steps][-1]
    logging.info(
        "distillation complete: %s -> %d steps (final loss %.5f); sample "
        "with MODEL.DDPM.SAMPLER=Distilled DISTILL_STEPS=%d, checkpoint "
        "tag %s",
        " -> ".join(str(n) for n in history["phases"]), args.steps, final,
        args.steps, distilled_tag(args.steps),
    )
    logging.info("kernel launches: %s",
                 json.dumps({fn.__name__: fn.launches for fn in KERNELS}))
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
