"""``python -m crowdmod_tpu_torch.cli import-checkpoint`` — migrate a
reference torch checkpoint so the port's commands can serve it (port of the
JAX package's ``cli/import_checkpoint.py``).

Point it at the ``.pt`` file the reference's ``save_checkpoint`` wrote; it
writes a port checkpoint (``state.pt`` + ``metadata.json``, with
``"source": "torch-import:<abs path>"``) under ``DATA_FS.SAVE_DIR`` with the
name ``serve``, ``generate-metrics`` and ``load_predictor`` resolve for the
epoch label.  The config and arch must be the ones the torch model was
trained with: every key and shape is held against a freshly built port
model and each mismatch is reported before anything is written.  The
checkpoint holds the weights only; loading it seeds the EMA from them, as
the JAX import does.
"""

from __future__ import annotations

import logging
import os

from crowdmod_tpu_torch.cli import common_parser, setup_logging


def build_parser():
    p = common_parser("Import a reference torch checkpoint.")
    p.add_argument("--torch-ckpt", type=str, required=True,
                   help="Path to the reference .pt checkpoint file.")
    p.add_argument("--epoch-label", type=str, default="000",
                   help="Epoch tag for the imported checkpoint name "
                        "(000 = the best-loss slot).")
    p.add_argument("--out-dir", type=str, default=None,
                   help="Override DATA_FS.SAVE_DIR as the destination.")
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from crowdmod_tpu_torch.compat.torch_import import import_torch_checkpoint
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.config.validate import require_valid
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    require_valid(cfg, args.arch)
    setup_logging(os.path.join(cfg.DATA_FS.OUTPUT_DIR, "logs", "importCkpt.log"))

    trainer = Trainer(cfg, args.arch, device=args.device, seed=args.seed)
    sd = import_torch_checkpoint(args.torch_ckpt, args.arch, trainer.params)
    trainer.model.load_state_dict(sd)  # a last check: the model takes it
    path = os.path.join(args.out_dir or cfg.DATA_FS.SAVE_DIR,
                        ckpt.checkpoint_name(cfg, args.arch, args.epoch_label))
    meta = ckpt.build_metadata(
        cfg, args.arch, args.epoch_label,
        extra={"source": f"torch-import:{os.path.abspath(args.torch_ckpt)}"},
    )
    ckpt.save_checkpoint(path, {"params": trainer.params}, meta)
    logging.info("imported %s -> %s", args.torch_ckpt, path)
    print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
