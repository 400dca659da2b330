"""Training entry point (the JAX package's ``cli/train.py``).

Trains DDPM-UNet, DDPM-DiT, FM-UNet, FM-DiT or ConvRNN (which reads all 4
channels of the pickles) through :class:`~crowdmod_tpu_torch.train.
trainer.Trainer` on the config's macroprop pickles, logging through
:class:`~crowdmod_tpu_torch.utils.tracker.RunTracker` (``events.jsonl`` and
``config.json`` in the run directory) and keeping the best-loss checkpoint
under ``DATA_FS.SAVE_DIR``; a log line gives the kernel launches of the
run, another each step's loss and milliseconds (``Trainer.fit``'s
history).  The JAX command's loss-curve plot (``losses.png``) waits for
the plotting module (ROADMAP.md Queue 1 item 17).  Exit status 1 when
the NaN watchdog aborts the run.

Data parallelism (:mod:`crowdmod_tpu_torch.parallel.launch`):
``--data-parallel`` trains with DDP on one process a card of this host (on
``--device cpu``, a world of one over gloo), ``--fsdp`` shards parameters,
Adam moments and EMA (FSDP), ``--multihost`` joins a launch made outside
(``CROWDMOD_*`` variables or torchrun).  ``DATASET.BATCH_SIZE`` stays the
global batch.  Process 0 owns the run directory and commits the
checkpoints; process N logs to ``train.pN.log`` and tracks into
``<run_dir>/.procN``.  ``--model-parallel N`` (with ``--data-parallel``)
adds tensor parallelism: a ("data", "model") mesh of world/N × N, the
model's large weights cut over the model axis (``TPU.MESH.MODEL`` and
``TPU.MESH.DATA`` when the flag is absent; on ``--device cpu`` the spawn
makes one process a mesh position).

    python -m crowdmod_tpu_torch.cli train --arch DDPM-DiT \\
        --config-yml-file ATC.yml --configList-yml-file ATC_datafiles.yml
"""

from __future__ import annotations

import json
import logging
import os
import sys

from crowdmod_tpu_torch.cli import common_parser, setup_logging
from crowdmod_tpu_torch.parallel import launch, multiprocess, tensor

COMMAND = "crowdmod_tpu_torch.cli.train"


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
    p.add_argument("--data-parallel", action="store_true",
                   help="Data-parallel training (DDP): one process a card of "
                        "this host, the global batch split over them.")
    p.add_argument("--fsdp", action="store_true",
                   help="With --data-parallel: also shard parameters, Adam "
                        "moments and EMA over the processes (FSDP).")
    p.add_argument("--model-parallel", type=int, default=None, metavar="N",
                   help="With --data-parallel: tensor parallelism over N "
                        "processes (the mesh's \"model\" axis; overrides "
                        "TPU.MESH.MODEL).")
    p.add_argument("--multihost", action="store_true",
                   help="With --data-parallel: join a launch made outside "
                        "(CROWDMOD_COORDINATOR/NUM_PROCESSES/PROCESS_ID, or "
                        "torchrun) instead of spawning a process a card; "
                        "every process runs this same command.")
    return p


def run(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    code = launch.check_flags(args)
    if code is not None:
        return code
    if args.data_parallel:
        from crowdmod_tpu_torch.config import load_config
        from crowdmod_tpu_torch.parallel.mesh import mesh_shape

        cfg = load_config(args.config_yml_file, args.configList_yml_file)
        data, model = mesh_shape(cfg, args.model_parallel)
        return launch.run_ranks(COMMAND, argv, args.device, args.multihost,
                                data=data, model=model)
    from crowdmod_tpu_torch.train.trainer import resolve_device

    return run_rank(args, resolve_device(args.device))


def run_rank(args, device) -> int:
    """The command on one process (all of it without --data-parallel)."""
    import torch

    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.config.validate import require_valid
    from crowdmod_tpu_torch.data.ingest import get_training_dataset
    from crowdmod_tpu_torch.ops.kernels import KERNELS
    from crowdmod_tpu_torch.train.trainer import Trainer
    from crowdmod_tpu_torch.utils.tracker import RunTracker

    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    require_valid(cfg, args.arch)
    rank = multiprocess.process_index()
    log_name = f"train.p{rank}.log" if args.data_parallel else "train.log"
    setup_logging(os.path.join(cfg.DATA_FS.OUTPUT_DIR, "logs", log_name))

    mesh, run_dir = None, args.run_dir
    if args.data_parallel:
        from crowdmod_tpu_torch.parallel.mesh import mesh_from_config

        mesh = mesh_from_config(cfg, args.model_parallel)
        logging.info("data parallel: process %d/%d (%s) on %s, mesh %s, %s", rank,
                     multiprocess.process_count(), multiprocess.backend(), device,
                     tuple(mesh.shape), "FSDP" if args.fsdp else "DDP")
        logging.info("mesh: %s, this process at (data %d, model %d)",
                     dict(zip(mesh.mesh_dim_names, mesh.shape)),
                     mesh["data"].get_local_rank(), mesh["model"].get_local_rank())
        if rank:
            # One writer: process 0 owns the run directory, the others
            # track beside it.
            base = run_dir or os.path.join(cfg.DATA_FS.OUTPUT_DIR, "runs", args.arch)
            run_dir = os.path.join(base, f".proc{rank}")
    trainer = Trainer(cfg, args.arch, device=device, run_dir=run_dir, seed=args.seed,
                      mesh=mesh, param_sharding="fsdp" if args.fsdp else "tp")
    if args.resume and trainer.resume_from_abort():
        logging.info("resumed from emergency checkpoint")
    mprops = trainer.mprops_count
    logging.info("loading training data (mprops_count=%d) onto %s", mprops,
                 trainer.device)
    train_ds, val_ds = get_training_dataset(cfg, mprops, seed=args.seed,
                                            device=trainer.device)
    logging.info("train windows: %d, val windows: %d",
                 len(train_ds), len(val_ds) if val_ds else 0)

    if trainer.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(trainer.device)
    with RunTracker(trainer.run_dir, config=cfg) as tracker:
        history = trainer.fit(
            train_ds, val_ds,
            baseline_ckpt=args.baseline_ckpt,
            epochs=args.epochs,
            tracker=tracker,
        )
    peak = (torch.cuda.max_memory_allocated(trainer.device) / 2**30
            if trainer.device.type == "cuda" else None)
    if mesh is not None and mesh["model"].size() > 1:
        # Every rank of a model group computes the uncut layers alike: their
        # parameters must not have parted.
        agree = tensor.uncut_agree(trainer.model)
        logging.info("model group: %s", json.dumps({
            "mesh": list(mesh.shape), "cut": len(tensor.model_shards(trainer.model)),
            "uncut_equal": agree}))
        if not agree:
            raise RuntimeError("the uncut parameters parted within a model group")
    logging.info("train steps: %s", json.dumps({
        "step_loss": history.get("step_loss"), "step_ms": history.get("step_ms"),
        "peak_memory_gb": peak}))
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
