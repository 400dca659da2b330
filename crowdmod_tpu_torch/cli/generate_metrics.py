"""Metrics entry point (the JAX package's ``cli/generate_metrics.py``).

Runs the repeated-past protocol (``BATCH_SIZE × chunk`` samples a batch)
with a trained checkpoint and the metric suite, writing the CSVs and the
``metrics_files.json`` manifest under the JAX package's names.  The
boxplot PNGs wait for the plotting module (ROADMAP.md Queue 1 item 17).
The last log line gives the kernel launches of the run.

``--data-parallel`` samples each protocol batch split over one process a
card of this host (gloo and one process on ``--device cpu``), the samples
gathered on every process and the metric suite run on each; ``--multihost``
joins a launch made outside (``CROWDMOD_*`` variables or torchrun).
Process 0 writes the CSVs and the manifest; process N writes its own into
``<output-dir>/.procN`` (a cross-process agreement check) and logs to
``genMetrics.pN.log``.

    python -m crowdmod_tpu_torch.cli generate-metrics --arch DDPM-DiT \\
        --metric ALL --chunk-repd-past-seq 20 --batches-to-use 1
"""

from __future__ import annotations

import json
import logging
import os

import sys

from crowdmod_tpu_torch.cli import common_parser, setup_logging
from crowdmod_tpu_torch.parallel import launch, multiprocess

COMMAND = "crowdmod_tpu_torch.cli.generate_metrics"


def build_parser():
    p = common_parser("Compute the evaluation-metric suite for a model.")
    p.add_argument(
        "--metric", type=str, default="ALL",
        help="PSNR|MASK_PSNR|SSIM|MF_MSE|MF_BHATT|ENERGY|RE_DENSITY|TV|ALL",
    )
    p.add_argument(
        "--chunk-repd-past-seq", type=int, default=None,
        help="Samples drawn per repeated past sequence "
             "(default cfg.METRICS.CHUNK_REPD_PAST_SEQ or 20).",
    )
    p.add_argument("--batches-to-use", type=int, default=1)
    p.add_argument("--model-sample-to-load", type=str, default="000")
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--sample-weights", choices=("ema", "raw"), default="ema",
                   help="Sample with EMA weights (default) or the raw "
                        "training weights.")
    p.add_argument("--data-parallel", action="store_true",
                   help="Sample each protocol batch split over one process a "
                        "card of this host.")
    p.add_argument("--multihost", action="store_true",
                   help="With --data-parallel: join a launch made outside "
                        "(CROWDMOD_COORDINATOR/NUM_PROCESSES/PROCESS_ID, or "
                        "torchrun); process 0 commits the CSVs and manifest, "
                        "the others write to a .procN directory.")
    return p


def run(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    code = launch.check_flags(args)
    if code is not None:
        return code
    if args.data_parallel:
        return launch.run_ranks(COMMAND, argv, args.device, args.multihost)
    from crowdmod_tpu_torch.train.trainer import resolve_device

    return run_rank(args, resolve_device(args.device))


def run_rank(args, device) -> int:
    """The command on one process (all of it without --data-parallel)."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.config.validate import require_valid
    from crowdmod_tpu_torch.data.ingest import get_test_dataset
    from crowdmod_tpu_torch.ops.kernels import KERNELS
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    require_valid(cfg, args.arch)
    rank = multiprocess.process_index()
    log_name = f"genMetrics.p{rank}.log" if args.data_parallel else "genMetrics.log"
    setup_logging(os.path.join(cfg.DATA_FS.OUTPUT_DIR, "logs", log_name))

    chunk = args.chunk_repd_past_seq
    if chunk is None:
        chunk = cfg.METRICS.get("CHUNK_REPD_PAST_SEQ", 20)
    mesh = None
    if args.data_parallel:
        from crowdmod_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
        logging.info("batch-parallel sampling: process %d/%d (%s) on %s", rank,
                     multiprocess.process_count(), multiprocess.backend(), device)
    trainer = Trainer(cfg, args.arch, device=device, seed=args.seed, mesh=mesh)
    tag = args.model_sample_to_load
    path = os.path.join(
        cfg.DATA_FS.SAVE_DIR, ckpt.checkpoint_name(cfg, args.arch, tag)
    )
    trainer.load(path)
    trainer.sample_weights = args.sample_weights
    logging.info("checkpoint restored from %s (sampling with %s weights)",
                 path, args.sample_weights)

    test_ds = get_test_dataset(cfg, trainer.mprops_count, seed=args.seed,
                               device=trainer.device)
    out_dir = args.output_dir or os.path.join(
        cfg.DATA_FS.OUTPUT_DIR, "metrics", args.arch
    )
    if rank:  # one writer: process 0 commits the canonical files
        out_dir = os.path.join(out_dir, f".proc{rank}")
    results = trainer.generate_metrics(
        test_ds,
        metric=args.metric,
        chunk=chunk,
        batches_to_use=args.batches_to_use,
        output_dir=out_dir,
        epoch_tag=tag,
        seed=args.seed,
    )
    summary = {
        k: float(v.mean()) for k, v in results.items()
        if hasattr(v, "mean")
    }
    logging.info("metric means: %s", json.dumps(summary, indent=2))
    logging.info("metric artifacts written to %s (boxplots not written: "
                 "plots are not ported yet, ROADMAP.md Queue 1 item 17)", out_dir)
    logging.info("kernel launches: %s",
                 json.dumps({fn.__name__: fn.launches for fn in KERNELS}))
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
