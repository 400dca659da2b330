"""Sampling entry point (the JAX package's ``cli/generate_samples.py``).

Restores a checkpoint by epoch tag, draws ``MODEL.NSAMPLES4PLOTS``
conditioned samples of the test set (or of the fixed-past set) with the
configured sampler on the card, computes the GIFs' overlay metrics there,
then draws the static SVG grid or the GIFs and the density-over-time
plots on the host.  :func:`sample_sequences` is the device half (the
checkpoint, the test set, the ids, ``Trainer.sample``, the overlays) and
:func:`render` the drawing, so the device half runs without the plots.
It logs the samples' L1 norm, as the JAX command does, and the kernel
launches of the run.

The window ids and the sampler's noise come from one ``torch.Generator``
on the card seeded ``--seed`` (the ids first), not the JAX package's key
split: the same seed draws other samples than the JAX command.  The
command draws plots, so on a host without matplotlib it exits 2 before it
loads anything.  ``--data-parallel`` splits the sampling over one process
a card of this host (gloo and one process on ``--device cpu``), as
``generate-metrics --data-parallel`` does; process 0 draws.

    python -m crowdmod_tpu_torch.cli generate-samples --arch DDPM-UNet \\
        --plot-type Dynamic --output-dir out/samples/DDPM-UNet
"""

from __future__ import annotations

import json
import logging
import os
import sys

from crowdmod_tpu_torch.cli import common_parser, setup_logging
from crowdmod_tpu_torch.parallel import launch, multiprocess

COMMAND = "crowdmod_tpu_torch.cli.generate_samples"


def build_parser():
    p = common_parser("Generate and plot samples from a trained model.")
    p.add_argument("--plot-mprop", type=str, default="Density&Vel",
                   help="Density|Uncertainty|Density&Vel")
    p.add_argument("--plot-past", type=str, default="Last2",
                   help="All|Last2|Alternate")
    p.add_argument("--plot-type", type=str, default="Static",
                   help="Static (.svg) or Dynamic (.gif)")
    p.add_argument("--vel-scale", type=float, default=0.5)
    p.add_argument("--vel-unc-scale", type=float, default=1.0)
    p.add_argument("--headwidth", type=int, default=5)
    p.add_argument("--same-past-seq", action="store_true",
                   help="Repeat one past sequence for every sample.")
    p.add_argument("--from-fixed-past", action="store_true",
                   help="Sample from the fixed 4sampling past set.")
    p.add_argument("--model-sample-to-load", type=str, default="000",
                   help="Checkpoint epoch tag; 000 = best-loss model.")
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--data-parallel", action="store_true",
                   help="Split the sampling over one process a card of this host.")
    p.add_argument("--multihost", action="store_true",
                   help="With --data-parallel: join a launch made outside "
                        "(CROWDMOD_COORDINATOR/NUM_PROCESSES/PROCESS_ID, or "
                        "torchrun); process 0 draws the plots.")
    return p


def run(argv=None, *, draws=None) -> int:
    """The command.  ``draws``: a :class:`~crowdmod_tpu_torch.train.trainer.
    ProtocolDraws` giving the window permutation and the sampler's noise
    (tests inject the JAX package's), one process only."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    code = launch.check_flags(args)
    if code is not None:
        return code
    from crowdmod_tpu_torch.viz import plotting_unavailable

    no_plots = plotting_unavailable()
    if no_plots:
        print(f"generate-samples draws plots, which this host cannot: {no_plots}",
              file=sys.stderr)
        return 2
    if args.data_parallel:
        if draws is not None:
            raise ValueError("draws are injected into one process only")
        return launch.run_ranks(COMMAND, argv, args.device, args.multihost)
    from crowdmod_tpu_torch.train.trainer import resolve_device

    return run_rank(args, resolve_device(args.device), draws=draws)


def run_rank(args, device, *, draws=None) -> int:
    """The command on one process (all of it without --data-parallel)."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.config.validate import require_valid

    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    require_valid(cfg, args.arch)
    rank = multiprocess.process_index()
    log_name = f"genSamples.p{rank}.log" if args.data_parallel else "genSamples.log"
    setup_logging(os.path.join(cfg.DATA_FS.OUTPUT_DIR, "logs", log_name))
    samples = sample_sequences(cfg, args, device, draws=draws)
    if rank == 0:
        render(cfg, args, samples)
    return 0


def sample_sequences(cfg, args, device, *, draws=None) -> dict:
    """The device half of the command: the checkpoint, the test set, the
    window ids, ``Trainer.sample`` and the overlay metrics, on ``device``
    (under ``--data-parallel`` inside a launch: the batch split over the
    processes, the samples gathered on each) → ``{"past", "future", "pred",
    "seqs"`` (interleaved, see :func:`~crowdmod_tpu_torch.viz.plot_samples.
    interleave`) on the device, ``"overlays"`` (host arrays), ``"l1"``,
    ``"launches"``}."""
    import torch

    from crowdmod_tpu_torch.data.ingest import get_test_dataset
    from crowdmod_tpu_torch.ops.kernels import KERNELS
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import ProtocolDraws, Trainer
    from crowdmod_tpu_torch.viz.plot_samples import interleave, overlay_metrics

    mesh = None
    if args.data_parallel:
        from crowdmod_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
        logging.info("batch-parallel sampling: process %d/%d (%s) on %s",
                     multiprocess.process_index(), multiprocess.process_count(),
                     multiprocess.backend(), device)
    trainer = Trainer(cfg, args.arch, device=device, seed=args.seed, mesh=mesh)
    path = os.path.join(cfg.DATA_FS.SAVE_DIR,
                        ckpt.checkpoint_name(cfg, args.arch, args.model_sample_to_load))
    trainer.load(path)
    logging.info("checkpoint restored from %s", path)

    test_ds = get_test_dataset(cfg, trainer.mprops_count,
                               from_fixed_past=args.from_fixed_past, seed=args.seed,
                               device=trainer.device)
    if draws is None:
        draws = ProtocolDraws(
            generator=torch.Generator(device=trainer.device).manual_seed(args.seed))
    # Select the window ids first and gather only those: a test split's
    # stride-1 windows overlap, so gathering every window would take
    # (PAST + FUTURE) times the raw tensor to pick a handful.
    idx = Trainer.select_ids(len(test_ds), cfg.MODEL.NSAMPLES4PLOTS, draws.generator,
                             perm=draws.perm, same_past=args.same_past_seq)
    past, future = test_ds.gather(idx.cpu())
    logging.info("sampling %d sequences with %s", past.shape[0], args.arch)
    pred = trainer.sample(past, draws.generator, noise=draws.noise)
    # The reference logs the samples' L1 norm as a sanity check.
    l1 = float(pred.abs().sum())
    logging.info("sample L1 norm: %.4f", l1)
    pred_seq, gt_seq, seqs = interleave(pred, past, future)
    overlays = overlay_metrics(pred_seq, gt_seq, cfg.METRICS, cfg.MACROPROPS.EPS)
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    logging.info("kernel launches: %s", json.dumps(launches))
    return dict(past=past, future=future, pred=pred, seqs=seqs, overlays=overlays,
                l1=l1, launches=launches)


def render(cfg, args, samples: dict) -> dict:
    """The host half: the requested plots of :func:`sample_sequences`'
    output under ``--output-dir`` (default ``OUTPUT_DIR/samples/<arch>``),
    each recorded as an artifact of the run's tracker → the artifacts."""
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.utils.tracker import RunTracker
    from crowdmod_tpu_torch.viz.plot_samples import MacropropPlotter, render_predictions

    out_dir = args.output_dir or os.path.join(cfg.DATA_FS.OUTPUT_DIR, "samples", args.arch)
    plotter = MacropropPlotter(
        cfg, out_dir, arch=args.arch, vel_scale=args.vel_scale,
        vel_unc_scale=args.vel_unc_scale, headwidth=args.headwidth,
        run_tag=ckpt.run_tag(cfg, args.arch, args.model_sample_to_load),
    )
    artifacts = render_predictions(
        plotter, samples["seqs"].cpu().numpy(), samples["overlays"],
        plot_type=args.plot_type, plot_mprop=args.plot_mprop, plot_past=args.plot_past,
    )
    with RunTracker(out_dir, config=cfg, use_wandb=None) as tracker:
        for k, v in artifacts.items():
            if k == "overlays":
                continue
            logging.info("wrote %s: %s", k, v)
            for path in (v if isinstance(v, list) else [v]):
                tracker.log_artifact(path, kind=k)
    return artifacts


if __name__ == "__main__":
    raise SystemExit(run())
