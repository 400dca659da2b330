"""Hyperparameter random-search sweeps (port of the JAX package's
``cli/sweep.py``; the reference's ``train_sweep.py`` and its
``get_sweep_configuration``).

Samples the reference's per-arch search spaces locally with numpy's
``default_rng(--seed)`` (so the trials are the JAX command's), trains each
trial through the port's :class:`~crowdmod_tpu_torch.train.trainer.
Trainer` on the card, and appends every trial to ``sweep_results.jsonl``;
the best finite final loss goes to ``best.json``.  A trial that raises
(a diverging run) is logged with its traceback and recorded with a NaN
loss, and the sweep goes on, as in the JAX command.  ``--wandb`` lets a
W&B agent pick the points instead (``wandb.sweep`` / ``wandb.agent``).
The last log line gives the kernel launches of the whole sweep.

    python -m crowdmod_tpu_torch.cli sweep --arch DDPM-UNet --trials 10 \
        --epochs-per-trial 5
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np

from crowdmod_tpu_torch.cli import common_parser, setup_logging


def sweep_space(arch: str) -> dict:
    """Per-arch random-search space (the reference's
    get_sweep_configuration, utils.py:208-268)."""
    if arch in ("DDPM-UNet", "DDPM-DiT"):
        return {
            "name": "sweep_crowdmod_ddpm",
            "metric": "train_loss",
            "parameters": {
                "learning_rate": {"min": 1e-5, "max": 1e-3},
                "batch_size": {"values": [16, 32, 64]},
                "epochs": {"values": [150, 180, 200]},
                "base_ch": {"values": [16, 32, 64]},
                "dropout_rate": {"values": [0.05, 0.15, 0.25]},
                "time_emb_mult": {"values": [2, 4, 8]},
                "scale": {"values": [0.1, 0.3, 0.5, 0.8]},
                "timesteps": {"values": [500, 1000, 1500]},
            },
        }
    if arch in ("FM-UNet", "FM-DiT"):
        return {
            "name": "sweep_crowdmod_fm",
            "metric": "train_loss",
            "parameters": {
                "learning_rate": {"min": 5e-6, "max": 1e-4},
                "weight_decay": {"values": [0.0003, 0.001, 0.01]},
                "betas": {"values": [[0.5, 0.999], [0.7, 0.999], [0.9, 0.999]]},
                "batch_size": {"values": [16, 32, 64]},
                "epochs": {"values": [150, 180, 200]},
                "base_ch": {"values": [32, 64]},
                "dropout_rate": {"values": [0.05, 0.1, 0.15]},
                "time_emb_mult": {"values": [2, 4, 8]},
                "time_max_pos": {"values": [800, 1000, 1200]},
            },
        }
    if arch == "ConvRNN":
        return {
            "name": "sweep_crowdmod_ConvRNN",
            "metric": "train_loss",
            "parameters": {
                "learning_rate": {"min": 1e-5, "max": 1e-3},
                "batch_size": {"values": [32, 64, 128]},
                "epochs": {"values": [100, 150, 180]},
                "weight_decay": {"values": [0.0003, 0.001, 0.01]},
                "betas": {"values": [[0.5, 0.999], [0.7, 0.999], [0.9, 0.999]]},
                "enc_hidden_ch": {"values": [
                    [16, 64, 64, 96, 96, 96],
                    [32, 64, 64, 96, 96, 96],
                    [16, 64, 64, 128, 128, 128],
                    [32, 64, 64, 128, 128, 128],
                ]},
            },
        }
    raise ValueError(f"architecture {arch!r} not supported for sweeps")


def sample_trial(space: dict, rng: np.random.Generator) -> dict:
    """Draw one point: uniform for {min,max} ranges, choice for values."""
    out = {}
    for name, spec in space["parameters"].items():
        if "values" in spec:
            vals = spec["values"]
            out[name] = vals[int(rng.integers(len(vals)))]
        else:
            out[name] = float(rng.uniform(spec["min"], spec["max"]))
    return out


def trial_overrides(arch: str, trial: dict) -> dict:
    """Translate sweep parameter names into config-tree overrides."""
    # Config-tree node names are uppercase (MODEL.DDPM.UNET, factory.py:22);
    # FrozenConfig merges are case-sensitive, so a mixed-case key would land
    # in a dead node the factory never reads.
    family = "CONVRNN" if arch == "ConvRNN" else arch.upper().split("-")[0]
    backbone = None if arch == "ConvRNN" else arch.upper().split("-")[1]
    node: dict = {}
    train_node: dict = {}
    solver: dict = {}

    for k, v in trial.items():
        if k == "learning_rate":
            solver["LR"] = v
        elif k == "weight_decay":
            solver["WEIGHT_DECAY"] = v
        elif k == "betas":
            solver["BETAS"] = list(v)
        elif k == "batch_size":
            pass  # handled at DATASET level below
        elif k == "epochs":
            train_node["EPOCHS"] = v
        elif k == "base_ch":
            node["BASE_CH"] = v
        elif k == "dropout_rate":
            node["DROPOUT_RATE"] = v
        elif k == "time_emb_mult":
            node["TIME_EMB_MULT"] = v
        elif k == "scale":
            pass  # MODEL.DDPM.SCALE, handled below
        elif k == "timesteps":
            pass  # MODEL.DDPM.TIMESTEPS, handled below
        elif k == "time_max_pos":
            pass  # MODEL.FM.TIME_MAX_POS, handled below
        elif k == "enc_hidden_ch":
            enc = list(v)
            node["ENC_HIDDEN_CH"] = enc
            # Keep the shared-state slot constraint
            # (Forecaster: FORC[5,3,1] == ENC[1,3,5]).
            node["FORC_HIDDEN_CH"] = [
                enc[5], enc[5], enc[4], enc[3], enc[2], enc[1], enc[0]
            ]

    if solver:
        train_node["SOLVER"] = solver
    model_node: dict = {}
    if arch == "ConvRNN":
        fam_node = dict(node)
        fam_node["TRAIN"] = train_node
    else:
        fam_node = {backbone: {**node, "TRAIN": train_node}}
    if "scale" in trial:
        fam_node["SCALE"] = trial["scale"]
    if "timesteps" in trial:
        fam_node["TIMESTEPS"] = trial["timesteps"]
    if "time_max_pos" in trial:
        fam_node["TIME_MAX_POS"] = trial["time_max_pos"]
    model_node[family] = fam_node

    overrides: dict = {"MODEL": model_node}
    if "batch_size" in trial:
        overrides["DATASET"] = {"BATCH_SIZE": trial["batch_size"]}
    return overrides


def wandb_sweep_configuration(arch: str) -> dict:
    """W&B-shaped sweep config (the reference's utils.py:208-268): the same
    search space as :func:`sweep_space` plus the agent metadata keys."""
    space = sweep_space(arch)
    return {
        "name": space["name"],
        "method": "random",
        "metric": {"goal": "minimize", "name": space["metric"]},
        "parameters": space["parameters"],
    }


def build_parser():
    p = common_parser("Random-search hyperparameter sweep.")
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--epochs-per-trial", type=int, default=None,
                   help="Cap epochs per trial (default: sampled value).")
    p.add_argument("--sweep-dir", type=str, default=None)
    p.add_argument("--wandb", action="store_true",
                   help="drive trials through wandb.sweep/wandb.agent "
                        "instead of the local random search; requires the "
                        "wandb package")
    p.add_argument("--wandb-project", type=str,
                   default="macroprops-predict-4D")
    return p


def run_trial(base_cfg, arch: str, trial: dict, i: int, sweep_dir: str,
              seed: int, epochs_cap: int | None, results_path: str,
              on_epoch=None, device="cuda") -> dict:
    """Train one sweep point on ``device`` and append its record to the
    results file.  A trial that raises is logged with its traceback and
    recorded with a NaN loss (a diverging trial must not end the sweep)."""
    from crowdmod_tpu_torch.data.ingest import get_training_dataset
    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg = base_cfg.updated(trial_overrides(arch, trial))
    epochs = epochs_cap or trial.get("epochs")
    logging.info("trial %d: %s", i, trial)
    t0 = time.time()
    trainer = Trainer(
        cfg, arch, device=device, seed=seed + i,
        run_dir=os.path.join(sweep_dir, f"trial_{i:03d}"),
    )
    train_ds, val_ds = get_training_dataset(cfg, trainer.mprops_count,
                                            seed=seed, device=trainer.device)
    try:
        history = trainer.fit(train_ds, val_ds, epochs=epochs)
        final = (history["train_loss"][-1] if history["train_loss"]
                 else float("nan"))
    except Exception:  # a diverging trial must not kill the sweep
        logging.exception("trial %d failed", i)
        final = float("nan")
        history = {"train_loss": [], "val_loss": []}
    if on_epoch is not None:
        for ep_loss in history["train_loss"]:
            on_epoch({"train_loss": ep_loss})
    record = {
        "trial": i,
        "params": trial,
        "train_loss": final,
        "val_loss": history["val_loss"][-1] if history["val_loss"] else None,
        "wall_s": time.time() - t0,
    }
    with open(results_path, "a") as f:
        f.write(json.dumps(record) + "\n")
    return record


def run_wandb_agent(args, base_cfg, sweep_dir: str, results_path: str,
                    device) -> int:
    """Agent-driven sweep: W&B samples the points, the port trains them
    (the reference's ``wandb.sweep`` + ``wandb.agent`` flow), on the same
    trial path as the local search."""
    try:
        import wandb
    except ImportError as e:
        raise SystemExit(
            "--wandb requires the wandb package; use the default local "
            "random search on offline machines"
        ) from e

    sweep_id = wandb.sweep(
        sweep=wandb_sweep_configuration(args.arch), project=args.wandb_project
    )
    counter = {"i": 0}

    def one_trial():
        run = wandb.init()
        trial = dict(run.config) if run is not None else dict(wandb.config)
        i = counter["i"]
        counter["i"] += 1
        record = run_trial(
            base_cfg, args.arch, trial, i, sweep_dir, args.seed,
            args.epochs_per_trial, results_path, on_epoch=wandb.log,
            device=device,
        )
        wandb.log({"train_loss": record["train_loss"]})
        wandb.finish()

    wandb.agent(sweep_id, function=one_trial, count=args.trials)
    logging.info("wandb sweep %s finished after %d trials",
                 sweep_id, counter["i"])
    return 0


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.ops.kernels import KERNELS
    from crowdmod_tpu_torch.train.trainer import resolve_device

    device = resolve_device(args.device)
    base_cfg = load_config(args.config_yml_file, args.configList_yml_file)
    sweep_dir = args.sweep_dir or os.path.join(
        base_cfg.DATA_FS.OUTPUT_DIR, "sweeps", args.arch
    )
    os.makedirs(sweep_dir, exist_ok=True)
    setup_logging(os.path.join(sweep_dir, "sweep.log"))
    results_path = os.path.join(sweep_dir, "sweep_results.jsonl")

    if args.wandb:
        code = run_wandb_agent(args, base_cfg, sweep_dir, results_path, device)
    else:
        space = sweep_space(args.arch)
        rng = np.random.default_rng(args.seed)
        best = {"loss": float("inf"), "trial": None}
        for i in range(args.trials):
            trial = sample_trial(space, rng)
            record = run_trial(
                base_cfg, args.arch, trial, i, sweep_dir, args.seed,
                args.epochs_per_trial, results_path, device=device,
            )
            final = record["train_loss"]
            if np.isfinite(final) and final < best["loss"]:
                best = {"loss": final, "trial": i, "params": trial}
        logging.info("sweep done; best trial: %s", json.dumps(best))
        with open(os.path.join(sweep_dir, "best.json"), "w") as f:
            json.dump(best, f, indent=2)
        code = 0
    logging.info("kernel launches: %s",
                 json.dumps({fn.__name__: fn.launches for fn in KERNELS}))
    return code


if __name__ == "__main__":
    raise SystemExit(run())
