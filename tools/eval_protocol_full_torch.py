#!/usr/bin/env python
"""Run the reference evaluation protocol at FULL scale on synthetic data,
with the PyTorch port (``crowdmod_tpu_torch``) on the GPU.

The reference's metric protocol is NSAMPLES = 1280 = BATCH_SIZE 64 × 20
repeated-past chunks, metric ALL (reference generate_metrics.py:53-58,
config/ATC.yml:42).  The real ATC corpus is not shipped, so this tool
builds a *scaled synthetic* corpus (varied diagonal walkers at the
canonical ATC 12×36 geometry, pickled in the reference's (N, C, H, W, L)
layout), trains a DDPM-DiT briefly through the port's ``train`` command,
then drives its ``generate-metrics`` at the full 64×20 protocol for each
requested sampler — recording wall-clock and the MAX/MIN-over-chunk
statistics that only exist at this scale.

    python tools/eval_protocol_full_torch.py --out /tmp/evalproto
    python tools/eval_protocol_full_torch.py --samplers DDPM DDIM DPM-Solver \
        --train-epochs 30
    python tools/eval_protocol_full_torch.py --device cpu ...   # no GPU

Writes ``report.json`` under --out.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pickle
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def build_corpus(out_dir, n_files=6, per_file=64, h=12, w=36, seq_len=24,
                 seed=0):
    """Varied walker sequences pickled in the reference (N, C, H, W, L)
    layout + a DATA_LIST file; returns (pickle dir, DATA_LIST entries).
    The arrays of the JAX tool's ``build_corpus`` for the same arguments."""
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers

    rng = np.random.default_rng(seed)
    pkl_dir = os.path.join(out_dir, "pickle")
    os.makedirs(pkl_dir, exist_ok=True)
    files = []
    for k in range(n_files):
        seqs = []
        for _ in range(per_file):
            row = int(rng.integers(2, h - 3))
            vel = float(rng.uniform(0.4, 1.2))
            kind = rng.choice(["FORWARD", "BACKWARD", "ALL"])
            s = synthetic_walkers(1, h, w, seq_len, vel_x=vel, row=row,
                                  kind=str(kind))[0]
            # Per-sequence vertical drift so the vy channel is non-degenerate
            # (a zero GT range turns PSNR into -inf at metric time).
            s[..., 2] = s[..., 1] * float(rng.uniform(-0.5, 0.5))
            # Low-rate background occupancy so densities differ per seq.
            noise = (rng.random((seq_len, h, w, 1)) < 0.02).astype(np.float32)
            s = s + np.concatenate(
                [noise, np.zeros((seq_len, h, w, 2), np.float32)], axis=-1
            )
            # Reference pickles carry 4 macroprop channels (ρ, vx, vy, σ²);
            # walkers have zero velocity variance.
            s = np.concatenate(
                [s, np.zeros(s.shape[:-1] + (1,), np.float32)], axis=-1
            )
            seqs.append(s)
        arr = np.stack(seqs)  # (N, L, H, W, 4)
        arr = arr.transpose(0, 4, 2, 3, 1).astype(np.float32)  # (N,C,H,W,L)
        name = f"walkers_{k}.pkl"
        with open(os.path.join(pkl_dir, name), "wb") as f:
            pickle.dump(arr, f)
        files.append([name, per_file])
    return pkl_dir, files


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="/tmp/eval_protocol")
    p.add_argument("--samplers", nargs="+",
                   default=["DDPM", "DDIM", "DPM-Solver"],
                   help="MODEL.DDPM.SAMPLER values to run the protocol for; "
                        "add 'Distilled' to distill an 8-step student first. "
                        "'DDIM-eta' accepts an inline spec "
                        "'DDIM-eta:ETA:STEPS' (e.g. DDIM-eta:1.0:50).")
    p.add_argument("--train-epochs", type=int, default=30)
    p.add_argument("--pred-type", default="eps", choices=["eps", "v", "x0"],
                   help="MODEL.DDPM.PRED_TYPE for training (v = Salimans-Ho "
                        "parameterization, the few-step quality choice)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="TRAIN.EMA_DECAY; sampling uses EMA weights when set")
    p.add_argument("--timesteps", type=int, default=None,
                   help="override MODEL.DDPM.TIMESTEPS (a reduced-T protocol "
                        "makes ancestral sampling fit a CPU budget)")
    p.add_argument("--files", type=int, default=6)
    p.add_argument("--per-file", type=int, default=64)
    p.add_argument("--chunk", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=None,
                   help="override DATASET.BATCH_SIZE (a CPU run shrinks the "
                        "protocol batch; the reference protocol is 64)")
    p.add_argument("--batches-to-use", type=int, default=1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sample-weights", choices=("ema", "raw"), default="ema",
                   help="Protocol sampling weights (raw = EMA ablation).")
    p.add_argument("--skip-train", action="store_true",
                   help="Reuse the checkpoint/corpus already in --out (same "
                        "seed/scale flags!) and only run the samplers — for "
                        "follow-up sweeps off one trained model.")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    import yaml

    from crowdmod_tpu_torch.cli import distill as distill_cli
    from crowdmod_tpu_torch.cli import generate_metrics, train
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.train.trainer import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    h, w, seq_len = 12, 36, 24
    pkl_dir, files = build_corpus(
        args.out, n_files=args.files, per_file=args.per_file,
        h=h, w=w, seq_len=seq_len, seed=args.seed,
    )
    print(f"corpus: {args.files} files x {args.per_file} seqs "
          f"@({seq_len},{h},{w})", flush=True)

    # Full reference ATC model/protocol scale; only the data location, the
    # sequence length, and the training budget are overridden.
    over = {
        "DATA_FS": {
            "PICKLE_DIR": pkl_dir,
            "SAVE_DIR": os.path.join(args.out, "ckpts"),
            "OUTPUT_DIR": os.path.join(args.out, "out"),
        },
        "DATASET": {
            "RAW_SEQ_LEN": seq_len,
            "TRAIN_FILE_COUNT": max(args.files - 2, 1),
            "VAL_FILE_COUNT": 1,
            "TEST_FILE_COUNT": 1,
            **({"BATCH_SIZE": args.batch_size} if args.batch_size else {}),
        },
        "MODEL": {"DDPM": {
            "PRED_TYPE": args.pred_type,
            **({"TIMESTEPS": args.timesteps} if args.timesteps else {}),
            "DIT": {"TRAIN": {
                "EPOCHS": args.train_epochs,
                "EMA_DECAY": args.ema_decay,
            }},
        }},
        "METRICS": {"CHUNK_REPD_PAST_SEQ": args.chunk},
    }
    cfg = load_config("ATC.yml").updated(over)
    cfg_path = os.path.join(args.out, "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    list_path = os.path.join(args.out, "list.yml")
    with open(list_path, "w") as f:
        yaml.safe_dump({"DATA_LIST": files}, f)
    common = ["--config-yml-file", cfg_path, "--configList-yml-file",
              list_path, "--arch", "DDPM-DiT", "--seed", str(args.seed),
              "--device", args.device]

    report = {
        "backend": device.type,
        "protocol": {
            "batch": int(cfg.DATASET.BATCH_SIZE), "chunk": args.chunk,
            "nsamples": int(cfg.DATASET.BATCH_SIZE) * args.chunk
            * args.batches_to_use,
            "metric": "ALL",
        },
        "corpus_sequences": args.files * args.per_file,
        "samplers": {},
    }

    if args.skip_train:
        report["train_wall_s"] = 0.0
        print("--skip-train: reusing the checkpoint in --out", flush=True)
    else:
        t0 = time.time()
        rc = train.run(common + ["--run-dir", os.path.join(args.out, "run")])
        assert rc == 0, "training failed"
        report["train_wall_s"] = round(time.time() - t0, 1)
        print(f"trained DDPM-DiT in {report['train_wall_s']}s", flush=True)

    def _distill_steps(spec):
        """Student step count for a Distilled-family spec, else None.
        Parses via sampler_overrides so guidance suffixes don't break it
        (the Distilled sampler itself rejects guidance at dispatch)."""
        from crowdmod_tpu_torch.utils.sampler_spec import sampler_overrides

        over = sampler_overrides(spec)
        if over.get("SAMPLER") != "Distilled":
            return None
        return int(over.get("DISTILL_STEPS", 8))

    def _have_student(n):
        from crowdmod_tpu_torch.train import checkpoint as ckpt_mod
        from crowdmod_tpu_torch.train.distiller import distilled_tag

        return os.path.isdir(os.path.join(
            cfg.DATA_FS.SAVE_DIR,
            ckpt_mod.checkpoint_name(cfg, "DDPM-DiT", distilled_tag(n)),
        ))

    # --skip-train reuses the base checkpoint but still distills any
    # requested student whose checkpoint is missing (follow-up sweeps may
    # introduce new step counts).
    distill_counts = sorted({
        n for n in map(_distill_steps, args.samplers)
        if n is not None and not (args.skip_train and _have_student(n))
    })
    for n in distill_counts:
        t0 = time.time()
        rc = distill_cli.run(common + ["--steps", str(n)])
        assert rc == 0, "distillation failed"
        report[f"distill{n}_wall_s"] = round(time.time() - t0, 1)
        print(f"distilled {n}-step student in {time.time() - t0:.1f}s",
              flush=True)

    for sampler in args.samplers:
        from crowdmod_tpu_torch.utils.sampler_spec import sampler_overrides

        sampler_over = sampler_overrides(sampler)
        scfg = cfg.updated({"MODEL": {"DDPM": sampler_over}})
        spath = os.path.join(
            args.out, f"cfg_{sampler.replace(':', '_')}.yml"
        )
        with open(spath, "w") as f:
            yaml.safe_dump(scfg.to_dict(), f)
        out_dir = os.path.join(
            args.out, "metrics", sampler.replace(":", "_")
        )
        argv_m = [
            "--config-yml-file", spath, "--configList-yml-file", list_path,
            "--arch", "DDPM-DiT", "--seed", str(args.seed),
            "--metric", "ALL", "--chunk-repd-past-seq", str(args.chunk),
            "--batches-to-use", str(args.batches_to_use),
            "--output-dir", out_dir,
            "--sample-weights", args.sample_weights,
            "--device", args.device,
        ]
        n_distill = _distill_steps(sampler)
        if n_distill is not None:
            from crowdmod_tpu_torch.train.distiller import distilled_tag

            argv_m += ["--model-sample-to-load", distilled_tag(n_distill)]
        t0 = time.time()
        rc = generate_metrics.run(argv_m)
        wall = time.time() - t0
        assert rc == 0, f"generate-metrics failed for {sampler}"

        # Harvest per-metric means incl. the MAX/MIN-over-chunk variants
        # that only exist at protocol scale.
        means = {}
        with open(os.path.join(out_dir, "metrics_files.json")) as fm:
            manifest = json.load(fm)
        for metric_name, fname in manifest.items():
            path = os.path.join(out_dir, os.path.basename(fname))
            if not os.path.exists(path):
                continue
            with open(path) as fcsv:
                rows = list(csv.reader(fcsv))
            # Keep finite cells only: empty strings, NaN (any case), and
            # +/-inf (degenerate-range PSNR, see build_corpus) would poison
            # the mean with one bad cell.
            vals = [
                f for row in rows[1:] for v in row[1:] if v
                for f in (float(v),) if np.isfinite(f)
            ]
            if vals:
                means[metric_name] = round(float(np.mean(vals)), 4)
        report["samplers"][sampler] = {
            "wall_s": round(wall, 1),
            "samples_per_sec": round(report["protocol"]["nsamples"] / wall, 2),
            "metric_means": means,
        }
        print(f"{sampler}: {wall:.1f}s for {report['protocol']['nsamples']} "
              f"samples; {len(means)} metric arrays", flush=True)

    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
