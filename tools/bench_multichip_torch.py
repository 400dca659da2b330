#!/usr/bin/env python
"""Data-parallel scaling of the port: sampler and training throughput
against the number of cards — the twin of ``tools/bench_multichip.py``.

  * **Sampler scaling** — the flagship DDPM-DiT reverse chain, batch
    ``--batch-per-chip`` PER CARD (weak scaling), its parameters
    FSDP-sharded (FSDP2) over the data axis; each process samples its rows
    of the global batch through ``Trainer.sample`` and the samples are
    gathered on every process.  Reports denoise steps/s across the mesh,
    with the busy share of a chain on process 0's card.
  * **Training scaling** — ``Trainer.fit`` over a DP-split global batch,
    parameters FSDP-sharded as in the JAX tool (samples/s from the CUDA
    events of the second epoch's steps), then the same under DDP
    (``train_ddp_samples_per_sec``).

One process a card, through ``parallel/launch.py::run_ranks`` (NCCL); a
mesh of n < the cards present runs in a process that sees the first n
(``CUDA_VISIBLE_DEVICES``).  Nothing is subtracted from a time: the cards
are local, so no dispatch round trip sits in it (the JAX tool subtracted a
remote TPU's).  ``Predictor(mesh=)``'s threads are not used: one process
drives every card there.

``--virtual N`` is the correctness mode (no cards needed): each mesh size
up to N runs as that many gloo processes on the CPU, at a narrow DiT
(hidden 64, depth 2), and the tool ASSERTS that the parallelism is real —
each process holds batch/N rows, the samples and the losses are finite,
and the collectives ran, counted as ``c10d::`` operators in a
``torch.profiler`` trace of one chain and one training epoch: FSDP2's
all-gather and reduce-scatter, DDP's all-reduce (where N > 1).  Its walls
are not a speed claim.

Examples::

  python tools/bench_multichip_torch.py                 # the cards present
  python tools/bench_multichip_torch.py --virtual 2     # correctness on gloo
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

MODULE = "tools.bench_multichip_torch"
P, F, H, W, C = 5, 3, 12, 36, 3
REPORT_KEYS = ("backend", "batch_per_chip", "timesteps", "rows")
ROW_KEYS = ("mesh", "sampler_steps_per_sec", "train_samples_per_sec", "collectives")
VIRTUAL_ROW_KEYS = ("mesh", "ok", "collectives", "sampler_wall_s_virtual",
                    "epoch_wall_s_virtual")
ADDED_KEYS = ("device",)
ADDED_ROW_KEYS = ("busy_share", "train_ddp_samples_per_sec", "ddp_collectives")
# c10d operator names → the JAX tool's collective names.
COLLECTIVES = {"all-reduce": "allreduce", "all-gather": "allgather",
               "reduce-scatter": "reduce_scatter"}


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="N gloo processes on the CPU (correctness mode; "
                         "throughput is not meaningful there).")
    ap.add_argument("--batch-per-chip", type=int, default=64)
    ap.add_argument("--timesteps", type=int, default=None,
                    help="Sampler chain length (default: 1000 on the cards, "
                         "4 on the virtual mesh).")
    ap.add_argument("--epoch-batches", type=int, default=None,
                    help="Batches per epoch (default: 16 on the cards, 2 virtual).")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu "
                         "(as --virtual)")
    # One mesh of every process of the launch; process 0 appends its row
    # to --rows-file (main, looping over the mesh sizes, passes both).
    ap.add_argument("--mesh", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rows-file", default=None, help=argparse.SUPPRESS)
    return ap


def _mesh_sizes(n: int) -> list[int]:
    sizes, s = [], 1
    while s <= n:
        sizes.append(s)
        s *= 2
    if sizes[-1] != n:
        sizes.append(n)
    return sizes


def collective_counts(fn) -> dict:
    """The ``c10d::`` collectives ``fn()`` issues on this process, by the
    JAX tool's names, from a CPU ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    counts = dict.fromkeys(COLLECTIVES, 0)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("c10d::"):
            for key, op in COLLECTIVES.items():
                counts[key] += op in name
    return counts


def settings(args, virtual: bool) -> dict:
    return {"timesteps": args.timesteps or (4 if virtual else 1000),
            "epoch_batches": args.epoch_batches or (2 if virtual else 16),
            "width": (64, 2) if virtual else (256, 6)}


def run_rank(args, device) -> int:
    """One process of a mesh of every process of the launch: sampler, then
    FSDP and DDP training; process 0 appends the row."""
    with tempfile.TemporaryDirectory(prefix="bench_multichip_") as work:
        return _mesh_row(args, device, work)


def _mesh_row(args, device, work: str) -> int:
    import time

    import numpy as np
    import torch

    from bench_torch import bench_config
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.parallel import multiprocess
    from crowdmod_tpu_torch.parallel.mesh import make_mesh
    from crowdmod_tpu_torch.train.trainer import Trainer
    from crowdmod_tpu_torch.utils.profiling import time_calls

    virtual = device.type == "cpu"
    s = settings(args, virtual)
    n = multiprocess.process_count()
    b = args.batch_per_chip * n
    hidden, depth = s["width"]
    cfg = bench_config(s["timesteps"], overrides={
        "DATA_FS": {"SAVE_DIR": os.path.join(work, "ckpts")},
        "DATASET": {"BATCH_SIZE": b},
        "MODEL": {"DDPM": {"CHECKPOINTS_TO_KEEP": 0,
                           "DIT": {"HIDDEN_SIZE": hidden, "DEPTH": depth}}}})
    mesh = make_mesh(data=n)
    row = {"mesh": n}

    # ---- sampler --------------------------------------------------------
    tr = Trainer(cfg, "DDPM-DiT", device=device, seed=0, mesh=mesh,
                 param_sharding="fsdp", run_dir=os.path.join(work, "run"))
    past = torch.zeros((b, P, H, W, C), device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    mine = multiprocess.rank_rows(b, mesh)
    if mine.stop - mine.start != args.batch_per_chip:
        raise AssertionError(f"process {multiprocess.process_index()} holds rows "
                             f"{mine}, not batch/{n} = {args.batch_per_chip}")
    t0 = time.perf_counter()
    out = tr.sample(past, gen)
    first_wall = time.perf_counter() - t0
    if tuple(out.shape) != (b, F, H, W, C) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"samples {tuple(out.shape)} not finite or not gathered")
    coll = collective_counts(lambda: tr.sample(past, gen))
    if not virtual:
        t = time_calls(lambda: tr.sample(past, gen), reps=3, device=device)
        row.update(sampler_steps_per_sec=b * s["timesteps"] / t["seconds"],
                   busy_share=t["busy_share"])

    # ---- training: FSDP (the JAX tool's), then DDP ----------------------
    raw = synthetic_walkers(s["epoch_batches"] * b // 2, H, W, 16)  # 2 windows a sequence
    ds = WindowDataset(torch.from_numpy(raw).to(device), past_len=P, future_len=F, stride=8)
    walls, rates = {}, {}
    for mode in ("fsdp", "tp"):
        trainer = tr if mode == "fsdp" else Trainer(
            cfg, "DDPM-DiT", device=device, seed=0, mesh=mesh, param_sharding=mode,
            run_dir=os.path.join(work, "run_ddp"))
        t0 = time.perf_counter()
        hist = trainer.fit(ds, epochs=2)
        walls[mode] = time.perf_counter() - t0
        losses = np.asarray(hist["step_loss"], dtype=np.float64)
        if not np.isfinite(losses).all():
            raise AssertionError(f"{mode} epoch losses not finite: {losses}")
        rates[mode] = b * len(hist["step_ms"][1]) / (sum(hist["step_ms"][1]) / 1e3)
        counted = collective_counts(lambda: trainer.fit(ds, epochs=1))
        if mode == "fsdp":
            coll = {k: coll[k] + counted[k] for k in coll}
        else:
            ddp_coll = counted
    if n > 1 and not (coll["all-gather"] and coll["reduce-scatter"]
                      and ddp_coll["all-reduce"]):
        raise AssertionError(f"collectives missing: FSDP {coll}, DDP {ddp_coll}")
    if virtual:
        row.update(ok=True, collectives=coll, sampler_wall_s_virtual=first_wall,
                   epoch_wall_s_virtual=walls["fsdp"] / 2)
    else:
        row.update(train_samples_per_sec=rates["fsdp"], collectives=coll)
    row.update(train_ddp_samples_per_sec=rates["tp"], ddp_collectives=ddp_coll)
    if multiprocess.is_main():
        print(f"mesh={n}: " + json.dumps(row), flush=True)
        if args.rows_file:
            with open(args.rows_file, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    from crowdmod_tpu_torch.parallel.launch import run_ranks
    from crowdmod_tpu_torch.train.trainer import resolve_device
    from crowdmod_tpu_torch.utils.profiling import card_identity

    virtual = bool(args.virtual) or args.device == "cpu"
    device = resolve_device("cpu" if virtual else args.device)
    if args.mesh:  # one mesh: every process of this launch
        return run_ranks(MODULE, argv, device, False, data=args.mesh if virtual else None)

    import torch

    count = (args.virtual or 1) if virtual else torch.cuda.device_count()
    s = settings(args, virtual)
    print(f"backend={device.type}  devices={count}  batch/chip={args.batch_per_chip}  "
          f"T={s['timesteps']}", flush=True)
    with tempfile.TemporaryDirectory(prefix="bench_multichip_") as tmp:
        rows_file = os.path.join(tmp, "rows.jsonl")
        for n in _mesh_sizes(count):
            sub = argv + ["--mesh", str(n), "--rows-file", rows_file]
            if virtual:
                code = run_ranks(MODULE, sub, device, False, data=n)
            else:  # a process that sees the first n cards runs this mesh
                env = {**os.environ, "CUDA_VISIBLE_DEVICES": ",".join(map(str, range(n)))}
                code = subprocess.run([sys.executable, os.path.abspath(__file__), *sub],
                                      env=env).returncode
            if code:
                raise SystemExit(f"mesh {n} failed with exit status {code}")
        with open(rows_file) as f:
            rows = [json.loads(line) for line in f]
    print(json.dumps({"backend": device.type, "batch_per_chip": args.batch_per_chip,
                      "timesteps": s["timesteps"], "rows": rows,
                      "device": card_identity() if not virtual else "cpu"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
