#!/usr/bin/env python
"""Multi-PROCESS dryrun of the PyTorch port: N real OS processes, one
process group.

The in-process tests prove the data-parallel math; what they cannot prove
is the process topology a real multi-card launch runs: N Python processes
that join one ``torch.distributed`` group, each driving one device, each
feeding its own file shard into the global batch, and committing
checkpoints exactly once.  This tool exercises exactly that layer — over
gloo on the CPU (``--device cpu``) or over NCCL with one process a card
(the default; it needs as many cards as processes: two NCCL ranks cannot
share a card, and CUDA tensors never go through gloo), so the real launch
is a parameter change, not new code:

  orchestrator            spawns N workers of itself (--worker)
  worker                  multiprocess.initialize(coordinator, N, i)
    data                  host_shard() -> FileWindowStream over OWN files
    batch                 all_gather_rows() assembles the global batch from
                          every process's rows; the trainer's
                          multiprocess.global_batch() cuts this process's
                          rows back out (held equal to what it read)
    step                  the DDPM-DiT train step under the ("data",
                          "model") mesh: DDP, or FSDP2 with --fsdp
    agreement             multiprocess.all_processes_equal(loss) every step,
                          bitwise (the loss is the all-reduced global mean)
    checkpoint            commit_checkpoint (process-0 commit between
                          barriers) then load_checkpoint on every process,
                          the state compared with the live weights
  control                 the orchestrator re-runs the identical schedule as
                          ONE process emulating all N shards and asserts the
                          step losses match the distributed run (atol 1e-4)

Usage:
  python tools/dryrun_multihost_torch.py --nprocs 2 --device cpu     # gloo
  python tools/dryrun_multihost_torch.py --nprocs 4 --fsdp          # 4 cards
  python tools/dryrun_multihost_torch.py --nprocs 2 --config serving/ATC.yml

The default model is the tiny DiT (8×12 grid, hidden 64, depth 2);
``--config serving/ATC.yml`` runs the ATC serving config at its full width
(12×36, hidden 256, depth 6, 4 heads, patch 4 / t-patch 4).  Writes
``report.json`` under --out and exits non-zero on any failure.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import socket
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

H, W, PAST, FUT = 8, 12, 5, 3
SEQ_LEN = 16
ROWS_PER_PROC = 4  # rows each process contributes to the global batch
ARCH = "DDPM-DiT"


def model_config(config: str | None = None):
    """The rehearsal's DDPM-DiT config: the JAX tool's tiny model on the
    8×12 grid by default, else ``config`` at its own width and grid; T = 50
    at scale 1, ε targets, float32 Adam 1e-3 (betas 0.9/0.999, no decay),
    no dropout, no EMA, no CFG drop."""
    from crowdmod_tpu_torch.config import load_config

    dit = {"DROPOUT_RATE": 0.0, "TRAIN": {"EMA_DECAY": 0.0, "SOLVER": {
        "LR": 1e-3, "BETAS": [0.9, 0.999], "WEIGHT_DECAY": 0.0}}}
    over = {"MODEL": {"DDPM": {"TIMESTEPS": 50, "SCALE": 1.0, "PRED_TYPE": "eps",
                               "CFG_DROP_PROB": 0.0, "DIT": dit}}}
    if config is None:
        dit.update({"HIDDEN_SIZE": 64, "DEPTH": 2, "NUM_HEADS": 2,
                    "PATCH_SIZE": 2, "T_PATCH_SIZE": 2})
        over["MACROPROPS"] = {"ROWS": H, "COLS": W}
    return load_config(config or "ATC.yml").updated(over)


def grid(config: str | None = None) -> tuple[int, int]:
    cfg = model_config(config)
    return int(cfg.MACROPROPS.ROWS), int(cfg.MACROPROPS.COLS)


def _write_corpus(data_dir: str, n_files: int = 4, per_file: int = 6,
                  channels: int = 3, h: int = H, w: int = W) -> list:
    """Tiny walker pickles in the reference (N, C, H, W, L) layout: the
    JAX tool's arrays for the same arguments.

    ``channels=4`` appends the zero sigma^2 channel the reference's raw
    pickles carry (the ingest loader expects it; the stream path slices)."""
    import numpy as np

    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers

    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for k in range(n_files):
        arr = np.stack([
            synthetic_walkers(1, h, w, SEQ_LEN, vel_x=0.5 + 0.1 * j,
                              row=1 + (j + k) % (h - 2))[0]
            for j in range(per_file)
        ])  # (N, L, H, W, C)
        if channels == 4:
            arr = np.concatenate(
                [arr, np.zeros(arr.shape[:-1] + (1,), np.float32)], axis=-1
            )
        arr = arr.transpose(0, 4, 2, 3, 1).astype(np.float32)
        path = os.path.join(data_dir, f"walkers_{k}.pkl")
        with open(path, "wb") as f:
            pickle.dump(arr, f)
        paths.append(path)
    return paths


def _local_rows(files: list, rows: int):
    """First ``rows`` (past, future) windows of this process's file shard —
    deterministic (shuffle=False), so the control run can reproduce the
    exact global batch.  Read on the host: numpy arrays."""
    import numpy as np

    from crowdmod_tpu_torch.data.prefetch import FileWindowStream

    stream = FileWindowStream(files, past_len=PAST, future_len=FUT, stride=1,
                              device="cpu")
    pasts, futures = [], []
    need = rows
    for past, future in stream.batches(1, shuffle=False):
        pasts.append(past.numpy())
        futures.append(future.numpy())
        need -= 1
        if need == 0:
            break
    if need:
        raise RuntimeError(f"file shard yielded too few windows ({need} short)")
    return np.concatenate(pasts), np.concatenate(futures)


def _train_schedule(nprocs: int, files: list, *, emulate: bool, fsdp: bool,
                    steps: int, device="cpu", config: str | None = None,
                    weights: dict | None = None, draws: list | None = None):
    """Build the trainer and the global batch, run ``steps`` steps; shared
    by workers and the control run → (trainer, losses, step ms).

    ``emulate=True`` (control) assembles every virtual process's rows in one
    process without a mesh; otherwise each process reads its own shard and
    the trainer runs under the process group's mesh.  Each step's t and ε
    come from a generator seeded ``100 + i`` on the device, or from
    ``draws[i]`` (a :class:`~crowdmod_tpu_torch.train.trainer.StepDraws` for
    the global batch); ``weights`` (a state_dict) replaces the seeded
    initial weights."""
    import numpy as np
    import torch

    from crowdmod_tpu_torch.data.prefetch import host_shard
    from crowdmod_tpu_torch.parallel import multiprocess
    from crowdmod_tpu_torch.parallel.mesh import make_mesh
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import StepDraws, Trainer

    device = torch.device(device)
    cfg = model_config(config)
    mesh = None if emulate else make_mesh()  # every process on "data"
    if emulate:
        parts = [_local_rows(host_shard(files, p, nprocs), ROWS_PER_PROC)
                 for p in range(nprocs)]
        past = np.concatenate([p[0] for p in parts])
        future = np.concatenate([p[1] for p in parts])
        batch = (torch.from_numpy(past).to(device),
                 torch.from_numpy(future).to(device))
    else:
        local = [torch.from_numpy(a).to(device)
                 for a in _local_rows(host_shard(files), ROWS_PER_PROC)]
        batch = tuple(multiprocess.all_gather_rows(x, mesh) for x in local)
        mine = multiprocess.global_batch(batch, mesh)
        if not all(torch.equal(a, b) for a, b in zip(mine, local)):
            raise RuntimeError("the global batch's rows of this process are "
                               "not the rows it read")

    trainer = Trainer(
        cfg, ARCH, device=device, seed=0, compute_dtype=torch.float32,
        mesh=mesh, param_sharding="fsdp" if fsdp else "tp",
        run_dir=os.path.join(os.path.dirname(files[0]), "run"),
    ).setup()
    if weights is not None:
        ckpt.load_full_state_dict(trainer.model, weights)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, step_ms = [], []
    for i in range(steps):
        step_draws = (draws[i] if draws is not None else StepDraws(
            generator=torch.Generator(device).manual_seed(100 + i)))
        sync()
        t0 = time.perf_counter()
        loss = trainer._train_step(*trainer._rank_args(batch, step_draws))
        loss = trainer._process_mean(loss.detach().reshape(1), f"loss[{i}]")
        sync()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss[0]))
    return trainer, losses, step_ms


def _data_files(data_dir: str) -> list:
    return sorted(
        os.path.join(data_dir, f) for f in os.listdir(data_dir)
        if f.endswith(".pkl")
    )


def worker_main(args) -> int:
    import numpy as np
    import torch

    from crowdmod_tpu_torch.parallel import multiprocess

    device = multiprocess.initialize(
        f"127.0.0.1:{args.port}", args.nprocs, args.process_id,
        device_type=torch.device(args.device).type,
    )
    try:
        assert multiprocess.process_count() == args.nprocs
        assert multiprocess.process_index() == args.process_id
        trainer, losses, step_ms = _train_schedule(
            args.nprocs, _data_files(args.data_dir), emulate=False,
            fsdp=args.fsdp, steps=args.steps, device=device, config=args.config,
        )
        assert all(np.isfinite(losses)), losses
        for i, loss in enumerate(losses):
            assert multiprocess.all_processes_equal(
                loss, atol=0.0, name=f"loss[{i}]"
            ), f"cross-process loss divergence at step {i}"

        # Checkpoint: process-0 commit (between the barriers inside
        # commit_checkpoint), then every process restores and compares
        # against its live weights (gathered whole under FSDP).
        from crowdmod_tpu_torch.train.checkpoint import (
            commit_checkpoint, load_checkpoint,
        )

        ckpt = os.path.join(args.out, "ckpt")
        live = trainer.params
        commit_checkpoint(ckpt, {"params": live},
                          {"harness": "dryrun_multihost", "nprocs": args.nprocs})
        restored, meta = load_checkpoint(ckpt)
        assert meta and meta.get("nprocs") == args.nprocs
        assert set(restored["params"]) == set(live)
        for name, tensor in live.items():
            assert torch.equal(restored["params"][name], tensor.cpu()), name
        checkpoint_agree = multiprocess.all_processes_equal(
            [float(t.double().sum()) for t in restored["params"].values()],
            name="checkpoint")
        assert checkpoint_agree

        with open(os.path.join(args.out, f"worker_{args.process_id}.json"),
                  "w") as f:
            json.dump({
                "process_id": args.process_id,
                "world_size": multiprocess.process_count(),
                "backend": multiprocess.backend(),
                "device": str(device),
                "losses": losses,
                "step_ms": step_ms,
                "checkpoint_roundtrip": True,
            }, f)
        print(f"worker {args.process_id}: ok, losses={losses}", flush=True)
        multiprocess.barrier("dryrun-exit")
    finally:
        multiprocess.shutdown()
    return 0


def control_main(args) -> int:
    """Single-process control emulating every shard (same global batch)."""
    import torch

    device = torch.device(args.device, 0) if args.device == "cuda" else "cpu"
    _, losses, step_ms = _train_schedule(
        args.nprocs, _data_files(args.data_dir), emulate=True, fsdp=False,
        steps=args.steps, device=device, config=args.config,
    )
    with open(os.path.join(args.out, "control.json"), "w") as f:
        json.dump({"losses": losses, "step_ms": step_ms}, f)
    print(f"control: losses={losses}", flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(args, extra: dict | None = None) -> dict:
    """A child's environment: this checkout first on the path; one intra-op
    thread a process on the CPU (N CPU processes of all the host's threads
    each contend many times over)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
    if args.device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def _wait_all(procs, timeout: float, label: str) -> list:
    """Each process's exit status; its output printed when it failed."""
    rcs = []
    for i, proc in enumerate(procs):
        try:
            pout, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            pout, _ = proc.communicate()
            pout += "\n[orchestrator] TIMEOUT"
        rcs.append(proc.returncode)
        if proc.returncode != 0:
            print(f"--- {label} {i} (rc={proc.returncode}) ---\n{pout[-3000:]}")
    return rcs


def _launch_command(args, command: list, i: int, port: int) -> subprocess.Popen:
    """Process ``i`` of an N-process launch of a port command, joined
    through the ``CROWDMOD_*`` variables."""
    env = _env(args, {
        "CROWDMOD_COORDINATOR": f"127.0.0.1:{port}",
        "CROWDMOD_NUM_PROCESSES": str(args.nprocs),
        "CROWDMOD_PROCESS_ID": str(i),
    })
    return subprocess.Popen(
        [sys.executable, "-m", "crowdmod_tpu_torch.cli", *command,
         "--device", args.device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=REPO,
    )


def cli_smoke(args) -> dict:
    """N processes running the port's ``train --data-parallel --multihost``
    command on a tiny corpus: the runbook's exact command, end to end.

    Asserts all processes exit 0, the checkpoint committed exactly once
    (no partial/tmp dirs), and process 0 owns the canonical run artifacts
    (its events, and its loss plot where matplotlib imports)."""
    import yaml

    from crowdmod_tpu_torch.viz import plotting_unavailable

    out = os.path.join(args.out, "cli")
    pkl_dir = os.path.join(out, "pickle")
    os.makedirs(pkl_dir, exist_ok=True)
    h, w = grid(args.config)
    files = [[os.path.basename(p), 6]
             for p in _write_corpus(pkl_dir, n_files=3, channels=4, h=h, w=w)]

    cfg = model_config(args.config).updated({
        "DATA_FS": {"PICKLE_DIR": pkl_dir,
                    "SAVE_DIR": os.path.join(out, "ckpts"),
                    "OUTPUT_DIR": os.path.join(out, "outdir")},
        "DATASET": {"RAW_SEQ_LEN": SEQ_LEN, "BATCH_SIZE": 8,
                    "TRAIN_FILE_COUNT": 1, "VAL_FILE_COUNT": 1,
                    "TEST_FILE_COUNT": 1},
        "MODEL": {"DDPM": {"TIMESTEPS": 10, "SAMPLER": "DDPM",
                           "DIT": {"TRAIN": {"EPOCHS": 2}}}},
        # float32, as the rehearsal's step and the JAX tool's CPU run: its
        # 1e-4 control checks are float32 ones.
        "TPU": {"COMPUTE_DTYPE": "float32"},
    })
    cfg_path = os.path.join(out, "cfg.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    list_path = os.path.join(out, "list.yml")
    with open(list_path, "w") as f:
        yaml.safe_dump({"DATA_LIST": files}, f)

    port = _free_port()
    t0 = time.time()
    procs = [_launch_command(args, [
        "train", "--config-yml-file", cfg_path, "--configList-yml-file",
        list_path, "--arch", ARCH, "--data-parallel", "--multihost",
        "--run-dir", os.path.join(out, "run")], i, port)
        for i in range(args.nprocs)]
    rcs = _wait_all(procs, args.timeout, "cli proc")
    ckpt_root = os.path.join(out, "ckpts")
    ckpts = (sorted(os.listdir(ckpt_root))
             if os.path.isdir(ckpt_root) else [])
    run = os.path.join(out, "run")
    result = {
        "rcs": rcs,
        "wall_s": round(time.time() - t0, 1),
        "checkpoints": ckpts,
        "no_partial_commits": not any(
            c.endswith((".orbax-checkpoint-tmp", ".pending", ".meta.json"))
            for c in ckpts
        ),
        "main_owns_run": os.path.exists(os.path.join(run, "events.jsonl")) and (
            os.path.exists(os.path.join(run, "losses.png"))
            or bool(plotting_unavailable())),
        "ok": all(rc == 0 for rc in rcs) and bool(ckpts),
    }
    result["ok"] = (result["ok"] and result["no_partial_commits"]
                    and result["main_owns_run"])
    return result


def metrics_smoke(args) -> dict:
    """N processes running the port's ``generate-metrics --data-parallel
    --multihost`` against the checkpoint :func:`cli_smoke` just trained,
    plus a single-process control: the runbook must cover evaluation, not
    just training.

    Asserts all processes exit 0, process 0 committed the canonical
    CSV/manifest, the secondaries' scratch artifacts agree bit for bit
    (cross-process agreement), and the multi-process CSVs match the
    single-process control within float tolerance."""
    import numpy as np

    out = os.path.join(args.out, "cli")  # cli_smoke's corpus + checkpoint
    cfg_path = os.path.join(out, "cfg.yml")
    list_path = os.path.join(out, "list.yml")
    common = [
        "--config-yml-file", cfg_path, "--configList-yml-file", list_path,
        "--arch", ARCH, "--metric", "ALL", "--chunk-repd-past-seq", "2",
    ]

    # Single-process control.
    ctrl_dir = os.path.join(out, "metrics_ctrl")
    try:
        r = subprocess.run(
            [sys.executable, "-m", "crowdmod_tpu_torch.cli", "generate-metrics",
             *common, "--output-dir", ctrl_dir, "--device", args.device],
            env=_env(args), capture_output=True, text=True,
            timeout=args.timeout, cwd=REPO,
        )
    except subprocess.TimeoutExpired:
        print("--- metrics control TIMED OUT ---")
        return {"ok": False, "control_timeout": True}
    if r.returncode != 0:
        print(f"--- metrics control (rc={r.returncode}) ---\n"
              f"{(r.stdout + r.stderr)[-3000:]}")
        return {"ok": False, "control_rc": r.returncode}

    # N-process multihost run.
    mh_dir = os.path.join(out, "metrics_mh")
    port = _free_port()
    t0 = time.time()
    procs = [_launch_command(args, [
        "generate-metrics", *common, "--data-parallel", "--multihost",
        "--output-dir", mh_dir], i, port) for i in range(args.nprocs)]
    rcs = _wait_all(procs, args.timeout, "metrics proc")

    def _arrays(d):
        manifest_path = os.path.join(d, "metrics_files.json")
        if not os.path.exists(manifest_path):
            return None
        with open(manifest_path) as f:
            manifest = json.load(f)
        out_arrays = {}
        for name, fname in manifest.items():
            path = os.path.join(d, os.path.basename(fname))
            if os.path.exists(path):
                out_arrays[name] = np.genfromtxt(
                    path, delimiter=",", skip_header=1
                )
        return out_arrays

    def _agree(a, b, atol):
        if a is None or b is None or set(a) != set(b):
            return False
        return all(
            a[k].shape == b[k].shape
            and np.allclose(a[k], b[k], atol=atol, equal_nan=True)
            for k in a
        )

    ctrl = _arrays(ctrl_dir)
    main_arrays = _arrays(mh_dir)
    # Secondaries write the identical suite into .procN scratch dirs.
    procs_agree = all(
        _agree(main_arrays, _arrays(os.path.join(mh_dir, f".proc{i}")),
               atol=0.0)
        for i in range(1, args.nprocs)
    )
    result = {
        "rcs": rcs,
        "wall_s": round(time.time() - t0, 1),
        "main_manifest": main_arrays is not None,
        "procs_agree": bool(procs_agree),
        "matches_control": bool(_agree(main_arrays, ctrl, atol=1e-4)),
        "metric_arrays": len(main_arrays or {}),
    }
    result["ok"] = (all(rc == 0 for rc in rcs) and result["main_manifest"]
                    and result["procs_agree"] and result["matches_control"])
    return result


def orchestrate(args) -> int:
    import numpy as np

    from crowdmod_tpu_torch.train.trainer import resolve_device

    resolve_device(args.device)
    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < args.nprocs:
            raise SystemExit(
                f"--nprocs {args.nprocs} over NCCL needs {args.nprocs} cards, "
                f"one a process; this host has {torch.cuda.device_count()}")
    os.makedirs(args.out, exist_ok=True)
    data_dir = os.path.join(args.out, "data")
    h, w = grid(args.config)
    _write_corpus(data_dir, n_files=max(4, args.nprocs), h=h, w=w)
    port = _free_port()

    def spawn(extra):
        base = [sys.executable, os.path.abspath(__file__),
                "--nprocs", str(args.nprocs),
                "--steps", str(args.steps),
                "--data-dir", data_dir, "--out", args.out,
                "--port", str(port), "--device", args.device]
        if args.fsdp:
            base.append("--fsdp")
        if args.config:
            base += ["--config", args.config]
        return subprocess.Popen(base + extra, env=_env(args),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    t0 = time.time()
    procs = [spawn(["--worker", "--process-id", str(i)])
             for i in range(args.nprocs)]
    rcs = _wait_all(procs, args.timeout, "worker")
    workers_ok = all(rc == 0 for rc in rcs)

    # Control run: one process, the same global batch.
    control_ok = _wait_all([spawn(["--control"])], args.timeout,
                           "control") == [0]

    report = {
        "ok": False,
        "nprocs": args.nprocs,
        "local_devices": 1,
        "device": args.device,
        "config": args.config or "tiny",
        "fsdp": bool(args.fsdp),
        "steps": args.steps,
        "wall_s": round(time.time() - t0, 1),
        "workers_rc": rcs,
    }
    if workers_ok and control_ok:
        workers = []
        for i in range(args.nprocs):
            with open(os.path.join(args.out, f"worker_{i}.json")) as f:
                workers.append(json.load(f))
        with open(os.path.join(args.out, "control.json")) as f:
            control = json.load(f)
        worker_losses = [wk["losses"] for wk in workers]
        same_across = all(wl == worker_losses[0] for wl in worker_losses)
        vs_control = bool(np.allclose(
            worker_losses[0], control["losses"], atol=1e-4
        ))
        report.update(
            losses=worker_losses[0], control_losses=control["losses"],
            max_abs_vs_control=float(np.max(np.abs(
                np.subtract(worker_losses[0], control["losses"])))),
            backend=workers[0]["backend"],
            # The first step builds; the median of the rest is the step.
            step_ms=[statistics.median(wk["step_ms"][1:] or wk["step_ms"])
                     for wk in workers],
            control_step_ms=statistics.median(
                control["step_ms"][1:] or control["step_ms"]),
            same_across_processes=same_across,
            matches_single_process_control=vs_control,
            checkpoint_roundtrip=all(wk["checkpoint_roundtrip"]
                                     for wk in workers),
            ok=same_across and vs_control,
        )
    if (args.cli or args.metrics) and report["ok"]:
        report["cli_smoke"] = cli_smoke(args)
        report["ok"] = report["ok"] and report["cli_smoke"]["ok"]
    if args.metrics and report["ok"]:
        report["metrics_smoke"] = metrics_smoke(args)
        report["ok"] = report["ok"] and report["metrics_smoke"]["ok"]
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--fsdp", action="store_true",
                   help="shard params over the data axis (FSDP2) instead "
                        "of replicating them (DDP)")
    p.add_argument("--out", default="/tmp/dryrun_multihost")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--cli", action="store_true",
                   help="also run the port's `train --multihost` command "
                        "end-to-end with N processes (the runbook command)")
    p.add_argument("--metrics", action="store_true",
                   help="after the CLI training smoke, run N-process "
                        "`generate-metrics --multihost` against its "
                        "checkpoint and compare the process-0 CSVs to a "
                        "single-process control (implies --cli)")
    p.add_argument("--config", default=None,
                   help="run this config's DDPM-DiT at its own width and grid "
                        "(e.g. serving/ATC.yml) instead of the tiny model")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default: NCCL, one card a process; raises "
                        "without a GPU) or cpu (gloo)")
    # worker/control plumbing (set by the orchestrator)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--process-id", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--data-dir", default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        return worker_main(args)
    if args.control:
        return control_main(args)
    return orchestrate(args)


if __name__ == "__main__":
    raise SystemExit(main())
