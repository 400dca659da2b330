"""The port's process glue (``crowdmod_tpu_torch.parallel.multiprocess``)
and the multi-process commands, on the CPU over gloo.

Worlds of processes are spawned here (:func:`spawn_world`): they meet
through a ``file://`` rendezvous in the test's own directory (no TCP port
to collide under xdist), and each world has a timeout, so a hung
rendezvous fails its test.  The ranks' work is the module-level functions
below, which import only torch and the port; ``test_torch_parallel.py``
spawns them too.  The commands run as OS processes: ``train`` and
``generate-metrics`` with ``--multihost`` (two processes joined through the
``CROWDMOD_*`` variables), ``serve --data-parallel``.
"""

import json
import multiprocessing
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from crowdmod_tpu_torch.parallel import launch, multiprocess

REPO = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 240  # a spawned world's limit; its process group's is 120 s
SEED = 5
BATCH = 4
TIMESTEPS = 10  # a short chain: the spawned worlds share the host with other tests


# ---------------------------------------------------------------------------
# Spawned worlds
# ---------------------------------------------------------------------------

def spawn_world(target, world: int, tmp_path: Path, *args):
    """``target(tmp_path, *args)`` on ``world`` gloo processes → rank 0's
    return value.  Every process must end with status 0 within
    :data:`WORLD_TIMEOUT_S`."""
    ctx = multiprocessing.get_context("spawn")
    init = "file://" + str(tmp_path / "rendezvous")
    procs = [ctx.Process(target=_rank_main, args=(target, world, r, init, str(tmp_path), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p.name for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"spawned world timed out: {hung}"
    assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]
    return torch.load(tmp_path / "rank0.pt", weights_only=False)


def _rank_main(target, world, rank, init, tmp, args):
    torch.set_num_threads(1)
    multiprocess.initialize(init_method=init, num_processes=world, process_id=rank,
                            device_type="cpu", timeout_s=120)
    try:
        out = target(Path(tmp), *args)
        if rank == 0:
            torch.save(out, Path(tmp) / "rank0.pt")
    finally:
        multiprocess.shutdown()


def tiny_config(arch: str, root: Path, dropout: float = 0.1, cfg_drop: float = 0.1):
    """The parity tests' tiny models (a base-8 two-level UNet with attention
    at level 1, a hidden-64 depth-2 DiT), batch 4, T = 10, with dropout and
    the CFG drop on: every draw of a step matters."""
    from crowdmod_tpu_torch.config import load_config

    backbone = {
        "UNET": {"BASE_CH": 8, "BASE_CH_MULT": [1, 2], "APPLY_ATTENTION": [False, True],
                 "DROPOUT_RATE": dropout, "TRAIN": {"EPOCHS": 1, "EMA_DECAY": 0.9}},
        "DIT": {"HIDDEN_SIZE": 64, "DEPTH": 2, "NUM_HEADS": 4, "DROPOUT_RATE": dropout,
                "TRAIN": {"EPOCHS": 1, "EMA_DECAY": 0.9}},
    }
    return load_config("4test/ATC.yml", overrides={
        "DATA_FS": {"SAVE_DIR": str(root / "ckpts"), "OUTPUT_DIR": str(root / "out")},
        "MACROPROPS": {"ROWS": 8, "COLS": 12},
        "DATASET": {"BATCH_SIZE": BATCH},
        "MODEL": {"DDPM": {"TIMESTEPS": TIMESTEPS, "CHECKPOINTS_TO_KEEP": 0,
                           "CFG_DROP_PROB": cfg_drop, **backbone},
                  "FM": {"CHECKPOINTS_TO_KEEP": 0, "CFG_DROP_PROB": cfg_drop, **backbone}},
        "METRICS": {"CHUNK_REPD_PAST_SEQ": 2},
    })


def walker_windows(n: int = 6, seed: int = 3):
    """(n, 16, 8, 12, 3) walkers plus seeded noise → windows of 8 frames at
    stride 8 (two a sequence: 12 windows, three batches of 4)."""
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.data.windows import WindowDataset

    raw = synthetic_walkers(n, 8, 12, 16)
    raw = raw + np.random.default_rng(seed).normal(0, 0.1, raw.shape).astype(np.float32)
    return WindowDataset(torch.from_numpy(raw), past_len=5, future_len=3, stride=8)


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def dp_fit(tmp: Path, arch: str, mode: str) -> dict:
    """One process's part of a data-parallel run (the whole run without a
    process group): step 1's gradients, a 3-step ``fit`` with ``evaluate``
    (its best checkpoint saved), the weights and EMA, a ragged ``sample``
    and ``generate_metrics``.  Under FSDP also: a second sharded trainer
    loads the checkpoint.  → rank 0's results."""
    from crowdmod_tpu_torch.parallel.mesh import make_mesh
    from crowdmod_tpu_torch.train.trainer import StepDraws, Trainer

    rank = multiprocess.process_index()
    cfg = tiny_config(arch, tmp)
    mesh = make_mesh() if multiprocess.active() else None
    tr = Trainer(cfg, arch, device="cpu", seed=SEED, mesh=mesh, param_sharding=mode,
                 run_dir=str(tmp / f"run{rank}")).setup()
    ds = walker_windows()
    first = next(ds.batches(BATCH, shuffle=True, seed=SEED + 1))
    draws = StepDraws(generator=torch.Generator().manual_seed(11))
    tr._loss_fn()(*tr._rank_args(first, draws)).backward()
    grads = {n: _whole(p.grad).clone() for n, p in tr.model.named_parameters()}
    tr.model.zero_grad(set_to_none=True)

    hist = tr.fit(ds, ds, epochs=1)
    out = dict(history=hist, grads=grads, lr=tr.plateau.lr, step=tr.state.step,
               params={k: v.clone() for k, v in tr.params.items()},
               ema={k: v.clone() for k, v in tr.ema_params.items()})
    past = ds.gather(np.arange(5))[0]  # 5 rows: ragged over 2 processes
    out["sample"] = tr.sample(past, torch.Generator().manual_seed(7))
    out["metrics"] = {k: np.asarray(v) for k, v in tr.generate_metrics(
        ds, chunk=2, output_dir=str(tmp / f"metrics{rank}"), seed=9).items()}
    from crowdmod_tpu_torch.train import checkpoint as ckpt

    out["ckpt"] = str(Path(cfg.DATA_FS.SAVE_DIR) / ckpt.checkpoint_name(cfg, arch, "000"))
    if mode == "fsdp" and mesh is not None:
        again = Trainer(cfg, arch, device="cpu", seed=SEED + 1, mesh=mesh,
                        param_sharding="fsdp", run_dir=str(tmp / f"again{rank}"))
        again.load(out["ckpt"])
        p0 = dict(tr.model.named_parameters())
        out["reloaded"] = {k: v.clone() for k, v in again.params.items()}
        out["reloaded_step"] = again.state.step
        out["same_layout"] = all(
            p.placements == p0[n].placements and p.to_local().shape == p0[n].to_local().shape
            for n, p in again.model.named_parameters())
        moments = [s["exp_avg"] for s in again.state.optimizer.state.values()]
        out["moments_sharded"] = bool(moments) and all(
            type(m).__name__ == "DTensor" for m in moments)
    return out


def glue(tmp: Path) -> dict:
    """The helpers of a 2-process world: ``process_allgather`` of a tree of
    a scalar, a plain tensor and an FSDP-style shard; ``all_processes_equal``
    on equal, NaN and differing values; ``global_batch``, ``all_gather_rows``
    and ``mean_over_processes``; the mesh's ``shard_batch`` and
    ``replicate``; ``host_shard``'s defaults and ``device_prefetch``'s rows
    under the group."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from crowdmod_tpu_torch.data.prefetch import device_prefetch, host_shard
    from crowdmod_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

    rank = multiprocess.process_index()
    mesh = make_mesh()
    full = torch.arange(12.0).reshape(4, 3)
    tree = {"lr": 0.25, "step": torch.tensor(3.0),
            "w": distribute_tensor(full, mesh["data"], [Shard(0)]), "rows": [full[rank]]}
    gathered = multiprocess.process_allgather(tree)
    batch = (torch.arange(8.0).reshape(8, 1), np.arange(8))
    src = [(torch.arange(8.0) + 10 * k).reshape(4, 2) for k in range(3)]
    return dict(
        gathered=gathered, local_w=tree["w"].to_local().clone(),
        equal=multiprocess.all_processes_equal(1.5, name="same"),
        nan_equal=multiprocess.all_processes_equal(float("nan"), name="nan"),
        differ=multiprocess.all_processes_equal(float(rank), name="rank"),
        rows=multiprocess.global_batch(batch),
        all_rows=multiprocess.all_gather_rows(torch.full((2, 1), float(rank))),
        mean=multiprocess.mean_over_processes(torch.tensor([float(rank), 2.0])),
        shard=host_shard([f"f{i}" for i in range(5)]),
        mesh_shape=tuple(mesh.shape), mesh_rows=shard_batch(torch.arange(6.0), mesh),
        replicated=replicate({"w": [torch.full((2,), float(rank) + 1.0)]}, mesh),
        prefetched=list(device_prefetch(iter(src), device="cpu")),
        main=multiprocess.is_main(), count=multiprocess.process_count(),
    )


# ---------------------------------------------------------------------------
# The process glue
# ---------------------------------------------------------------------------

def test_initialize_partial_env_is_a_labeled_error(monkeypatch):
    """A manual launch that sets CROWDMOD_COORDINATOR but not the other two
    variables fails with the runbook's hint; so does a torchrun-style
    environment without MASTER_ADDR, and no launch at all."""
    for key in ("CROWDMOD_COORDINATOR", "CROWDMOD_NUM_PROCESSES", "CROWDMOD_PROCESS_ID",
                "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="no multi-process launch"):
        multiprocess.initialize(device_type="cpu")
    monkeypatch.setenv("CROWDMOD_COORDINATOR", "127.0.0.1:9999")
    with pytest.raises(RuntimeError, match="CROWDMOD_NUM_PROCESSES"):
        multiprocess.initialize(device_type="cpu")
    monkeypatch.setenv("CROWDMOD_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="CROWDMOD_PROCESS_ID"):
        multiprocess.initialize(device_type="cpu")
    monkeypatch.delenv("CROWDMOD_COORDINATOR")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multiprocess.initialize(device_type="cpu")
    assert not multiprocess.active()


def test_single_process_degrades():
    """Without a process group every helper is the one-process identity."""
    tree = {"lr": 0.5, "w": torch.ones(3)}
    got = multiprocess.process_allgather(tree)
    assert got["lr"] == 0.5 and got["w"] is tree["w"]
    assert multiprocess.all_processes_equal(3.0) and multiprocess.is_main()
    assert multiprocess.global_batch(tree) is tree
    assert multiprocess.rank_rows(5) == slice(0, 5)
    multiprocess.barrier()
    x = torch.arange(4.0)
    assert multiprocess.all_gather_rows(x) is x and multiprocess.mean_over_processes(x) is x


@pytest.fixture(scope="module")
def glue_world(tmp_path_factory):
    return spawn_world(glue, 2, tmp_path_factory.mktemp("glue"))


def test_process_allgather_keeps_scalars(glue_world):
    got = glue_world["gathered"]
    assert got["lr"] == 0.25 and isinstance(got["lr"], float)
    assert got["step"].shape == () and float(got["step"]) == 3.0
    assert torch.equal(got["w"], torch.arange(12.0).reshape(4, 3))  # the whole tensor
    assert glue_world["local_w"].shape == (2, 3)  # rank 0's shard
    assert torch.equal(got["rows"][0], torch.arange(3.0))  # a plain leaf stays local


def test_all_processes_equal_is_false_on_a_mismatch(glue_world):
    assert glue_world["equal"] and glue_world["nan_equal"]
    assert glue_world["differ"] is False


def test_rows_gathers_and_means_under_the_group(glue_world):
    rows_t, rows_np = glue_world["rows"]
    assert torch.equal(rows_t, torch.arange(4.0).reshape(4, 1))  # rank 0: the first half
    assert np.array_equal(rows_np, np.arange(4))
    assert torch.equal(glue_world["all_rows"], torch.tensor([[0.0], [0.0], [1.0], [1.0]]))
    assert torch.equal(glue_world["mean"], torch.tensor([0.5, 2.0]))
    assert glue_world["main"] and glue_world["count"] == 2
    assert glue_world["mesh_shape"] == (2, 1)
    assert torch.equal(glue_world["mesh_rows"], torch.arange(3.0))
    assert torch.equal(glue_world["replicated"]["w"][0], torch.full((2,), 1.0))
    assert glue_world["shard"] == ["f0", "f2", "f4"]  # host_shard's defaults: rank 0 of 2
    got = glue_world["prefetched"]  # device_prefetch yields rank 0's rows
    assert [g.tolist() for g in got] == [
        [[10 * k + 0.0, 10 * k + 1.0], [10 * k + 2.0, 10 * k + 3.0]] for k in range(3)]


def _hang(tmp: Path) -> None:
    time.sleep(60)


def test_a_hung_world_fails_within_its_limit(tmp_path, monkeypatch):
    """A world that does not finish fails its test at the world's limit,
    its processes ended, rather than holding the tier."""
    monkeypatch.setattr(sys.modules[__name__], "WORLD_TIMEOUT_S", 5)
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="timed out"):
        spawn_world(_hang, 1, tmp_path)
    assert time.monotonic() - t0 < 30


# ---------------------------------------------------------------------------
# The commands
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _workspace(tmp: Path, arch: str = "DDPM-UNet"):
    """Three reference-layout pickles of 4 sequences (8 windows each, two
    batches of 4), a copy of the tiny config pointing at them, its
    DATA_LIST → (config path, list path)."""
    import pickle

    import yaml

    cfg = tiny_config(arch, tmp, dropout=0.0, cfg_drop=0.0)
    pkl = tmp / "pickle"
    pkl.mkdir()
    rng = np.random.default_rng(0)
    files = []
    for k in range(3):
        arr = np.abs(rng.normal(size=(4, 4, 8, 12, 16))).astype(np.float32)
        with open(pkl / f"f{k}.pkl", "wb") as f:
            pickle.dump(arr, f)
        files.append([f"f{k}.pkl", 4])
    cfg = cfg.updated({"DATA_FS": {"PICKLE_DIR": str(pkl)},
                       "DATASET": {"RAW_SEQ_LEN": 16, "TRAIN_FILE_COUNT": 1,
                                   "VAL_FILE_COUNT": 1, "TEST_FILE_COUNT": 1,
                                   "DATASET_TYPE": "ByFilenames"}})
    cfg_path, list_path = tmp / "cfg.yml", tmp / "list.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    list_path.write_text(yaml.safe_dump({"DATA_LIST": files}))
    return str(cfg_path), str(list_path)


# One thread a process: two CPU processes of 8 threads each on a shared host
# spend most of a gloo run contending (a step 30x slower).
ONE_THREAD = {"OMP_NUM_THREADS": "1"}


def _cli(*args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "crowdmod_tpu_torch.cli", *args], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, **ONE_THREAD, **(env or {})})


def _multihost(*args, world=2):
    """``args`` as ``world`` processes joined through the CROWDMOD_*
    variables → their outputs, each process's status 0."""
    port = _free_port()
    procs = [_cli(*args, env={"CROWDMOD_COORDINATOR": f"127.0.0.1:{port}",
                              "CROWDMOD_NUM_PROCESSES": str(world),
                              "CROWDMOD_PROCESS_ID": str(r)}) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, outs
    return outs


def _csv_values(directory: Path) -> dict:
    return {p.name: np.loadtxt(p, delimiter=",", skiprows=1, ndmin=2)
            for p in sorted(directory.glob("*.csv"))}


def test_multihost_train_and_generate_metrics(tmp_path):
    """Two processes of ``train --multihost --data-parallel --device cpu``
    and of ``generate-metrics --multihost``: process 0 owns the run
    directory and commits the checkpoint once, process 1 tracks into
    ``.proc1`` and writes its CSVs there; the CSVs equal a one-process
    control run of the same checkpoint (and process 1's equal process 0's
    bit for bit: the same gathered samples, the same suite)."""
    cfg, lst = _workspace(tmp_path)
    common = ["--config-yml-file", cfg, "--configList-yml-file", lst, "--arch", "DDPM-UNet",
              "--device", "cpu"]
    outs = _multihost("train", *common, "--data-parallel", "--multihost")
    runs = tmp_path / "out" / "runs" / "DDPM-UNet"
    assert (runs / "events.jsonl").exists() and (runs / ".proc1" / "events.jsonl").exists()
    ckpts = list((tmp_path / "ckpts").iterdir())
    assert [c.name for c in ckpts] == ["DDPM-UNet_ATC4TEST_TE1_PL5_FL3_CE000_NA"]
    logs = tmp_path / "out" / "logs"
    assert (logs / "train.p0.log").exists() and (logs / "train.p1.log").exists()
    commits = [out.count("checkpoint committed") for out in outs]
    assert commits == [1, 0], commits
    losses = [json.loads(out.split("train steps: ")[1].splitlines()[0])["step_loss"]
              for out in outs]
    assert losses[0] == losses[1]  # reduced over the processes

    metrics = tmp_path / "m"
    _multihost("generate-metrics", *common, "--data-parallel", "--multihost",
               "--output-dir", str(metrics))
    control = tmp_path / "control"
    p = _cli("generate-metrics", *common, "--output-dir", str(control))
    out = p.communicate(timeout=300)[0]
    assert p.returncode == 0, out
    got, mirror, want = (_csv_values(d) for d in (metrics, metrics / ".proc1", control))
    assert got.keys() == want.keys() == mirror.keys() and len(got) >= 18
    for name, w in want.items():
        assert np.array_equal(got[name], mirror[name], equal_nan=True), name
        np.testing.assert_allclose(got[name], w, rtol=1e-4, atol=1e-6, err_msg=name)
    assert json.loads((metrics / "metrics_files.json").read_text()).keys() == \
        json.loads((control / "metrics_files.json").read_text()).keys()


def test_data_parallel_spawn_trains_on_the_cpu(tmp_path):
    """``train --data-parallel --fsdp --device cpu`` spawns its world (one
    process on the CPU) and trains; ``--multihost`` and ``--fsdp`` need
    ``--data-parallel``, checked before any rendezvous."""
    cfg, lst = _workspace(tmp_path)
    common = ["--config-yml-file", cfg, "--configList-yml-file", lst, "--arch", "DDPM-UNet",
              "--device", "cpu"]
    p = _cli("train", *common, "--data-parallel", "--fsdp")
    out = p.communicate(timeout=300)[0]
    assert p.returncode == 0, out
    assert "data parallel: process 0/1" in out and "FSDP" in out
    assert (tmp_path / "ckpts" / "DDPM-UNet_ATC4TEST_TE1_PL5_FL3_CE000_NA" / "state.pt").exists()
    from crowdmod_tpu_torch.cli import generate_metrics, train

    for run, flags in ((train.run, ["--fsdp"]), (train.run, ["--multihost"]),
                       (generate_metrics.run, ["--multihost"])):
        with pytest.raises(SystemExit, match="require --data-parallel"):
            run([*common, *flags])


def test_model_parallel_exits_2_naming_its_roadmap_item(capsys, monkeypatch):
    """Tensor parallelism is ported: ``--model-parallel 2`` runs (as in
    ``test_torch_tensor_parallel.py``), and a mesh that does not cover the
    launch's processes — a model axis of 2 over a manual launch of 3 —
    exits 2 naming the mesh, before any handshake."""
    from crowdmod_tpu_torch.cli import train

    monkeypatch.setenv("CROWDMOD_NUM_PROCESSES", "3")
    assert train.run(["--data-parallel", "--multihost", "--model-parallel", "2",
                      "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "data x model mesh does not cover the 3 processes" in err
    assert "16b" not in err and launch.mesh_mismatch(3, None, 2) in err


def _status(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(base + path, data=data)) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_serve_data_parallel_on_the_cpu(tmp_path):
    """``serve --data-parallel --device cpu``: one replica (the CPU), its
    seeded future equal to a plain predictor's; SIGTERM → exit 0."""
    from crowdmod_tpu_torch.serving import load_predictor
    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg = tiny_config("DDPM-DiT", tmp_path, dropout=0.0, cfg_drop=0.0)
    cfg_path = tmp_path / "cfg.yml"
    import yaml

    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    tr = Trainer(cfg, "DDPM-DiT", device="cpu", seed=SEED)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        for v in tr.model.parameters():
            v.add_(0.02 * torch.randn(v.shape, generator=gen))
    tr.save(cfg.DATA_FS.SAVE_DIR, "000")
    past = np.random.default_rng(2).normal(size=(2, 5, 8, 12, 3)).astype(np.float32)
    want = load_predictor(str(cfg_path), "DDPM-DiT", device="cpu",
                          batch_buckets=(1, 2)).predict(past, seed=4)

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "crowdmod_tpu_torch.cli", "serve", "--arch", "DDPM-DiT",
         "--config-yml-file", str(cfg_path), "--device", "cpu", "--data-parallel",
         "--port", str(port), "--batch-buckets", "1", "2"],
        cwd=tmp_path, env={**os.environ, **ONE_THREAD, "PYTHONPATH": str(REPO)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                if _status(base, "/healthz")[0] == 200:
                    break
            except OSError:
                pass  # not listening yet
            time.sleep(0.2)
        else:
            raise AssertionError("the server never became ready")
        code, body = _status(base, "/predict", {"past": past.tolist(), "seed": 4})
        assert code == 200
        np.testing.assert_array_equal(np.asarray(body["future"], np.float32), want)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
