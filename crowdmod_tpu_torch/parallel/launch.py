"""How ``train`` and ``generate-metrics`` run data-parallel (the JAX
package's ``--data-parallel`` / ``--multihost`` flags).

  * ``--data-parallel`` alone: the command spawns one process a card of
    this host (on the CPU, one process a rank of the model axis: a world of
    one over gloo without ``--model-parallel``), which meet through a
    ``file://`` rendezvous in a temporary directory;
  * ``--data-parallel --multihost``: this process joins a launch made
    outside — ``CROWDMOD_COORDINATOR``/``CROWDMOD_NUM_PROCESSES``/
    ``CROWDMOD_PROCESS_ID`` on each process, or torchrun.

``--model-parallel N`` (``train`` only) adds a "model" axis of N: the
("data", "model") mesh must cover the world exactly, which is checked
before any handshake (exit 2 otherwise).  Either way each process runs
the command's ``run_rank(args, device)``, then waits at an exit barrier
for the others.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import sys
import tempfile
import time

from crowdmod_tpu_torch.parallel import multiprocess

EXIT_GRACE_S = 30.0  # how long the others may take to stop after one failed


def check_flags(args) -> int | None:
    """The parallel flags' rules, before any handshake (a late check would
    leave the other processes waiting at the rendezvous): → 2 for
    ``--model-parallel`` under 1; raises ``SystemExit`` when ``--fsdp``,
    ``--multihost`` or ``--model-parallel`` comes without
    ``--data-parallel``; else None."""
    model = getattr(args, "model_parallel", None)
    if model is not None and model < 1:
        print(f"--model-parallel {model}: the model axis needs at least 1 process",
              file=sys.stderr)
        return 2
    given = [flag for flag, on in (("--fsdp", getattr(args, "fsdp", False)),
                                   ("--multihost", args.multihost),
                                   ("--model-parallel", model is not None)) if on]
    if given and not args.data_parallel:
        raise SystemExit(f"{'/'.join(given)} require --data-parallel")
    return None


def mesh_mismatch(world: int, data: int | None, model: int) -> str | None:
    """Why a ``data`` × ``model`` mesh (``data`` None: every other process)
    does not cover ``world`` processes, or None when it does."""
    if data is None and world % model == 0 or data is not None and data * model == world:
        return None
    shape = f"{'world/' + str(model) if data is None else data}x{model}"
    return (f"the ({shape}) data x model mesh does not cover the {world} processes "
            "of this launch")


def _launch_world() -> int | None:
    """The world size a manual or torchrun launch announces, or None."""
    for key in ("CROWDMOD_NUM_PROCESSES", "WORLD_SIZE"):
        if key in os.environ:
            return int(os.environ[key])
    return None


def run_ranks(command: str, argv: list[str], device, multihost: bool, *,
              data: int | None = None, model: int = 1) -> int:
    """Run ``command`` (a module with ``build_parser`` and ``run_rank``) on
    every process of the parallel run, whose mesh is ``data`` × ``model``
    (``data`` None: every other process on the data axis); → the exit
    status, 2 when the mesh does not cover the world."""
    from crowdmod_tpu_torch.train.trainer import resolve_device

    device = resolve_device(device)
    if multihost:
        world = _launch_world()
        why = None if world is None else mesh_mismatch(world, data, model)
        if why:
            print(why, file=sys.stderr)
            return 2
        return _rank(command, argv, device.type)
    import torch

    if device.type == "cuda":
        world = torch.cuda.device_count()
    else:  # one CPU process a mesh position
        world = model * (data or 1)
    why = mesh_mismatch(world, data, model)
    if why:
        print(why, file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="crowdmod_dp_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_spawned, name=f"crowdmod-rank{r}",
                             args=(command, argv, device.type, init, world, r))
                 for r in range(world)]
        for p in procs:
            p.start()
        return _wait(procs)


def _spawned(command, argv, device_type, init_method, world, rank) -> None:
    sys.exit(_rank(command, argv, device_type, init_method, world, rank))


def _rank(command, argv, device_type, init_method=None, world=None, rank=None) -> int:
    module = importlib.import_module(command)
    args = module.build_parser().parse_args(argv)
    device = multiprocess.initialize(num_processes=world, process_id=rank,
                                     device_type=device_type, init_method=init_method)
    try:
        code = module.run_rank(args, device)
        # Rejoin before exit: a process that finished first must not leave
        # while process 0 still writes the run's files.
        multiprocess.barrier(f"{command}-exit")
    finally:
        multiprocess.shutdown()
    return code


def _wait(procs) -> int:
    """Join the spawned processes; once one fails, give the others
    :data:`EXIT_GRACE_S` to stop, then end them (they would wait for it in
    the next collective).  → 0, or the first failure's status."""
    failed_at = code = None
    while any(p.is_alive() for p in procs):
        for p in procs:
            if p.exitcode not in (None, 0) and failed_at is None:
                failed_at, code = time.monotonic(), p.exitcode
        if failed_at is not None and time.monotonic() - failed_at > EXIT_GRACE_S:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        time.sleep(0.2)
    for p in procs:
        p.join()
        if code is None and p.exitcode:
            code = p.exitcode
    return 0 if code is None else (code if code > 0 else 1)

