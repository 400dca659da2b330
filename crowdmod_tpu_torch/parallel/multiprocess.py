"""Multi-process runtime glue on ``torch.distributed`` (port of the JAX
package's ``parallel/multiprocess.py``).

One process drives one card (or, with gloo, one CPU); the processes form
one process group:

* :func:`initialize` — join or form the group: from the ``CROWDMOD_*``
  variables of a manual launch, from torchrun's ``RANK``/``WORLD_SIZE``/
  ``MASTER_ADDR``, or from explicit arguments (the commands' own spawn
  passes a ``file://`` rendezvous).  NCCL on the card, gloo on the CPU.
* :func:`global_batch` — this process's rows of a global batch (every
  process reads the same batch; each trains on its slice).  Given a mesh,
  the rows are the data index's: the ranks of one model group take the
  same rows, and the gathers and the mean run over the data axis.
* :func:`process_allgather`, :func:`all_gather_rows`,
  :func:`mean_over_processes` — the gathers and the reduction that
  checkpoints, sampling and the loss need.
* :func:`all_processes_equal` — cross-process agreement check.
* :func:`barrier` / :func:`is_main` — sync and process-0 commit helpers.

Every helper degrades to single-process behaviour without a process group,
so library code calls them unconditionally.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

_PARTIAL = (
    "a manual multi-process launch needs all three of CROWDMOD_COORDINATOR, "
    "CROWDMOD_NUM_PROCESSES, CROWDMOD_PROCESS_ID (README.md, Scaling)"
)


def active() -> bool:
    """True inside an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if active() else 0


def process_count() -> int:
    return dist.get_world_size() if active() else 1


def _launch_from_env() -> tuple[str, int, int] | None:
    """(init_method, world size, rank) of a manual or torchrun launch, or
    None when the environment holds neither."""
    env = os.environ
    coordinator = env.get("CROWDMOD_COORDINATOR")
    if coordinator:
        try:
            world = int(env["CROWDMOD_NUM_PROCESSES"])
            rank = int(env["CROWDMOD_PROCESS_ID"])
        except KeyError as missing:
            raise RuntimeError(
                f"CROWDMOD_COORDINATOR is set but {missing.args[0]} is not — {_PARTIAL}"
            ) from None
        return f"tcp://{coordinator}", world, rank
    if "RANK" in env or "WORLD_SIZE" in env:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in env]
        if missing:
            raise RuntimeError(
                f"a torchrun-style launch sets RANK, WORLD_SIZE, MASTER_ADDR and "
                f"MASTER_PORT; {missing} not set"
            )
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def _local_rank(rank: int) -> int:
    """The card of this process on its host: torchrun's ``LOCAL_RANK``,
    ``CROWDMOD_LOCAL_RANK``, else the rank modulo the host's cards."""
    for key in ("LOCAL_RANK", "CROWDMOD_LOCAL_RANK"):
        if key in os.environ:
            return int(os.environ[key])
    return rank % max(torch.cuda.device_count(), 1)


def backend() -> str | None:
    """The process group's backend ("nccl", "gloo"), None without one."""
    return dist.get_backend() if active() else None


def device() -> torch.device:
    """This process's device: its card under NCCL, else the CPU."""
    if active() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device_type: str = "cuda",
    init_method: str | None = None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join (or form) the process group; → this process's device.

    ``coordinator_address`` (``host:port``, process 0 hosts the store),
    ``num_processes`` and ``process_id`` go together; ``init_method`` (a
    ``file://`` or ``tcp://`` URL) replaces the address.  With neither, the
    environment is read: ``CROWDMOD_COORDINATOR``/``CROWDMOD_NUM_PROCESSES``/
    ``CROWDMOD_PROCESS_ID``, else torchrun's variables.  ``device_type``
    "cuda" uses NCCL (and raises where CUDA or NCCL is missing: CUDA tensors
    never go through gloo) after making this process's card the current
    device; "cpu" uses gloo.  Idempotent: a second call returns the device.
    """
    if active():
        return device()
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}; expected cuda or cpu")
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is None:
        launch = _launch_from_env()
        if launch is None:
            raise RuntimeError(
                "no multi-process launch found: export CROWDMOD_COORDINATOR, "
                "CROWDMOD_NUM_PROCESSES and CROWDMOD_PROCESS_ID, or start the "
                "processes with torchrun"
            )
        init_method, num_processes, process_id = launch
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id go with an explicit rendezvous")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; a data-parallel run on the card needs "
                "one — pass device cpu to run on gloo"
            )
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch build has no NCCL; CUDA tensors "
                               "do not fall back to gloo")
        torch.cuda.set_device(_local_rank(process_id))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )
    logging.info("process group up: %s, process %d/%d, device %s", backend,
                 process_index(), process_count(), device())
    return device()


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if active():
        dist.destroy_process_group()


def is_main() -> bool:
    """True on the process that owns single-writer side effects (checkpoint
    commit, metrics files, logging)."""
    return process_index() == 0


def barrier(name: str = "crowdmod") -> None:
    """Block until every process reaches this point (no-op single-process).
    Used around process-0 filesystem commits."""
    if process_count() == 1:
        return
    logging.debug("barrier %s", name)
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def data_coords(mesh=None) -> tuple[int, int, Any]:
    """(this process's data index, the data size, the data group): the
    mesh's "data" axis, else every process on it (group None: the world)."""
    if mesh is None or not active():
        return process_index(), process_count(), None
    axis = mesh["data"]
    return axis.get_local_rank(), axis.size(), axis.get_group()


def rank_rows(n: int, mesh=None) -> slice:
    """This process's rows of a global batch of ``n``: its data index's
    share of the data size's equal contiguous slices (the process's of the
    processes' without a mesh)."""
    index, size, _ = data_coords(mesh)
    if n % size:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{size} data-parallel processes; use a multiple of {size}")
    m = n // size
    return slice(index * m, (index + 1) * m)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def global_batch(batch: Any, mesh=None) -> Any:
    """This process's rows of ``batch`` (tensors or arrays with the global
    batch on dim 0, in nested tuples, lists or dicts): the global batch is
    the concatenation of every data index's rows in order.  The batch
    itself without a process group or on a data axis of one."""
    if data_coords(mesh)[1] == 1:
        return batch
    return _tree_map(lambda x: x[rank_rows(x.shape[0], mesh)], batch)


def process_allgather(tree: Any) -> Any:
    """Gather the distributed leaves of ``tree`` to full tensors on every
    process: the pre-step of a process-0 commit of FSDP-sharded state.

    Only ``DTensor`` leaves (FSDP's shards) go through the collective;
    every other leaf — a plain tensor, a Python scalar such as the learning
    rate — is the same on every process already and is returned as is, so
    scalars never become ``(nprocs,)`` stacks.
    """
    from torch.distributed.tensor import DTensor

    return _tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def all_gather_rows(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Every data index's ``x`` (equal shapes) concatenated on dim 0 in
    order, on every process; ``x`` itself without a process group."""
    _, size, group = data_coords(mesh)
    if size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def mean_over_processes(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean of ``x`` over the data indices (an all-reduce), equal on
    every process; ``x`` itself without a process group."""
    _, size, group = data_coords(mesh)
    if size == 1:
        return x
    y = x.detach().to(device(), torch.float64).clone()
    dist.all_reduce(y, group=group)
    return (y / size).to(x.dtype)


def all_processes_equal(value, *, atol: float = 0.0, name: str = "value") -> bool:
    """True when ``value`` (a scalar or small array) is the same on every
    process, within ``atol``; every process gets the verdict.  The classic
    silent bugs of a multi-process run — a different data order, a
    non-deterministic reduction — show here first."""
    arr = np.asarray(value.detach().cpu() if isinstance(value, torch.Tensor) else value,
                     dtype=np.float64)
    if process_count() == 1:
        return True
    gathered = all_gather_rows(torch.from_numpy(arr.reshape(1, -1)).to(device()))
    gathered = gathered.cpu().numpy()
    nan = np.isnan(gathered) & np.isnan(gathered[0])  # a NaN loss everywhere agrees
    ok = bool(np.all((np.abs(gathered - gathered[0]) <= atol) | nan))
    if not ok:
        logging.error("cross-process mismatch in %s: %s", name, gathered.tolist())
    return ok
