"""Checkpoints (port of the JAX package's ``train/checkpoint.py``).

A port checkpoint is a directory holding ``state.pt`` — a torch file with
``params`` and, when EMA is on, ``ema_params`` (each a state_dict in the
reference torch layout) and, from a trainer, ``step``, the Adam state
(``optimizer``) and the learning rate (``lr``) — plus the same
``metadata.json`` the JAX package writes.  The directory is named by
:func:`checkpoint_name`, the reference's run-name convention.  The JAX
package's orbax directories need JAX to read; ``import-checkpoint``
converts them.

``save_checkpoint(..., async_save=True)`` is the JAX package's async
commit: the state is snapshotted at the call (on the card: a copy on the
device in stream order, so the next step's in-place updates cannot reach
it) and a background thread copies it to pinned host memory on a stream
of its own and writes it into ``<dir>.pending``, its metadata into the
sidecar ``<dir>.meta.json``.  :func:`wait_for_saves` waits for the
commit, then swaps the staged directory into place, so the previous
checkpoint at ``<dir>`` survives until its replacement is whole on disk.  A synchronous
save waits for pending ones first.  The files are those of a synchronous
save of the same state, byte for byte.

Under a process group a save is collective: every process gathers the
full state (:func:`full_state_dict`, :func:`full_optimizer_state`; FSDP's
shards over "data", then the tensor-parallel slices over "model", become
whole tensors), process 0 writes it between two barriers
(:func:`commit_checkpoint`), and the files are those of a one-process save.
A load onto a sharded model puts each tensor back in its shard layout
(:func:`load_full_state_dict`, :func:`load_optimizer_state`), whatever
mesh wrote it.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import shutil
from pathlib import Path

import torch

from crowdmod_tpu_torch.config import FrozenConfig
from crowdmod_tpu_torch.parallel import multiprocess, tensor

STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"
STAGE_SUFFIX = ".pending"  # an async save's directory until its swap
SIDECAR_SUFFIX = ".meta.json"  # an async save's metadata until its swap
ORBAX_TMP_SUFFIX = ".orbax-checkpoint-tmp"  # the JAX package's half-committed saves

# (commit, staged dir, final dir, sidecar or None) of each async save not
# yet swapped in; the commits run one at a time on one background thread.
_PENDING: list = []
_WRITER: concurrent.futures.ThreadPoolExecutor | None = None


def checkpoint_name(cfg: FrozenConfig, arch: str, epoch: int | str) -> str:
    """Reference-style run name.  Tag field: 'NA' for DDPM, the FM W_TYPE,
    or the ConvRNN cell base name."""
    if arch in ("DDPM-UNet", "DDPM-DiT", "FM-UNet", "FM-DiT"):
        family, backbone = arch.upper().split("-")
        node = getattr(getattr(cfg.MODEL, family), backbone)
        total_epochs = node.TRAIN.EPOCHS
        tag = "NA" if family == "DDPM" else cfg.MODEL.FM.W_TYPE
    elif arch == "ConvRNN":
        total_epochs = cfg.MODEL.CONVRNN.TRAIN.EPOCHS
        tag = cfg.MODEL.CONVRNN.CELL_CLASS[4:]  # strip 'Conv'
    else:
        raise ValueError(f"unknown arch {arch!r}")
    return (
        f"{arch}_{cfg.DATASET.NAME}_TE{total_epochs}"
        f"_PL{cfg.DATASET.PAST_LEN}_FL{cfg.DATASET.FUTURE_LEN}"
        f"_CE{epoch}_{tag}"
    )


def run_tag(cfg: FrozenConfig, arch: str, epoch: int | str) -> str:
    """The metadata part of the run name, used in metric CSV file names
    (``TE{n}_PL{p}_FL{f}_CE{epoch}_{tag}``)."""
    name = checkpoint_name(cfg, arch, epoch)
    return name.split(f"{cfg.DATASET.NAME}_", 1)[1]


def build_metadata(cfg: FrozenConfig, arch: str, epoch: int | str,
                   extra: dict | None = None) -> dict:
    meta = {
        "arch": arch,
        "dataset": cfg.DATASET.NAME,
        "total_epochs": None,
        "past_len": cfg.DATASET.PAST_LEN,
        "future_len": cfg.DATASET.FUTURE_LEN,
        "epoch": epoch,
        "name": checkpoint_name(cfg, arch, epoch),
    }
    if arch == "ConvRNN":
        meta["total_epochs"] = cfg.MODEL.CONVRNN.TRAIN.EPOCHS
        meta["cell"] = cfg.MODEL.CONVRNN.CELL_CLASS
    else:
        family, backbone = arch.upper().split("-")
        meta["total_epochs"] = getattr(
            getattr(cfg.MODEL, family), backbone
        ).TRAIN.EPOCHS
        if family == "FM":
            meta["w_type"] = cfg.MODEL.FM.W_TYPE
    if extra:
        meta.update(extra)
    return meta


def _to_cpu(obj):
    """``obj`` with every tensor in its (nested) dicts detached and on the
    CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _write_json(path: Path, payload: dict) -> None:
    """Write JSON whole, then move it into place: a kill mid-write cannot
    leave a truncated file."""
    tmp = Path(f"{path}.tmp")
    tmp.write_text(json.dumps(payload, indent=2, default=str))
    os.replace(tmp, path)


def _write_state(directory: Path, payload: dict) -> None:
    """``state.pt`` of a payload whose tensors are on the host, written
    whole, then moved into place (the file name enters torch.save's bytes,
    so every save writes through this one name)."""
    tmp = directory / (STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, directory / STATE_FILE)


def save_checkpoint(
    directory: str | os.PathLike,
    payload: dict,
    metadata: dict | None = None,
    *,
    async_save: bool = False,
) -> str:
    """Write ``payload`` ({"params": sd, "ema_params": sd, ...}, its tensors
    moved to the CPU) and the metadata under ``directory``; each file is
    written whole, then moved into place.  Pending async saves commit
    first.  ``async_save=True`` snapshots the payload and returns while a
    background thread commits it (see the module's notes): call
    :func:`wait_for_saves`, or save once more synchronously, before
    reading the checkpoint back."""
    directory = Path(directory)
    directory.parent.mkdir(parents=True, exist_ok=True)
    wait_for_saves()
    if not async_save:
        directory.mkdir(parents=True, exist_ok=True)
        _write_state(directory, _to_cpu(payload))
        if metadata is not None:
            _write_json(directory / METADATA_FILE, metadata)
        return str(directory)
    staged = Path(f"{directory}{STAGE_SUFFIX}")
    if staged.exists():
        shutil.rmtree(staged)
    staged.mkdir()
    snapshot, copied = _snapshot(payload)
    sidecar = None
    if metadata is not None:
        sidecar = Path(f"{directory}{SIDECAR_SUFFIX}")
        _write_json(sidecar, metadata)
    global _WRITER
    if _WRITER is None:
        _WRITER = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
    commit = _WRITER.submit(_commit, staged, snapshot, copied)
    _PENDING.append((commit, staged, directory, sidecar))
    return str(directory)


def _snapshot(payload: dict):
    """``(copy, copied)``: a copy of ``payload`` that no later in-place
    update reaches, laid out as :func:`_to_cpu` lays it out.  A CPU
    tensor's storage is copied at once (once, its views kept); a card
    tensor is copied on the device, on the current stream: after the step
    that made it, before the next one, and the loop waits for nothing
    more.  ``copied`` is the event after those device copies and their
    device (None without any); :func:`_commit` moves them to the host."""
    storages: dict = {}
    device = None

    def copy(obj):
        nonlocal device
        if isinstance(obj, dict):
            return {k: copy(v) for k, v in obj.items()}
        if not isinstance(obj, torch.Tensor):
            return obj
        t = obj.detach()
        if t.device.type == "cuda":
            device = t.device
            return t.clone()
        storage = t.untyped_storage()
        if storage.data_ptr() not in storages:
            storages[storage.data_ptr()] = storage.clone()
        return torch.empty(0, dtype=t.dtype).set_(
            storages[storage.data_ptr()], t.storage_offset(), t.size(), t.stride())

    snapshot = copy(payload)
    if device is None:
        return snapshot, None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return snapshot, (event, device)


def _to_host(obj, stream):
    """``obj`` with each card tensor copied into pinned host memory on
    ``stream``."""
    if isinstance(obj, dict):
        return {k: _to_host(v, stream) for k, v in obj.items()}
    if not (isinstance(obj, torch.Tensor) and obj.device.type == "cuda"):
        return obj
    host = torch.empty_like(obj, device="cpu", pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(obj, non_blocking=True)
    return host


def _commit(staged: Path, snapshot: dict, copied) -> None:
    """The background half of an async save: the device copies to the host
    on a stream of this thread, after ``copied`` (event, device), then
    ``state.pt``."""
    if copied is not None:
        event, device = copied
        stream = torch.cuda.Stream(device=device)
        stream.wait_event(event)
        snapshot = _to_host(snapshot, stream)
        stream.synchronize()
    _write_state(staged, snapshot)


def wait_for_saves() -> None:
    """Wait until every async save has committed, then swap each staged
    directory into its place and its metadata sidecar into it.  The swap
    comes after the commit, so the previous checkpoint at the final path
    stays whole until its replacement is on disk.  Raises what a commit
    raised."""
    while _PENDING:
        commit, staged, final, sidecar = _PENDING.pop(0)
        commit.result()
        if sidecar is not None and sidecar.exists():
            sidecar.replace(staged / METADATA_FILE)
        if final.exists():
            shutil.rmtree(final)
        staged.replace(final)


def _sharded(module: torch.nn.Module) -> bool:
    """Whether FSDP shards ``module``.  Not read from its parameters: the
    root unit keeps its parameters gathered, as plain tensors, from a
    forward without gradients to the next step, while its ``state_dict``
    still gives the shards (a model wholly in the root, as the ConvRNN is,
    would pass for unsharded after ``evaluate``)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


def full_state_dict(module: torch.nn.Module) -> dict:
    """``module``'s state_dict with whole tensors: for an FSDP-sharded or
    model-cut module, gathered on every process (a collective: every
    process calls it); otherwise ``state_dict()`` itself (views of the
    parameters)."""
    if not _sharded(module):
        sd = module.state_dict()
    else:
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions,
            get_model_state_dict,
        )

        sd = get_model_state_dict(module, options=StateDictOptions(full_state_dict=True))
    shards = tensor.model_shards(module)
    if not shards:
        return sd
    with torch.no_grad():
        return {k: tensor.gather_weight(v, shards[k]) if k in shards else v
                for k, v in sd.items()}


def load_full_state_dict(module: torch.nn.Module, state: dict) -> None:
    """Load a whole-tensor state_dict into ``module``, into its shards when
    FSDP shards it or the model axis cuts it (every process calls it)."""
    shards = tensor.model_shards(module)
    state = {k: tensor.local_slice(v, shards[k]) if k in shards else v
             for k, v in state.items()}
    if not _sharded(module):
        module.load_state_dict(state)
        return
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
    )

    set_model_state_dict(module, state, options=StateDictOptions(full_state_dict=True))


def _param_shards(model) -> list:
    """(shard or None, shape over "data") of each parameter of ``model``,
    in the order the optimizer holds them."""
    if model is None:
        return []
    shards = tensor.model_shards(model)
    return [(shards.get(n), tuple(p.shape)) for n, p in model.named_parameters()]


def full_optimizer_state(optimizer: torch.optim.Optimizer, model=None) -> dict:
    """The optimizer's ``state_dict()`` with its FSDP-sharded moments
    gathered whole (:func:`~crowdmod_tpu_torch.parallel.multiprocess.
    process_allgather`), then the moments of ``model``'s model-cut
    parameters gathered over "model", in the one-process format: state
    keyed by the parameter's index, the step and learning rate as they
    are."""
    sd = multiprocess.process_allgather(optimizer.state_dict())
    params = _param_shards(model)
    if not any(shard for shard, _ in params):
        return sd
    state = {}
    with torch.no_grad():
        for i, moments in sd["state"].items():
            shard, shape = params[i]
            state[i] = {k: tensor.gather_weight(v, shard)
                        if shard is not None and isinstance(v, torch.Tensor)
                        and tuple(v.shape) == shape else v
                        for k, v in moments.items()}
    return {**sd, "state": state}


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict,
                         model=None) -> None:
    """``optimizer.load_state_dict(state)`` with each moment of ``model``'s
    model-cut parameters cut to the rank's slice, then each moment of an
    FSDP-sharded parameter cut to that parameter's shard layout."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    params = _param_shards(model)
    if any(shard for shard, _ in params):
        cut = {}
        for i, moments in state["state"].items():
            shard, shape = params[i]
            if shard is not None:
                whole = shape[:shard.dim] + (shard.full,) + shape[shard.dim + 1:]
                moments = {k: tensor.local_slice(v, shard)
                           if isinstance(v, torch.Tensor) and tuple(v.shape) == whole else v
                           for k, v in moments.items()}
            cut[i] = moments
        state = {**state, "state": cut}
    optimizer.load_state_dict(state)
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not isinstance(p, DTensor):
                continue
            moments = optimizer.state.get(p, {})
            for k, v in moments.items():
                if isinstance(v, torch.Tensor) and not isinstance(v, DTensor) \
                        and v.shape == p.shape:
                    moments[k] = distribute_tensor(v.to(p.device), p.device_mesh,
                                                   p.placements)


def commit_checkpoint(directory: str | os.PathLike, payload: dict,
                      metadata: dict | None = None) -> str:
    """:func:`save_checkpoint` by process 0 alone, between two barriers: no
    process still reads the previous files while they are replaced, and
    none reads before the commit ended.  A plain save without a process
    group."""
    multiprocess.barrier("checkpoint-begin")
    if multiprocess.is_main():
        save_checkpoint(directory, payload, metadata)
        logging.info("checkpoint committed to %s", directory)
    multiprocess.barrier("checkpoint-commit")
    return str(directory)


def load_checkpoint(directory: str | os.PathLike):
    """Read ``(payload, metadata)`` (tensors on the CPU); metadata is None
    when absent or unreadable."""
    directory = Path(directory)
    state_path = directory / STATE_FILE
    if not state_path.exists():
        raise FileNotFoundError(f"no port checkpoint at {directory}")
    payload = torch.load(state_path, map_location="cpu", weights_only=True)
    return payload, read_metadata(directory)


def read_metadata(directory: str | os.PathLike) -> dict | None:
    """A checkpoint's ``metadata.json`` (or, while the directory exists
    without one, its async save's sidecar) without loading its state; None
    when missing, truncated or corrupt (a half-written file from a hard
    kill must not break every later resume).  An orphaned sidecar describes
    a checkpoint never committed, and is not read."""
    directory = Path(directory)
    path = directory / METADATA_FILE
    if not path.exists() and directory.is_dir():
        path = Path(f"{directory}{SIDECAR_SUFFIX}")
    try:
        return json.loads(path.read_text())
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None


def gc_checkpoints(
    save_dir: str | os.PathLike,
    cfg: FrozenConfig,
    arch: str,
    *,
    keep_epochs: int | None = None,
    remove_abort: bool = False,
) -> list[str]:
    """Remove this run's stale checkpoints under ``save_dir``: the best-loss
    ``000`` always stays; of the numbered epochs only the ``keep_epochs``
    highest survive (``0`` deletes all, ``None`` keeps all); ``abort`` goes
    when ``remove_abort``; what crashed async saves left — staged
    ``.pending`` directories, ``*.orbax-checkpoint-tmp`` directories (the
    JAX package's), ``.meta.json`` sidecars whose checkpoint is gone — goes
    always, with a removed checkpoint's sidecar.  Only names of this (cfg,
    arch)'s scheme are touched.  Returns the removed paths.  Under a
    process group only process 0 sweeps (concurrent removals on a shared
    file system race)."""
    if multiprocess.process_count() > 1 and not multiprocess.is_main():
        return []
    save = Path(save_dir)
    if not save.is_dir():
        return []
    pre, post = checkpoint_name(cfg, arch, "@EPOCH@").split("@EPOCH@")
    removed: list[str] = []

    def ours(stem: str) -> bool:
        return stem.startswith(pre) and stem.endswith(post)

    def rm(path: Path) -> None:
        if path.is_dir():
            shutil.rmtree(path)
        else:
            path.unlink()
        sidecar = Path(f"{path}{SIDECAR_SUFFIX}")
        if sidecar.exists():
            sidecar.unlink()
        removed.append(str(path))

    numbered: list[tuple[int, Path]] = []
    for entry in sorted(save.iterdir()):
        name = entry.name
        if name.endswith(ORBAX_TMP_SUFFIX):
            stem = name[:-len(ORBAX_TMP_SUFFIX)]
            stem = stem[:-len(STAGE_SUFFIX)] if stem.endswith(STAGE_SUFFIX) else stem
            if ours(stem):
                rm(entry)
        elif name.endswith(STAGE_SUFFIX):
            if ours(name[:-len(STAGE_SUFFIX)]):
                rm(entry)
        elif name.endswith(SIDECAR_SUFFIX):
            stem = name[:-len(SIDECAR_SUFFIX)]
            if ours(stem) and not (save / stem).exists():
                entry.unlink()
                removed.append(str(entry))
        elif entry.is_dir() and ours(name):
            tag = name[len(pre):len(name) - len(post)]
            if tag == "abort" and remove_abort:
                rm(entry)
            elif tag.isdigit() and tag != "000":
                numbered.append((int(tag), entry))
    if keep_epochs is not None:
        numbered.sort()
        for _, entry in numbered[:max(0, len(numbered) - keep_epochs)]:
            rm(entry)
    return removed
