"""Checkpoints (port of the JAX package's ``train/checkpoint.py``).

A port checkpoint is a directory holding ``state.pt`` — a torch file with
``params`` and, when EMA is on, ``ema_params`` (each a state_dict in the
reference torch layout) and, from a trainer, ``step``, the Adam state
(``optimizer``) and the learning rate (``lr``) — plus the same
``metadata.json`` the JAX package writes.  The directory is named by
:func:`checkpoint_name`, the reference's run-name convention.  Saves are
synchronous (the JAX package's async commit is not ported).  The JAX
package's orbax directories need JAX to read; importing them is a later
slice's work.

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


def save_checkpoint(
    directory: str | os.PathLike,
    payload: dict,
    metadata: dict | None = None,
) -> str:
    """Write ``payload`` ({"params": sd, "ema_params": sd, ...}, its tensors
    moved to the CPU) and the metadata under ``directory``; each file is
    written whole, then moved into place."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / (STATE_FILE + ".tmp")
    torch.save(_to_cpu(payload), tmp)
    os.replace(tmp, directory / STATE_FILE)
    if metadata is not None:
        tmp = directory / (METADATA_FILE + ".tmp")
        tmp.write_text(json.dumps(metadata, indent=2, default=str))
        os.replace(tmp, directory / METADATA_FILE)
    return str(directory)


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
    """A checkpoint's ``metadata.json`` without loading its state; None when
    the file is missing, truncated or corrupt (a half-written file from a
    hard kill must not break every later resume)."""
    path = Path(directory) / METADATA_FILE
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
    when ``remove_abort``.  Only directories named by this (cfg, arch)'s
    scheme are touched.  Returns the removed paths."""
    save = Path(save_dir)
    if not save.is_dir():
        return []
    pre, post = checkpoint_name(cfg, arch, "@EPOCH@").split("@EPOCH@")
    removed: list[str] = []
    numbered: list[tuple[int, Path]] = []
    for entry in sorted(save.iterdir()):
        name = entry.name
        if not (entry.is_dir() and name.startswith(pre) and name.endswith(post)):
            continue
        tag = name[len(pre):len(name) - len(post)]
        if tag == "abort" and remove_abort:
            shutil.rmtree(entry)
            removed.append(str(entry))
        elif tag.isdigit() and tag != "000":
            numbered.append((int(tag), entry))
    if keep_epochs is not None:
        numbered.sort()
        for _, entry in numbered[:max(0, len(numbered) - keep_epochs)]:
            shutil.rmtree(entry)
            removed.append(str(entry))
    return removed
