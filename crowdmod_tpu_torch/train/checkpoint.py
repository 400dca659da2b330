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
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch

from crowdmod_tpu_torch.config import FrozenConfig

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
