"""Checkpoints for serving (port of the JAX package's
``train/checkpoint.py``, the subset serving needs).

A port checkpoint is a directory holding ``state.pt`` — a torch file with
``params`` and, when EMA is on, ``ema_params``, each a state_dict in the
reference torch layout — plus the same ``metadata.json`` the JAX package
writes.  The directory is named by :func:`checkpoint_name`, the reference's
run-name convention.  The JAX package's orbax directories need JAX to read;
importing them is a later slice's work.
"""

from __future__ import annotations

import json
import os
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


def save_checkpoint(
    directory: str | os.PathLike,
    payload: dict[str, dict[str, torch.Tensor]],
    metadata: dict | None = None,
) -> str:
    """Write ``payload`` ({"params": sd, "ema_params": sd}) and the metadata
    under ``directory``; each file is written whole, then moved into place."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    state = {
        name: {k: v.detach().cpu() for k, v in sd.items()}
        for name, sd in payload.items()
    }
    tmp = directory / (STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, directory / STATE_FILE)
    if metadata is not None:
        tmp = directory / (METADATA_FILE + ".tmp")
        tmp.write_text(json.dumps(metadata, indent=2))
        os.replace(tmp, directory / METADATA_FILE)
    return str(directory)


def load_checkpoint(directory: str | os.PathLike):
    """Read ``(payload, metadata)`` (tensors on the CPU); metadata is None
    when absent."""
    directory = Path(directory)
    state_path = directory / STATE_FILE
    if not state_path.exists():
        raise FileNotFoundError(f"no port checkpoint at {directory}")
    payload = torch.load(state_path, map_location="cpu", weights_only=True)
    meta_path = directory / METADATA_FILE
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else None
    return payload, meta
