"""Import reference torch checkpoints into the port (port of the JAX
package's ``compat/torch_import.py``).

The reference saves ``torch.save({"opt": ..., "model": state_dict})`` and
restores ``torch.load(...)["model"]``.  The port's modules keep the
reference's state_dict layout (key names, shapes, the ConvTranspose and
fused-QKV layouts), so a reference state_dict loads into a freshly built
port model as it is: this module reads the file, identifies the backbone
from its keys (:func:`detect_backbone`, the port's own copy of the JAX
package's), refuses a backbone that is not the one the arch builds, and
holds every key and shape against the port model, reporting every mismatch
before anything is used.  The one key it drops is the reference's
sinusoidal time-embedding table (``…time_blocks.0.weight``), a
deterministic buffer the port recomputes, as the JAX importer does.
"""

from __future__ import annotations

import re

import torch

__all__ = [
    "BACKBONE_FOR_ARCH",
    "load_torch_state_dict",
    "detect_backbone",
    "import_torch_checkpoint",
    "verify_state_dict",
]

# Reference arch → backbone its wrapper instantiates.
BACKBONE_FOR_ARCH = {
    "DDPM-UNet": "unet3d",
    "FM-UNet": "unet3d",
    "DDPM-DiT": "dit4d_factorized",
    "FM-DiT": "dit2d",
    "ConvRNN": "convrnn",
}

# Deterministic buffers the reference stores but the port recomputes: the
# sinusoidal time-embedding table (nn.Embedding.from_pretrained).
_IGNORABLE = re.compile(r"(^|\.)time_blocks\.0\.weight$")


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read a reference checkpoint file → ``{key: float32 CPU tensor}``.
    Accepts the reference's ``{"opt": ..., "model": sd}`` wrapper and a
    bare state_dict."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if not (isinstance(obj, dict) and all(isinstance(v, torch.Tensor) for v in obj.values())):
        raise ValueError(
            f"{path} is not a reference checkpoint: expected a state_dict "
            "or {'opt': ..., 'model': state_dict}"
        )
    return {k: v.detach().float().contiguous() for k, v in obj.items()}


def detect_backbone(sd: dict) -> str:
    """Fingerprint the backbone family from state_dict keys alone."""
    if any(k.startswith("encoder.encoder_cell_list.") for k in sd):
        return "convrnn"
    if "blocks.0.spatial_attn.in_proj_weight" in sd:
        return "dit4d_factorized"  # DiT4D_V4: per-block spatial+temporal attn
    if "blocks.0.attn.in_proj_weight" in sd:
        if sd["patch_embed.proj.weight"].ndim == 4:
            return "dit2d"  # per-frame Conv2d patchify (V1)
        # V2 (full tube) has a single temporal slot and no temporal embed;
        # V3 (partial tube, joint attention) learns one per slot.
        return "dit4d_joint" if "temporal_pos_embed" in sd else "dit4d_tube"
    if "first.weight" in sd:
        return "unet3d"
    raise ValueError(
        "unrecognized state_dict: not a reference UNet/DiT/ConvRNN "
        f"(sample keys: {sorted(sd)[:5]})"
    )


def verify_state_dict(sd: dict, template: dict) -> None:
    """Raise with every missing key, unexpected key and shape mismatch
    unless ``sd`` has exactly ``template``'s keys and shapes."""
    problems = []
    missing, extra = sorted(set(template) - set(sd)), sorted(set(sd) - set(template))
    if missing:
        problems.append(f"missing params: {missing}")
    if extra:
        problems.append(f"unexpected params: {extra}")
    shapes = [f"{k}: checkpoint {tuple(sd[k].shape)} vs model {tuple(template[k].shape)}"
              for k in sorted(set(sd) & set(template))
              if tuple(sd[k].shape) != tuple(template[k].shape)]
    if shapes:
        problems.append("shape mismatches: " + "; ".join(shapes))
    if problems:
        raise ValueError(
            "imported checkpoint does not fit the configured model (check "
            "--config/--arch match the torch training run):\n  "
            + "\n  ".join(problems)
        )


def import_torch_checkpoint(path: str, arch: str, template: dict) -> dict[str, torch.Tensor]:
    """A reference checkpoint file → the port state_dict of ``arch``,
    verified against ``template`` (a freshly built model's state_dict).
    The detected backbone must be the one ``arch`` instantiates: mixing up
    e.g. an FM-DiT (DiT2D) checkpoint with ``--arch DDPM-DiT`` (DiT4D_V4)
    raises before any structure check."""
    sd = load_torch_state_dict(path)
    kind = detect_backbone(sd)
    want = BACKBONE_FOR_ARCH.get(arch)
    if want is None:
        raise ValueError(f"unknown arch {arch!r}; expected one of {sorted(BACKBONE_FOR_ARCH)}")
    if want != kind:
        raise ValueError(
            f"checkpoint contains a {kind} backbone but --arch {arch} expects {want}"
        )
    sd = {k: v for k, v in sd.items() if not (_IGNORABLE.search(k) and k not in template)}
    verify_state_dict(sd, template)
    return sd
