"""Architecture registry: config node → backbone module (port of the JAX
package's ``models/factory.py``: the ``DDPM-DiT`` and ``DDPM-UNet``
branches).

Arch strings ``DDPM-UNet | DDPM-DiT | FM-UNet | FM-DiT | ConvRNN`` select
both the generative family and the backbone, with hyperparameters read from
the ``MODEL.{DDPM,FM,CONVRNN}.{UNET,DIT}`` config nodes.  Archs not ported
yet raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import torch
from torch import nn

from crowdmod_tpu_torch.config import FrozenConfig

ARCHS = ("DDPM-UNet", "DDPM-DiT", "FM-UNet", "FM-DiT", "ConvRNN")

# Arch → the ROADMAP.md Queue 1 item that ports its backbone.
_NOT_PORTED = {
    "FM-UNet": "Queue 1 item 12 (flow matching)",
    "FM-DiT": "Queue 1 items 10 and 12 (DiT2D, flow matching)",
    "ConvRNN": "Queue 1 item 13 (ConvRNN)",
}


def backbone_cfg(cfg: FrozenConfig, arch: str) -> FrozenConfig:
    """Navigate to the backbone node, e.g. cfg.MODEL.DDPM.DIT."""
    family, backbone = arch.upper().split("-")
    return getattr(getattr(cfg.MODEL, family), backbone)


def build_backbone(
    cfg: FrozenConfig,
    arch: str,
    mprops_count: int = 3,
    *,
    dtype: torch.dtype = torch.float32,
    conv_impl: str = "im2col",
) -> nn.Module:
    """Instantiate the denoiser backbone for ``arch`` (on the CPU; the
    caller moves it).  ``conv_impl`` picks the UNet's conv kernel."""
    if arch == "DDPM-UNet":
        from crowdmod_tpu_torch.models.backbones.unet3d import UNet3D

        node = backbone_cfg(cfg, arch)
        return UNet3D(
            out_channels=mprops_count,
            num_res_blocks=node.NUM_RES_BLOCKS,
            base_channels=node.BASE_CH,
            base_channels_multiples=tuple(node.BASE_CH_MULT),
            apply_attention=tuple(node.APPLY_ATTENTION),
            dropout_rate=node.DROPOUT_RATE,
            time_multiple=node.TIME_EMB_MULT,
            condition=node.CONDITION,
            dtype=dtype,
            conv_impl=conv_impl,
        )
    if arch == "DDPM-DiT":
        from crowdmod_tpu_torch.models.backbones.dit import DiT4DFactorized

        node = backbone_cfg(cfg, arch)
        # The reference's DDPM-DiT instantiates the factorized-attention V4.
        return DiT4DFactorized(
            out_channels=mprops_count,
            grid_rows=cfg.MACROPROPS.ROWS,
            grid_cols=cfg.MACROPROPS.COLS,
            past_len=cfg.DATASET.PAST_LEN,
            future_len=cfg.DATASET.FUTURE_LEN,
            patch_size=node.PATCH_SIZE,
            t_patch_size=node.T_PATCH_SIZE,
            hidden_size=node.HIDDEN_SIZE,
            depth=node.DEPTH,
            num_heads=node.NUM_HEADS,
            mlp_ratio=node.MLP_RATIO,
            dropout_rate=node.DROPOUT_RATE,
            time_multiple=node.TIME_EMB_MULT,
            condition=node.CONDITION,
            dtype=dtype,
        )
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to PyTorch yet: ROADMAP.md "
            f"{_NOT_PORTED[arch]}"
        )
    raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")
