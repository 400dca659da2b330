"""Architecture registry: config node → backbone module (port of the JAX
package's ``models/factory.py``).

Arch strings ``DDPM-UNet | DDPM-DiT | FM-UNet | FM-DiT | ConvRNN`` select
both the model family and the backbone, with hyperparameters read from the
``MODEL.{DDPM,FM}.{UNET,DIT}`` and ``MODEL.CONVRNN`` config nodes.
"""

from __future__ import annotations

import torch
from torch import nn

from crowdmod_tpu_torch.config import FrozenConfig

ARCHS = ("DDPM-UNet", "DDPM-DiT", "FM-UNet", "FM-DiT", "ConvRNN")


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
    """Instantiate the backbone for ``arch`` (on the CPU; the caller moves
    it).  ``conv_impl`` picks the UNet's conv kernel; ``TPU.REMAT``
    recomputes each DiT or UNet block in the backward pass."""
    remat = bool(cfg.get_path("TPU.REMAT", False))
    if arch in ("DDPM-UNet", "FM-UNet"):
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
            remat=remat,
        )
    if arch in ("DDPM-DiT", "FM-DiT"):
        from crowdmod_tpu_torch.models.backbones import dit

        node = backbone_cfg(cfg, arch)
        common = dict(
            out_channels=mprops_count,
            grid_rows=cfg.MACROPROPS.ROWS,
            grid_cols=cfg.MACROPROPS.COLS,
            past_len=cfg.DATASET.PAST_LEN,
            future_len=cfg.DATASET.FUTURE_LEN,
            patch_size=node.PATCH_SIZE,
            hidden_size=node.HIDDEN_SIZE,
            depth=node.DEPTH,
            num_heads=node.NUM_HEADS,
            mlp_ratio=node.MLP_RATIO,
            dropout_rate=node.DROPOUT_RATE,
            time_multiple=node.TIME_EMB_MULT,
            condition=node.CONDITION,
            dtype=dtype,
            remat=remat,
        )
        if arch == "DDPM-DiT":
            # The reference's DDPM-DiT instantiates the factorized V4.
            return dit.DiT4DFactorized(t_patch_size=node.T_PATCH_SIZE, **common)
        # FM-DiT: the per-frame DiT2D.
        return dit.DiT2D(**common)
    if arch == "ConvRNN":
        from crowdmod_tpu_torch.models.convrnn import CELLS, Forecaster

        node = cfg.MODEL.CONVRNN
        try:
            cell = CELLS[node.CELL_CLASS]
        except KeyError:
            raise ValueError(
                f"unknown cell class {node.CELL_CLASS!r}; expected {list(CELLS)}"
            ) from None
        return Forecaster(
            out_channels=mprops_count,
            enc_hidden_channels=tuple(node.ENC_HIDDEN_CH),
            forc_hidden_channels=tuple(node.FORC_HIDDEN_CH),
            enc_kernels=tuple(node.ENC_KERNELS),
            forc_kernels=tuple(node.FORC_KERNELS),
            cell=cell,
            dtype=dtype,
        )
    raise ValueError(f"unknown arch {arch!r}; expected one of {ARCHS}")
