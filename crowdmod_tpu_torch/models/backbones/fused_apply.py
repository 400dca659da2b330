"""Which UNet3D ResnetBlocks run the fused kernel, and with what (port of
the JAX package's ``models/backbones/fused_apply.py``).

The JAX package redirects eligible blocks with a flax method interceptor;
PyTorch needs none: :meth:`ResnetBlock3D.forward` asks :func:`eligible` and
then calls :func:`fused_forward`, on the card (the kernel) and on the CPU
(the wrapper's twin) alike.

Eligibility is the JAX package's: deterministic (not training), no
attention epilogue, Cin and Cout multiples of 8, and a volume of at least
:data:`MIN_FUSED_VOLUME` positions — the UNet's level-0 blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from crowdmod_tpu_torch.ops.attention import dense
from crowdmod_tpu_torch.ops.conv3d import jax_kernel, weights_key
from crowdmod_tpu_torch.ops.kernels import fused_resblock
from crowdmod_tpu_torch.ops.kernels.resblock import pack_resblock

# Minimum (T·H·W) volume routed to the kernel: level 0 of the ATC geometry
# is 8·12·36 = 3456; one downsample divides it by 8.
MIN_FUSED_VOLUME = 1024


def eligible(block, x: torch.Tensor, training: bool) -> bool:
    if training or block.attention is not None:
        return False
    cin, cout = x.shape[-1], block.out_channels
    if cin % 8 or cout % 8 or x.dim() != 5:
        return False
    t, h, w = x.shape[1:4]
    return t * h * w >= MIN_FUSED_VOLUME


def weights_from_block(block) -> dict:
    """The block's parameters as the fused kernel's weight dict (JAX
    layout, views of the parameters)."""
    w = {
        "gn1_scale": block.normalize_1.weight,
        "gn1_bias": block.normalize_1.bias,
        "w1": jax_kernel(block.conv_1.weight),
        "b1": block.conv_1.bias,
        "gn2_scale": block.normalize_2.weight,
        "gn2_bias": block.normalize_2.bias,
        "w2": jax_kernel(block.conv_2.weight),
        "b2": block.conv_2.bias,
    }
    if block.match_input is not None:
        w["w_skip"] = jax_kernel(block.match_input.weight)
        w["b_skip"] = block.match_input.bias
    return w


@torch.no_grad()
def _packed(block, w: dict, dtype: torch.dtype) -> dict:
    """:func:`pack_resblock` of the block's weights, cached on the block and
    rebuilt only when a parameter changed."""
    key = weights_key(*w.values()) + (dtype,)
    cached = getattr(block, "_fused_pack", (None, None))
    if cached[0] != key:
        cached = (key, pack_resblock(w, dtype))
        block._fused_pack = cached
    return cached[1]


def fused_forward(block, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
    """The block's forward through :func:`fused_resblock`; ``temb_proj`` is
    its ``time_dense`` (``dense_1``) of silu(temb), in the compute dtype."""
    dt = block.dtype
    temb_proj = dense(F.silu(temb.to(dt)), block.dense_1, dt)
    w = weights_from_block(block)
    x = x.to(dt).contiguous()
    packed = None if x.device.type == "cpu" else _packed(block, w, dt)
    return fused_resblock(x, temb_proj, w, num_groups=8, eps=1e-5, packed=packed)
