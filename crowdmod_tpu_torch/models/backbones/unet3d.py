"""3-D UNet denoiser over macroproperty sequences, channels-last (port of
the JAX package's ``models/backbones/unet3d.py``).

Same topology: first conv, per-level ResNet blocks with optional attention,
stride-2 downsampling, a 2-block bottleneck, a skip-concat decoder with
nearest ×2 upsampling, and a GroupNorm(8) + SiLU head with an f32 final
conv.  Past and (noisy) future frames are concatenated on time and the
future slice of the output is returned.  Activations are ``(B, T, H, W, C)``.

Module and parameter names follow the reference's torch state_dict, the one
``crowdmod_tpu.compat.torch_import._import_unet3d`` reads: ``first``;
``encoder_blocks.N`` with ResnetBlocks (``normalize_1``, ``conv_1``,
``dense_1``, ``normalize_2``, ``conv_2``, ``match_input``,
``attention.{group_norm,mhsa}``) and DownSamples (``downsample``)
interleaved; ``bottleneck_blocks.{0,1}``; ``decoder_blocks.N`` with
UpSamples at ``upsample.1``; ``final.{0,2}``;
``time_embeddings.time_blocks.{1,3}``.  A state_dict of this model is a
reference checkpoint.

The hand-written kernels carry the stride-1 convs (:class:`Conv3DSame`), the
GroupNorms (:class:`GroupNormSiLU`), the attention and, at the level-0
blocks, the whole ResnetBlock (:mod:`.fused_apply`).  The stride-2
downsample and the unfused 1×1 skip stay library calls, as they were XLA's
in the JAX package.  ``dtype`` is the compute dtype: weights stay float32.

Dropout (training mode) draws each ResnetBlock's channel mask from the
``generator`` passed to the forward, before the block runs, and hands it to
the block; with ``remat`` each ResnetBlock runs under
``torch.utils.checkpoint`` (the JAX package's ``TPU.REMAT``), and its
recompute applies the same mask.

Under tensor parallelism every layer whose weight is cut over "model" runs
column-parallel (:func:`~crowdmod_tpu_torch.parallel.tensor.column`): the
convs, the time projections, the 1×1 skip, the stride-2 downsample (a
library call on its local channels) and the attention; the fused
resblock gathers its block's weights at use (:mod:`.fused_apply`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from crowdmod_tpu_torch.models.backbones import fused_apply
from crowdmod_tpu_torch.models.backbones.embeddings import TimestepEmbedding
from crowdmod_tpu_torch.ops.attention import MultiHeadAttention, dense
from crowdmod_tpu_torch.ops.conv3d import Conv3DSame, lecun_normal_
from crowdmod_tpu_torch.ops.dropout import dropout, keep_mask
from crowdmod_tpu_torch.ops.norm import GroupNormSiLU
from crowdmod_tpu_torch.parallel import tensor


class SpatialAttentionBlock(nn.Module):
    """GroupNorm (no SiLU) → 4-head self-attention over all T·H·W positions
    → residual."""

    def __init__(self, channels: int, num_heads: int = 4, dtype=torch.float32):
        super().__init__()
        self.group_norm = GroupNormSiLU(channels, silu=False, dtype=dtype)
        self.mhsa = MultiHeadAttention(channels, num_heads, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, t * h * w, c)
        return x + self.mhsa(y).reshape(b, t, h, w, c)


class ResnetBlock3D(nn.Module):
    """GN→SiLU→Conv, + time embedding, GN→SiLU→channel dropout→Conv, skip,
    optional attention.  Dropout is Dropout3d's: whole channels of a sample,
    in training mode only.  ``cache_packs``: as :class:`Conv3DSame`'s, for
    the fused kernel's weight pack."""

    cache_packs = True

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int, *,
                 dropout_rate: float = 0.1, apply_attention: bool = False,
                 dtype=torch.float32, conv_impl: str = "im2col"):
        super().__init__()
        self.out_channels = out_channels
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.normalize_1 = GroupNormSiLU(in_channels, dtype=dtype)
        self.conv_1 = Conv3DSame(in_channels, out_channels, dtype=dtype, impl=conv_impl)
        self.dense_1 = nn.Linear(temb_dim, out_channels)
        self.normalize_2 = GroupNormSiLU(out_channels, dtype=dtype)
        self.conv_2 = Conv3DSame(out_channels, out_channels, dtype=dtype, impl=conv_impl)
        self.match_input = (
            nn.Conv3d(in_channels, out_channels, kernel_size=1)
            if in_channels != out_channels else None
        )
        self.attention = (
            SpatialAttentionBlock(out_channels, dtype=dtype) if apply_attention else None
        )

    def keep_mask(self, batch: int, generator) -> torch.Tensor | None:
        """The channel dropout's ``(B, 1, 1, 1, Cout)`` keep mask (Dropout3d:
        whole channels of a sample, the JAX package's ``broadcast_dims=(1,
        2, 3)``), or None when dropout is off."""
        if not self.training or self.dropout_rate == 0.0:
            return None
        return keep_mask((batch, 1, 1, 1, self.out_channels), self.dropout_rate,
                         generator, self.dense_1.weight.device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        if fused_apply.eligible(self, x, self.training):
            return fused_apply.fused_forward(self, x, temb)
        dt = self.dtype
        h = self.conv_1(self.normalize_1(x))
        h = h + dense(F.silu(temb.to(dt)), self.dense_1, dt)[:, None, None, None, :]
        h = self.conv_2(dropout(self.normalize_2(h), keep, self.dropout_rate))
        if self.match_input is not None:
            x = tensor.column(self.match_input, x, lambda x, w, b: F.linear(
                x.to(dt), w.flatten(1).to(dt), b.to(dt)))
        h = h + x
        if self.attention is not None:
            h = self.attention(h)
        return h


class DownSample3D(nn.Module):
    """Stride-2 3×3×3 conv over (T, H, W), padding 1 (the reference's)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.downsample = nn.Conv3d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype

        def op(x, w, b):
            # (B, T, H, W, C) seen as (B, C, T, H, W); the reference weight
            # (O, I, kh, kw, kl) reordered to (O, I, kl, kh, kw).
            y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), w.permute(0, 1, 4, 2, 3).to(dt),
                         b.to(dt), stride=2, padding=1)
            return y.permute(0, 2, 3, 4, 1).contiguous()

        return tensor.column(self.downsample, x, op)


class NearestUpsample3D(nn.Module):
    """Nearest ×2 over (T, H, W), one copy."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        x = x[:, :, None, :, None, :, None, :].expand(b, t, 2, h, 2, w, 2, c)
        return x.reshape(b, 2 * t, 2 * h, 2 * w, c)


class UpSample3D(nn.Module):
    """Nearest ×2 upsample then a 3×3×3 conv (``upsample.1``)."""

    def __init__(self, channels: int, dtype=torch.float32, conv_impl: str = "im2col"):
        super().__init__()
        self.upsample = nn.Sequential(
            NearestUpsample3D(), Conv3DSame(channels, channels, dtype=dtype, impl=conv_impl)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.upsample(x)


class UNet3D(nn.Module):
    """UNet denoiser; forward ``(future, t, past) → output``.  Arguments map
    1:1 to the ``MODEL.*.UNET`` config node; ``conv_impl`` picks the conv
    kernel (``"im2col"`` or ``"tapgemm"``)."""

    def __init__(
        self,
        *,
        out_channels: int = 3,
        num_res_blocks: int = 1,
        base_channels: int = 32,
        base_channels_multiples: Sequence[int] = (1, 2, 4),
        apply_attention: Sequence[bool] = (False, False, True, False),
        dropout_rate: float = 0.1,
        time_multiple: int = 4,
        condition: str = "Past",
        dtype: torch.dtype = torch.float32,
        conv_impl: str = "im2col",
        remat: bool = False,
    ):
        super().__init__()
        self.condition = condition
        self.dtype = dtype
        self.remat = remat
        temb_dim = base_channels * time_multiple
        self.time_embeddings = TimestepEmbedding(base_channels, temb_dim, dtype)

        def block(cin, cout, attn):
            return ResnetBlock3D(cin, cout, temb_dim, dropout_rate=dropout_rate,
                                 apply_attention=attn, dtype=dtype, conv_impl=conv_impl)

        self.first = Conv3DSame(out_channels, base_channels, dtype=dtype, impl=conv_impl)
        levels = len(base_channels_multiples)
        ch, skips = base_channels, [base_channels]
        encoder = []
        for level in range(levels):
            out = base_channels * base_channels_multiples[level]
            for _ in range(num_res_blocks):
                encoder.append(block(ch, out, apply_attention[level]))
                ch = out
                skips.append(ch)
            if level != levels - 1:
                encoder.append(DownSample3D(ch, dtype))
                skips.append(ch)
        self.encoder_blocks = nn.ModuleList(encoder)
        self.bottleneck_blocks = nn.ModuleList([block(ch, ch, True), block(ch, ch, False)])
        decoder = []
        for level in reversed(range(levels)):
            out = base_channels * base_channels_multiples[level]
            for _ in range(num_res_blocks + 1):
                decoder.append(block(ch + skips.pop(), out, apply_attention[level]))
                ch = out
            if level != 0:
                decoder.append(UpSample3D(ch, dtype, conv_impl))
        self.decoder_blocks = nn.ModuleList(decoder)
        self.final = nn.ModuleList([
            GroupNormSiLU(ch, dtype=dtype), nn.Identity(),
            Conv3DSame(ch, out_channels, dtype=torch.float32, impl=conv_impl),
        ])
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The JAX package's initialisation: flax's lecun-normal kernels and
        zero biases, unit GroupNorm scales, the attention's own init."""
        for m in self.modules():
            if isinstance(m, (Conv3DSame, GroupNormSiLU, MultiHeadAttention)):
                m.reset_parameters(generator)
            elif isinstance(m, (nn.Linear, nn.Conv3d)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)

    def pin_packs(self) -> None:
        """Pack every conv's and fused block's kernel weights once, now, and
        keep those packs (for a frozen copy, e.g. an exported sampler's:
        under a trace no pack can be cached, so each would be rebuilt in
        every step of the traced program)."""
        for m in self.modules():
            if isinstance(m, Conv3DSame):
                m.pin_pack()
            elif isinstance(m, ResnetBlock3D) and m.attention is None:
                fused_apply.pin_pack(m)

    def _block(self, blk, h, temb, generator) -> torch.Tensor:
        keep = blk.keep_mask(h.shape[0], generator)
        if self.remat and torch.is_grad_enabled():
            return checkpoint(blk, h, temb, keep, use_reentrant=False)
        return blk(h, temb, keep)

    def forward(self, future, t, past=None, *, generator=None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training mode."""
        if self.condition == "Past":
            if past is None:
                raise ValueError(
                    "condition='Past' requires past frames; got past=None "
                    "(a model trained conditionally cannot be sampled "
                    "unconditionally)"
                )
            past_len = past.shape[1]
            x = torch.cat([past, future], dim=1)
        else:
            past_len, x = 0, future
        x = x.to(self.dtype)
        temb = self.time_embeddings(t)

        h = self.first(x)
        skips = [h]
        for blk in self.encoder_blocks:
            h = (self._block(blk, h, temb, generator) if isinstance(blk, ResnetBlock3D)
                 else blk(h))
            skips.append(h)
        for blk in self.bottleneck_blocks:
            h = self._block(blk, h, temb, generator)
        for blk in self.decoder_blocks:
            if isinstance(blk, ResnetBlock3D):
                h = self._block(blk, torch.cat([h, skips.pop()], dim=-1), temb, generator)
            else:
                h = blk(h)
        h = self.final[2](self.final[0](h))
        return h[:, past_len:] if past_len else h
