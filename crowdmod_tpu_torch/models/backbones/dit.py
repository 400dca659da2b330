"""Diffusion-Transformer backbones for macroproperty sequences (port of the
JAX package's ``models/backbones/dit.py``).

  * :class:`DiT2D` — per-frame patchify, full attention over all T·N
    tokens (the reference's DiT2D, V1; the FM-DiT backbone);
  * :class:`DiT4DTube` — full temporal-tube patchify, one token per spatial
    patch, the final layer emitting the future frames only (DiT4D, V2);
  * :class:`DiT4DJoint` — partial temporal tube, joint attention over all
    T_p·N_s tokens (DiT4D_V3);
  * :class:`DiT4DFactorized` — partial temporal tube + factorized
    attention: spatial self-attention per temporal slot, then temporal
    cross-attention where only future slots are queries (DiT4D_V4, the
    DDPM-DiT flagship).

AdaLN-Zero conditioning throughout.  Inputs and outputs are native layout
``(B, T, H, W, C)``; tokens are carried as ``(B, T_p, N_s, D)``.  Module and
parameter names follow the reference's torch layout, the one
``crowdmod_tpu.compat.torch_import`` reads (``blocks.{i}.attn`` or
``blocks.{i}.spatial_attn``, ``patch_embed.proj.weight`` as Conv2d ``(D, C,
p, p)`` or Conv3d ``(D, C, pt, p, p)``, ``final_layer.linear`` with
channel-major token features, ``temporal_pos_embed`` as ``(1, t_slots, D)``
where the variant has one, ``time_embeddings`` (V1, V2) or
``dif_time_embeddings`` (V3, V4)), so a state_dict of each is a reference
checkpoint that ``detect_backbone`` tells apart.

``dtype`` is the compute dtype: weights stay float32 and are cast at use, and
the final projection runs in float32, as in the JAX package.

Dropout (training mode) draws its masks from the ``generator`` passed to
the forward, before each block runs, and hands them to the block; with
``remat`` each block runs under ``torch.utils.checkpoint`` (the JAX
package's ``TPU.REMAT``), and its recompute applies the same masks.

Under tensor parallelism every projection whose weight is cut over "model"
(the time MLPs, AdaLN, attention, MLP, final layer, patch embedding) runs
column-parallel through :func:`~crowdmod_tpu_torch.ops.attention.dense`
or :func:`~crowdmod_tpu_torch.parallel.tensor.column`; a cut position
embedding is gathered at use.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from crowdmod_tpu_torch.models.backbones.embeddings import TimestepEmbedding
from crowdmod_tpu_torch.ops.attention import MultiHeadAttention, dense
from crowdmod_tpu_torch.ops.dropout import dropout, keep_mask
from crowdmod_tpu_torch.ops.kernels.library import platform_of
from crowdmod_tpu_torch.parallel import tensor


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """AdaLN-Zero: x * (1 + scale) + shift, broadcasting (B, D) over tokens."""
    extra = x.ndim - shift.ndim
    shape = shift.shape[:1] + (1,) * extra + shift.shape[1:]
    return x * (1.0 + scale.reshape(shape)) + shift.reshape(shape)


def _gate(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    extra = x.ndim - g.ndim
    return x * g.reshape(g.shape[:1] + (1,) * extra + g.shape[1:])


def gelu_approximate(device: torch.device) -> str:
    """``F.gelu``'s ``approximate`` argument.

    The JAX package uses tanh-GELU on its accelerator and exact (erf) GELU
    everywhere else; the port applies the same rule with the card in the
    TPU's place: tanh on CUDA, exact on the CPU.  ``CROWDMOD_GELU=exact|tanh``
    overrides either way, as in the JAX package.
    """
    mode = os.environ.get("CROWDMOD_GELU")
    if mode is None:
        mode = "tanh" if platform_of(device) == "cuda" else "exact"
    return "tanh" if mode == "tanh" else "none"


def _layer_norm(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # LayerNorm(elementwise_affine=False, eps=1e-6); statistics in float32.
    return F.layer_norm(x.float(), x.shape[-1:], eps=1e-6).to(dtype)


def _modulation(seq: nn.Sequential, c: torch.Tensor, n: int, dtype) -> tuple:
    """``adaLN_modulation`` = Sequential(SiLU, Linear): n (B, D) vectors."""
    return dense(F.silu(c), seq[1], dtype).chunk(n, dim=-1)


def _ada_ln(hidden: int, n: int) -> nn.Sequential:
    return nn.Sequential(nn.SiLU(), nn.Linear(hidden, n * hidden))


class Mlp(nn.Sequential):
    """Linear → GELU → Dropout → Linear → Dropout (keys ``0`` and ``3``).

    The two dropouts apply the keep masks passed in (:meth:`keep_masks`);
    their ``nn.Dropout`` entries hold the rate and the reference's keys."""

    def __init__(self, dim: int, hidden: int, dropout_rate: float, dtype):
        super().__init__(
            nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(dropout_rate),
            nn.Linear(hidden, dim), nn.Dropout(dropout_rate),
        )
        self.dtype = dtype

    def keep_masks(self, lead: tuple, generator) -> tuple | None:
        """Keep masks of the hidden and the output activations of tokens
        ``lead + (D,)``, or None when dropout is off."""
        rate = self[2].p
        if not (self.training and rate > 0.0):
            return None
        device = self[0].weight.device
        return (keep_mask(tuple(lead) + (self[0].out_features,), rate, generator, device),
                keep_mask(tuple(lead) + (self[3].out_features,), rate, generator, device))

    def forward(self, x: torch.Tensor, keep: tuple | None = None) -> torch.Tensor:
        k1, k2 = keep if keep is not None else (None, None)
        h = dense(x, self[0], self.dtype)
        h = dropout(F.gelu(h, approximate=gelu_approximate(h.device)), k1, self[2].p)
        return dropout(dense(h, self[3], self.dtype), k2, self[4].p)


class DiTBlock(nn.Module):
    """Self-attention DiT block over ``(B, S, D)`` tokens, 6-parameter
    AdaLN-Zero (``attn``, ``mlp``, ``adaLN_modulation``)."""

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float,
                 dropout_rate: float, dtype):
        super().__init__()
        self.dtype = dtype
        self.adaLN_modulation = _ada_ln(hidden, 6)
        self.attn = MultiHeadAttention(
            hidden, num_heads, dropout_rate=dropout_rate, dtype=dtype
        )
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio), dropout_rate, dtype)

    def keep_masks(self, tokens_shape, generator) -> tuple:
        """The dropout keep masks of one forward over ``tokens_shape`` (B,
        S, D): the attention weights', then the MLP's two; each None when
        dropout is off."""
        b, s, _ = tokens_shape
        return (self.attn.keep_mask((b,), s, s, generator),
                self.mlp.keep_masks((b, s), generator))

    def forward(self, x, c, keep: tuple = (None, None)) -> torch.Tensor:
        dt = self.dtype
        keep_attn, keep_mlp = keep
        sh1, sc1, g1, sh2, sc2, g2 = _modulation(self.adaLN_modulation, c, 6, dt)
        h = self.attn(modulate(_layer_norm(x, dt), sh1, sc1), keep=keep_attn)
        x = x + _gate(h, g1)
        h = self.mlp(modulate(_layer_norm(x, dt), sh2, sc2), keep=keep_mlp)
        return x + _gate(h, g2)


class DiTBlockFactorized(nn.Module):
    """Spatial self-attention + future-query temporal cross-attention + MLP.

    Token shape ``(B, T_p, N_s, D)``.  Stage 1 attends over N_s with
    (B, T_p) batched; stage 2 attends over T_p with (B, N_s) batched, the
    queries being the future slots only and the residual added back to the
    future slots only.  9-parameter AdaLN-Zero.
    """

    def __init__(self, hidden: int, num_heads: int, mlp_ratio: float,
                 dropout_rate: float, dtype):
        super().__init__()
        self.dtype = dtype
        self.adaLN_modulation = _ada_ln(hidden, 9)
        attn = lambda: MultiHeadAttention(
            hidden, num_heads, dropout_rate=dropout_rate, dtype=dtype
        )
        self.spatial_attn = attn()
        self.temporal_attn = attn()
        self.mlp = Mlp(hidden, int(hidden * mlp_ratio), dropout_rate, dtype)

    def keep_masks(self, tokens_shape, query_slot_start: int, generator) -> tuple:
        """The dropout keep masks of one forward over ``tokens_shape`` (B,
        T_p, N_s, D): spatial and temporal attention weights, then the MLP's
        two; each None when dropout is off."""
        b, tp, ns, _ = tokens_shape
        return (self.spatial_attn.keep_mask((b, tp), ns, ns, generator),
                self.temporal_attn.keep_mask((b, ns), tp - query_slot_start, tp, generator),
                self.mlp.keep_masks((b, tp, ns), generator))

    def forward(self, x, c, query_slot_start: int, keep: tuple = (None,) * 3) -> torch.Tensor:
        qs, dt = query_slot_start, self.dtype
        keep_s, keep_t, keep_mlp = keep
        (sh1, sc1, g1, sh2, sc2, g2, sh3, sc3, g3) = _modulation(
            self.adaLN_modulation, c, 9, dt
        )

        # 1. Spatial self-attention: (B, T_p, N_s, D), attention over N_s.
        h = self.spatial_attn(modulate(_layer_norm(x, dt), sh1, sc1), keep=keep_s)
        x = x + _gate(h, g1)

        # 2. Temporal cross-attention: (B, N_s, T_p, D), future slots query all.
        xt = x.transpose(1, 2)
        kv = modulate(_layer_norm(xt, dt), sh2, sc2)
        attn = self.temporal_attn(kv[:, :, qs:, :], kv, keep=keep_t)
        future = xt[:, :, qs:, :] + _gate(attn, g2)
        x = torch.cat([xt[:, :, :qs, :], future], dim=2).transpose(1, 2)

        # 3. MLP over all tokens.
        h = self.mlp(modulate(_layer_norm(x, dt), sh3, sc3), keep=keep_mlp)
        return x + _gate(h, g3)


class FinalLayer(nn.Module):
    """AdaLN-modulated zero-init projection to patch pixels, in float32."""

    def __init__(self, hidden: int, out_features: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.adaLN_modulation = _ada_ln(hidden, 2)
        self.linear = nn.Linear(hidden, out_features)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = _modulation(self.adaLN_modulation, c, 2, self.dtype)
        h = modulate(_layer_norm(x, self.dtype), shift, scale)
        return dense(h, self.linear, torch.float32)


class PatchEmbed4D(nn.Module):
    """(B, T, H, W, C) → (B, T_p, N_s, D) via (t_patch, p, p) tube patches.

    The weight is the reference's Conv3d ``(D, C, pt, p, p)``, or with
    ``frame_wise`` its per-frame Conv2d ``(D, C, p, p)`` (t_patch 1, the
    reference's DiT2D); with stride equal to the kernel the convolution is
    a reshape and one matmul, which is how it runs here (no cuDNN, so no
    TF32 rounding of an f32 convolution).
    """

    def __init__(self, in_channels: int, hidden: int, patch_size: int,
                 t_patch_size: int, dtype, *, frame_wise: bool = False):
        super().__init__()
        self.patch_size, self.t_patch_size = patch_size, t_patch_size
        self.dtype = dtype
        if frame_wise:
            if t_patch_size != 1:
                raise ValueError("a frame-wise patch embedding has t_patch 1")
            k = (patch_size, patch_size)
            self.proj = nn.Conv2d(in_channels, hidden, kernel_size=k, stride=k)
        else:
            k = (t_patch_size, patch_size, patch_size)
            self.proj = nn.Conv3d(in_channels, hidden, kernel_size=k, stride=k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, pt = self.patch_size, self.t_patch_size
        b, t, h, w, c = x.shape
        if h % p or w % p or t % pt:
            raise ValueError(
                f"grid ({t},{h},{w}) not divisible by patches (t={pt}, s={p})"
            )
        tp, hp, wp = t // pt, h // p, w // p
        x = x.reshape(b, tp, pt, hp, p, wp, p, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
        x = x.reshape(b, tp, hp * wp, c * pt * p * p)  # features (C, pt, p, p)
        dt = self.dtype
        return tensor.column(self.proj, x, lambda x, w, b: F.linear(
            x.to(dt), w.reshape(w.shape[0], -1).to(dt), b.to(dt)))


def unpatch4d(
    tokens: torch.Tensor,
    *,
    h_patches: int,
    w_patches: int,
    patch_size: int,
    t_patch_size: int,
    out_channels: int,
) -> torch.Tensor:
    """(B, T_p, N_s, pt·C·p·p) → (B, T_p·pt, H, W, C).

    Token features are ordered (pt, C, p, p), the reference FinalLayer's
    channel-major order (the JAX package's are (pt, p, p, C)).
    """
    b, tp, _, _ = tokens.shape
    p, pt, c = patch_size, t_patch_size, out_channels
    x = tokens.reshape(b, tp, h_patches, w_patches, pt, c, p, p)
    x = x.permute(0, 1, 4, 2, 6, 3, 7, 5)  # (B, Tp, pt, hp, p, wp, p, C)
    return x.reshape(b, tp * pt, h_patches * p, w_patches * p, c)


class _DiTBase(nn.Module):
    """Shared condition and positional plumbing of the DiT variants: the
    timestep embedding (under ``time_key``), ``time_proj``, the patch
    embedding, the learned spatial and (where ``temporal_slots``) temporal
    position embeddings, the blocks, the final layer and the JAX package's
    initialisation.  Subclasses build ``blocks`` and define ``forward``."""

    time_key = "dif_time_embeddings"

    def __init__(
        self,
        *,
        out_channels: int,
        patch_size: int,
        t_patch_size: int,
        temporal_slots: int | None,
        final_features: int,
        block=DiTBlock,
        frame_wise: bool = False,
        grid_rows: int = 12,
        grid_cols: int = 36,
        past_len: int = 5,
        future_len: int = 3,
        hidden_size: int = 256,
        depth: int = 6,
        num_heads: int = 4,
        mlp_ratio: float = 4.0,
        dropout_rate: float = 0.1,
        time_multiple: int = 4,
        condition: str = "Past",
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        self.out_channels = out_channels
        self.grid_rows, self.grid_cols = grid_rows, grid_cols
        self.past_len, self.future_len = past_len, future_len
        self.patch_size, self.t_patch_size = patch_size, t_patch_size
        self.condition = condition
        self.dtype = dtype
        exp_dim = hidden_size * time_multiple
        self.add_module(self.time_key, TimestepEmbedding(hidden_size, exp_dim, dtype))
        self.time_proj = nn.Sequential(nn.Linear(exp_dim, hidden_size), nn.SiLU())
        self.patch_embed = PatchEmbed4D(
            out_channels, hidden_size, patch_size, t_patch_size, dtype,
            frame_wise=frame_wise,
        )
        n_spatial = (grid_rows // patch_size) * (grid_cols // patch_size)
        self.spatial_pos_embed = nn.Parameter(torch.zeros(1, n_spatial, hidden_size))
        if temporal_slots is not None:
            self.temporal_pos_embed = nn.Parameter(
                torch.zeros(1, temporal_slots, hidden_size)
            )
        else:
            self.temporal_pos_embed = None
        self.blocks = nn.ModuleList([
            block(hidden_size, num_heads, mlp_ratio, dropout_rate, dtype)
            for _ in range(depth)
        ])
        self.final_layer = FinalLayer(hidden_size, final_features, dtype)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The JAX package's initialisation: Xavier-uniform projections,
        zero biases, zero-init AdaLN and final projection (AdaLN-Zero), and
        truncated-normal(0.02) positional embeddings."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, MultiHeadAttention):
                m.reset_parameters(generator)
        zero = [blk.adaLN_modulation[1] for blk in self.blocks]
        zero += [self.final_layer.adaLN_modulation[1], self.final_layer.linear]
        for m in zero:
            nn.init.zeros_(m.weight)
            nn.init.zeros_(m.bias)
        for p in (self.spatial_pos_embed, self.temporal_pos_embed):
            if p is not None:
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04, generator=generator)

    def _concat_input(self, future, past):
        if self.condition == "Past":
            if past is None:
                raise ValueError(
                    "condition='Past' requires past frames; got past=None "
                    "(a model trained conditionally cannot be sampled "
                    "unconditionally)"
                )
            return torch.cat([past, future], dim=1), past.shape[1]
        return future, 0

    def _condition_vec(self, t: torch.Tensor) -> torch.Tensor:
        emb = getattr(self, self.time_key)(t)
        return F.silu(dense(emb, self.time_proj[0], self.dtype))

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Patch tokens ``(B, T_p, N_s, D)`` plus the position embeddings."""
        dt = self.dtype
        spatial = tensor.whole(self, "spatial_pos_embed")
        tokens = self.patch_embed(x) + spatial[:, None].to(dt)
        if self.temporal_pos_embed is not None:
            temporal = tensor.whole(self, "temporal_pos_embed")
            tokens = tokens + temporal[:, : tokens.shape[1], None].to(dt)
        return tokens

    def _run_block(self, block, tokens, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, tokens, *args, use_reentrant=False)
        return block(tokens, *args)

    def _unpatch(self, tokens: torch.Tensor, t_patch: int) -> torch.Tensor:
        return unpatch4d(
            tokens,
            h_patches=self.grid_rows // self.patch_size,
            w_patches=self.grid_cols // self.patch_size,
            patch_size=self.patch_size,
            t_patch_size=t_patch,
            out_channels=self.out_channels,
        )


class _DiTJointBase(_DiTBase):
    """Joint self-attention over all of a sample's tokens (:class:`DiTBlock`),
    the forward shared by :class:`DiT2D`, :class:`DiT4DJoint` and
    :class:`DiT4DTube`."""

    def forward(self, future, t, past=None, *, generator=None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training mode."""
        x, past_len = self._concat_input(future, past)
        x = x.to(self.dtype)
        c = self._condition_vec(t)
        tokens = self._tokens(x)  # (B, T_p, N_s, D)
        b, tp, ns, d = tokens.shape
        tokens = tokens.reshape(b, tp * ns, d)
        for block in self.blocks:
            keep = block.keep_masks(tokens.shape, generator)
            tokens = self._run_block(block, tokens, c, keep)
        tokens = self.final_layer(tokens, c)
        return self._output(tokens.reshape(b, tp, ns, -1), past_len)

    def _output(self, tokens: torch.Tensor, past_len: int) -> torch.Tensor:
        return self._unpatch(tokens, self.t_patch_size)[:, past_len:]


class DiT2D(_DiTJointBase):
    """Per-frame patchify; full attention over (T·N) tokens (V1, FM-DiT)."""

    time_key = "time_embeddings"

    def __init__(self, *, out_channels: int = 3, patch_size: int = 4,
                 t_max: int = 32, **kw):
        super().__init__(
            out_channels=out_channels, patch_size=patch_size, t_patch_size=1,
            temporal_slots=t_max, frame_wise=True,
            final_features=out_channels * patch_size**2, **kw,
        )


class DiT4DJoint(_DiTJointBase):
    """Partial temporal tube + joint attention over all T_p·N_s tokens (V3)."""

    def __init__(self, *, out_channels: int = 3, patch_size: int = 4,
                 t_patch_size: int = 2, t_max: int = 32, **kw):
        super().__init__(
            out_channels=out_channels, patch_size=patch_size,
            t_patch_size=t_patch_size, temporal_slots=t_max // t_patch_size,
            final_features=t_patch_size * out_channels * patch_size**2, **kw,
        )


class DiT4DTube(_DiTJointBase):
    """Full temporal tube (V2): one token per spatial patch, t_patch = T.

    The reference's layout: no temporal position embedding (a single slot)
    and a final layer that emits the F future frames only, ``(F, C, p, p)``
    features a token.  (The JAX package emits all T frames and slices them,
    with zero past rows; ``state_dict_from_jax`` drops those rows.)  Build
    with :meth:`make` so t_patch == past + future.
    """

    time_key = "time_embeddings"

    def __init__(self, *, out_channels: int = 3, patch_size: int = 4,
                 t_patch_size: int, future_len: int = 3, **kw):
        super().__init__(
            out_channels=out_channels, patch_size=patch_size,
            t_patch_size=t_patch_size, future_len=future_len, temporal_slots=None,
            final_features=future_len * out_channels * patch_size**2, **kw,
        )

    @classmethod
    def make(cls, *, past_len: int, future_len: int, **kw):
        return cls(past_len=past_len, future_len=future_len,
                   t_patch_size=past_len + future_len, **kw)

    def _output(self, tokens: torch.Tensor, past_len: int) -> torch.Tensor:
        return self._unpatch(tokens, self.future_len)


class DiT4DFactorized(_DiTBase):
    """Partial tube + factorized spatial/temporal-cross attention (V4)."""

    def __init__(self, *, out_channels: int = 3, patch_size: int = 4,
                 t_patch_size: int = 4, t_max: int = 32, **kw):
        super().__init__(
            out_channels=out_channels, patch_size=patch_size,
            t_patch_size=t_patch_size, temporal_slots=t_max // t_patch_size,
            final_features=t_patch_size * out_channels * patch_size**2,
            block=DiTBlockFactorized, **kw,
        )

    def forward(self, future, t, past=None, *, generator=None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training mode."""
        x, past_len = self._concat_input(future, past)
        x = x.to(self.dtype)
        c = self._condition_vec(t)
        tokens = self._tokens(x)  # (B, T_p, N_s, D)

        # First future temporal slot, from the runtime past length.
        query_slot_start = past_len // self.t_patch_size
        for block in self.blocks:
            keep = block.keep_masks(tokens.shape, query_slot_start, generator)
            tokens = self._run_block(block, tokens, c, query_slot_start, keep)

        tokens = self.final_layer(tokens, c)
        return self._unpatch(tokens, self.t_patch_size)[:, past_len:]
