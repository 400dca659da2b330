"""Diffusion-Transformer backbone for macroproperty sequences (port of the
JAX package's ``models/backbones/dit.py``: the shared pieces and
:class:`DiT4DFactorized`, the DDPM-DiT flagship).

:class:`DiT4DFactorized` — partial temporal tube patchify + factorized
attention: spatial self-attention per temporal slot, then temporal
cross-attention where only future slots are queries (the reference's
DiT4D_V4).  AdaLN-Zero conditioning throughout.

Inputs and outputs are native layout ``(B, T, H, W, C)``; tokens are carried
as ``(B, T_p, N_s, D)``.  Module and parameter names follow the reference's
torch layout, the one ``crowdmod_tpu.compat.torch_import`` reads
(``blocks.{i}.spatial_attn.in_proj_weight``, ``patch_embed.proj.weight`` as
``(D, C, pt, p, p)``, ``final_layer.linear`` with channel-major token
features, ``temporal_pos_embed`` as ``(1, t_slots, D)``), so a state_dict of
this model is a reference checkpoint.

``dtype`` is the compute dtype: weights stay float32 and are cast at use, and
the final projection runs in float32, as in the JAX package.

Dropout (training mode) draws its masks from the ``generator`` passed to
the forward, before each block runs, and hands them to the block; with
``remat`` each block runs under ``torch.utils.checkpoint`` (the JAX
package's ``TPU.REMAT``), and its recompute applies the same masks.
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
        mode = "tanh" if device.type == "cuda" else "exact"
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

    The weight is the reference's Conv3d ``(D, C, pt, p, p)``; with stride
    equal to the kernel the convolution is a reshape and one matmul, which is
    how it runs here (no cuDNN, so no TF32 rounding of an f32 convolution).
    """

    def __init__(self, in_channels: int, hidden: int, patch_size: int,
                 t_patch_size: int, dtype):
        super().__init__()
        self.patch_size, self.t_patch_size = patch_size, t_patch_size
        self.dtype = dtype
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
        weight = self.proj.weight.reshape(self.proj.out_channels, -1)
        return F.linear(
            x.to(self.dtype), weight.to(self.dtype), self.proj.bias.to(self.dtype)
        )


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


class DiT4DFactorized(nn.Module):
    """Partial tube + factorized spatial/temporal-cross attention (V4)."""

    def __init__(
        self,
        *,
        out_channels: int = 3,
        grid_rows: int = 12,
        grid_cols: int = 36,
        past_len: int = 5,
        future_len: int = 3,
        patch_size: int = 4,
        t_patch_size: int = 4,
        hidden_size: int = 256,
        depth: int = 6,
        num_heads: int = 4,
        mlp_ratio: float = 4.0,
        dropout_rate: float = 0.1,
        time_multiple: int = 4,
        condition: str = "Past",
        t_max: int = 32,
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
        self.dif_time_embeddings = TimestepEmbedding(hidden_size, exp_dim, dtype)
        self.time_proj = nn.Sequential(nn.Linear(exp_dim, hidden_size), nn.SiLU())
        self.patch_embed = PatchEmbed4D(
            out_channels, hidden_size, patch_size, t_patch_size, dtype
        )
        n_spatial = (grid_rows // patch_size) * (grid_cols // patch_size)
        self.spatial_pos_embed = nn.Parameter(torch.zeros(1, n_spatial, hidden_size))
        self.temporal_pos_embed = nn.Parameter(
            torch.zeros(1, t_max // t_patch_size, hidden_size)
        )
        self.blocks = nn.ModuleList([
            DiTBlockFactorized(hidden_size, num_heads, mlp_ratio, dropout_rate, dtype)
            for _ in range(depth)
        ])
        self.final_layer = FinalLayer(
            hidden_size, t_patch_size * out_channels * patch_size**2, dtype
        )
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The JAX package's initialisation: Xavier-uniform projections,
        zero biases, zero-init AdaLN and final projection (AdaLN-Zero), and
        truncated-normal(0.02) positional embeddings."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
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

    def forward(self, future, t, past=None, *, generator=None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training mode."""
        x, past_len = self._concat_input(future, past)
        dt = self.dtype
        x = x.to(dt)
        c = F.silu(dense(self.dif_time_embeddings(t), self.time_proj[0], dt))

        tokens = self.patch_embed(x)  # (B, T_p, N_s, D)
        tokens = (
            tokens + self.spatial_pos_embed[:, None].to(dt)
            + self.temporal_pos_embed[:, : tokens.shape[1], None].to(dt)
        )

        # First future temporal slot, from the runtime past length.
        query_slot_start = past_len // self.t_patch_size
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            keep = block.keep_masks(tokens.shape, query_slot_start, generator)
            if remat:
                tokens = checkpoint(block, tokens, c, query_slot_start, keep,
                                    use_reentrant=False)
            else:
                tokens = block(tokens, c, query_slot_start, keep)

        tokens = self.final_layer(tokens, c)
        out = unpatch4d(
            tokens,
            h_patches=self.grid_rows // self.patch_size,
            w_patches=self.grid_cols // self.patch_size,
            patch_size=self.patch_size,
            t_patch_size=self.t_patch_size,
            out_channels=self.out_channels,
        )
        return out[:, past_len:]
