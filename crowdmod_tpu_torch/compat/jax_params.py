"""Carry the JAX package's DiT4DFactorized and UNet3D weights into the port.

:func:`state_dict_from_jax` turns a flax parameter tree (nested dicts of
numpy arrays, as ``model.init(...)["params"]`` gives them) into the port's
state_dict.  The port keeps the reference's torch layout, so this is the
exact inverse of the JAX package's ``compat/torch_import.py``:

* ``_import_dit4d_factorized``: the fused MHA in-projection is packed, the
  patch kernel goes back to Conv3d ``(D, C, pt, p, p)``, and the final
  layer's token features go back from channel-minor ``(pt, p, p, C)`` to the
  reference's channel-major ``(pt, C, p, p)`` order;
* ``_import_unet3d``: conv kernels go back to Conv3d ``(O, I, kh, kw, kl)``,
  and the flax names (``enc_{level}_{i}``, ``down_{level}``, ``mid_*``,
  ``dec_{level}_{i}``, ``up_{level}``) to the reference's ModuleList indices,
  where ResnetBlocks and Down/UpSamples interleave.

Pure numpy, then ``torch.from_numpy``; nothing of JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch


def _linear(tree: dict, prefix: str, out: dict) -> None:
    # flax Dense kernel (in, out) → torch Linear weight (out, in).
    out[f"{prefix}.weight"] = np.asarray(tree["kernel"]).T
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _mha(tree: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.in_proj_weight"] = np.concatenate(
        [np.asarray(tree[n]["kernel"]).T for n in ("query", "key", "value")]
    )
    out[f"{prefix}.in_proj_bias"] = np.concatenate(
        [np.asarray(tree[n]["bias"]) for n in ("query", "key", "value")]
    )
    _linear(tree["out"], f"{prefix}.out_proj", out)


def _tube_perm(pt: int, p: int, c: int) -> np.ndarray:
    """Index j of the JAX feature order (pt, p, p, C) → index perm[j] of the
    reference order (pt, C, p, p)."""
    return (np.arange(pt * c * p * p).reshape(pt, c, p, p)
            .transpose(0, 2, 3, 1).reshape(-1))


def _conv3d(tree: dict, prefix: str, out: dict) -> None:
    # flax (kl, kh, kw, I, O) → torch Conv3d (O, I, kh, kw, kl).
    out[f"{prefix}.weight"] = np.asarray(tree["kernel"]).transpose(4, 3, 1, 2, 0)
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _gn(tree: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["scale"])
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _resblock(tree: dict, prefix: str, out: dict) -> None:
    _gn(tree["GroupNormSiLU_0"], f"{prefix}.normalize_1", out)
    _conv3d(tree["conv1"], f"{prefix}.conv_1", out)
    _linear(tree["time_dense"], f"{prefix}.dense_1", out)
    _gn(tree["GroupNormSiLU_1"], f"{prefix}.normalize_2", out)
    _conv3d(tree["conv2"], f"{prefix}.conv_2", out)
    if "match_input" in tree:
        _conv3d(tree["match_input"], f"{prefix}.match_input", out)
    if "SpatialAttentionBlock_0" in tree:
        attn = tree["SpatialAttentionBlock_0"]
        _gn(attn["GroupNormSiLU_0"], f"{prefix}.attention.group_norm", out)
        _mha(attn["MultiHeadAttention_0"], f"{prefix}.attention.mhsa", out)


def _unet3d(params: dict) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    temb = params["TimestepEmbedding_0"]
    _linear(temb["expand"], "time_embeddings.time_blocks.1", sd)
    _linear(temb["project"], "time_embeddings.time_blocks.3", sd)
    _conv3d(params["first"], "first", sd)
    levels = 1 + max(int(k.split("_")[1]) for k in params if k.startswith("enc_"))
    blocks = sum(1 for k in params if k.startswith("enc_0_"))
    n = 0  # encoder_blocks index: blocks, then a downsample, per level
    for level in range(levels):
        for i in range(blocks):
            _resblock(params[f"enc_{level}_{i}"], f"encoder_blocks.{n}", sd)
            n += 1
        if f"down_{level}" in params:
            _conv3d(params[f"down_{level}"]["Conv_0"],
                    f"encoder_blocks.{n}.downsample", sd)
            n += 1
    _resblock(params["mid_0"], "bottleneck_blocks.0", sd)
    _resblock(params["mid_1"], "bottleneck_blocks.1", sd)
    n = 0  # decoder_blocks index, deepest level first
    for level in reversed(range(levels)):
        for i in range(blocks + 1):
            _resblock(params[f"dec_{level}_{i}"], f"decoder_blocks.{n}", sd)
            n += 1
        if f"up_{level}" in params:
            _conv3d(params[f"up_{level}"]["Conv3DSame_0"],
                    f"decoder_blocks.{n}.upsample.1", sd)
            n += 1
    _gn(params["final_norm"], "final.0", sd)
    _conv3d(params["final_conv"], "final.2", sd)
    return sd


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Flax DiT4DFactorized or UNet3D params → the port's (reference-layout)
    state_dict, float32 and contiguous."""
    sd = _unet3d(params) if "first" in params else _dit4d_factorized(params)
    return {
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        for k, v in sd.items()
    }


def _dit4d_factorized(params: dict) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    _linear(params["time_emb"]["expand"], "dif_time_embeddings.time_blocks.1", sd)
    _linear(params["time_emb"]["project"], "dif_time_embeddings.time_blocks.3", sd)
    _linear(params["time_proj"], "time_proj.0", sd)

    kernel = np.asarray(params["patch_embed"]["Conv_0"]["kernel"])  # (pt,p,p,C,D)
    pt, p, _, c, _ = kernel.shape
    sd["patch_embed.proj.weight"] = kernel.transpose(4, 3, 0, 1, 2)
    sd["patch_embed.proj.bias"] = np.asarray(params["patch_embed"]["Conv_0"]["bias"])
    sd["spatial_pos_embed"] = np.asarray(params["spatial_pos_embed"])[:, 0]
    sd["temporal_pos_embed"] = np.asarray(params["temporal_pos_embed"])[:, :, 0]

    n_blocks = sum(1 for k in params if k.startswith("block_"))
    for i in range(n_blocks):
        blk, pre = params[f"block_{i}"], f"blocks.{i}"
        _linear(blk["AdaLNModulation_0"]["Dense_0"], f"{pre}.adaLN_modulation.1", sd)
        _mha(blk["spatial_attn"], f"{pre}.spatial_attn", sd)
        _mha(blk["temporal_attn"], f"{pre}.temporal_attn", sd)
        _linear(blk["Mlp_0"]["Dense_0"], f"{pre}.mlp.0", sd)
        _linear(blk["Mlp_0"]["Dense_1"], f"{pre}.mlp.3", sd)

    final = params["final"]
    _linear(final["AdaLNModulation_0"]["Dense_0"],
            "final_layer.adaLN_modulation.1", sd)
    perm = _tube_perm(pt, p, c)
    fin_k = np.asarray(final["Dense_0"]["kernel"])  # (hidden, out), JAX order
    weight = np.empty((fin_k.shape[1], fin_k.shape[0]), np.float32)
    bias = np.empty((fin_k.shape[1],), np.float32)
    weight[perm] = fin_k.T
    bias[perm] = np.asarray(final["Dense_0"]["bias"])
    sd["final_layer.linear.weight"] = weight
    sd["final_layer.linear.bias"] = bias
    return sd
