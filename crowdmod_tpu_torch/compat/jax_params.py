"""Carry the JAX package's DiT4DFactorized weights into the port.

:func:`state_dict_from_jax` turns a flax parameter tree (nested dicts of
numpy arrays, as ``model.init(...)["params"]`` gives them) into the port's
state_dict.  The port keeps the reference's torch layout, so this is the
exact inverse of the JAX package's ``compat/torch_import.py``
(``_import_dit4d_factorized``): the fused MHA in-projection is packed, the
patch kernel goes back to Conv3d ``(D, C, pt, p, p)``, and the final layer's
token features go back from channel-minor ``(pt, p, p, C)`` to the
reference's channel-major ``(pt, C, p, p)`` order.  Pure numpy, then
``torch.from_numpy``; nothing of JAX is imported.
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


def state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """Flax DiT4DFactorized params → the port's (reference-layout)
    state_dict, float32 and contiguous."""
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

    return {
        k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
        for k, v in sd.items()
    }
