"""Carry the JAX package's DiT, UNet3D and ConvRNN weights into the port.

:func:`state_dict_from_jax` turns a flax parameter tree (nested dicts of
numpy arrays, as ``model.init(...)["params"]`` gives them) into the port's
state_dict.  The port keeps the reference's torch layout, so this is the
inverse of the JAX package's ``compat/torch_import.py``:

* ``_import_dit4d_factorized`` and ``_import_dit4d_joint``: the fused MHA
  in-projection is packed, the patch kernel goes back to Conv3d ``(D, C,
  pt, p, p)``, and the final layer's token features go back from
  channel-minor ``(pt, p, p, C)`` to the reference's channel-major ``(pt, C,
  p, p)`` order;
* ``_import_dit2d``: the same with the per-frame Conv2d ``(D, C, p, p)``
  and the ``time_embeddings`` prefix;
* ``_import_dit4d_tube``: the reference's final layer emits the F future
  frames only, so the JAX projection's past-frame rows (zero in any tree
  that importer makes or that training reaches: they never get a gradient)
  are dropped, and refused where they are not zero; the reference has no
  temporal embedding (one slot), so the JAX one is added into the spatial
  embedding, which every token also gets;
* ``_import_unet3d``: conv kernels go back to Conv3d ``(O, I, kh, kw, kl)``,
  and the flax names (``enc_{level}_{i}``, ``down_{level}``, ``mid_*``,
  ``dec_{level}_{i}``, ``up_{level}``) to the reference's ModuleList indices,
  where ResnetBlocks and Down/UpSamples interleave;
* ``_import_convrnn``, ``_cell``, ``_conv2d`` and ``_convT2d``: conv
  kernels go back to Conv2d ``(O, I, kh, kw)``, the transpose kernels to
  ConvTranspose2d ``(I, O, kh, kw)`` with the spatial flip undone, the
  fused GRU ``gates`` conv is split into ``reset_gate`` (its first
  ``hidden`` output channels) and ``update_gate``, and the flax names to
  the reference's ``encoder.encoder_cell_list`` and
  ``forecaster_cell_list`` indices.

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


def _conv2d(tree: dict, prefix: str, out: dict) -> None:
    # flax (kh, kw, I, O) → torch Conv2d (O, I, kh, kw).
    out[f"{prefix}.weight"] = np.asarray(tree["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _conv_t2d(tree: dict, prefix: str, out: dict) -> None:
    # flax ConvTranspose (kh, kw, I, O), spatially flipped against the
    # reference → torch ConvTranspose2d (I, O, kh, kw).
    out[f"{prefix}.weight"] = np.asarray(tree["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _cell(tree: dict, prefix: str, out: dict) -> None:
    if "candidate" not in tree:  # ConvLSTM: one 4-gate conv
        _conv2d(tree["gates"], f"{prefix}.conv", out)
        return
    gates = tree["gates"]  # ConvGRU: [reset | update] along the outputs
    hidden = np.shape(gates["kernel"])[-1] // 2
    for name, part in (("reset_gate", slice(0, hidden)),
                       ("update_gate", slice(hidden, 2 * hidden))):
        half = {"kernel": np.asarray(gates["kernel"])[..., part]}
        if "bias" in gates:
            half["bias"] = np.asarray(gates["bias"])[part]
        _conv2d(half, f"{prefix}.{name}", out)
    _conv2d(tree["candidate"], f"{prefix}.conv_cand", out)


def _convrnn(params: dict) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    enc, pre = params["encoder"], "encoder.encoder_cell_list"
    for i, (name, fn) in enumerate((("conv1", _conv2d), ("rnn1", _cell), ("down1", _conv2d),
                                    ("rnn2", _cell), ("down2", _conv2d), ("rnn3", _cell))):
        fn(enc[name], f"{pre}.{i}", sd)
    for i, (name, fn) in enumerate((("frnn1", _cell), ("fup1", _conv_t2d), ("frnn2", _cell),
                                    ("fup2", _conv_t2d), ("frnn3", _cell),
                                    ("fconv4", _conv2d), ("head", _conv2d))):
        fn(params[name], f"forecaster_cell_list.{i}", sd)
    return sd


BACKBONES = ("unet3d", "dit4d_factorized", "dit2d", "dit4d_joint", "dit4d_tube",
             "convrnn")


def state_dict_from_jax(params: dict, backbone: str | None = None, *,
                        future_len: int | None = None) -> dict[str, torch.Tensor]:
    """Flax params of a UNet3D, DiT or ConvRNN → the port's
    (reference-layout) state_dict, float32 and contiguous.

    ``backbone`` (a name of :data:`BACKBONES`, as ``torch_import`` names
    them) is read from the tree when None: the UNet, the ConvRNN, the
    factorized DiT, and DiT2D (a joint-attention tree with a one-frame
    patch; a DiT4DJoint with t_patch 1 computes the same function).  DiT4DJoint and DiT4DTube trees
    must be named, the tube's with its ``future_len``."""
    if backbone is None:
        backbone = _detect(params)
    if backbone not in BACKBONES:
        raise ValueError(f"unknown backbone {backbone!r}; expected one of {BACKBONES}")
    if backbone == "dit4d_tube":
        sd = _dit4d_tube(params, future_len)
    else:
        sd = {"unet3d": _unet3d, "dit2d": _dit2d, "convrnn": _convrnn,
              "dit4d_factorized": lambda p: _dit4d(p, _FACTORIZED_ATTN),
              "dit4d_joint": lambda p: _dit4d(p, _JOINT_ATTN)}[backbone](params)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
        for k, v in sd.items()
    }


def _detect(params: dict) -> str:
    if "first" in params:
        return "unet3d"
    if "encoder" in params and "frnn1" in params:
        return "convrnn"
    if "spatial_attn" in params["block_0"]:
        return "dit4d_factorized"
    if np.shape(params["patch_embed"]["Conv_0"]["kernel"])[0] == 1:
        return "dit2d"
    raise ValueError(
        "a joint-attention DiT tree with a temporal tube: pass "
        "backbone='dit4d_joint' or 'dit4d_tube'"
    )


def _dit_common(params: dict, time_key: str, sd: dict) -> np.ndarray:
    """The timestep embedding, ``time_proj``, the patch bias and the spatial
    embedding into ``sd``; → the patch kernel ``(pt, p, p, C, D)``."""
    _linear(params["time_emb"]["expand"], f"{time_key}.time_blocks.1", sd)
    _linear(params["time_emb"]["project"], f"{time_key}.time_blocks.3", sd)
    _linear(params["time_proj"], "time_proj.0", sd)
    sd["patch_embed.proj.bias"] = np.asarray(params["patch_embed"]["Conv_0"]["bias"])
    sd["spatial_pos_embed"] = np.asarray(params["spatial_pos_embed"])[:, 0]
    return np.asarray(params["patch_embed"]["Conv_0"]["kernel"])


def _dit_blocks(params: dict, sd: dict, attn: tuple[str, ...]) -> None:
    """Each ``block_{i}``: AdaLN, the attention(s) named ``attn`` (flax
    name → reference name), the MLP."""
    n_blocks = sum(1 for k in params if k.startswith("block_"))
    for i in range(n_blocks):
        blk, pre = params[f"block_{i}"], f"blocks.{i}"
        _linear(blk["AdaLNModulation_0"]["Dense_0"], f"{pre}.adaLN_modulation.1", sd)
        for flax_name, name in attn:
            _mha(blk[flax_name], f"{pre}.{name}", sd)
        _linear(blk["Mlp_0"]["Dense_0"], f"{pre}.mlp.0", sd)
        _linear(blk["Mlp_0"]["Dense_1"], f"{pre}.mlp.3", sd)


def _dit_final(final: dict, perm: np.ndarray, sd: dict) -> None:
    """The final layer, its token features from the JAX order to the
    reference's: feature ``perm[j]`` of the reference is JAX's ``j``."""
    _linear(final["AdaLNModulation_0"]["Dense_0"],
            "final_layer.adaLN_modulation.1", sd)
    fin_k = np.asarray(final["Dense_0"]["kernel"])  # (hidden, out), JAX order
    weight = np.empty((fin_k.shape[1], fin_k.shape[0]), np.float32)
    bias = np.empty((fin_k.shape[1],), np.float32)
    weight[perm] = fin_k.T
    bias[perm] = np.asarray(final["Dense_0"]["bias"])
    sd["final_layer.linear.weight"] = weight
    sd["final_layer.linear.bias"] = bias


_JOINT_ATTN = (("MultiHeadAttention_0", "attn"),)
_FACTORIZED_ATTN = (("spatial_attn", "spatial_attn"), ("temporal_attn", "temporal_attn"))


def _dit4d(params: dict, attn: tuple) -> dict[str, np.ndarray]:
    """DiT4DFactorized (V4) or DiT4DJoint (V3): a Conv3d tube patch."""
    sd: dict[str, np.ndarray] = {}
    kernel = _dit_common(params, "dif_time_embeddings", sd)  # (pt, p, p, C, D)
    pt, p, _, c, _ = kernel.shape
    sd["patch_embed.proj.weight"] = kernel.transpose(4, 3, 0, 1, 2)
    sd["temporal_pos_embed"] = np.asarray(params["temporal_pos_embed"])[:, :, 0]
    _dit_blocks(params, sd, attn)
    _dit_final(params["final"], _tube_perm(pt, p, c), sd)
    return sd


def _dit2d(params: dict) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    kernel = _dit_common(params, "time_embeddings", sd)  # (1, p, p, C, D)
    _, p, _, c, _ = kernel.shape
    sd["patch_embed.proj.weight"] = kernel[0].transpose(3, 2, 0, 1)  # Conv2d
    sd["temporal_pos_embed"] = np.asarray(params["temporal_pos_embed"])[:, :, 0]
    _dit_blocks(params, sd, _JOINT_ATTN)
    _dit_final(params["final"], _tube_perm(1, p, c), sd)
    return sd


def _dit4d_tube(params: dict, future_len: int | None) -> dict[str, np.ndarray]:
    if future_len is None:
        raise ValueError("a DiT4DTube tree needs future_len: the reference's "
                         "final layer emits the future frames only")
    sd: dict[str, np.ndarray] = {}
    kernel = _dit_common(params, "time_embeddings", sd)  # (T, p, p, C, D)
    t_total, p, _, c, _ = kernel.shape
    sd["patch_embed.proj.weight"] = kernel.transpose(4, 3, 0, 1, 2)
    # One slot: its temporal embedding reaches every token, as the spatial
    # one does.
    sd["spatial_pos_embed"] = (sd["spatial_pos_embed"]
                               + np.asarray(params["temporal_pos_embed"])[:, :1, 0])
    _dit_blocks(params, sd, _JOINT_ATTN)

    final = params["final"]
    fin_k = np.asarray(final["Dense_0"]["kernel"])  # (hidden, T·p·p·C)
    fin_b = np.asarray(final["Dense_0"]["bias"])
    cut = (t_total - future_len) * p * p * c  # the past frames' features
    if np.any(fin_k[:, :cut]) or np.any(fin_b[:cut]):
        raise ValueError(
            "DiT4DTube: the final layer's past-frame rows are not zero, so the "
            "reference layout (future frames only) cannot hold them"
        )
    _dit_final({"AdaLNModulation_0": final["AdaLNModulation_0"],
                "Dense_0": {"kernel": fin_k[:, cut:], "bias": fin_b[cut:]}},
               _tube_perm(future_len, p, c), sd)
    return sd
