"""Fused UNet ResnetBlock3D forward: the Hopper kernel and its plain twin.

Replaces ``crowdmod_tpu/ops/pallas/resblock.py`` (``_fused_pallas``, kernel
``_resblock_kernel``).  The CUDA source, ``csrc/resblock.cu``, notes what
bounds it on the H100 and how its design (three launches a call: GN1
moments, conv1 with GN1+SiLU on load, conv2 with GN2+SiLU on load and the
skip folded in) answers that.

The weight dict is the JAX package's contract (``resblock.py:62-94``), as
torch tensors: ``gn1_scale``/``gn1_bias (Cin,)``, ``w1 (3,3,3,Cin,Cout)``,
``b1``, ``gn2_scale``/``gn2_bias (Cout,)``, ``w2 (3,3,3,Cout,Cout)``,
``b2`` and, when Cin ≠ Cout, ``w_skip (1,1,1,Cin,Cout)`` + ``b_skip``.
:func:`pack_resblock` lays it out for the kernel once; a caller that holds
the weights passes the packed form as ``packed=`` so no call repacks.

:func:`fused_resblock` runs :func:`resblock_reference` on CPU tensors and
the kernel on CUDA tensors, or raises; it never falls back to the twin.
"""

from __future__ import annotations

import ctypes

import torch

from crowdmod_tpu_torch.ops.kernels import build
from crowdmod_tpu_torch.ops.kernels.conv3d import (
    conv3d_same_reference,
    pack_im2col,
)
from crowdmod_tpu_torch.ops.kernels.groupnorm import group_norm_reference

# Limits of the kernel (csrc/resblock.cu): a block's 128 output positions
# may span two samples, never more, and GN2's per-block sums hold 32 groups.
MIN_VOLUME = 128
MAX_GROUPS = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "crowdmod_resblock": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ),
}


def resblock_reference(x, temb_proj, w, *, num_groups: int = 8, eps: float = 1e-5):
    """Plain twin of one deterministic ResnetBlock3D, op for op as the JAX
    oracle: each conv's output and bias in x's dtype, GN moments in f32."""
    dt = x.dtype
    h = group_norm_reference(x, w["gn1_scale"], w["gn1_bias"], num_groups, eps, True)
    h = conv3d_same_reference(h, w["w1"].to(dt)) + w["b1"].to(dt)
    h = h + temb_proj.to(dt)[:, None, None, None, :]
    h = group_norm_reference(h, w["gn2_scale"], w["gn2_bias"], num_groups, eps, True)
    h = conv3d_same_reference(h, w["w2"].to(dt)) + w["b2"].to(dt)
    if "w_skip" in w:
        cin, cout = w["w_skip"].shape[-2:]
        skip = torch.matmul(
            x.float(), w["w_skip"].reshape(cin, cout).to(dt).float()
        ).to(dt) + w["b_skip"].to(dt)
    else:
        skip = x
    return h + skip


def pack_resblock(w: dict, dtype: torch.dtype) -> dict:
    """The kernel's layout of a weight dict: folded conv weights in
    ``dtype`` (the 1×1 skip appended to conv2's as Cin extra rows), the GN
    affines and the summed output bias in float32."""
    cin, cout = w["w1"].shape[-2:]
    w2 = pack_im2col(w["w2"])
    bias2 = w["b2"].float()
    has_skip = "w_skip" in w
    if has_skip:
        w2 = torch.cat([w2, w["w_skip"].reshape(cin, cout)])
        bias2 = bias2 + w["b_skip"].float()
    f32 = lambda t: t.float().contiguous()
    return {
        "w1": pack_im2col(w["w1"]).to(dtype).contiguous(),
        "w2": w2.to(dtype).contiguous(),
        "b1": f32(w["b1"]),
        "gamma1": f32(w["gn1_scale"]), "beta1": f32(w["gn1_bias"]),
        "gamma2": f32(w["gn2_scale"]), "beta2": f32(w["gn2_bias"]),
        "bias2": bias2.contiguous(),
        "has_skip": has_skip, "cin": int(cin), "cout": int(cout),
    }


def _check(x, temb_proj, p, num_groups) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock: x is on {x.device}, not a CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"fused_resblock: dtype {x.dtype}; the kernel takes one of "
            f"{list(_DTYPE_CODES)}"
        )
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError(
            "fused_resblock: x must be a contiguous (B, T, H, W, Cin) tensor, "
            f"got shape {tuple(x.shape)}, strides {x.stride()}"
        )
    b, t, h, w, cin = x.shape
    cout = p["cout"]
    if cin != p["cin"] or (not p["has_skip"] and cin != cout):
        raise ValueError(
            f"fused_resblock: x has {cin} channels, the weights take "
            f"{p['cin']} → {cout}"
        )
    if cin % num_groups or cout % num_groups or num_groups > MAX_GROUPS:
        raise ValueError(
            f"fused_resblock: channels {cin} → {cout} must be divisible by "
            f"num_groups ({num_groups} ≤ {MAX_GROUPS})"
        )
    if t * h * w < MIN_VOLUME:
        raise ValueError(
            f"fused_resblock: volume {t}·{h}·{w} < {MIN_VOLUME}, the least "
            "the kernel takes"
        )
    if tuple(temb_proj.shape) != (b, cout) or temb_proj.device != x.device:
        raise ValueError(
            f"fused_resblock: temb_proj must be ({b}, {cout}) on {x.device}, "
            f"got {tuple(temb_proj.shape)} on {temb_proj.device}"
        )
    for name in ("w1", "w2"):
        if p[name].dtype != x.dtype or p[name].device != x.device:
            raise ValueError(
                f"fused_resblock: packed {name} is {p[name].dtype} on "
                f"{p[name].device}; x is {x.dtype} on {x.device}"
            )


def fused_resblock(
    x: torch.Tensor,
    temb_proj: torch.Tensor,
    w: dict,
    *,
    num_groups: int = 8,
    eps: float = 1e-5,
    packed: dict | None = None,
) -> torch.Tensor:
    """One ResnetBlock3D forward (deterministic), ``(B, T, H, W, Cin) →
    (B, T, H, W, Cout)``; ``temb_proj (B, Cout)`` is the block's
    ``time_dense`` output.  CPU tensors take the plain twin; CUDA tensors
    the kernel, with ``packed`` (:func:`pack_resblock` of ``w``) when the
    caller has it."""
    if x.device.type == "cpu":
        return resblock_reference(x, temb_proj, w, num_groups=num_groups, eps=eps)
    p = packed if packed is not None else pack_resblock(w, x.dtype)
    _check(x, temb_proj, p, num_groups)
    b, t, h, wd, cin = x.shape
    cout = p["cout"]
    tvec = (temb_proj.float() + p["b1"]).contiguous()
    h1 = torch.empty((b, t, h, wd, cout), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, b, num_groups, 2), dtype=torch.float32, device=x.device)
    out = torch.empty((b, t, h, wd, cout), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    lib = build.load("resblock", _SIGNATURES)
    err = lib.crowdmod_resblock(
        _DTYPE_CODES[x.dtype], x.data_ptr(), tvec.data_ptr(),
        p["w1"].data_ptr(), p["w2"].data_ptr(), p["gamma1"].data_ptr(),
        p["beta1"].data_ptr(), p["gamma2"].data_ptr(), p["beta2"].data_ptr(),
        p["bias2"].data_ptr(), h1.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), out.data_ptr(), b, t, h, wd, cin, cout,
        num_groups, float(eps), int(p["has_skip"]),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"resblock kernel launch failed: CUDA error {err}")
    fused_resblock.launches += 1
    return out


fused_resblock.launches = 0
