"""Fused GroupNorm (+SiLU): the Hopper kernel and its plain twin.

Replaces ``crowdmod_tpu/ops/pallas/groupnorm.py`` (``_gn_pallas``, kernel
``_gn_kernel``).  The CUDA source, ``csrc/groupnorm.cu``, notes what bounds
the kernel on the H100 (bytes) and how its design answers that.

:func:`fused_group_norm` takes channels-last ``(B, ..., C)``.  On CPU
tensors it runs :func:`group_norm_reference`; on CUDA tensors it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from crowdmod_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "crowdmod_group_norm": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ),
}


def group_norm_reference(x, gamma, beta, num_groups: int, eps: float, silu: bool):
    """Plain twin, flax ``nn.GroupNorm`` semantics: moments over all
    positions and the group's channels, biased variance (two passes), f32
    moments and affine, input dtype in and out."""
    c = x.shape[-1]
    xg = x.float().reshape(x.shape[0], -1, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    norm = (xg - mean) * torch.rsqrt(var + eps)
    out = norm.reshape(x.shape) * gamma.float() + beta.float()
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def _check(x, gamma, beta) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: x is on {x.device}, not a CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"fused_group_norm: dtype {x.dtype}; the kernel takes one of "
            f"{list(_DTYPE_CODES)}"
        )
    if x.dim() < 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(
            "fused_group_norm: x must be a contiguous, 16-byte aligned "
            f"(B, ..., C) tensor, got shape {tuple(x.shape)}, strides "
            f"{x.stride()}"
        )
    c = x.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.device != x.device or t.dtype != torch.float32
                or t.shape != (c,) or not t.is_contiguous()):
            raise ValueError(
                f"fused_group_norm: {name} must be a contiguous float32 "
                f"({c},) tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )


def fused_group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    num_groups: int = 8,
    eps: float = 1e-5,
    silu: bool = False,
) -> torch.Tensor:
    """GroupNorm(+SiLU) over channels-last ``(B, ..., C)``.  CPU tensors
    take the plain twin; CUDA tensors the kernel."""
    if x.shape[-1] % num_groups:
        raise ValueError(
            f"channels ({x.shape[-1]}) must be divisible by "
            f"num_groups ({num_groups})"
        )
    if x.device.type == "cpu":
        return group_norm_reference(x, gamma, beta, num_groups, eps, silu)
    _check(x, gamma, beta)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, c = x.shape[0], x.shape[-1]
    lib = build.load("groupnorm", _SIGNATURES)
    err = lib.crowdmod_group_norm(
        _DTYPE_CODES[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), b, x.numel() // (b * c), c, num_groups, float(eps),
        int(silu), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"group-norm kernel launch failed: CUDA error {err}")
    fused_group_norm.launches += 1
    return out


fused_group_norm.launches = 0
