"""Fused multi-head attention: the Hopper kernel and its plain twin.

Replaces ``crowdmod_tpu/ops/pallas/attention.py`` (``_attention_pallas``,
kernel ``_attn_kernel``).  The CUDA source, ``csrc/attention.cu``, notes what
bounds the kernel on the H100 (bytes) and how its design answers that.

:func:`fused_attention` takes ``(B, H, S, Dh)`` tensors.  On CPU tensors it
runs :func:`attention_reference`; on CUDA tensors it launches the kernel or
raises.  The kernel reads each input through its strides (only the last
dimension must be contiguous), so the ``(B, S, H, Dh)`` views that
``MultiHeadAttention`` makes are read in place, and it writes its output in
``(B, S, H, Dh)`` memory order, returned as a ``(B, H, S, Dh)`` view: the
caller's move back to ``(B, S, H·Dh)`` is a free reshape, not a copy.
"""

from __future__ import annotations

import ctypes

import torch

from crowdmod_tpu_torch.ops.kernels import build

# Limits of the kernel (csrc/attention.cu): the head dims it is compiled for
# and the most keys whose K and V it can hold in shared memory.
HEAD_DIMS = (32, 64)
MAX_KEYS = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "crowdmod_attention": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p],
    ),
}


def attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """Plain twin: f32 logits and softmax over ``(B, H, Sq/Sk, Dh)``, the
    weights cast to V's dtype, f32 accumulation, output in q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"fused_attention: {name} is on {t.device}, q on {q.device}; "
                "all three must be on one CUDA device"
            )
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(
                f"fused_attention: {name} has dtype {t.dtype} (q {q.dtype}); "
                f"the kernel takes one of {list(_DTYPE_CODES)}"
            )
        if t.dim() != 4:
            raise ValueError(
                f"fused_attention: {name} must be (B, H, S, Dh), got "
                f"{tuple(t.shape)}"
            )
        if t.stride(-1) != 1:
            raise ValueError(
                f"fused_attention: {name}'s last dimension must be contiguous "
                f"(strides {t.stride()})"
            )
    b, h, _, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != dh:
        raise ValueError(
            f"fused_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not form (B, H, S, Dh) problems"
        )
    if dh not in HEAD_DIMS:
        raise ValueError(
            f"fused_attention: head dim {dh} not in the kernel's {HEAD_DIMS}"
        )
    if not 1 <= k.shape[2] <= MAX_KEYS:
        raise ValueError(
            f"fused_attention: {k.shape[2]} keys; the kernel takes 1 to "
            f"{MAX_KEYS}"
        )


def fused_attention(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """softmax(scale · q kᵀ) v over ``(B, H, S, Dh)``; ``scale`` defaults to
    1/√Dh.  CPU tensors take the plain twin; CUDA tensors the kernel."""
    scale = float(scale if scale is not None else 1.0 / q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    _check(q, k, v)
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    out = torch.empty(
        (b, sq, h, dh), dtype=q.dtype, device=q.device
    ).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    lib = build.load("attention", _SIGNATURES)
    err = lib.crowdmod_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, h, sq, sk, dh, scale, strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
