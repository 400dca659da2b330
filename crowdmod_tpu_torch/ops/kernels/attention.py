"""Fused multi-head attention: the Hopper kernel and its plain twin.

Replaces ``crowdmod_tpu/ops/pallas/attention.py`` (``_attention_pallas``,
kernel ``_attn_kernel``).  The CUDA source, ``csrc/attention.cu``, notes what
bounds the kernel on the H100 (bytes) and how its two routes answer that:
``"mma"``, bf16 tiles of 16 query rows on the tensor cores, for bf16 with at
least 16 queries; ``"simt"``, a warp a query row in f32, for f32 and for the
DiT's one-query temporal attention.  :func:`attention_plan` picks the route
and the block shape from the call's shape and dtype.

:func:`fused_attention` takes ``(B, H, S, Dh)`` tensors.  On CPU tensors it
runs :func:`attention_reference`; on CUDA tensors it launches the kernel or
raises.  Where a gradient is needed it runs as :class:`FusedAttention`,
whose backward is :func:`attention_vjp`: the VJP of the plain math, as the
JAX package's ``custom_vjp`` takes it (no TPU kernel has a backward
kernel).  The kernel reads each input through its strides (only the last
dimension must be contiguous), so the ``(B, S, H, Dh)`` views that
``MultiHeadAttention`` makes are read in place, and it writes its output in
``(B, S, H, Dh)`` memory order, returned as a ``(B, H, S, Dh)`` view: the
caller's move back to ``(B, S, H·Dh)`` is a free reshape, not a copy.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from crowdmod_tpu_torch.ops.kernels import build

# Limits of the kernel (csrc/attention.cu): the head dims it is compiled for,
# the most keys a block holds, and the shared memory a block can have.
HEAD_DIMS = (32, 64)
MAX_KEYS = 256
MAX_SMEM = 232448  # 227 KB
MMA_MIN_QUERIES = 16  # one 16-row query tile; fewer take the SIMT route
_ROUTES = {"simt": 0, "mma": 1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "crowdmod_attention": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    ),
}


@dataclass(frozen=True)
class AttentionPlan:
    """How one attention call is cut into blocks.

    ``route``: ``"mma"`` (bf16 tensor cores, a warp a 16-row query tile) or
    ``"simt"`` (a warp a query row, f32 arithmetic); ``problems_per_block``
    (b, h) problems a block holds; ``warps`` a block; ``keys_padded``: Sk
    rounded up to the route's multiple (16 or 4); ``smem_bytes``: dynamic
    shared memory a block; ``blocks`` of the grid."""

    route: str
    problems_per_block: int
    warps: int
    keys_padded: int
    smem_bytes: int
    blocks: int


def attention_plan(b: int, h: int, sq: int, sk: int, dh: int, dtype) -> AttentionPlan:
    """The block shape of :func:`fused_attention` for ``b·h`` problems of
    ``sq`` queries against ``sk`` keys of width ``dh``.

    bf16 with ``sq ≥ 16``: the mma route, ⌈sq/16⌉ query tiles a problem and
    8 // tiles problems a block, a warp a tile up to 16 warps (the DiT's
    spatial 27 queries: 4 problems on 8 warps; the UNet's 54: 2 on 8); Q (in
    whole tiles), K and V (keys padded to 16) in shared memory as bf16 rows
    of Dh + 8.  Otherwise the SIMT route: 8 warps and 8 // sq problems a
    block, K and V as f32 rows plus a query row and a logit row a warp.
    Either takes fewer problems a block where their keys would overflow
    shared memory, and at least one."""
    mma = dtype == torch.bfloat16 and sq >= MMA_MIN_QUERIES
    if mma:
        tiles = -(-sq // 16)
        keys = -(-sk // 16) * 16
        smem = lambda n: 2 * (dh + 8) * n * (tiles * 16 + 2 * keys)  # noqa: E731
        per_block = max(1, 8 // tiles)
    else:
        keys = -(-sk // 4) * 4
        smem = lambda n: 4 * (n * sk * (2 * dh + 4) + 8 * (dh + keys))  # noqa: E731
        per_block = max(1, 8 // max(sq, 1))
    while per_block > 1 and smem(per_block) > MAX_SMEM:
        per_block -= 1
    warps = min(per_block * tiles, 16) if mma else 8
    return AttentionPlan("mma" if mma else "simt", per_block, warps, keys, smem(per_block),
                         -(-b * h // per_block))


def rows_aligned(ptr: int, strides, elsize: int) -> bool:
    """Whether every (b, h, s) row of a tensor at ``ptr`` with element
    ``strides`` starts on a 16-byte boundary: the kernel's 16-byte copies."""
    return ptr % 16 == 0 and all(s * elsize % 16 == 0 for s in strides)


def check_rows(route: str, rows: dict, elsize: int) -> bool:
    """``rows``: name → (data pointer, (b, h, s) strides).  Whether all of
    them are 16-byte aligned; raises where the ``"mma"`` route needs it."""
    bad = [n for n, (ptr, strides) in rows.items() if not rows_aligned(ptr, strides, elsize)]
    if bad and route == "mma":
        raise ValueError(
            f"fused_attention: rows of {', '.join(bad)} are not 16-byte aligned "
            f"({ {n: rows[n] for n in bad} }); the tensor-core route copies "
            "16-byte pieces"
        )
    return not bad


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


def attention_vjp(q, k, v, g, scale: float):
    """``(dq, dk, dv)`` of :func:`attention_reference` at ``(q, k, v)`` for
    the output cotangent ``g``, in f32 from the recomputed weights
    ``P = softmax(scale·q kᵀ)``: ``dv = Pᵀg``, ``dS = P ⊙ (g vᵀ −
    rowsum(P ⊙ g vᵀ))``, ``dq = scale·dS k``, ``dk = scale·dSᵀq``; each in
    its input's dtype."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FusedAttention(torch.autograd.Function):
    """:func:`fused_attention` with a gradient: the kernel (the twin on the
    CPU) forward, :func:`attention_vjp` backward on either device."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        return (*attention_vjp(*ctx.saved_tensors, g, ctx.scale), None)


def fused_attention(q, k, v, *, scale: float | None = None) -> torch.Tensor:
    """softmax(scale · q kᵀ) v over ``(B, H, S, Dh)``; ``scale`` defaults to
    1/√Dh.  CPU tensors take the plain twin; CUDA tensors the kernel."""
    scale = float(scale if scale is not None else 1.0 / q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FusedAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


def _forward(q, k, v, scale: float) -> torch.Tensor:
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
    plan = attention_plan(b, h, sq, sk, dh, q.dtype)
    if plan.smem_bytes > MAX_SMEM:
        raise ValueError(
            f"fused_attention: {plan.smem_bytes} bytes of shared memory for "
            f"{sq} queries × {sk} keys (route {plan.route}); a block has "
            f"{MAX_SMEM}"
        )
    vec = check_rows(plan.route, {n: (t.data_ptr(), t.stride()[:3])
                                  for n, t in (("q", q), ("k", k), ("v", v))},
                     q.element_size())
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    lib = build.load("attention", _SIGNATURES)
    err = lib.crowdmod_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, h, sq, sk, dh, scale, strides, _ROUTES[plan.route],
        plan.problems_per_block, plan.warps, plan.keys_padded, plan.smem_bytes,
        int(vec), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
