"""Fused multi-head attention: the Hopper kernel and its plain twin.

Replaces ``crowdmod_tpu/ops/pallas/attention.py`` (``_attention_pallas``,
kernel ``_attn_kernel``).  The CUDA source, ``csrc/attention.cu``, notes what
bounds the kernel on the H100 (bytes) and how its two routes answer that:
``"mma"``, bf16 tiles of 16 query rows on the tensor cores, for bf16 with at
least 16 queries while a problem's Q, K and V fit in shared memory;
``"simt"``, a warp a query row in f32, for f32, for the DiT's one-query
temporal attention and for bf16 problems too large for the mma route, with
K and V resident in shared memory or, where they do not fit, streamed
through it in blocks of keys.  Any number of keys.  :func:`attention_plan`
picks the route and the block shape from the call's shape and dtype.

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
The kernel is the ``crowdmod::attention`` operator (:mod:`.library`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from crowdmod_tpu_torch.ops.kernels import build, library

# Limits of the kernel (csrc/attention.cu): the head dims it is compiled for
# (the mma route's k-slices are 16 deep: Dh 8 takes the simt route) and the
# shared memory a block can have.
HEAD_DIMS = (8, 16, 32, 64)
MMA_HEAD_DIMS = (16, 32, 64)
MAX_SMEM = 232448  # 227 KB
MMA_MIN_QUERIES = 16  # one 16-row query tile; fewer take the SIMT route
# The streamed SIMT form: keys a block stages at once, query rows a warp
# holds (csrc/attention.cu, kStreamKeys and kStreamRows).
STREAM_KEYS = 128
STREAM_ROWS = 4
WARPS_SIMT = 8
_ROUTES = {"simt": 0, "mma": 1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "crowdmod_attention": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    ),
}


@dataclass(frozen=True)
class AttentionPlan:
    """How one attention call is cut into blocks.

    ``route``: ``"mma"`` (bf16 tensor cores, a warp a 16-row query tile) or
    ``"simt"`` (a warp a query row, f32 arithmetic); ``problems_per_block``
    (b, h) problems a block holds; ``warps`` a block; ``keys_padded``: Sk
    rounded up to the route's multiple (16 or 4); ``query_rows``: the
    queries of a problem a block covers (Sq, but for the streamed SIMT
    form); ``key_block``: the keys a block holds in shared memory at once
    (``keys_padded``, or :data:`STREAM_KEYS` when the SIMT route streams
    them); ``smem_bytes``: dynamic shared memory a block; ``blocks`` of the
    grid."""

    route: str
    problems_per_block: int
    warps: int
    keys_padded: int
    query_rows: int
    key_block: int
    smem_bytes: int
    blocks: int

    @property
    def streamed(self) -> bool:
        return self.key_block < self.keys_padded


def attention_plan(b: int, h: int, sq: int, sk: int, dh: int, dtype) -> AttentionPlan:
    """The block shape of :func:`fused_attention` for ``b·h`` problems of
    ``sq`` queries against ``sk`` keys of width ``dh``.

    bf16 with ``sq ≥ 16``: the mma route, ⌈sq/16⌉ query tiles a problem and
    8 // tiles problems a block, a warp a tile up to 16 warps (the DiT's
    spatial 27 queries: 4 problems on 8 warps; the UNet's 54: 2 on 8;
    FM-DiT's 216: 1 on 14); Q (in whole tiles), K and V (keys padded to 16)
    in shared memory as bf16 rows of Dh + 8; fewer problems a block where
    they would overflow it, and where one problem does, the SIMT route.
    Dh 8 has no mma tile: it takes the SIMT route.
    Otherwise the SIMT route: resident, 8 warps and 8 // sq problems a
    block (fewer where their keys would overflow shared memory), K and V as
    f32 rows plus a query row and a logit row a warp; or, where one
    problem's K and V do not fit, streamed: one problem and up to 32 query
    rows a block (4 a warp), K and V through shared memory 128 keys at a
    time."""
    tiles = -(-sq // 16)
    keys16 = -(-sk // 16) * 16
    mma_smem = lambda n: 2 * (dh + 8) * n * (tiles * 16 + 2 * keys16)  # noqa: E731
    problems = b * h
    if (dtype == torch.bfloat16 and sq >= MMA_MIN_QUERIES and dh in MMA_HEAD_DIMS
            and mma_smem(1) <= MAX_SMEM):
        per_block = max(1, 8 // tiles)
        while per_block > 1 and mma_smem(per_block) > MAX_SMEM:
            per_block -= 1
        return AttentionPlan("mma", per_block, min(per_block * tiles, 16), keys16, sq,
                             keys16, mma_smem(per_block), -(-problems // per_block))
    keys = -(-sk // 4) * 4
    smem = lambda n: 4 * (n * sk * (2 * dh + 4) + WARPS_SIMT * (dh + keys))  # noqa: E731
    if smem(1) <= MAX_SMEM:
        per_block = max(1, 8 // max(sq, 1))
        while per_block > 1 and smem(per_block) > MAX_SMEM:
            per_block -= 1
        return AttentionPlan("simt", per_block, WARPS_SIMT, keys, sq, keys, smem(per_block),
                             -(-problems // per_block))
    rows = WARPS_SIMT * min(STREAM_ROWS, -(-sq // WARPS_SIMT))
    streamed_smem = 4 * (STREAM_KEYS * (2 * dh + 4)
                         + WARPS_SIMT * (rows // WARPS_SIMT * dh + STREAM_KEYS))
    return AttentionPlan("simt", 1, WARPS_SIMT, keys, rows, STREAM_KEYS, streamed_smem,
                         problems * -(-sq // rows))


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
    if k.shape[2] < 1:
        raise ValueError("fused_attention: no keys; the kernel takes at least one")


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
    return torch.ops.crowdmod.attention(q, k, v, scale)


def _empty_out(q) -> torch.Tensor:
    """The ``(B, H, Sq, Dh)`` output, laid out ``(B, Sq, H, Dh)`` in
    memory."""
    b, h, sq, dh = q.shape
    return q.new_empty_strided((b, h, sq, dh), (sq * h * dh, dh, h * dh, 1))


def _attention_cuda(q, k, v, scale: float) -> torch.Tensor:
    """``crowdmod::attention`` on CUDA tensors: check, plan, launch."""
    _check(q, k, v)
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    out = _empty_out(q)
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
        plan.problems_per_block, plan.warps, plan.keys_padded, plan.query_rows,
        plan.key_block, plan.smem_bytes, int(vec),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    fused_attention.launches += 1
    return out


library.define("attention(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
               _attention_cuda, lambda q, k, v, scale: _empty_out(q))
fused_attention.launches = 0
