"""Fused multi-head attention: the Hopper kernel and its plain twin.

Replaces ``crowdmod_tpu/ops/pallas/attention.py`` (``_attention_pallas``,
kernel ``_attn_kernel``).  The CUDA source, ``csrc/attention.cu``, notes what
bounds the kernel on the H100 (bytes, and up to 64 keys the latency of a
call) and how its five routes answer that.  bf16: ``"row"``, a few keys
(the DiT's temporal attention, one query against two keys): a group of
Dh/8 lanes a query row, every row of Q, K and V one 16-byte load a lane
straight into registers; ``"tile"``, up to 64 keys at head dims 16–64
(the DiT's spatial and the UNet's level-2 attention): persistent CTAs, a
producer warp keeping a ring of Q, K and V stages full by TMA, consumer
warps on 16-row ``mma.sync`` tiles, the output stored by TMA; ``"wgmma"``,
65–448 keys at head dims 32 and 64 (FM-DiT's 216–432 tokens): a CTA a
problem, a warpgroup a 64-row query tile on ``wgmma``, a row's logits in
registers, two warpgroups past 224 keys; ``"mma"``, the other problems
with at least 16 queries past 64 keys while one fits shared memory (Dh
16): 16-row tiles, the keys in blocks of 64 in two sweeps.  f32, Dh 8 and
the bf16 problems none of these takes: ``"simt"``, a warp a query row in
f32, K and V resident in shared memory or, where they do not fit,
streamed through it in blocks of keys.  Any number of keys.
:func:`attention_plan` picks the route and the block shape from the
call's shape and dtype.

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
from crowdmod_tpu_torch.ops.kernels.build import SMS

# Limits of the kernel (csrc/attention.cu): the head dims it is compiled for
# (the tensor-core routes' k-slices are 16 deep: Dh 8 takes the simt route)
# and the shared memory a block, and a multiprocessor, can have.
HEAD_DIMS = (8, 16, 32, 64)
MMA_HEAD_DIMS = (16, 32, 64)
MAX_SMEM = 232448  # 227 KB
SM_SMEM = 233472  # 228 KB a multiprocessor, 1 KB of it reserved for each resident block
MMA_MIN_QUERIES = 16  # one 16-row query tile; fewer take the SIMT route past 64 keys
# The tile route (csrc/attention.cu, kTile*): up to 64 keys and 64 query
# rows a work item (more queries: several items a problem), at most 8
# consumer warps a CTA besides the producer.
TILE_KEYS = 64
TILE_ROWS = 64
TILE_CONSUMERS = 8
# The row route (kRowKeys): up to 8 keys, a group of Dh / 8 lanes a query
# row; it takes problems of up to ROW_MAX_QUERIES queries, fewer lanes
# idle than a 16-row tile's rows (csrc/attention.cu's note).
ROW_KEYS = 8
ROW_MAX_QUERIES = 8
ROW_WARPS = 4
# The streamed SIMT form: keys a block stages at once, query rows a warp
# holds (csrc/attention.cu, kStreamKeys and kStreamRows).
STREAM_KEYS = 128
STREAM_ROWS = 4
WARPS_SIMT = 8
# The wgmma route (csrc/attention.cu, CROWDMOD_WGMMA_TILES): a CTA a
# problem, a warpgroup a 64-row query tile; the built (NK, split): the keys
# a warpgroup's logits hold, and 1 or 2 warpgroups splitting the keys.
WGMMA_QUERY_TILE = 64
WGMMA_KEYS = (128, 160, 192, 224)
WGMMA_TILES = frozenset({(nk, split) for nk in WGMMA_KEYS for split in (1, 2)})
WGMMA_HEAD_DIMS = (32, 64)
WGMMA_MIN_KEYS = 65  # up to 64 keys bf16 at Dh 16-64 takes the tile or the row route
_ROUTES = {"simt": 0, "mma": 1, "wgmma": 2, "tile": 3, "row": 4}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "crowdmod_attention": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)]
        + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    ),
}


@dataclass(frozen=True)
class AttentionPlan:
    """How one attention call is cut into blocks.

    ``route``: ``"row"`` (bf16, a few keys: Dh/8 lanes a query row),
    ``"tile"`` (bf16 up to 64 keys: persistent CTAs on a TMA ring, a warp a
    16-row query tile), ``"wgmma"`` (bf16 past 64 keys: a warpgroup a
    64-row query tile on ``wgmma``, K and V staged by TMA), ``"mma"``
    (bf16 tensor cores past 64 keys, a warp a 16-row query tile) or
    ``"simt"`` (a warp a query row, f32 arithmetic);
    ``problems_per_block`` (b, h) problems a block holds (tile: its teams,
    the problems in flight; row: the query rows a block); ``warps`` a
    block (tile: the producer and teams × tiles consumers);
    ``keys_padded``: Sk rounded up to the route's multiple (16 or 4; row:
    Sk; wgmma: the keys its warpgroups hold, ``key_split`` ×
    ``key_block``); ``query_rows``: the queries of a problem a block covers
    (Sq, but for the streamed SIMT form; tile: a work item's, its Q box);
    ``key_block``: the keys a block holds at once (``keys_padded``, or
    :data:`STREAM_KEYS` when the SIMT route streams them; wgmma: the keys
    one warpgroup's logits hold); ``smem_bytes``: dynamic shared memory a
    block; ``blocks`` of the grid (tile: the persistent CTAs);
    ``query_tile``: the query rows a tile (wgmma 64, mma and tile 16, simt
    and row 1); ``stages``: the tile route's ring (1 elsewhere)."""

    route: str
    problems_per_block: int
    warps: int
    keys_padded: int
    query_rows: int
    key_block: int
    smem_bytes: int
    blocks: int
    query_tile: int = 1
    stages: int = 1

    @property
    def streamed(self) -> bool:
        return self.route == "simt" and self.key_block < self.keys_padded

    @property
    def key_split(self) -> int:
        """Warpgroups that split a problem's keys (wgmma), else 1."""
        return self.keys_padded // self.key_block if self.route == "wgmma" else 1


def wgmma_smem_bytes(dh: int, nk: int, split: int) -> int:
    """Shared memory of a wgmma CTA (csrc/attention.cu ``smem_bytes``,
    route 2): 1024 bytes of alignment, K and V (split·NK keys each), a ring
    of two 64-row query tiles, with two warpgroups the halves of the output
    (f32) they hand each other and their row statistics, and 4 barriers."""
    exchange = 4 * 2 * (dh // 4) * 128 + 4 * 2 * 128 * 4 if split == 2 else 0
    return (1024 + 2 * split * nk * 2 * dh + 2 * 2 * WGMMA_QUERY_TILE * dh + exchange
            + 8 * 4)


def _wgmma_plan(b: int, h: int, sq: int, sk: int, dh: int,
                split: int | None = None) -> AttentionPlan | None:
    """The wgmma plan, or None where it does not apply: one CTA a problem,
    one warpgroup a 64-row query tile up to 224 keys, two splitting the keys
    past that (at most 448; ``split`` forces 1 or 2), each holding the
    logits of NK keys (the least built NK covering its share) in
    registers, so a row's softmax is one pass."""
    if dh not in WGMMA_HEAD_DIMS or sk < WGMMA_MIN_KEYS or sq < MMA_MIN_QUERIES:
        return None
    if split is None:
        split = 1 if sk <= WGMMA_KEYS[-1] else 2
    nk = next((n for n in WGMMA_KEYS if (n, split) in WGMMA_TILES and split * n >= sk), None)
    if nk is None or sk <= (split - 1) * nk:
        return None
    smem = wgmma_smem_bytes(dh, nk, split)
    if smem > MAX_SMEM:
        return None
    return AttentionPlan("wgmma", 1, 4 * split, split * nk, sq, nk, smem, b * h,
                         WGMMA_QUERY_TILE)


def tile_smem_bytes(dh: int, rows: int, keys: int, consumers: int, stages: int) -> int:
    """Shared memory of a tile-route CTA (csrc/attention.cu ``smem_bytes``,
    route 3): 1024 bytes of alignment, ``stages`` of Q (``rows``), K and V
    (``keys`` each), a 16-row staging box of the output a consumer warp,
    and two barriers a stage."""
    return 1024 + 2 * dh * (stages * (rows + 2 * keys) + 16 * consumers) + 16 * stages


def _tile_plan(b: int, h: int, sq: int, sk: int, dh: int, sms: int = SMS, *,
               rows: int | None = None, teams: int | None = None,
               stages: int | None = None, ctas: int | None = None) -> AttentionPlan | None:
    """The tile plan, or None where it does not apply (Dh 8, more than 64
    keys).  A work item: ``rows`` query rows of a problem (Sq up to a
    multiple of 16, at most 64) against all its keys; a team of rows / 16
    consumer warps an item, ``teams`` = 8 // tiles of them a CTA, ``stages``
    = teams, a stage a team (a multiple of ``teams``: each team owns its
    stages, so its waits on their phases are unambiguous, csrc/attention.cu);
    ``ctas`` a multiprocessor (2 where two fit its
    shared memory), the grid at most ``ctas`` × ``sms``.  The keyword
    arguments force a value (``chip_smoke.py``'s alternatives)."""
    if dh not in MMA_HEAD_DIMS or sk > TILE_KEYS:
        return None
    rows = rows or min(-(-sq // 16), TILE_ROWS // 16) * 16
    tiles = rows // 16
    keys = -(-sk // 16) * 16
    teams = teams or max(1, TILE_CONSUMERS // tiles)
    stages = stages or teams
    if stages % teams:
        # A stage two teams share: a team's wait on its parity could pass on
        # another team's phase (csrc/attention.cu, attention_tile_kernel).
        raise ValueError(f"tile plan: {stages} stages for {teams} teams")
    smem = tile_smem_bytes(dh, rows, keys, teams * tiles, stages)
    if ctas is None:
        ctas = 2 if 2 * (smem + 1024) <= SM_SMEM else 1
    items = b * h * -(-sq // rows)
    return AttentionPlan("tile", teams, 1 + teams * tiles, keys, rows, keys, smem,
                         max(1, min(items, ctas * sms)), 16, stages)


def _row_plan(b: int, h: int, sq: int, sk: int, dh: int, *,
              warps: int = ROW_WARPS) -> AttentionPlan | None:
    """The row plan, or None where it does not apply: Dh 16–64, at most
    :data:`ROW_KEYS` keys and :data:`ROW_MAX_QUERIES` queries; a group of
    Dh / 8 lanes a query row, ``warps`` a block."""
    if dh not in MMA_HEAD_DIMS or sk > ROW_KEYS or sq > ROW_MAX_QUERIES:
        return None
    per_block = warps * 32 // (dh // 8)
    return AttentionPlan("row", per_block, warps, sk, sq, sk, 0,
                         max(1, -(-(b * h * sq) // per_block)))


def attention_plan(b: int, h: int, sq: int, sk: int, dh: int, dtype,
                   sms: int = SMS) -> AttentionPlan:
    """The block shape of :func:`fused_attention` for ``b·h`` problems of
    ``sq`` queries against ``sk`` keys of width ``dh`` on a card of ``sms``
    multiprocessors.

    bf16 at Dh 16, 32 or 64: up to :data:`ROW_KEYS` keys and
    :data:`ROW_MAX_QUERIES` queries the row route (:func:`_row_plan`: the
    DiT's temporal attention); up to 64 keys the tile route
    (:func:`_tile_plan`: the DiT's spatial 27 queries, 2 tiles a problem,
    4 problems in flight a CTA; the UNet's 54, 4 tiles, 2 in flight);
    with ``sq ≥ 16`` and 65–448 keys at Dh 32 or 64 (FM-DiT's 216, 336
    and 432 tokens) the wgmma route (:func:`_wgmma_plan`).  Other bf16
    with ``sq ≥ 16``: the mma route, ⌈sq/16⌉ query tiles a problem and
    8 // tiles problems a block, a warp a tile up to 16 warps; Q (in whole
    tiles), K and V (keys padded to 16) in shared memory as bf16 rows of
    Dh + 8; fewer problems a block where they would overflow it, and where
    one problem does, the SIMT route.  Dh 8 has no tensor-core tile: it
    takes the SIMT route.  Otherwise the SIMT route: resident, 8 warps and
    8 // sq problems a block (fewer where their keys would overflow shared
    memory), K and V as f32 rows plus a query row and a logit row a warp;
    or, where one problem's K and V do not fit, streamed: one problem and
    up to 32 query rows a block (4 a warp), K and V through shared memory
    128 keys at a time."""
    tiles = -(-sq // 16)
    keys16 = -(-sk // 16) * 16
    mma_smem = lambda n: 2 * (dh + 8) * n * (tiles * 16 + 2 * keys16)  # noqa: E731
    problems = b * h
    if dtype == torch.bfloat16:
        short = (_wgmma_plan(b, h, sq, sk, dh) or _row_plan(b, h, sq, sk, dh)
                 or _tile_plan(b, h, sq, sk, dh, sms))
        if short is not None:
            return short
    if (dtype == torch.bfloat16 and sq >= MMA_MIN_QUERIES and dh in MMA_HEAD_DIMS
            and mma_smem(1) <= MAX_SMEM):
        per_block = max(1, 8 // tiles)
        while per_block > 1 and mma_smem(per_block) > MAX_SMEM:
            per_block -= 1
        return AttentionPlan("mma", per_block, min(per_block * tiles, 16), keys16, sq,
                             keys16, mma_smem(per_block), -(-problems // per_block), 16)
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
    them are 16-byte aligned; raises where a route other than ``"simt"``
    needs it (TMA's boxes, 16-byte copies and loads)."""
    bad = [n for n, (ptr, strides) in rows.items() if not rows_aligned(ptr, strides, elsize)]
    if bad and route != "simt":
        raise ValueError(
            f"fused_attention: rows of {', '.join(bad)} are not 16-byte aligned "
            f"({ {n: rows[n] for n in bad} }); only the simt route reads "
            "other than 16-byte pieces"
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
    plan = attention_plan(b, h, sq, sk, dh, q.dtype, build.sm_count(q.device))
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
        plan.key_block, plan.smem_bytes, int(vec), plan.stages, plan.blocks,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    fused_attention.launches += 1
    return out


library.define("attention(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
               _attention_cuda, lambda q, k, v, scale: _empty_out(q))
fused_attention.launches = 0
