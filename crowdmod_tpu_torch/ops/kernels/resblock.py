"""Fused UNet ResnetBlock3D forward: the Hopper kernel and its plain twin.

Replaces ``crowdmod_tpu/ops/pallas/resblock.py`` (``_fused_pallas``, kernel
``_resblock_kernel``).  The CUDA source, ``csrc/resblock.cu``, notes what
bounds it on the H100 and how its design answers that: in bf16 five
launches a call (GN1's moments as chunk partials in one pass; GN1+SiLU
once into ``a1``; conv1 on the halo-box ``wgmma`` kernel, h1 stored in bf16
with per-tile GN2 partial sums; GN2+SiLU over h1; conv2 with the skip
folded in as extra K), in f32 four on the CUDA cores (GN2's moments in two
passes over h1).  Every sum runs in a fixed order, so a call's output is
the same bits every run.  :func:`resblock_plan` sizes the tiles and the
scratch; the wrapper allocates the scratch.

The weight dict is the JAX package's contract (``resblock.py:62-94``), as
torch tensors: ``gn1_scale``/``gn1_bias (Cin,)``, ``w1 (3,3,3,Cin,Cout)``,
``b1``, ``gn2_scale``/``gn2_bias (Cout,)``, ``w2 (3,3,3,Cout,Cout)``,
``b2`` and, when Cin ≠ Cout, ``w_skip (1,1,1,Cin,Cout)`` + ``b_skip``.
:func:`pack_resblock` lays it out for the kernel once; a caller that holds
the weights passes the packed form as ``packed=`` so no call repacks.

:func:`fused_resblock` runs :func:`resblock_reference` on CPU tensors and
the kernel on CUDA tensors, or raises; it never falls back to the twin.
Where autograd needs a graph (an input that requires grad while grad is
enabled) it runs as :class:`FusedResblock`, the JAX package's
``custom_vjp``: the kernel forward, and backward the VJP of
:func:`resblock_reference` recomputed from the saved inputs (plain
PyTorch ops on either device).  The kernel is the ``crowdmod::resblock``
operator (:mod:`.library`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from crowdmod_tpu_torch.ops.kernels import build, library
from crowdmod_tpu_torch.ops.kernels.build import SMS, sm_count
from crowdmod_tpu_torch.ops.kernels.conv3d import (
    conv3d_same_reference,
    pack_im2col,
)
from crowdmod_tpu_torch.ops.kernels.groupnorm import group_norm_reference

# Limits of the kernel (csrc/resblock.cu): the f32 tiles' 128 output
# positions may span two samples, never more (a bf16 tile lies in one), and
# GN2's partials hold 32 groups.
MIN_VOLUME = 128
MAX_GROUPS = 32
SIMT_BM, SIMT_BK = 128, 16  # csrc/common.cuh, kBM and kBK: the f32 loops' tile
SMEM_LIMIT = 232448  # dynamic shared memory a block may use
MAX_STAGES = 4  # csrc/resblock.cu kMaxStages
ATOM_COLS = 32  # output channels of a weight atom (64-byte swizzled rows)
HALO_REGISTERS = 224  # 65,536 / 288 threads, in steps of 8: a halo block's registers a thread
MAX_WIDTH = 254  # bf16: a halo box row is W + 2 positions, a TMA box dimension 256 at most
MAX_CHANNELS = 1024  # bf16: csrc/resblock.cu kMaxChannels, a GN pass's staged channels
MOMENT_ROWS = 1024  # csrc/resblock.cu kMomentRows: positions a GN1 partial sums (bf16)
# The bf16 conv blocks csrc/resblock.cu is built with (CROWDMOD_RES_TILES):
# (mt, na, kc) — 128·mt GEMM rows (two warpgroups of mt 64-row tiles), 32·na
# output channels, chunks of kc input channels.
HALO_BLOCKS = frozenset(
    {(mt, 1, kc) for mt in (1, 2) for kc in (16, 32, 64)} | {(4, 1, 16), (4, 1, 32)}
    | {(mt, 2, kc) for mt in (1, 2) for kc in (16, 32, 64)})
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The packed tensors, in the operator's order.
PACKED = ("w1", "w2", "b1", "gamma1", "beta1", "gamma2", "beta2", "bias2")
_SIGNATURES = {
    "crowdmod_resblock": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
        + [ctypes.c_float] + [ctypes.c_int] * 4
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
    ),
    "crowdmod_resblock_smem_bytes": (ctypes.c_int, [ctypes.c_int] * 8),
}


@dataclass(frozen=True)
class ResblockPlan:
    """How one fused-resblock call is cut, and the scratch it needs.

    f32: ``bm`` × ``bn`` blocks of the CUDA-core loop, K in chunks of
    ``bk`` (16); ``m_tiles`` × ``n_tiles`` blocks a conv.  bf16: the
    halo-box conv block of ``bm`` = 128·MT GEMM rows (two warpgroups of MT
    64-row tiles) × ``bn`` = 32·NA output channels (``bk`` 0); ``tile``:
    the (t slices, h rows) of one sample a work item computes, all of W;
    ``box``: its halo box (tile + 2, W + 2); ``kc``, ``stages``, ``nbox``,
    ``smem_bytes``: conv1's and conv2's channel chunk, weight stages and
    boxes in flight, and dynamic shared memory; ``m_tiles`` × ``n_tiles``
    work items a conv (a persistent block a multiprocessor walks them).
    ``launches`` a call (bf16 5, f32 4).  Scratch: ``a1_elems`` bf16 for
    GN1+SiLU of x (bf16 only), ``h1_elems`` in x's dtype for conv1's
    output, ``workspace_floats`` f32: in f32 GN1's and GN2's (mean, rstd),
    (B, G, 2) each; in bf16 GN1's partials, (B, chunks of
    :data:`MOMENT_ROWS` positions, 1, G, 2), then GN2's, (B, tiles a
    sample, n_tiles, G, 2).  ``registers``: the registers a consumer
    thread's arrays take (accumulators, two sets of A fragments, row
    offsets), at most :data:`HALO_REGISTERS`; 0 for f32."""

    bm: int
    bn: int
    bk: int
    m_tiles: int
    n_tiles: int
    launches: int
    a1_elems: int
    h1_elems: int
    workspace_floats: int
    tile: tuple = (0, 0)
    box: tuple = (0, 0, 0)
    kc: tuple = (0, 0)
    stages: tuple = (0, 0)
    nbox: tuple = (0, 0)
    smem_bytes: tuple = (0, 0)
    registers: int = 0

    @property
    def halo(self) -> tuple:
        """The bf16 plan's 8 ints in the C interface's order: tb, hb, then
        (kc, stages, nbox) of conv1 and of conv2."""
        return (*self.tile, self.kc[0], self.stages[0], self.nbox[0],
                self.kc[1], self.stages[1], self.nbox[1])


def halo_smem_bytes(conv1: bool, na: int, kc: int, box_positions: int, stages: int,
                    nbox: int) -> int:
    """Dynamic shared memory of a bf16 conv block (csrc/resblock.cu
    ``res_smem_bytes``): ``nbox`` halo boxes of kc channels (each rounded
    up to 1024 bytes), ``stages`` weight stages of na 32-column atoms × kc
    rows × 64 bytes, conv1's column sums (8 warps × 32·na columns × 2
    moments, f32), 12 barriers and 1024 bytes of alignment."""
    box = -(-box_positions * kc * 2 // 1024) * 1024
    main = nbox * box + stages * na * kc * 64 + (8 * na * ATOM_COLS * 2 * 4 if conv1 else 0)
    return 1024 + main + 8 * (4 + 2 * MAX_STAGES)


def halo_registers(mt: int, na: int, kc: int) -> int:
    """Registers of a consumer thread's arrays: mt × na m64n32 accumulators
    (16 f32 each), two sets of A fragments (mt × kc/16 × 4), 2·mt row
    offsets."""
    return mt * na * 16 + 2 * mt * (kc // 16) * 4 + 2 * mt


def _res_kc(mt: int, na: int, *channels: int) -> int:
    """The chunk: the widest of 64, 32, 16 that divides every conv input's
    channels (conv2: Cout and the skip's Cin) and is built for the block;
    16 where none divides (a last chunk partly past the channels, zero)."""
    return next((kc for kc in (64, 32, 16) if (mt, na, kc) in HALO_BLOCKS
                 and all(c % kc == 0 for c in channels if c)), 16)


def _res_tile(t: int, h: int, w: int, bm: int):
    """The (t, h) tile of whole rows of one sample that computes the fewest
    GEMM rows in all (bm a tile, pad columns included), then loads the
    fewest halo positions; → (tile, box positions, tiles a sample)."""
    pw = w + 2
    best = None
    for tb in range(1, t + 1):
        for hb in range(1, h + 1):
            if tb * hb * pw > bm:
                break
            tiles = -(-t // tb) * -(-h // hb)
            npos = (tb + 2) * (hb + 2) * pw
            key = (tiles * bm, tiles * npos)
            if best is None or key < best[0]:
                best = (key, (tb, hb), npos, tiles)
    return None if best is None else best[1:]


def halo_resblock_plan(batch: int, t: int, h: int, w: int, cin: int, cout: int,
                       sms: int = SMS, mt: int | None = None):
    """The bf16 blocks of both convs: 32·na output channels (na 1 for
    Cout ≤ 32, else 2, channel tiles past 64); the largest of 4, 2, 1
    64-row tiles a warpgroup whose work items still fill 90% of ``sms``
    (else 1) — ``mt`` forces one; :func:`_res_tile`'s tile; each conv's
    chunk (:func:`_res_kc`), two boxes where its input takes several chunks
    and they fit, then as many weight stages as fit (at most 4).
    → (bm, bn, tile, box, kc, stages, nbox, smem, tiles a sample, n_tiles,
    registers)."""
    na = 1 if cout <= ATOM_COLS else 2
    n_tiles = -(-cout // (ATOM_COLS * na))
    best = None
    for m in ((mt,) if mt is not None else (4, 2, 1)):
        if not any(b[:2] == (m, na) for b in HALO_BLOCKS):
            continue
        found = _res_tile(t, h, w, 128 * m)
        if found is None:
            continue
        best = (m, *found)
        if mt is not None or batch * found[2] * n_tiles >= 0.9 * sms:
            break
    if best is None:
        raise ValueError(f"fused_resblock: no bf16 tile of a {t}×{h}×{w} volume fits a block")
    m, tile, npos, tiles = best
    convs = []
    for conv1, inputs in ((True, (cin,)), (False, (cout, cin if cin != cout else 0))):
        kc = _res_kc(m, na, *inputs)
        chunks = sum(-(-c // kc) for c in inputs if c)
        nbox, stages = next(
            ((nb, st) for nb in ((2, 1) if chunks > 1 else (1,)) for st in (4, 3, 2)
             if halo_smem_bytes(conv1, na, kc, npos, st, nb) <= SMEM_LIMIT), (0, 0))
        if not nbox:
            raise ValueError(f"fused_resblock: a {tile} tile's box does not fit a block")
        convs.append((kc, stages, nbox, halo_smem_bytes(conv1, na, kc, npos, stages, nbox)))
    (k1, s1, n1, m1), (k2, s2, n2, m2) = convs
    regs = max(halo_registers(m, na, k1), halo_registers(m, na, k2))
    return (128 * m, ATOM_COLS * na, tile, (tile[0] + 2, tile[1] + 2, w + 2), (k1, k2),
            (s1, s2), (n1, n2), (m1, m2), tiles, n_tiles, regs)


def resblock_plan(batch: int, t: int, h: int, w: int, cin: int, cout: int,
                  groups: int, dtype, sms: int = SMS, mt: int | None = None) -> ResblockPlan:
    """The tiles and scratch of :func:`fused_resblock` at one shape.

    bf16: the halo blocks of :func:`halo_resblock_plan` (``mt`` forces the
    64-row tiles a warpgroup).  f32: 128-row tiles of the CUDA-core loop,
    64 channels wide where that still makes two waves on 132 SMs, else 32
    or 16."""
    positions = batch * t * h * w
    if dtype == torch.bfloat16:
        (bm, bn, tile, box, kc, stages, nbox, smem, tiles, n_tiles,
         regs) = halo_resblock_plan(batch, t, h, w, cin, cout, sms, mt)
        m_tiles = batch * tiles
        gn1 = 2 * batch * groups * -(-(t * h * w) // MOMENT_ROWS)
        return ResblockPlan(bm, bn, 0, m_tiles, n_tiles, 5, positions * cin, positions * cout,
                            gn1 + m_tiles * n_tiles * 2 * groups,
                            tile, box, kc, stages, nbox, smem, regs)
    wide = -(-positions // SIMT_BM) * -(-cout // 64) >= 2 * sms
    bn = 64 if cout >= 64 and wide else 32 if cout >= 32 else 16
    m_tiles, n_tiles = -(-positions // SIMT_BM), -(-cout // bn)
    return ResblockPlan(SIMT_BM, bn, SIMT_BK, m_tiles, n_tiles, 4, 0, positions * cout,
                        2 * batch * groups + 2 * batch * groups)


def smem_bytes(plan: ResblockPlan, w: int) -> tuple:
    """Dynamic shared memory of a bf16 plan's two conv blocks for an input
    of width ``w``, as the built library computes it
    (``crowdmod_resblock_smem_bytes``)."""
    lib = build.load("resblock", _SIGNATURES)
    return tuple(lib.crowdmod_resblock_smem_bytes(
        int(conv1), w, plan.bn // ATOM_COLS, plan.kc[i], *plan.tile, plan.stages[i],
        plan.nbox[i]) for i, conv1 in enumerate((True, False)))


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
    if x.dtype == torch.bfloat16 and (cin % 8 or cout % 8 or x.data_ptr() % 16):
        raise ValueError(
            f"fused_resblock: bf16 takes 16-byte channel rows: channels {cin} → "
            f"{cout} must be multiples of 8 and x 16-byte aligned"
        )
    if x.dtype == torch.bfloat16 and (w > MAX_WIDTH or max(cin, cout) > MAX_CHANNELS):
        raise ValueError(
            f"fused_resblock: bf16 takes widths up to {MAX_WIDTH} (a halo box row "
            f"of W + 2 positions) and up to {MAX_CHANNELS} channels, got width {w}, "
            f"channels {cin} → {cout}"
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


class FusedResblock(torch.autograd.Function):
    """:func:`fused_resblock` with a gradient: the kernel (the twin on the
    CPU) forward from the packed weights; backward the VJP of
    :func:`resblock_reference` recomputed from the saved ``(x, temb_proj,
    w)``, as the JAX package's ``_fused_bwd``, so each weight of the block
    (the skip's too) gets its gradient, never the pack."""

    @staticmethod
    def forward(ctx, x, temb_proj, keys, num_groups, eps, packed, *weights):
        ctx.save_for_backward(x, temb_proj, *weights)
        ctx.args = (keys, num_groups, eps)
        return _forward(x, temb_proj, dict(zip(keys, weights)), num_groups, eps, packed)

    @staticmethod
    def backward(ctx, g):
        keys, num_groups, eps = ctx.args
        wanted = ctx.needs_input_grad[:2] + ctx.needs_input_grad[6:]
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, wanted)]
        with torch.enable_grad():
            out = resblock_reference(inputs[0], inputs[1], dict(zip(keys, inputs[2:])),
                                     num_groups=num_groups, eps=eps)
        leaves = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, leaves, g))
        dx, dtemb, *dw = (next(grads) if need else None for need in wanted)
        return (dx, dtemb, None, None, None, None, *dw)


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, temb_proj, *w.values())):
        return FusedResblock.apply(x, temb_proj, tuple(w), num_groups, eps, packed,
                                   *w.values())
    return _forward(x, temb_proj, w, num_groups, eps, packed)


def _forward(x, temb_proj, w, num_groups: int, eps: float, packed) -> torch.Tensor:
    if x.device.type == "cpu":
        return resblock_reference(x, temb_proj, w, num_groups=num_groups, eps=eps)
    p = packed if packed is not None else pack_resblock(w, x.dtype)
    return torch.ops.crowdmod.resblock(
        x, temb_proj, *(p[k] for k in PACKED), p["has_skip"], num_groups, float(eps))


def _resblock_cuda(x, temb_proj, w1, w2, b1, gamma1, beta1, gamma2, beta2, bias2,
                   has_skip, num_groups, eps):
    """``crowdmod::resblock`` on CUDA tensors: check, plan, launch."""
    p = dict(zip(PACKED, (w1, w2, b1, gamma1, beta1, gamma2, beta2, bias2)),
             has_skip=has_skip, cin=w1.shape[0] // 27, cout=w1.shape[1])
    _check(x, temb_proj, p, num_groups)
    b, t, h, wd, cin = x.shape
    cout = p["cout"]
    out = torch.empty((b, t, h, wd, cout), dtype=x.dtype, device=x.device)
    if b == 0:
        return out
    plan = resblock_plan(b, t, h, wd, cin, cout, num_groups, x.dtype, sm_count(x.device))
    bf16 = x.dtype == torch.bfloat16
    # f32: b1 + temb_proj here; bf16: temb_proj as the twin casts it, b1
    # added in conv1's epilogue (the same f32 sum).
    tvec = (temb_proj.to(torch.bfloat16) if bf16 else temb_proj.float() + p["b1"]).contiguous()
    # Scratch, freed on return: the allocator orders its reuse on the stream.
    empty = lambda n, dt: torch.empty(n, dtype=dt, device=x.device)  # noqa: E731
    a1 = empty(plan.a1_elems, torch.bfloat16) if plan.a1_elems else None
    h1 = empty(plan.h1_elems, x.dtype)
    ws = empty(plan.workspace_floats, torch.float32)
    lib = build.load("resblock", _SIGNATURES)
    err = lib.crowdmod_resblock(
        _DTYPE_CODES[x.dtype], x.data_ptr(), tvec.data_ptr(),
        p["b1"].data_ptr() if bf16 else None, p["w1"].data_ptr(), p["w2"].data_ptr(),
        p["gamma1"].data_ptr(),
        p["beta1"].data_ptr(), p["gamma2"].data_ptr(), p["beta2"].data_ptr(),
        p["bias2"].data_ptr(), None if a1 is None else a1.data_ptr(), h1.data_ptr(),
        ws.data_ptr(), out.data_ptr(), b, t, h, wd, cin, cout, num_groups, float(eps),
        int(p["has_skip"]), plan.bm, plan.bn, plan.bk,
        (ctypes.c_int * 8)(*plan.halo) if bf16 else None,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"resblock kernel launch failed: CUDA error {err}")
    fused_resblock.launches += 1
    return out


library.define(
    "resblock(Tensor x, Tensor temb_proj, Tensor w1, Tensor w2, Tensor b1, "
    "Tensor gamma1, Tensor beta1, Tensor gamma2, Tensor beta2, Tensor bias2, "
    "bool has_skip, int num_groups, float eps) -> Tensor",
    _resblock_cuda, lambda x, temb_proj, w1, *args: x.new_empty((*x.shape[:-1], w1.shape[1])))
fused_resblock.launches = 0
