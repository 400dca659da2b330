"""Fused UNet ResnetBlock3D forward: the Hopper kernel and its plain twin.

Replaces ``crowdmod_tpu/ops/pallas/resblock.py`` (``_fused_pallas``, kernel
``_resblock_kernel``).  The CUDA source, ``csrc/resblock.cu``, notes what
bounds it on the H100 and how its design answers that: in bf16 five
launches a call (GN1 moments; GN1+SiLU once into ``a1``; conv1 on the tensor
cores, h1 stored in bf16 with per-tile GN2 partial sums; GN2+SiLU over h1;
conv2 with the skip folded in), in f32 four on the CUDA cores (GN2's
moments in two passes over h1).  Every sum runs in a fixed order, so a
call's output is the same bits every run.  :func:`resblock_plan` sizes the tiles
and the scratch; the wrapper allocates the scratch.

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
from crowdmod_tpu_torch.ops.kernels.conv3d import (
    conv3d_same_reference,
    pack_im2col,
)
from crowdmod_tpu_torch.ops.kernels.groupnorm import group_norm_reference

# Limits of the kernel (csrc/resblock.cu): a tile's 128 output positions
# may span two samples, never more, and GN2's partials hold 32 groups.
MIN_VOLUME = 128
MAX_GROUPS = 32
SIMT_BM, SIMT_BK = 128, 16  # csrc/common.cuh, kBM and kBK: the f32 loops' tile
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The packed tensors, in the operator's order.
PACKED = ("w1", "w2", "b1", "gamma1", "beta1", "gamma2", "beta2", "bias2")
_SIGNATURES = {
    "crowdmod_resblock": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
        + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    ),
}


@dataclass(frozen=True)
class ResblockPlan:
    """How one fused-resblock call is cut, and the scratch it needs.

    ``bm`` × ``bn``: a conv block's output positions × channels, K in
    chunks of ``bk`` (bf16: 32 channels of one tap on the tensor cores;
    f32: the CUDA-core loop's 16); ``m_tiles`` × ``n_tiles`` blocks a conv;
    ``launches`` a call (bf16 5, f32 4).  Scratch: ``a1_elems`` bf16 for
    GN1+SiLU of x (bf16 only), ``h1_elems`` in x's dtype for conv1's output,
    ``workspace_floats`` f32: GN1's (mean, rstd), (B, G, 2), then in f32
    GN2's, the same shape, and in bf16 the GN2 partials, (m_tiles, n_tiles,
    2 sample slots, G, 2)."""

    bm: int
    bn: int
    bk: int
    m_tiles: int
    n_tiles: int
    launches: int
    a1_elems: int
    h1_elems: int
    workspace_floats: int


def resblock_plan(batch: int, t: int, h: int, w: int, cin: int, cout: int,
                  groups: int, dtype) -> ResblockPlan:
    """The tiles and scratch of :func:`fused_resblock` at one shape.

    bf16: 128 × 32 tiles of 32-deep K chunks (the mma tile ``ResTile``).  f32: 128-row tiles of the CUDA-core loop,
    64 channels wide where that still makes two waves on 132 SMs, else 32
    or 16."""
    positions = batch * t * h * w
    if dtype == torch.bfloat16:
        bm, bn, bk, launches, a1 = 128, 32, 32, 5, positions * cin
    else:
        wide = -(-positions // SIMT_BM) * -(-cout // 64) >= 2 * 132
        bn = 64 if cout >= 64 and wide else 32 if cout >= 32 else 16
        bm, bk, launches, a1 = SIMT_BM, SIMT_BK, 4, 0
    m_tiles, n_tiles = -(-positions // bm), -(-cout // bn)
    gn2 = m_tiles * n_tiles * 4 * groups if a1 else 2 * batch * groups
    return ResblockPlan(bm, bn, bk, m_tiles, n_tiles, launches, a1, positions * cout,
                        2 * batch * groups + gn2)


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
    plan = resblock_plan(b, t, h, wd, cin, cout, num_groups, x.dtype)
    tvec = (temb_proj.float() + p["b1"]).contiguous()
    # Scratch, freed on return: the allocator orders its reuse on the stream.
    empty = lambda n, dt: torch.empty(n, dtype=dt, device=x.device)  # noqa: E731
    a1 = empty(plan.a1_elems, torch.bfloat16) if plan.a1_elems else None
    h1 = empty(plan.h1_elems, x.dtype)
    ws = empty(plan.workspace_floats, torch.float32)
    lib = build.load("resblock", _SIGNATURES)
    err = lib.crowdmod_resblock(
        _DTYPE_CODES[x.dtype], x.data_ptr(), tvec.data_ptr(),
        p["w1"].data_ptr(), p["w2"].data_ptr(), p["gamma1"].data_ptr(),
        p["beta1"].data_ptr(), p["gamma2"].data_ptr(), p["beta2"].data_ptr(),
        p["bias2"].data_ptr(), None if a1 is None else a1.data_ptr(), h1.data_ptr(),
        ws.data_ptr(), out.data_ptr(), b, t, h, wd, cin, cout, num_groups, float(eps),
        int(p["has_skip"]), plan.bm, plan.bn, plan.bk,
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
