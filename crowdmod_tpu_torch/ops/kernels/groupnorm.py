"""Fused GroupNorm (+SiLU): the Hopper kernel and its plain twin.

Replaces ``crowdmod_tpu/ops/pallas/groupnorm.py`` (``_gn_pallas``, kernel
``_gn_kernel``).  The CUDA source, ``csrc/groupnorm.cu``, notes what bounds
the kernel on the H100 (bytes) and how its two routes answer that:
``"cluster"`` (bf16), a sample held in the shared memory of a thread-block
cluster and read from device memory once; ``"stream"``, a block per
(sample, group) that streams its slice three times, for float32, for
samples no cluster holds and for calls small enough to stay latency-bound.
:func:`group_norm_plan` picks the route, the cluster size and the CTA shape
from the call's shape and dtype; the wrapper passes the plan to the kernel,
which rejects a plan whose shared memory is not its own.

:func:`fused_group_norm` takes channels-last ``(B, ..., C)``.  On CPU
tensors it runs :func:`group_norm_reference`; on CUDA tensors it launches
the kernel or raises.  Where a gradient is needed it runs as
:class:`FusedGroupNorm`, whose backward is :func:`group_norm_vjp`, the
closed-form VJP of the plain math in f32 (the JAX package's ``custom_vjp``
takes the oracle's VJP; no TPU kernel has a backward kernel).  The kernel is
the ``crowdmod::group_norm`` operator (:mod:`.library`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from crowdmod_tpu_torch.ops.kernels import build, library
from crowdmod_tpu_torch.ops.kernels.build import SMS, sm_count

# Limits of the cluster route (csrc/groupnorm.cu): cluster sizes, groups,
# threads a CTA, and a CTA's dynamic shared memory for gamma, beta and its
# run of positions (227 KB less the 3 KB kept for the kernel's static
# reduction scratch).
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_GROUPS = 8
MAX_THREADS = 1024
MAX_CHUNK = 232448 - 3072
STREAM_THREADS = 256  # csrc/common.cuh, kThreads
# The plan's thresholds, set from `chip_smoke.py --gn-plans` on an H100
# (every route and cluster size at every UNet GroupNorm shape and serving
# bucket; PERF.md).  The stream route wins where its three passes stay
# latency-bound: a block's pass reads at most STREAM_BLOCK_BYTES (counting
# each row's group slice as at least one 32-byte sector), the grid is one
# wave of STREAM_BLOCKS_PER_SM blocks a multiprocessor, and the passes read
# at most STREAM_TOTAL_BYTES in all.
STREAM_BLOCK_BYTES = 16 << 10
STREAM_BLOCKS_PER_SM = 4
STREAM_TOTAL_BYTES = 4 << 20
# A sample of at least SPLIT_BYTES is split over more CTAs while the grid
# keeps under one CTA a multiprocessor; a CTA doubles its threads in that
# case when its run gives each thread at least WIDE_VECTORS 16-byte vectors.
SPLIT_BYTES = 32 << 10
WIDE_VECTORS = 16
_ROUTES = {"stream": 0, "cluster": 1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "crowdmod_group_norm": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    ),
}


@dataclass(frozen=True)
class GroupNormPlan:
    """How one GroupNorm call is cut into CTAs.

    ``route``: ``"cluster"`` (k CTAs a sample, each holding ``rows_per_cta``
    positions in ``smem_bytes`` of shared memory) or ``"stream"`` (a block of
    256 threads per (sample, group), no dynamic shared memory);
    ``cluster``: k; ``threads`` a CTA; ``vec``: channels a 16-byte vector
    (cluster route); ``blocks`` of the grid; ``launches`` a call (always 1)."""

    route: str
    cluster: int
    threads: int
    rows_per_cta: int
    smem_bytes: int
    vec: int
    blocks: int
    launches: int = 1


def cluster_plan(batch: int, S: int, C: int, G: int, dtype, k: int,
                 threads: int | None = None) -> GroupNormPlan | None:
    """The cluster route's plan at cluster size ``k``, or None where the
    kernel cannot take it: float32 (which keeps the stream route: its
    free-running sampler chains are held against the twin with that
    kernel's rounding), channels not whole 16-byte vectors, more than 8
    groups, a row wider than a CTA's threads, or a CTA's run of ⌈S/k⌉
    positions past its shared memory.  Threads: by default the least
    multiple of lcm(32, C/vec) from 256 up, so a thread always sees one
    channel window."""
    if dtype != torch.bfloat16:
        return None
    elsize, vec = 2, 8
    if C % vec or G > MAX_GROUPS:
        return None
    step = math.lcm(32, C // vec)
    if threads is None:
        threads = step * -(-256 // step)
    elif threads % step:
        return None
    rows = -(-S // k)
    smem = 8 * C + rows * C * elsize  # gamma and beta, then the run
    if threads > MAX_THREADS or smem > MAX_CHUNK:
        return None
    return GroupNormPlan("cluster", k, threads, rows, smem, vec, batch * k)


def stream_pass_bytes(S: int, C: int, G: int, elsize: int) -> int:
    """Bytes one block of the stream route reads a pass: S rows of its
    group's channels, each at least a 32-byte sector."""
    return S * max(C // G * elsize, 32)


@functools.lru_cache(maxsize=512)
def group_norm_plan(batch: int, S: int, C: int, G: int, dtype,
                    sm_count: int = SMS) -> GroupNormPlan:
    """The plan of :func:`fused_group_norm` over ``(batch, S, C)`` with
    ``G`` groups, from the shape alone.

    The stream route for float32, for samples no cluster holds (past 8 CTAs
    of 224 KB, channels that are not whole 16-byte vectors, more than 8
    groups) and
    for calls small enough that its three passes stay latency-bound (the
    STREAM_* thresholds); the cluster route otherwise, at the least cluster
    size that holds the sample (where the grid has more CTAs than
    multiprocessors, the least whose CTA run fits twice in one), raised for
    a sample of at least SPLIT_BYTES while batch·2k CTAs fit one a
    multiprocessor, at most 8; its threads doubled while batch·k CTAs fit
    one a multiprocessor and each thread keeps WIDE_VECTORS vectors."""
    elsize = torch.empty((), dtype=dtype).element_size()
    stream = GroupNormPlan("stream", 1, STREAM_THREADS, S, 0, 1, batch * G)
    fits = [k for k in CLUSTER_SIZES if cluster_plan(batch, S, C, G, dtype, k)]
    block_bytes = stream_pass_bytes(S, C, G, elsize)
    if not fits or (batch * G <= STREAM_BLOCKS_PER_SM * sm_count
                    and block_bytes <= STREAM_BLOCK_BYTES
                    and batch * G * block_bytes <= STREAM_TOTAL_BYTES):
        return stream
    run = lambda k: -(-S // k) * C * elsize  # noqa: E731
    k = fits[0]
    if batch * k > sm_count:  # more CTAs than multiprocessors: two fit in one
        k = next((k for k in fits if 2 * run(k) <= MAX_CHUNK), fits[-1])
    while (k < CLUSTER_SIZES[-1] and S * C * elsize >= SPLIT_BYTES
           and batch * 2 * k <= sm_count):
        k *= 2
    plan = cluster_plan(batch, S, C, G, dtype, k)
    wide = 2 * plan.threads
    if (batch * k <= sm_count and wide <= MAX_THREADS
            and run(k) >= WIDE_VECTORS * 16 * plan.threads):
        plan = cluster_plan(batch, S, C, G, dtype, k, wide)
    return plan


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
                or t.shape != (c,) or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"fused_group_norm: {name} must be a contiguous, 16-byte aligned "
                f"float32 ({c},) tensor on {x.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )


def launch(x, gamma, beta, out, num_groups: int, eps: float, silu: bool,
           plan: GroupNormPlan) -> None:
    """Run the kernel on x's stream with ``plan`` (checked inputs); raises
    if CUDA refuses the launch."""
    b, c = x.shape[0], x.shape[-1]
    lib = build.load("groupnorm", _SIGNATURES)
    err = lib.crowdmod_group_norm(
        _DTYPE_CODES[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), b, x.numel() // (b * c), c, num_groups, float(eps),
        int(silu), _ROUTES[plan.route], plan.cluster, plan.threads,
        plan.smem_bytes, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"group-norm kernel launch failed: CUDA error {err} ({plan})"
        )


def group_norm_vjp(x, gamma, beta, g, num_groups: int, eps: float, silu: bool):
    """``(dx, dgamma, dbeta)`` of :func:`group_norm_reference` for the
    output cotangent ``g``: the closed form in f32 from the recomputed
    two-pass moments, each gradient in its input's dtype."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xg = x.float().reshape(b, -1, num_groups, cg)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt((xg - mean).square().mean(dim=(1, 3), keepdim=True) + eps)
    xhat = (xg - mean) * rstd
    gamma_g = gamma.float().reshape(num_groups, cg)
    gy = g.float().reshape(xg.shape)
    if silu:
        y = xhat * gamma_g + beta.float().reshape(num_groups, cg)
        s = torch.sigmoid(y)
        gy = gy * s * (1.0 + y * (1.0 - s))
    dgamma = (gy * xhat).sum(dim=(0, 1)).reshape(c)
    dbeta = gy.sum(dim=(0, 1)).reshape(c)
    dxhat = gy * gamma_g
    dx = rstd * (dxhat - dxhat.mean(dim=(1, 3), keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=(1, 3), keepdim=True))
    return dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype)


class FusedGroupNorm(torch.autograd.Function):
    """:func:`fused_group_norm` with a gradient: the kernel (the twin on the
    CPU) forward, :func:`group_norm_vjp` backward on either device."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, silu):
        ctx.save_for_backward(x, gamma, beta)
        ctx.args = (num_groups, eps, silu)
        return _forward(x, gamma, beta, num_groups, eps, silu)

    @staticmethod
    def backward(ctx, g):
        return (*group_norm_vjp(*ctx.saved_tensors, g, *ctx.args), None, None, None)


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
    if torch.is_grad_enabled() and (
            x.requires_grad or gamma.requires_grad or beta.requires_grad):
        return FusedGroupNorm.apply(x, gamma, beta, num_groups, eps, silu)
    return _forward(x, gamma, beta, num_groups, eps, silu)


def _forward(x, gamma, beta, num_groups: int, eps: float, silu: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return group_norm_reference(x, gamma, beta, num_groups, eps, silu)
    return torch.ops.crowdmod.group_norm(x, gamma, beta, num_groups, float(eps), bool(silu))


def _group_norm_cuda(x, gamma, beta, num_groups: int, eps: float, silu: bool):
    """``crowdmod::group_norm`` on CUDA tensors: check, plan, launch."""
    _check(x, gamma, beta)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    b, c = x.shape[0], x.shape[-1]
    plan = group_norm_plan(b, x.numel() // (b * c), c, num_groups, x.dtype,
                           sm_count(x.device))
    launch(x, gamma, beta, out, num_groups, eps, silu, plan)
    fused_group_norm.launches += 1
    return out


library.define(
    "group_norm(Tensor x, Tensor gamma, Tensor beta, int num_groups, float eps, "
    "bool silu) -> Tensor",
    _group_norm_cuda, lambda x, *args: torch.empty_like(x))
fused_group_norm.launches = 0
