"""Fused DDPM ancestral update: the Hopper kernel and its plain twin.

Replaces ``crowdmod_tpu/ops/pallas/fused_step.py``
(``fused_ancestral_update``, kernel ``_step_kernel``).  One reverse step is
the elementwise chain

    x' = 1/√α_t · (x − β_t/√(1−ᾱ_t) · ε̂) + √β_t · z
    x' = x' − λ·√β_t·sign(x')          [Sparsity guidance, ρ channel only]

run in one pass by ``csrc/fused_step.cu``, whose note says what bounds it on
the H100 (bytes) and how its design answers that: 16-byte vectors, one wave
of blocks, a scalar head and tail; :func:`ancestral_update_plan` cuts the
call from its size and the four pointers' alignment.  The noise ``z`` is an
input, so the kernel and the twin agree bit for bit on the same draws.  The
three per-step scalars (1/√α_t, β_t/√(1−ᾱ_t), √β_t) come as a float32
``(3,)`` tensor on the card, which the kernel reads, as the TPU kernel takes
them in SMEM: a sampler uploads its whole table once, and a step inside a
traced loop needs no host float.  float32 only: ε̂ comes out of the DiT's
f32 final layer and the sampler state stays f32.  The kernel is the
``crowdmod::ancestral_update`` operator (:mod:`.library`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from crowdmod_tpu_torch.ops.kernels import build, library
from crowdmod_tpu_torch.ops.kernels.build import SMS, sm_count

THREADS = 256
BLOCKS_PER_SM = 2048 // THREADS  # resident blocks a multiprocessor: one wave
_SIGNATURES = {
    "crowdmod_ancestral_update": (
        ctypes.c_int,
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_float, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    ),
}


@dataclass(frozen=True)
class StepPlan:
    """How one ancestral step over ``n`` elements is cut.

    ``vec``: 4 (float4 vectors) or 1 (every element scalar, when the four
    pointers do not share one offset modulo 16); ``head`` scalar elements
    before the first 16-byte boundary, then ``vectors`` float4 vectors,
    then ``tail`` scalar elements; ``blocks`` of ``threads`` (one wave at
    most, grid-stride beyond it); ``index64`` when n ≥ 2³¹."""

    vec: int
    head: int
    vectors: int
    tail: int
    threads: int
    blocks: int
    index64: bool


def ancestral_update_plan(n: int, channels: int, sm_count: int = SMS,
                          pointers=(0, 0, 0, 0)) -> StepPlan:
    """The plan of :func:`fused_ancestral_update` for ``n`` elements of
    ``channels`` channels, from the byte addresses of x, ε̂, z and the
    output (``pointers``).  Raises on an address that is not 4-byte
    aligned: the kernel reads whole floats."""
    if channels < 1:
        raise ValueError(f"ancestral_update_plan: {channels} channels")
    bad = [p for p in pointers if p % 4]
    if bad:
        raise ValueError(
            f"fused_ancestral_update: addresses {bad} are not 4-byte aligned; "
            "the kernel reads whole float32 elements"
        )
    if len({p % 16 for p in pointers}) == 1:
        head = min(n, (16 - pointers[0] % 16) % 16 // 4)
        vectors = (n - head) // 4
        vec = 4
    else:
        head, vectors, vec = n, 0, 1
    work = max(vectors, n - 4 * vectors)  # a thread a vector, then a scalar
    blocks = max(1, min(-(-work // THREADS), BLOCKS_PER_SM * sm_count))
    return StepPlan(vec, head, vectors, n - head - 4 * vectors, THREADS, blocks,
                    n >= 2**31)


def ancestral_update_reference(
    x, eps, z, *, inv_sqrt_alpha, beta_over_somab, sigma,
    lambda_guidance=0.0, sparsity=False, rho_channel=0,
):
    """Plain twin of the fused step, over any shape whose last dim is C.
    The three coefficients are floats or float32 scalar tensors (a row of
    a sampler's table); with tensors, λ·σ is a float32 product, as in the
    kernel."""
    out = inv_sqrt_alpha * (x - beta_over_somab * eps) + sigma * z
    if sparsity:
        guid = torch.zeros_like(out)
        guid[..., rho_channel] = torch.sign(out[..., rho_channel])
        out = out - lambda_guidance * sigma * guid
    return out


def step_coefficients(inv_sqrt_alpha, beta_over_somab, sigma, device) -> torch.Tensor:
    """The float32 ``(…, 3)`` coefficient tensor :func:`fused_ancestral_update`
    takes, on ``device``, from floats or arrays of them."""
    rows = np.stack(np.broadcast_arrays(inv_sqrt_alpha, beta_over_somab, sigma), -1)
    return torch.from_numpy(rows.astype(np.float32)).to(device)


def fused_ancestral_update(
    x: torch.Tensor,
    eps: torch.Tensor,
    z: torch.Tensor,
    coeffs: torch.Tensor,
    *,
    lambda_guidance: float = 0.0,
    sparsity: bool = False,
    rho_channel: int = 0,
) -> torch.Tensor:
    """One fused reverse step over ``(B, F, H, W, C)`` (any shape, really),
    with ``coeffs`` = (1/√α_t, β_t/√(1−ᾱ_t), √β_t), a float32 ``(3,)``
    tensor on x's device.  CPU tensors take the plain twin; CUDA tensors
    the kernel."""
    if x.device.type == "cpu":
        return ancestral_update_reference(
            x, eps, z, inv_sqrt_alpha=coeffs[0], beta_over_somab=coeffs[1],
            sigma=coeffs[2], lambda_guidance=lambda_guidance, sparsity=sparsity,
            rho_channel=rho_channel,
        )
    return torch.ops.crowdmod.ancestral_update(
        x, eps, z, coeffs, float(lambda_guidance), bool(sparsity), int(rho_channel))


def _step_cuda(x, eps, z, coeffs, lambda_guidance, sparsity, rho_channel):
    """``crowdmod::ancestral_update`` on CUDA tensors: check, plan, launch."""
    for name, t in (("x", x), ("eps", eps), ("z", z), ("coeffs", coeffs)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(
                f"fused_ancestral_update: {name} is on {t.device}, x on "
                f"{x.device}; all four must be on one CUDA device"
            )
        if t.dtype != torch.float32:
            raise ValueError(
                f"fused_ancestral_update: {name} has dtype {t.dtype}; the "
                "kernel takes float32"
            )
        if name != "coeffs" and (t.shape != x.shape or not t.is_contiguous()):
            raise ValueError(
                f"fused_ancestral_update: {name} must be contiguous with "
                f"x's shape {tuple(x.shape)}, got {tuple(t.shape)}"
            )
    if coeffs.shape != (3,) or not coeffs.is_contiguous():
        raise ValueError(
            "fused_ancestral_update: coeffs must be a contiguous (3,) tensor, "
            f"got {tuple(coeffs.shape)} with strides {coeffs.stride()}"
        )
    channels = x.shape[-1] if x.dim() else 1
    if not 0 <= rho_channel < channels:
        raise ValueError(
            f"fused_ancestral_update: rho_channel {rho_channel} outside "
            f"{channels} channels"
        )
    n = x.numel()
    # The output shares x's offset modulo 16, so both take the vector path.
    phase = x.data_ptr() % 16 // 4
    out = torch.empty(n + phase, dtype=x.dtype, device=x.device)[phase:].view(x.shape)
    if n == 0:
        return out
    plan = ancestral_update_plan(
        n, channels, sm_count(x.device),
        (x.data_ptr(), eps.data_ptr(), z.data_ptr(), out.data_ptr()))
    lib = build.load("fused_step", _SIGNATURES)
    err = lib.crowdmod_ancestral_update(
        x.data_ptr(), eps.data_ptr(), z.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
        n, channels, rho_channel, float(lambda_guidance), int(sparsity), plan.head,
        plan.vectors, plan.blocks, plan.threads, int(plan.index64),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"ancestral-update kernel launch failed: CUDA error {err}"
        )
    fused_ancestral_update.launches += 1
    return out


library.define(
    "ancestral_update(Tensor x, Tensor eps, Tensor z, Tensor coeffs, "
    "float lambda_guidance, bool sparsity, int rho_channel) -> Tensor",
    _step_cuda, lambda x, eps, z, coeffs, *args: torch.empty_like(x))
fused_ancestral_update.launches = 0
