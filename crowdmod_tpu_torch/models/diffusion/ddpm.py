"""DDPM loss and reverse samplers (port of the JAX package's
``models/diffusion/ddpm.py``: ``ddpm_loss``, ``as_eps_fn``,
``prediction_target`` and the ``ddpm``/``ddim``/``ddim_eta`` samplers).

Each sampler is a Python loop over timesteps calling ``denoise_fn``, any
callable ``(x, t_vec, past) -> eps_hat`` on native-layout ``(B, F, H, W, C)``
tensors.  The per-step coefficients are read from the host copy of the
schedule as floats, so a step never waits on the device.

Randomness: :func:`ddpm_loss` takes its timesteps and noise, or draws
them from an explicit generator.  A sampler takes ``noise``, a callable
``noise(t)`` that returns x_T for ``t=None`` and the step-``t`` Gaussian
draw otherwise, with the sample's shape.  By default the draws come from ``torch.randn`` with the
given ``generator`` on the sample's device; tests inject the JAX package's
exact draws instead.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from crowdmod_tpu_torch.core.schedule import DiffusionSchedule, q_sample
from crowdmod_tpu_torch.models.guidance import (
    mass_preservation_gradient,
    sparsity_gradient,
)
from crowdmod_tpu_torch.ops.kernels import fused_ancestral_update, step_coefficients

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, "torch.Tensor | None"], torch.Tensor]
Noise = Callable[["int | None"], torch.Tensor]

GUIDANCE_MODES = ("None", "Sparsity", "mass_preservation")

PRED_TYPES = ("eps", "v", "x0")

_f32 = np.float32


def gaussian_noise(
    shape: tuple[int, ...], device, generator: torch.Generator | None = None
) -> Noise:
    """Standard-normal draws of ``shape`` from ``generator`` on ``device``."""

    def draw(t: int | None) -> torch.Tensor:
        return torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        )

    return draw


def _ab_coeffs(sched: DiffusionSchedule, t: torch.Tensor, ndim: int):
    """``(sqrt_abar_t, sqrt_1m_abar_t)`` gathered on t's device and
    broadcast over ``ndim`` dims."""
    buf = sched.on(t.device)
    sab = buf["sqrt_alpha_bar"][t]
    somab = buf["sqrt_one_minus_alpha_bar"][t]
    shape = sab.shape + (1,) * (ndim - sab.ndim)
    return sab.reshape(shape), somab.reshape(shape)


def prediction_target(
    sched: DiffusionSchedule,
    pred_type: str,
    x0: torch.Tensor,
    eps: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """Training target for the chosen model parameterization: ``eps``,
    ``v = sqrt(abar)*eps - sqrt(1-abar)*x0`` or ``x0``."""
    if pred_type == "eps":
        return eps
    sab, somab = _ab_coeffs(sched, t, x0.ndim)
    if pred_type == "v":
        return sab * eps - somab * x0
    if pred_type == "x0":
        return x0
    raise ValueError(f"unknown PRED_TYPE {pred_type!r}; expected {PRED_TYPES}")


def ddpm_loss(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    future: torch.Tensor,
    past: torch.Tensor | None,
    *,
    t: torch.Tensor | None = None,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    pred_type: str = "eps",
) -> torch.Tensor:
    """Simple-DDPM MSE loss: uniform t, q-sample the future, predict the
    ``pred_type`` target.  ``t`` ``(B,)`` and ``eps`` are drawn from
    ``generator`` on the future's device (t first) unless given."""
    if t is None:
        if generator is None:
            raise ValueError("ddpm_loss needs t or an explicit generator")
        t = torch.randint(0, sched.timesteps, (future.shape[0],),
                          generator=generator, device=future.device)
    noisy, eps = q_sample(sched, future, t, eps, generator=generator)
    pred = denoise_fn(noisy, t, past)
    target = prediction_target(sched, pred_type, future, eps, t)
    return torch.mean(torch.square(pred - target))


def as_eps_fn(fn: DenoiseFn, sched: DiffusionSchedule, pred_type: str) -> DenoiseFn:
    """Adapt a ``pred_type``-parameterized model to the eps-space contract
    every sampler consumes: eps = sab*v + somab*x_t, or
    eps = (x_t - sab*x0_hat) / somab."""
    if pred_type == "eps":
        return fn
    if pred_type not in PRED_TYPES:
        raise ValueError(
            f"unknown PRED_TYPE {pred_type!r}; expected {PRED_TYPES}"
        )

    def eps_fn(x, t, past):
        out = fn(x, t, past)
        sab, somab = _ab_coeffs(sched, t, x.ndim)
        if pred_type == "v":
            return sab * out + somab * x
        return (x - sab * out) / somab  # x0

    return eps_fn


def _t_vec(t: int, b: int, device) -> torch.Tensor:
    return torch.full((b,), t, dtype=torch.int64, device=device)


def _noise_and_device(noise, generator, sample_shape, past, device):
    if device is None:
        if past is None:
            raise ValueError("pass device= when sampling without a past")
        device = past.device
    if noise is None:
        noise = gaussian_noise(sample_shape, device, generator)
    return noise, torch.device(device)


def _finish(x, traj, history):
    return (x, torch.stack(traj)) if history else x


def ancestral_coefficients(sched: DiffusionSchedule, device) -> torch.Tensor:
    """The ``(T, 3)`` float32 table of the fused step's coefficients on
    ``device``: row t is (1/√α_t, β_t/√(1−ᾱ_t), √β_t), from the host
    schedule's float32 arithmetic."""
    beta = sched.beta
    return step_coefficients(sched.one_by_sqrt_alpha,
                             beta / sched.sqrt_one_minus_alpha_bar, np.sqrt(beta), device)


def ddpm_sample(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    past: torch.Tensor | None,
    sample_shape: tuple[int, ...],
    *,
    noise: Noise | None = None,
    generator: torch.Generator | None = None,
    device=None,
    guidance: str = "None",
    lambda_guidance: float = 0.0,
    history: bool = False,
):
    """Ancestral DDPM sampling over all timesteps, T-1 down to 0.

    ``history=True`` also returns the ``(T+1, B, F, H, W, C)`` trajectory:
    the initial x_T followed by each denoised state.  With guidance None or
    Sparsity each step is one fused kernel launch; mass-preservation takes
    the composite path (it needs autograd).
    """
    if guidance not in GUIDANCE_MODES and guidance is not None:
        raise ValueError(f"unknown guidance {guidance!r}; expected {GUIDANCE_MODES}")
    noise, device = _noise_and_device(noise, generator, sample_shape, past, device)
    x = noise(None)
    traj = [x] if history else None
    b = sample_shape[0]
    table = ancestral_coefficients(sched, device)  # one upload a chain
    for t in range(sched.timesteps - 1, -1, -1):
        eps = denoise_fn(x, _t_vec(t, b, device), past)
        z = noise(t) if t > 0 else torch.zeros_like(x)
        beta = sched.beta[t]
        if guidance in ("None", None, "Sparsity"):
            x = fused_ancestral_update(
                x, eps, z, table[t], lambda_guidance=lambda_guidance,
                sparsity=(guidance == "Sparsity"),
            )
        else:  # mass_preservation
            x = float(sched.one_by_sqrt_alpha[t]) * (
                x - float(beta / sched.sqrt_one_minus_alpha_bar[t]) * eps
            ) + float(np.sqrt(beta)) * z
            # Reference call site: delta_t = delta_l = 1; strength 1 - alpha_t.
            alpha_t = _f32(1.0) - beta
            grad = mass_preservation_gradient(x, 1.0, 1.0)
            x = x - float(_f32(1.0) - alpha_t) * grad
        if history:
            traj.append(x)
    return _finish(x, traj, history)


def ddim_update(x, eps, z, c, guidance: str = "None"):
    """One DDIM-form transition of both DDIM samplers, with ``c`` = (√(1−ᾱ),
    √ᾱ of the current level, √ᾱ of the next, the direction coefficient, σ,
    the guidance strength), floats or float32 scalar tensors (a row of an
    exported chain's table):

        x' = c₂·(x − c₀·ε̂)/c₁ + c₃·ε̂ + c₄·z − c₅·∇guidance(x')

    ``z`` None adds no noise (the last step, σ = 0)."""
    pred_x0 = (x - c[0] * eps) / c[1]
    x = c[2] * pred_x0 + c[3] * eps
    if z is not None:
        x = x + c[4] * z
    if guidance == "Sparsity":
        x = x - c[5] * sparsity_gradient(x)
    elif guidance == "mass_preservation":
        x = x - c[5] * mass_preservation_gradient(x, 1.0, 1.0)
    return x


def ddim_coefficients(sched: DiffusionSchedule, taus: np.ndarray, sigma: float,
                      lambda_guidance: float) -> list[tuple[int, tuple]]:
    """The reference DDIM recurrence's steps, ``(t, c)`` for each tau from
    the last (see :func:`ddim_update`): the "current" coefficients start at
    t = T-1 and each step takes the previous step's tau's, with the
    constant ``sigma``."""
    last = sched.timesteps - 1
    beta_c = sched.beta[last]
    sab_c = sched.sqrt_alpha_bar[last]
    somab_c = sched.sqrt_one_minus_alpha_bar[last]
    sigma32 = _f32(sigma)
    steps = []
    for t in np.asarray(taus)[::-1]:
        t = int(t)
        sab_p = sched.sqrt_alpha_bar[t]
        direction = np.sqrt(_f32(1.0) - sab_p**2 - _f32(sigma**2))
        guide = _f32(lambda_guidance) * np.sqrt(beta_c)
        steps.append((t, (somab_c, sab_c, sab_p, direction, sigma32, guide)))
        beta_c, sab_c, somab_c = sched.beta[t], sab_p, sched.sqrt_one_minus_alpha_bar[t]
    return steps


def ddim_sample(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    past: torch.Tensor | None,
    sample_shape: tuple[int, ...],
    taus: np.ndarray,
    *,
    noise: Noise | None = None,
    generator: torch.Generator | None = None,
    device=None,
    sigma: float = 0.001,
    guidance: str = "None",
    lambda_guidance: float = 0.0,
    history: bool = False,
):
    """DDIM sampling with the reference's exact recurrence
    (:func:`ddim_coefficients`), with a constant sigma noise term.  Only
    Sparsity guidance participates, as in the reference."""
    check_ddim_guidance(guidance)
    noise, device = _noise_and_device(noise, generator, sample_shape, past, device)
    x = noise(None)
    traj = [x] if history else None
    b = sample_shape[0]
    for t, c in ddim_coefficients(sched, taus, sigma, lambda_guidance):
        eps = denoise_fn(x, _t_vec(t, b, device), past)
        x = ddim_update(x, eps, noise(t), [float(v) for v in c], guidance)
        if history:
            traj.append(x)
    return _finish(x, traj, history)


def check_ddim_guidance(guidance) -> None:
    """The reference DDIM's guidance modes: Sparsity or None."""
    if guidance == "mass_preservation":
        raise ValueError(
            "the DDIM path supports Sparsity/None guidance only "
            "(the reference's DDIM applies no mass guidance)"
        )
    if guidance not in ("None", "Sparsity"):
        raise ValueError(
            f"unknown guidance {guidance!r}; expected ('None', 'Sparsity')"
        )


def ddim_eta_sample(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    past: torch.Tensor | None,
    sample_shape: tuple[int, ...],
    taus: np.ndarray,
    *,
    noise: Noise | None = None,
    generator: torch.Generator | None = None,
    device=None,
    eta: float = 1.0,
    guidance: str = "None",
    lambda_guidance: float = 0.0,
    history: bool = False,
):
    """Textbook DDIM (Song et al. Eq. 12) with current-level coefficients
    and the full per-transition variance

        sigma_i = eta * sqrt((1-abar_prev)/(1-abar_t)) * sqrt(1-abar_t/abar_prev)

    ``eta == 1`` is the respaced ancestral sampler, ``eta == 0`` the
    deterministic probability-flow DDIM.  ``taus`` is an ascending subset of
    [0, T-1]; sampling starts from N(0, I) at ``taus[-1]`` and the last step
    maps ``taus[0]`` to the clean x0 prediction.
    """
    if guidance not in GUIDANCE_MODES and guidance is not None:
        raise ValueError(
            f"unknown guidance {guidance!r}; expected {GUIDANCE_MODES}"
        )
    noise, device = _noise_and_device(noise, generator, sample_shape, past, device)
    x = noise(None)
    traj = [x] if history else None
    ts = [int(t) for t in np.asarray(taus)[::-1]]
    for t, tp in zip(ts, ts[1:] + [-1]):
        x = ddim_eta_step(denoise_fn, sched, past, x, t, tp, noise=noise, eta=eta,
                          guidance=guidance, lambda_guidance=lambda_guidance)
        if history:
            traj.append(x)
    return _finish(x, traj, history)


def ddim_eta_coefficients(sched: DiffusionSchedule, t: int, tp: int, eta: float,
                          lambda_guidance: float, guidance: str = "None") -> tuple:
    """The coefficients (see :func:`ddim_update`) of one transition of
    :func:`ddim_eta_sample`, from level ``t`` to ``tp`` (−1: the clean x0
    prediction, σ = 0), in the host schedule's float32 arithmetic."""
    one, zero = _f32(1.0), _f32(0.0)
    ab_t = sched.alpha_bar[t]
    ab_p = sched.alpha_bar[tp] if tp >= 0 else one
    sigma = (
        _f32(eta) * np.sqrt(np.maximum((one - ab_p) / (one - ab_t), zero))
        * np.sqrt(np.maximum(one - ab_t / ab_p, zero))
    )
    direction = np.sqrt(np.maximum(one - ab_p - sigma**2, zero))
    guide = (one - ab_t / ab_p if guidance == "mass_preservation"
             else _f32(lambda_guidance) * np.sqrt(sched.beta[t]))
    return (np.sqrt(one - ab_t), np.sqrt(ab_t), np.sqrt(ab_p), direction, sigma, guide)


def ddim_eta_step(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    past: torch.Tensor | None,
    x: torch.Tensor,
    t: int,
    tp: int,
    *,
    noise: Noise,
    eta: float = 1.0,
    guidance: str = "None",
    lambda_guidance: float = 0.0,
) -> torch.Tensor:
    """One transition of :func:`ddim_eta_sample`, from ``x`` at level ``t``
    to level ``tp`` (−1: the clean x0 prediction, with no noise drawn)."""
    c = ddim_eta_coefficients(sched, t, tp, eta, lambda_guidance, guidance)
    eps = denoise_fn(x, _t_vec(t, x.shape[0], x.device), past)
    z = noise(t) if tp >= 0 else None
    return ddim_update(x, eps, z, [float(v) for v in c], guidance)
