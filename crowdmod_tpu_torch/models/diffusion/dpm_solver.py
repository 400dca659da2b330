"""DPM-Solver++(2M): the second-order multistep ODE sampler (port of the JAX
package's ``models/diffusion/dpm_solver.py``).

VP parameterization: alpha_t = sqrt(alpha_bar), sigma_t = sqrt(1-alpha_bar),
lambda_t = log(alpha_t / sigma_t).  Update (2M, data prediction):

    x_i = (sigma_i / sigma_{i-1}) * x_{i-1}
          - alpha_i * expm1(-h_i) * [ (1 + 1/(2 r_i)) x0_i - x0_{i-1}/(2 r_i) ]

with h_i = lambda_i - lambda_{i-1}, r_i = h_{i-1} / h_i; the first step is
first order (DDIM with eta = 0 in data space).  ``steps`` denoiser forwards
a sample; the coefficients are float32 scalars computed on the host.

Randomness: the only draw is x_T, ``noise(None)`` (see
:mod:`crowdmod_tpu_torch.models.diffusion.ddpm`).
"""

from __future__ import annotations

import numpy as np
import torch

from crowdmod_tpu_torch.core.schedule import DiffusionSchedule
from crowdmod_tpu_torch.models.diffusion.ddpm import (
    DenoiseFn,
    Noise,
    _finish,
    _noise_and_device,
    _t_vec,
)

_f32 = np.float32


# How XLA:CPU evaluates the JAX package's ``jnp.linspace(T-1, 0, n)`` over
# its first n-1 points (jaxlib 0.9.0 on x86-64 with AVX2 and FMA, at XLA's
# default 256-bit preferred vector width, fast math off): ``start·(1 − b·r)``
# with ``r = float32(1/(n-1))``, the product and the difference each
# rounded, except in the vector loop it runs once there are at least
# _FMA_MIN_POINTS points, over whole blocks of _FMA_LANES floats, where
# ``1 − b·r`` is one fused multiply-add.  The two forms differ only at exact
# .5 ties, and there the JAX integers are those of that compiler: another
# vector width or fast math moves some of them, and the TPU's XLA was not
# checked.  (Fitted to, and held against, the JAX package's ladders for
# every step count at T = 50 and T = 1000 under those conditions.)
_FMA_MIN_POINTS = 352
_FMA_LANES = 16


def dpm_timesteps(timesteps: int, steps: int) -> np.ndarray:
    """Uniform discrete timestep ladder T-1 → 0 with ``steps+1`` points, as
    int32: the JAX package's ``jnp.linspace(T-1, 0, steps+1).round()``,
    half to even.  A point that is an exact tie in exact arithmetic (e.g.
    499.5 at T = 1000, 20 steps) lands on the side XLA:CPU's float32
    evaluation puts it (see _FMA_MIN_POINTS for which build and host), so
    this is that evaluation, not a float64 linspace."""
    b = np.arange(steps)
    r = _f32(1.0) / _f32(steps)
    plain = _f32(1.0) - b.astype(_f32) * r
    # b·r is exact in float64, so this rounds 1 − b·r once, as an FMA does.
    fused = (1.0 - b.astype(np.float64) * np.float64(r)).astype(_f32)
    cut = steps - steps % _FMA_LANES if steps >= _FMA_MIN_POINTS else 0
    points = _f32(timesteps - 1) * np.where(b < cut, fused, plain)
    return np.rint(np.append(points, _f32(0.0))).astype(np.int32)


def check_dpm_steps(sched: DiffusionSchedule, steps: int) -> None:
    """Refuse a step count the ladder cannot take: with more solver steps
    than discrete timesteps the rounded ladder repeats a timestep, h becomes
    0 and r = h_prev/h divides by zero."""
    if not 2 <= steps <= sched.timesteps - 1:
        raise ValueError(
            f"DPM_STEPS must be in [2, TIMESTEPS-1] = "
            f"[2, {sched.timesteps - 1}]; got {steps}"
        )


def dpm_solver_sample(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    past: torch.Tensor | None,
    sample_shape: tuple[int, ...],
    *,
    steps: int = 20,
    noise: Noise | None = None,
    generator: torch.Generator | None = None,
    device=None,
    history: bool = False,
):
    """Sample with DPM-Solver++(2M) in ``steps`` model evaluations.

    ``history=True`` also returns the ``(steps+1, B, ...)`` trajectory: x_T,
    the first-order step's state, then each later state."""
    check_dpm_steps(sched, steps)
    noise, device = _noise_and_device(noise, generator, sample_shape, past, device)
    b = sample_shape[0]
    ts = [int(t) for t in dpm_timesteps(sched.timesteps, steps)]  # descending
    alpha = sched.sqrt_alpha_bar
    sigma = sched.sqrt_one_minus_alpha_bar
    lam = np.log(alpha) - np.log(sigma)

    def x0_of(x, t):
        eps = denoise_fn(x, _t_vec(t, b, device), past)
        return (x - float(sigma[t]) * eps) / float(alpha[t])

    x = noise(None)
    traj = [x] if history else None
    # First step, first order: x ← (σ1/σ0)·x − α1·expm1(−h)·x0.
    t0, t1 = ts[0], ts[1]
    x0_prev = x0_of(x, t0)
    h0 = lam[t1] - lam[t0]
    x = float(sigma[t1] / sigma[t0]) * x - float(alpha[t1] * np.expm1(-h0)) * x0_prev
    if history:
        traj.append(x)
    t_prev2 = t0
    for idx in range(1, steps):
        t, t_im1 = ts[idx + 1], ts[idx]  # target and current timesteps
        h = lam[t] - lam[t_im1]
        r = (lam[t_im1] - lam[t_prev2]) / h
        x0 = x0_of(x, t_im1)
        c = _f32(1.0) / (_f32(2.0) * r)
        d = float(_f32(1.0) + c) * x0 - float(c) * x0_prev
        x = float(sigma[t] / sigma[t_im1]) * x - float(alpha[t] * np.expm1(-h)) * d
        x0_prev, t_prev2 = x0, t_im1
        if history:
            traj.append(x)
    return _finish(x, traj, history)
