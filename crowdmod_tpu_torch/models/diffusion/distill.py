"""Progressive distillation for few-step DDPM sampling (port of the JAX
package's ``models/diffusion/distill.py``).

A student is trained to reproduce, in one deterministic DDIM step, what its
teacher does in two (Salimans & Ho, 2022); the distilled model samples
natively in ``n_steps`` steps on the grid :func:`distill_grid`.

  * A distillation step is two teacher forwards (no gradient) and one
    student forward and backward.
  * The loss is in x0 space with truncated-SNR weighting ``max(SNR, 1)``.
  * Grids nest exactly: ``distill_grid(T, n)`` is every other point of
    ``distill_grid(T, 2n)``, so a phase's student is queried only at
    timesteps its teacher was trained on.

Randomness: :func:`distill_loss` takes each example's student step ``k``
and the q-sample noise, or draws them from an explicit generator;
:func:`distilled_sample` takes ``noise`` (x_T for ``None``, the step at
``t_hi``'s Gaussian draw otherwise; see
:mod:`crowdmod_tpu_torch.models.diffusion.ddpm`).
"""

from __future__ import annotations

import numpy as np
import torch

from crowdmod_tpu_torch.core.schedule import DiffusionSchedule, q_sample
from crowdmod_tpu_torch.models.diffusion.ddpm import (
    DenoiseFn,
    Noise,
    _finish,
    _noise_and_device,
    _t_vec,
)

__all__ = [
    "distill_grid",
    "ddim_det_step",
    "distill_targets",
    "distill_loss",
    "distilled_sample",
]

_f32 = np.float32


def distill_grid(timesteps: int, n_steps: int) -> np.ndarray:
    """``(n_steps+1,)`` int32 timestep grid for an ``n_steps`` sampler.

    ``grid[0] == -1`` denotes clean data (alpha_bar == 1 by convention) and
    ``grid[n_steps] == timesteps - 1`` the terminal noise level; student
    step ``k`` jumps ``grid[k] -> grid[k-1]``.  The points are
    ``round(-1 + T·(k/n))`` in float32, half to even, as the JAX function
    computes them: ``k/n`` and ``2k/2n`` are the same float32 division, so
    ``distill_grid(T, n)[k] == distill_grid(T, 2n)[2k]`` exactly.
    """
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if n_steps > timesteps:
        raise ValueError(
            f"n_steps ({n_steps}) exceeds schedule timesteps ({timesteps}); "
            "the grid would repeat timesteps"
        )
    frac = np.arange(n_steps + 1, dtype=_f32) / _f32(n_steps)
    return np.rint(_f32(-1.0) + _f32(timesteps) * frac).astype(np.int32)


def _coeffs(sched: DiffusionSchedule, t, ndim: int, device=None):
    """``(sqrt_abar, sqrt_1m_abar)`` at ``t``; ``t == -1`` means clean data:
    ``(1, 0)``.  An int ``t`` gives host floats; a ``(B,)`` tensor gives
    tensors on its device broadcast over ``ndim`` dims."""
    if not torch.is_tensor(t):
        t = int(t)
        if t < 0:
            return 1.0, 0.0
        return float(sched.sqrt_alpha_bar[t]), float(sched.sqrt_one_minus_alpha_bar[t])
    buf = sched.on(t.device)
    tc = t.clamp(min=0)
    valid = t >= 0
    sab = torch.where(valid, buf["sqrt_alpha_bar"][tc], 1.0)
    somab = torch.where(valid, buf["sqrt_one_minus_alpha_bar"][tc], 0.0)
    shape = sab.shape + (1,) * (ndim - sab.ndim)
    return sab.reshape(shape), somab.reshape(shape)


def ddim_det_step(
    sched: DiffusionSchedule,
    x: torch.Tensor,
    eps: torch.Tensor,
    t_from,
    t_to,
) -> torch.Tensor:
    """Deterministic (eta = 0) DDIM jump ``x_{t_from} -> x_{t_to}``: x0 from
    the eps prediction at ``t_from``, re-noised analytically to ``t_to``
    (which may be -1, clean data).  ``t_from``/``t_to`` are ints or ``(B,)``
    tensors."""
    sab_f, somab_f = _coeffs(sched, t_from, x.ndim)
    sab_t, somab_t = _coeffs(sched, t_to, x.ndim)
    x0 = (x - somab_f * eps) / sab_f
    return sab_t * x0 + somab_t * eps


def distill_targets(
    teacher_fn: DenoiseFn,
    sched: DiffusionSchedule,
    x_t: torch.Tensor,
    t_hi: torch.Tensor,
    t_mid: torch.Tensor,
    t_lo: torch.Tensor,
    past: torch.Tensor | None,
):
    """The teacher's two deterministic DDIM half-steps, solved back into the
    single-step ``(x0_target, eps_target)`` the student must predict: the
    unique pair with ``x_t = sab_hi·x0 + somab_hi·eps`` and ``x_lo =
    sab_lo·x0 + somab_lo·eps``, so one student DDIM step from ``x_t`` with
    ``eps_target`` lands on ``x_lo``.  ``t_*`` are ``(B,)`` tensors.
    Returns ``(x0_target, eps_target, x_lo)``, detached; the teacher runs
    under ``no_grad``."""
    with torch.no_grad():
        eps1 = teacher_fn(x_t, t_hi, past)
        x_mid = ddim_det_step(sched, x_t, eps1, t_hi, t_mid)
        eps2 = teacher_fn(x_mid, t_mid, past)
        x_lo = ddim_det_step(sched, x_mid, eps2, t_mid, t_lo)

        sab_hi, somab_hi = _coeffs(sched, t_hi, x_t.ndim)
        sab_lo, somab_lo = _coeffs(sched, t_lo, x_t.ndim)
        # Strictly nonzero: t_lo < t_hi makes somab_lo·sab_hi < somab_hi·sab_lo.
        denom = somab_lo * sab_hi - somab_hi * sab_lo
        eps_tgt = (x_lo * sab_hi - x_t * sab_lo) / denom
        x0_tgt = (x_t - somab_hi * eps_tgt) / sab_hi
    return x0_tgt.detach(), eps_tgt.detach(), x_lo.detach()


def distill_loss(
    student_fn: DenoiseFn,
    teacher_fn: DenoiseFn,
    sched: DiffusionSchedule,
    n_steps: int,
    future: torch.Tensor,
    past: torch.Tensor | None,
    *,
    k: torch.Tensor | None = None,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """One progressive-distillation loss of an ``n_steps`` student against
    a ``2·n_steps`` teacher.

    Per example: a student step ``k ~ U{1..n}``, the data q-sampled to
    ``t_hi = grid2[2k]`` with noise ``eps``, the teacher run through the
    midpoint ``grid2[2k-1]`` down to ``grid2[2k-2]``, and the student's
    implied x0 regressed onto the solved single-step target with weight
    ``max(alpha_bar/(1-alpha_bar), 1)``.  ``k`` ``(B,)`` and ``eps`` are
    drawn from ``generator`` on the future's device (k first) unless
    given."""
    device = future.device
    if k is None:
        if generator is None:
            raise ValueError("distill_loss needs k or an explicit generator")
        k = torch.randint(1, n_steps + 1, (future.shape[0],), generator=generator,
                          device=device)
    grid2 = torch.from_numpy(distill_grid(sched.timesteps, 2 * n_steps)).long().to(device)
    k = k.to(device).long()
    t_hi, t_mid, t_lo = grid2[2 * k], grid2[2 * k - 1], grid2[2 * k - 2]

    x_t, _ = q_sample(sched, future, t_hi, eps, generator=generator)
    x0_tgt, _, _ = distill_targets(teacher_fn, sched, x_t, t_hi, t_mid, t_lo, past)

    eps_s = student_fn(x_t, t_hi, past)
    sab, somab = _coeffs(sched, t_hi, future.ndim)
    x0_s = (x_t - somab * eps_s) / sab
    w = torch.clamp(torch.square(sab / somab), min=1.0)
    return torch.mean(w * torch.square(x0_s - x0_tgt))


def distilled_sample(
    denoise_fn: DenoiseFn,
    sched: DiffusionSchedule,
    past: torch.Tensor | None,
    sample_shape: tuple[int, ...],
    n_steps: int,
    *,
    eta: float = 0.0,
    noise: Noise | None = None,
    generator: torch.Generator | None = None,
    device=None,
    history: bool = False,
):
    """Few-step sampler of a distilled student over the ``n_steps`` grid of
    :func:`distill_grid`, from N(0, I) at ``grid[n] = T-1``.

    ``eta == 0`` takes the :func:`ddim_det_step` the distillation targets
    were built from.  ``eta > 0`` adds the grid's respaced posterior noise
    each step (Song et al. Eq. 12's sigma, as ``ddim_eta_sample``), the draw
    ``noise(t_hi)``; the last step, to clean data, draws none.
    ``history=True`` also returns the ``(n_steps+1, B, ...)`` trajectory."""
    noise, device = _noise_and_device(noise, generator, sample_shape, past, device)
    grid = [int(t) for t in distill_grid(sched.timesteps, n_steps)]
    b = sample_shape[0]
    one, zero = _f32(1.0), _f32(0.0)
    x = noise(None)
    traj = [x] if history else None
    for k in range(n_steps, 0, -1):
        t_hi, t_lo = grid[k], grid[k - 1]
        eps = denoise_fn(x, _t_vec(t_hi, b, device), past)
        if eta == 0.0:
            x = ddim_det_step(sched, x, eps, t_hi, t_lo)
        else:
            ab_hi = sched.alpha_bar[t_hi]
            ab_lo = sched.alpha_bar[t_lo] if t_lo >= 0 else one
            sigma = (
                _f32(eta) * np.sqrt(np.maximum((one - ab_lo) / (one - ab_hi), zero))
                * np.sqrt(np.maximum(one - ab_hi / ab_lo, zero))
            )
            pred_x0 = (x - float(np.sqrt(one - ab_hi)) * eps) / float(np.sqrt(ab_hi))
            direction = float(np.sqrt(np.maximum(one - ab_lo - sigma**2, zero))) * eps
            x = float(np.sqrt(ab_lo)) * pred_x0 + direction
            if t_lo >= 0:
                x = x + float(sigma) * noise(t_hi)
        if history:
            traj.append(x)
    return _finish(x, traj, history)
