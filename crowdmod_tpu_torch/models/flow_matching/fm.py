"""Flow matching: interpolants, the training loss and the ODE integrators
(port of the JAX package's ``models/flow_matching/fm.py``).

The velocity predictor reuses the DDPM timestep embedding: the continuous
t ∈ [0, 1] is scaled by ``TIME_MAX_POS`` and floored before it reaches the
backbone.  Each integrator is a Python loop calling ``u_fn``, any callable
``(x, t_vec, past) -> u`` on native-layout ``(B, F, H, W, C)`` tensors; its
update is plain arithmetic (the JAX package has no kernel for it).  The
time grid is computed on the host as float32 bits equal to the JAX
package's ``jnp.linspace`` (``torch.linspace`` rounds other ways).

Randomness: :func:`fm_loss` takes its t and x0, or draws them from an
explicit generator.  The samplers take ``noise``, the
:mod:`~crowdmod_tpu_torch.models.diffusion.ddpm` callable (``noise(None)``
is x0; the integrators draw nothing else), or a generator.

As in the JAX package: "Heun" is the Heun RK2 sampler (the reference maps
it to Euler), and :func:`conic_interpolant` guards its (1 - t) division.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from crowdmod_tpu_torch.models.diffusion.ddpm import Noise, gaussian_noise

UFn = Callable[[torch.Tensor, torch.Tensor, "torch.Tensor | None"], torch.Tensor]


def linear_interpolant(x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor):
    """x_t = x0 + t (x1 - x0); u = x1 - x0."""
    return x0 + t * (x1 - x0), x1 - x0


def conic_interpolant(x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor,
                      eps: float = 1e-6):
    """x_t = t x1 + (1 - t) x0; u = (x1 - x_t) / max(1 - t, eps), the
    divisor a tensor (a division by a scalar would be a reciprocal product
    on CUDA)."""
    xt = t * x1 + (1.0 - t) * x0
    u = (x1 - xt) / torch.clamp(1.0 - t, min=eps)
    return xt, u


INTERPOLANTS = {"Linear": linear_interpolant, "Conic": conic_interpolant}


def fm_loss(
    u_fn: UFn,
    future: torch.Tensor,
    past: torch.Tensor | None,
    *,
    t: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    w_type: str = "Linear",
    time_max_pos: int = 1000,
) -> torch.Tensor:
    """MSE between the predicted and the interpolant's velocity.  ``x0``
    (the future's shape, N(0, I)) and ``t`` ``(B,)`` (uniform on [0, 1)) are
    drawn from ``generator`` on the future's device (x0 first) unless
    given."""
    x1 = future
    if x0 is None or t is None:
        if generator is None:
            raise ValueError("fm_loss needs t and x0 or an explicit generator")
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=x1.device,
                             dtype=x1.dtype)
        if t is None:
            t = torch.rand((x1.shape[0],), generator=generator, device=x1.device)
    t_b = t.reshape((-1,) + (1,) * (x1.ndim - 1))
    xt, u_target = INTERPOLANTS[w_type](x0, x1, t_b)
    u_pred = u_fn(xt, torch.floor(t * time_max_pos), past)
    return torch.mean(torch.square(u_target - u_pred))


def _time_grid(steps: int, time_max_pos: int) -> tuple[np.ndarray, np.ndarray]:
    """``linspace(0, 1, steps)`` and its embedding indices ``clip(floor(ts ·
    time_max_pos), 0, time_max_pos - 1)``, float32, bit for bit the JAX
    package's: ``arange(steps) · float32(1 / (steps - 1))`` with the last
    point 1."""
    ts = np.arange(steps, dtype=np.float32)
    if steps > 1:
        ts = ts * np.float32(1.0 / (steps - 1))
        ts[-1] = 1.0
    idx = np.clip(np.floor(ts * np.float32(time_max_pos)), 0, time_max_pos - 1)
    return ts, idx.astype(np.float32)


def _start(noise, generator, sample_shape, past, device):
    if device is None:
        if past is None:
            raise ValueError("pass device= when sampling without a past")
        device = past.device
    if noise is None:
        noise = gaussian_noise(sample_shape, device, generator)
    return noise(None), torch.device(device)


def euler_sample(
    u_fn: UFn,
    past: torch.Tensor | None,
    sample_shape: tuple[int, ...],
    *,
    steps: int = 1000,
    time_max_pos: int = 1000,
    noise: Noise | None = None,
    generator: torch.Generator | None = None,
    device=None,
    x_init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Euler integration of dx/dt = u from x(0) ~ N(0, I).

    ``x_init`` overrides the noise draw: ReFlow's coupling generation keeps
    the (x0, x1) endpoints paired."""
    if x_init is None:
        x, device = _start(noise, generator, sample_shape, past, device)
    else:
        x = x_init
    delta = 1.0 / steps
    b = sample_shape[0]
    _, idx = _time_grid(steps, time_max_pos)
    for t_idx in idx:
        u = u_fn(x, torch.full((b,), float(t_idx), device=x.device), past)
        x = x + delta * u
    return x


def heun_sample(
    u_fn: UFn,
    past: torch.Tensor | None,
    sample_shape: tuple[int, ...],
    *,
    steps: int = 500,
    time_max_pos: int = 1000,
    noise: Noise | None = None,
    generator: torch.Generator | None = None,
    device=None,
) -> torch.Tensor:
    """Heun (RK2) integration, two denoiser calls a step; the second stage
    embeds ``t_idx + 1``, as the reference does."""
    x, device = _start(noise, generator, sample_shape, past, device)
    delta = 1.0 / steps
    b = sample_shape[0]
    _, idx = _time_grid(steps, time_max_pos)
    for t_idx in idx:
        k1 = u_fn(x, torch.full((b,), float(t_idx), device=device), past)
        x_tilde = x + delta * k1
        k2 = u_fn(x_tilde, torch.full((b,), float(t_idx + 1), device=device), past)
        x = x + 0.5 * delta * (k1 + k2)
    return x


INTEGRATORS = {"Euler": euler_sample, "Heun": heun_sample}
