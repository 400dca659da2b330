"""Diffusion noise schedules (port of ``crowdmod_tpu.core.schedule``).

A linear beta schedule ``beta_t = linspace(scale*1e-4, scale*2e-2, T)`` with
its derived closed-form buffers, built in float32 by the same formulas as the
JAX package.  The schedule lives on the host as numpy arrays, so a sampler
reads each step's coefficients as plain floats (no device round trip per
step); :meth:`DiffusionSchedule.on` gives device copies for the gathers that
take a per-example ``t`` tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

_BUFFERS = (
    "beta", "alpha", "alpha_bar", "sqrt_alpha_bar",
    "sqrt_one_minus_alpha_bar", "one_by_sqrt_alpha",
)


@dataclass(frozen=True, eq=False)
class DiffusionSchedule:
    """Per-timestep buffers, each a ``(timesteps,)`` float32 numpy array."""

    beta: np.ndarray
    alpha: np.ndarray
    alpha_bar: np.ndarray
    sqrt_alpha_bar: np.ndarray
    sqrt_one_minus_alpha_bar: np.ndarray
    one_by_sqrt_alpha: np.ndarray
    _on_device: dict = field(default_factory=dict, repr=False)

    @property
    def timesteps(self) -> int:
        return self.beta.shape[0]

    def on(self, device) -> dict[str, torch.Tensor]:
        """The buffers as float32 tensors on ``device``, made once each.
        Under a trace (``torch.export``, a scan body) a made copy is used
        and not kept: the trace's tensors are fakes that must not outlive
        it; copies made before the trace are read as constants."""
        device = torch.device(device)
        buffers = self._on_device.get(device)
        if buffers is None:
            buffers = {
                name: torch.from_numpy(getattr(self, name)).to(device)
                for name in _BUFFERS
            }
            if not torch.compiler.is_compiling():
                self._on_device[device] = buffers
        return buffers


def linear_schedule(
    timesteps: int = 1000,
    scale: float = 1.0,
    beta_start: float = 1e-4,
    beta_end: float = 2e-2,
) -> DiffusionSchedule:
    """Linear beta schedule with the reference's scaling convention."""
    f32 = np.float32
    beta = np.linspace(
        scale * beta_start, scale * beta_end, timesteps, dtype=f32
    )
    alpha = f32(1.0) - beta
    alpha_bar = np.cumprod(alpha, dtype=f32)
    return DiffusionSchedule(
        beta=beta,
        alpha=alpha,
        alpha_bar=alpha_bar,
        sqrt_alpha_bar=np.sqrt(alpha_bar),
        sqrt_one_minus_alpha_bar=np.sqrt(f32(1.0) - alpha_bar),
        one_by_sqrt_alpha=f32(1.0) / np.sqrt(alpha),
    )


def q_sample(
    sched: DiffusionSchedule,
    x0: torch.Tensor,
    t: torch.Tensor,
    eps: torch.Tensor | None = None,
    *,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample from q(x_t | x_0); returns ``(x_t, eps)``.  ``eps`` is drawn
    from ``generator`` on x0's device unless given."""
    if eps is None:
        if generator is None:
            raise ValueError("q_sample needs eps or an explicit generator")
        eps = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
    buf = sched.on(x0.device)
    shape = t.shape + (1,) * (x0.ndim - t.ndim)
    mean = buf["sqrt_alpha_bar"][t].reshape(shape) * x0
    std = buf["sqrt_one_minus_alpha_bar"][t].reshape(shape)
    return mean + std * eps, eps


def ddim_tau_schedule(timesteps: int, divider: int) -> np.ndarray:
    """The reference's DDIM tau subset: ``arange(0, T-1, divider)``."""
    return np.arange(0, timesteps - 1, divider, dtype=np.int32)


def respaced_taus(timesteps: int, steps: int) -> np.ndarray:
    """Ascending ``(steps,)`` int32 tau grid 0 ... T-1 for respaced sampling.

    Unlike :func:`ddim_tau_schedule`, the grid always includes both
    endpoints, so the chain starts at the x_T the model was trained on.
    """
    if not 1 <= steps <= timesteps:
        raise ValueError(
            f"steps must be in [1, timesteps={timesteps}]; got {steps}"
        )
    if steps == 1:
        return np.array([timesteps - 1], dtype=np.int32)
    return np.unique(
        np.linspace(0, timesteps - 1, steps).round().astype(np.int32)
    )
