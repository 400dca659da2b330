"""Sampling-time guidance: sparsity, mass-preservation, classifier-free,
and the condition dropout that trains for it (port of the JAX package's
``models/guidance.py``, native ``(B, T, H, W, C)`` layout).

The mass-preservation gradient is the exact ``torch.autograd.grad`` of the
closed-form continuity-equation energy, as the JAX package takes its
``jax.grad``.
"""

from __future__ import annotations

import torch

from crowdmod_tpu_torch.core import layout


def sparsity_gradient(x: torch.Tensor) -> torch.Tensor:
    """Subgradient of the L1 norm of the density channel; zero elsewhere."""
    grad = torch.zeros_like(x)
    grad[..., layout.RHO] = torch.sign(x[..., layout.RHO])
    return grad


def continuity_energy(
    x: torch.Tensor, delta_t: float = 0.5, delta_l: float = 1.0
) -> torch.Tensor:
    """Continuity-equation residual energy, per batch element → ``(B,)``.

    f = ∂ρ/∂t + ρ(∂vx/∂x + ∂vy/∂y) + vx ∂ρ/∂x + vy ∂ρ/∂y  (finite differences
    on interior cells), E = mean-normalized 0.5·Σ f².  x-diff is along rows
    (H) and y-diff along cols (W), as in the reference.
    """
    _, t, h, w, _ = x.shape
    rho = x[..., layout.RHO]  # (B, T, H, W)
    vx = x[..., layout.VX]
    vy = x[..., layout.VY]

    r = rho[:, :-1, 1:-1, 1:-1]
    term1 = (1.0 / delta_t) * (rho[:, 1:, 1:-1, 1:-1] - r)
    term2 = (1.0 / delta_l) * r * (
        (vx[:, :-1, 2:, 1:-1] - vx[:, :-1, 1:-1, 1:-1])
        + (vy[:, :-1, 1:-1, 2:] - vy[:, :-1, 1:-1, 1:-1])
    )
    term3 = (1.0 / delta_l) * (rho[:, :-1, 2:, 1:-1] - r) * vx[:, :-1, 1:-1, 1:-1]
    term4 = (1.0 / delta_l) * (rho[:, :-1, 1:-1, 2:] - r) * vy[:, :-1, 1:-1, 1:-1]

    f = term1 + term2 + term3 + term4
    energy = 0.5 * torch.sum(f * f, dim=(1, 2, 3))
    return energy / (h * w * t)


def mass_preservation_gradient(
    x: torch.Tensor, delta_t: float = 0.5, delta_l: float = 1.0
) -> torch.Tensor:
    """Exact gradient of the summed batch energy (per-sample energies are
    independent, so this is each sample's own gradient)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        energy = continuity_energy(xg, delta_t, delta_l).sum()
        (grad,) = torch.autograd.grad(energy, xg)
    return grad


def drop_condition(
    past: torch.Tensor,
    prob: float,
    *,
    keep: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Per-example condition dropout for classifier-free-guidance training:
    each row's ``past`` is zeroed (the null condition) with probability
    ``prob``.  ``keep`` ``(B,)`` bool is drawn from ``generator`` on past's
    device unless given; ``prob == 0`` returns ``past`` unchanged."""
    if not 0.0 <= prob < 1.0:
        raise ValueError(f"CFG drop probability must be in [0, 1), got {prob}")
    if prob == 0.0:
        return past
    if keep is None:
        if generator is None:
            raise ValueError("drop_condition needs keep or an explicit generator")
        keep = torch.rand((past.shape[0],), generator=generator, device=past.device) < 1.0 - prob
    return past * keep.reshape((-1,) + (1,) * (past.ndim - 1)).to(past.dtype)


def cfg_denoise_fn(denoise_fn, scale: float):
    """Wrap ``denoise_fn(x, t, past)`` with classifier-free guidance:

        out = f(x, t, 0) + scale * (f(x, t, past) - f(x, t, 0))

    ``scale == 1`` returns ``denoise_fn`` unchanged.  Both evaluations run
    as one forward of twice the batch.
    """
    if scale == 1.0:
        return denoise_fn

    def guided(x, t, past):
        if past is None:
            raise ValueError(
                "cfg_denoise_fn needs a condition; got past=None "
                "(unconditioned sampling cannot be CFG-guided)"
            )
        x2 = torch.cat([x, x])
        t2 = torch.cat([t, t])
        past2 = torch.cat([past, torch.zeros_like(past)])
        eps_c, eps_u = denoise_fn(x2, t2, past2).chunk(2)
        return eps_u + scale * (eps_c - eps_u)

    return guided
