"""Sampling-time guidance: sparsity, mass-preservation, classifier-free,
and the condition dropout that trains for it (port of the JAX package's
``models/guidance.py``, native ``(B, T, H, W, C)`` layout).

The mass-preservation gradient is the exact gradient of the closed-form
continuity-equation energy, itself in closed form (the JAX package takes its
``jax.grad``): plain tensor ops, no autograd, so an exported sampler's loop
runs it as the eager samplers do.  The finite-difference oracle
:func:`mass_preservation_gradient_fd` is kept for the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    independent, so this is each sample's own gradient), in closed form.

    With g = f / (H·W·T) on the interior cells, ∂E/∂x is g times ∂f/∂x of
    each of the four terms, added into the slices of x each term reads:
    ρ at (t+1, i, j), (t, i, j), (t, i+1, j), (t, i, j+1); vx at (t, i+1,
    j), (t, i, j); vy at (t, i, j+1), (t, i, j).  Other channels get 0."""
    _, t, h, w, c = x.shape
    rho = x[..., layout.RHO]
    vx = x[..., layout.VX]
    vy = x[..., layout.VY]
    a, l = 1.0 / delta_t, 1.0 / delta_l

    r = rho[:, :-1, 1:-1, 1:-1]
    vxc = vx[:, :-1, 1:-1, 1:-1]
    vyc = vy[:, :-1, 1:-1, 1:-1]
    drho_i = rho[:, :-1, 2:, 1:-1] - r
    drho_j = rho[:, :-1, 1:-1, 2:] - r
    div = (vx[:, :-1, 2:, 1:-1] - vxc) + (vy[:, :-1, 1:-1, 2:] - vyc)
    f = a * (rho[:, 1:, 1:-1, 1:-1] - r) + l * r * div + l * drho_i * vxc + l * drho_j * vyc
    g = f / (h * w * t)

    def at(v, dt, di, dj):
        """``v`` (B, T-1, H-2, W-2) placed at offset (dt, 1+di, 1+dj) of a
        zero (B, T, H, W)."""
        return F.pad(v, (1 + dj, 1 - dj, 1 + di, 1 - di, dt, 1 - dt))

    lr = l * r * g
    grad_rho = (at(a * g, 1, 0, 0)
                + at((-a + l * div - l * vxc - l * vyc) * g, 0, 0, 0)
                + at(l * vxc * g, 0, 1, 0)
                + at(l * vyc * g, 0, 0, 1))
    grad_vx = at(lr, 0, 1, 0) + at(l * drho_i * g - lr, 0, 0, 0)
    grad_vy = at(lr, 0, 0, 1) + at(l * drho_j * g - lr, 0, 0, 0)
    chans = {layout.RHO: grad_rho, layout.VX: grad_vx, layout.VY: grad_vy}
    zero = torch.zeros_like(rho)
    return torch.stack([chans.get(k, zero) for k in range(c)], dim=-1)


def mass_preservation_gradient_fd(
    x: torch.Tensor, delta_t: float = 0.5, delta_l: float = 1.0, eps: float = 0.01
) -> torch.Tensor:
    """Forward-difference gradient, the reference's numerical scheme, kept
    only as a test oracle for the closed form: every element perturbed by
    ``eps`` in one batched energy evaluation a sample."""
    b = x.shape[0]
    n = x[0].numel()
    base = continuity_energy(x, delta_t, delta_l)  # (B,)
    flat = x.reshape(b, 1, n).expand(b, n, n).clone()
    flat.diagonal(dim1=1, dim2=2).add_(eps)
    pert = flat.reshape(b * n, *x.shape[1:])
    energy = continuity_energy(pert, delta_t, delta_l).reshape(b, n)
    return ((energy - base[:, None]) / eps).reshape(x.shape)


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
