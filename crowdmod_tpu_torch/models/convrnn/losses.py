"""ConvRNN composite loss (port of the JAX package's
``models/convrnn/losses.py``), on ``(B, T, H, W, C)``: KL-Poisson divergence
on density (the network predicts log density), the velocity and variance
MSE over occupied cells, and a regulariser on velocity norm and variance
over empty cells.
"""

from __future__ import annotations

import torch

from crowdmod_tpu_torch.core import layout


def kl_poisson_loss(rho_hat: torch.Tensor, rho_gt: torch.Tensor) -> torch.Tensor:
    """Pointwise KL divergence between Poisson rates."""
    return rho_gt * (torch.log(rho_gt) - torch.log(rho_hat)) + rho_hat - rho_gt


def velocity_mse_loss(mu_hat, var_hat, mu_gt, var_gt):
    """Squared error of the velocity mean plus that of the variance."""
    return torch.square(mu_hat - mu_gt) + torch.square(var_hat - var_gt)


def kl_gaussian_loss(mu_hat, var_hat, mu_gt, var_gt):
    """The Gaussian KL variant."""
    inv = 1.0 / var_hat
    return (0.5 * inv * torch.square(mu_hat - mu_gt) + var_gt * inv
            - torch.log(var_gt * inv) - 1.0)


def _clamp(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 1e-8, 20.0)


def convrnn_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6):
    """``(rho_loss, vel_loss, occupied_term, empty_term)`` of ``pred`` (log
    space ρ and σ² channels) against ``target``, both ``(B, F, H, W, 4)``.

    ρ and σ² are exp'd from the network's output and clamped to
    [1e-8, 20]; the velocity MSE is averaged over occupied cells (ρ_gt ≥ 1)
    and empty cells pay ‖v‖² + σ⁴.  As in the reference, the two-channel
    masked sum is divided by the one-channel cell count."""
    rho_hat = _clamp(torch.exp(pred[..., layout.RHO]))
    rho_gt = _clamp(target[..., layout.RHO])
    rho_loss = torch.mean(kl_poisson_loss(rho_hat, rho_gt))

    mu_hat = pred[..., layout.VX:layout.VY + 1]
    mu_gt = target[..., layout.VX:layout.VY + 1]
    var_hat = _clamp(torch.exp(pred[..., layout.SIGMA2]))
    var_gt = _clamp(target[..., layout.SIGMA2])

    occupied = (rho_gt >= 1.0).to(pred.dtype)  # (B, F, H, W)
    empty = 1.0 - occupied
    occupied_count = torch.sum(occupied)
    empty_count = torch.sum(empty)

    mse = velocity_mse_loss(mu_hat, var_hat[..., None], mu_gt, var_gt[..., None])
    occupied_term = torch.sum(occupied[..., None] * mse) / (occupied_count + eps)

    vel_norm = torch.sum(torch.square(mu_hat), dim=-1)
    var_penalty = torch.square(var_hat)
    empty_term = torch.sum(empty * (vel_norm + var_penalty)) / (empty_count + eps)
    return rho_loss, occupied_term + empty_term, occupied_term, empty_term
