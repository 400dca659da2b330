"""Array layout conventions, shared with the JAX package.

The native layout is channels-last, time-major ``(B, T, H, W, C)``.  The
reference PyTorch project stores ``(B, C, H, W, T)``; the converters below
move between the two so pickles and checkpoints stay interoperable.

Channel order: ``0 = rho`` (density), ``1 = mu_vx``, ``2 = mu_vy``,
``3 = sigma2_v`` (velocity-norm variance).
"""

from __future__ import annotations

import torch

RHO, VX, VY, SIGMA2 = 0, 1, 2, 3

BATCH_AXIS, TIME_AXIS, ROW_AXIS, COL_AXIS, CHANNEL_AXIS = 0, 1, 2, 3, 4


def from_reference(x: torch.Tensor) -> torch.Tensor:
    """``(B, C, H, W, T)`` (reference) → ``(B, T, H, W, C)`` (native)."""
    return x.permute(0, 4, 2, 3, 1)


def to_reference(x: torch.Tensor) -> torch.Tensor:
    """``(B, T, H, W, C)`` (native) → ``(B, C, H, W, T)`` (reference)."""
    return x.permute(0, 4, 2, 3, 1)


def split_past_future(x: torch.Tensor, past_len: int):
    """Split a ``(B, T, H, W, C)`` window into past / future along time."""
    return x[:, :past_len], x[:, past_len:]


def concat_time(past: torch.Tensor, future: torch.Tensor) -> torch.Tensor:
    """Concatenate past and future frames along the time axis."""
    return torch.cat([past, future], dim=TIME_AXIS)
