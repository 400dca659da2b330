"""The macroproperty scene (port of the JAX package's ``core/scene.py``).

The 4-D crowd state as named fields, ``MacroScene``, so model and metric
code can name density, velocity and variance instead of slicing channel
indices, while :meth:`MacroScene.pack` / :meth:`MacroScene.unpack` round
trip to the dense ``(..., T, H, W, C)`` tensors the compute paths run on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crowdmod_tpu_torch.core import layout


class MacroScene(NamedTuple):
    """Crowd macroproperties over a spatio-temporal grid.

    Fields (all leading dims ``(..., T, H, W)``):
      rho:    per-cell pedestrian density.
      vel:    mean velocity field, trailing dim 2 → (vx, vy).
      sigma2: per-cell velocity-norm variance; ``None`` for the 3-channel
              subset the diffusion and flow-matching models use.
    """

    rho: torch.Tensor
    vel: torch.Tensor
    sigma2: torch.Tensor | None = None

    @property
    def num_channels(self) -> int:
        return 3 if self.sigma2 is None else 4

    def pack(self) -> torch.Tensor:
        """→ the dense ``(..., T, H, W, C)`` tensor in the reference's
        channel order."""
        parts = [self.rho[..., None], self.vel]
        if self.sigma2 is not None:
            parts.append(self.sigma2[..., None])
        return torch.cat(parts, dim=-1)

    @classmethod
    def unpack(cls, grid: torch.Tensor) -> "MacroScene":
        """A scene of a dense ``(..., T, H, W, C)`` tensor (C in {3, 4})."""
        c = grid.shape[-1]
        if c not in (3, 4):
            raise ValueError(f"expected 3 or 4 macroprop channels, got {c}")
        return cls(
            rho=grid[..., layout.RHO],
            vel=grid[..., layout.VX : layout.VY + 1],
            sigma2=grid[..., layout.SIGMA2] if c == 4 else None,
        )

    def total_density(self) -> torch.Tensor:
        """Total pedestrian count per frame: the sum of rho over the grid."""
        return self.rho.sum(dim=(-2, -1))
