"""Diffusion-timestep embeddings (port of the JAX package's
``models/backbones/embeddings.py``).

The sinusoid is computed on the fly from a float timestep, as in the JAX
package.  The reference precomputes it as an ``nn.Embedding`` table at
``time_blocks.0``; here that slot holds no state (an ``nn.Identity``), so the
Linear layers keep the reference's state_dict keys ``time_blocks.1`` and
``time_blocks.3`` and no extra buffer is registered.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from crowdmod_tpu_torch.ops.attention import dense


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``(B,) → (B, dim)`` sinusoid, matching the reference table at integer t.

    Frequencies: exp(-log(10000) * i / (dim/2 - 1)), half sin / half cos.
    """
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * float(-np.log(10000.0) / (half - 1))
    )
    angles = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


class TimestepEmbedding(nn.Module):
    """sinusoid(dim) → Linear(exp_dim) → SiLU → Linear(exp_dim)."""

    def __init__(self, dim: int, exp_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.time_blocks = nn.ModuleList([
            nn.Identity(), nn.Linear(dim, exp_dim), nn.SiLU(),
            nn.Linear(exp_dim, exp_dim),
        ])

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_embedding(t, self.dim).to(self.dtype)
        emb = F.silu(dense(emb, self.time_blocks[1], self.dtype))
        return dense(emb, self.time_blocks[3], self.dtype)
