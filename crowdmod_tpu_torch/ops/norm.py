"""GroupNorm(+SiLU) module over the fused kernel (port of the JAX package's
``ops/norm.py``).

Drop-in for the reference's ``nn.GroupNorm(8, C)`` (+ ``nn.SiLU``) pairs:
the parameters are the reference ``GroupNorm``'s (``weight``, ``bias``), so
state_dicts keep its keys, and the math runs through
:func:`~crowdmod_tpu_torch.ops.kernels.fused_group_norm`.
"""

from __future__ import annotations

import torch
from torch import nn

from crowdmod_tpu_torch.ops.kernels import fused_group_norm


class GroupNormSiLU(nn.Module):
    """Fused GroupNorm with optional SiLU epilogue (channels-last); the
    output is cast to ``dtype``."""

    def __init__(self, channels: int, num_groups: int = 8, eps: float = 1e-5,
                 silu: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups, self.eps, self.silu, self.dtype = num_groups, eps, silu, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: torch.Generator | None = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = fused_group_norm(
            x.contiguous(), self.weight, self.bias, num_groups=self.num_groups,
            eps=self.eps, silu=self.silu,
        )
        return out.to(self.dtype)
