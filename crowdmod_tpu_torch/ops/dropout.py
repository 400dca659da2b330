"""Dropout with masks drawn from an explicit generator.

The port draws every random number from a ``torch.Generator`` that its
caller passes in, never from PyTorch's global state.  A model draws the
masks of a forward before it runs its blocks and passes them in: a block
recomputed under ``torch.utils.checkpoint`` (``TPU.REMAT``) then applies
the same masks again, where a second draw from the generator would not.
"""

from __future__ import annotations

import torch


def keep_mask(shape, rate: float, generator: torch.Generator | None, device) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``: True with probability
    ``1 - rate``, drawn from ``generator`` (which must be given)."""
    if generator is None:
        raise ValueError(
            "dropout in training mode needs an explicit torch.Generator "
            "(pass generator= to the model's forward)"
        )
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    """``x / (1 - rate)`` where ``keep``, 0 elsewhere (flax ``nn.Dropout``);
    ``x`` unchanged when ``keep`` is None."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
