"""Dropout with masks drawn from an explicit generator.

The port draws every random number from a ``torch.Generator`` that its
caller passes in, never from PyTorch's global state.  A model draws the
masks of a forward before it runs its blocks and passes them in: a block
recomputed under ``torch.utils.checkpoint`` (``TPU.REMAT``) then applies
the same masks again, where a second draw from the generator would not.

Under data parallelism each process runs a slice of the global batch, and a
:class:`BatchRows` in the generator's place makes every mask the slice of
the mask the whole batch would get: the run then draws what the
one-process run draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BatchRows:
    """Draw for rows ``[lo, hi)`` of a batch of ``total`` rows: each mask is
    drawn whole from ``generator`` and sliced to those rows."""

    generator: torch.Generator
    lo: int
    hi: int
    total: int


def keep_mask(shape, rate: float, generator: torch.Generator | BatchRows | None,
              device) -> torch.Tensor:
    """A bool mask of ``shape`` on ``device``: True with probability
    ``1 - rate``, drawn from ``generator`` (which must be given); with a
    :class:`BatchRows`, its rows of the whole batch's mask."""
    if generator is None:
        raise ValueError(
            "dropout in training mode needs an explicit torch.Generator "
            "(pass generator= to the model's forward)"
        )
    if isinstance(generator, BatchRows):
        rows = generator
        if shape[0] != rows.hi - rows.lo:
            raise ValueError(f"a mask of {shape[0]} rows for rows [{rows.lo}, {rows.hi})")
        full = torch.rand((rows.total,) + tuple(shape[1:]), generator=rows.generator,
                          device=device)
        return full[rows.lo:rows.hi] < 1.0 - rate
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    """``x / (1 - rate)`` where ``keep``, 0 elsewhere (flax ``nn.Dropout``);
    ``x`` unchanged when ``keep`` is None."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
