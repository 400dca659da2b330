"""Optimizer and LR schedule with the reference's training semantics (port
of the JAX package's ``train/optim.py``).

The reference trains with ``torch.optim.Adam``: weight decay coupled into
the gradient before the moment updates (L2, not AdamW), which the JAX
package writes as ``optax.chain(add_decayed_weights, scale_by_adam,
scale(-lr))``, bias correction and eps placement included.  Here it is
``torch.optim.Adam`` itself.  The learning rate lives in the optimizer's
``param_groups``; :class:`PlateauState` is the JAX package's plateau state
machine, not ``torch.optim.lr_scheduler.ReduceLROnPlateau`` (whose eps and
cooldown differ).
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch


def adam(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    betas: tuple[float, float] = (0.9, 0.999),
    weight_decay: float = 0.0,
    eps: float = 1e-8,
) -> torch.optim.Adam:
    """Adam with L2-coupled weight decay."""
    return torch.optim.Adam(params, lr=learning_rate, betas=tuple(betas),
                            eps=eps, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


class PlateauState(NamedTuple):
    """ReduceLROnPlateau (mode=min, rel threshold) state machine.

    Improvement when ``loss < best * (1 - threshold)``; after ``patience``
    non-improving epochs the LR is multiplied by ``factor`` and floored at
    ``min_lr``.
    """

    lr: float
    best: float = float("inf")
    num_bad: int = 0
    factor: float = 0.5
    patience: int = 10
    min_lr: float = 1e-6
    threshold: float = 1e-4

    def step(self, loss: float) -> "PlateauState":
        if loss < self.best * (1.0 - self.threshold):
            return self._replace(best=loss, num_bad=0)
        num_bad = self.num_bad + 1
        if num_bad > self.patience:
            return self._replace(
                lr=max(self.lr * self.factor, self.min_lr), num_bad=0
            )
        return self._replace(num_bad=num_bad)
