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

ConvRNN trains with AMSGrad in the JAX package's semantics, optax's
``scale_by_amsgrad``: the running maximum is taken of the bias-corrected
second moment, ``nu_max = max(nu_max, nu / (1 - b2^t))``, and the update is
``mu_hat / (sqrt(nu_max) + eps)``.  ``torch.optim.Adam(amsgrad=True)`` takes
the maximum of the uncorrected moment and corrects afterwards, which
differs once the maximum was reached at an earlier step, so
:class:`AMSGrad` is its own optimizer.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch


def adam(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    betas: tuple[float, float] = (0.9, 0.999),
    weight_decay: float = 0.0,
    eps: float = 1e-8,
    amsgrad: bool = False,
) -> torch.optim.Optimizer:
    """Adam with L2-coupled weight decay; ``amsgrad=True`` gives
    :class:`AMSGrad`."""
    if amsgrad:
        return AMSGrad(params, lr=learning_rate, betas=tuple(betas), eps=eps,
                       weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=learning_rate, betas=tuple(betas),
                            eps=eps, weight_decay=weight_decay)


class AMSGrad(torch.optim.Optimizer):
    """optax's ``chain(add_decayed_weights(wd), scale_by_amsgrad(b1, b2,
    eps), scale(-lr))`` in float32: per step ``g += wd·p``, ``mu = (1-b1)·g
    + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, ``nu_max = max(nu_max, nu / (1 -
    b2^t))``, ``p += -lr · (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)``."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    for name in ("mu", "nu", "nu_max"):
                        state[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state["step"] += 1
                t = state["step"]
                mu, nu, nu_max = state["mu"], state["nu"], state["nu_max"]
                mu.mul_(b1).add_((1.0 - b1) * g)
                nu.mul_(b2).add_((1.0 - b2) * torch.square(g))
                c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
                c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
                torch.maximum(nu_max, nu / c2, out=nu_max)
                p.add_((mu / c1) / (torch.sqrt(nu_max) + group["eps"]) * -group["lr"])
        return loss


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
