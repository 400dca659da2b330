"""Train state and the update step (port of the JAX package's
``train/state.py``).

:class:`TrainState` holds what training keeps beside the model's own
weights: the step counter, the optimizer and, with EMA on, a second module
holding the exponential moving average of the weights.  One step is
:func:`train_step`: the loss, its backward, the optimizer step, then the
EMA update; a plain step that updates the parameters in place (the JAX
package's donating jit has no counterpart to port).
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch
from torch import nn

_f32 = np.float32


def ema_decay_at(decay: float, step: int) -> float:
    """The warmup-scheduled EMA decay ``min(decay, (1 + t) / (10 + t))`` at
    step ``t`` (the step before its increment), in float32 as the JAX
    package computes it."""
    t = _f32(step)
    return float(np.minimum(_f32(decay), (_f32(1.0) + t) / (_f32(10.0) + t)))


def ema_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` to hold its EMA: eval mode, no gradients."""
    return copy.deepcopy(model).eval().requires_grad_(False)


class TrainState:
    """Step counter, optimizer and EMA module of a model being trained.
    ``ema_model``: the module that holds the EMA, equal to the model's
    weights (default, with ``ema_decay`` on: :func:`ema_copy`; an
    FSDP-sharded model passes one sharded alike, whose update then runs on
    the local shards)."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 *, ema_decay: float = 0.0, ema_model: nn.Module | None = None):
        self.model = model
        self.optimizer = optimizer
        self.ema_decay = ema_decay
        self.step = 0
        self.ema_model = None
        if ema_decay:
            self.ema_model = ema_copy(model) if ema_model is None else ema_model

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """The optimizer step on the model's gradients, then the EMA update
        ``ema = d·ema + (1 - d)·params`` with the decay at this step."""
        self.optimizer.step()
        if self.ema_model is not None:
            d = ema_decay_at(self.ema_decay, self.step)
            one_minus = float(_f32(1.0) - _f32(d))
            for e, p in zip(self.ema_model.parameters(), self.model.parameters()):
                e.mul_(d).add_(p.to(e.dtype) * one_minus)
        self.step += 1


LossFn = Callable[..., torch.Tensor]


def train_step(state: TrainState, loss_fn: LossFn, *args) -> torch.Tensor:
    """One update: ``loss_fn(*args)``, its backward, :meth:`apply_gradients`;
    returns the loss (detached)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(*args)
    loss.backward()
    state.apply_gradients()
    return loss.detach()
