"""ReFlow, the flow-matching family's few-step retraining (port of the ReFlow
half of the JAX package's ``train/distiller.py``: ``reflow_tag``,
``_save_tagged`` and ``reflow``).  Progressive distillation for DDPM is not
ported yet (ROADMAP.md Queue 1 item 11).

Randomness: each coupling batch's x0 and each training step's t come from a
``torch.Generator`` seeded ``seed`` on the trainer's device, or from the
caller's ``draws(kind, shape)`` (``kind`` "x0" or "t"), called in the order
the JAX package's key stream consumes them: every coupling batch of a round
("x0", the batch's sample shape), then every step ("t", (batch,)).  The
epoch permutations are numpy's ``default_rng(seed + round)``, as in the JAX
package.
"""

from __future__ import annotations

import copy
import logging
import os
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from crowdmod_tpu_torch.models.flow_matching.reflow import generate_coupling, reflow_loss
from crowdmod_tpu_torch.train import checkpoint as ckpt
from crowdmod_tpu_torch.train.optim import adam

if TYPE_CHECKING:  # pragma: no cover
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.train.trainer import Trainer

Draws = Callable[[str, tuple], torch.Tensor]


def reflow_tag(round_idx: int) -> str:
    """Checkpoint tag of the ``round_idx``-th rectified flow."""
    return f"RF{round_idx}"


def _save_tagged(trainer, params: dict, save_dir: str, tag: str, extra: dict) -> str:
    """``params`` (a state_dict) under the tagged checkpoint name, with the
    JAX package's metadata and ``extra``; → the path."""
    name = ckpt.checkpoint_name(trainer.cfg, trainer.arch, tag)
    path = os.path.join(save_dir, name)
    meta = ckpt.build_metadata(trainer.cfg, trainer.arch, tag, extra)
    ckpt.save_checkpoint(path, {"params": params}, meta)
    logging.info("%s checkpoint saved: %s", tag, path)
    return path


def reflow(
    trainer: "Trainer",
    train_ds: "WindowDataset",
    *,
    rounds: int = 1,
    coupling_steps: int = 100,
    epochs_per_round: int = 8,
    lr: float = 1e-4,
    save_dir: str | None = None,
    save_intermediate: bool = False,
    tracker=None,
    seed: int = 0,
    draws: Draws | None = None,
) -> dict:
    """Rectify a trained FM velocity field: each round integrates the
    teacher's ODE (``coupling_steps`` Euler steps) from x0 over the training
    pasts to build coupled (x0, x1) pairs, then retrains a copy of the
    teacher on the straight paths between them with plain Adam (b1 0.9, b2
    0.999, no decay) and no dropout.  The result samples with a small Euler
    ``INTEGRATOR_STEPS``.

    Leaves the rectified field in the trainer's weights (and its EMA copy,
    where it has one); returns a history dict of per-round loss curves."""
    if trainer.family != "FM":
        raise ValueError(f"reflow targets the FM family, got {trainer.arch!r}")
    if not trainer._ready:
        raise ValueError("trainer has no restored state; load a checkpoint "
                         "before reflowing")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    batch_size = trainer.cfg.DATASET.BATCH_SIZE
    if len(train_ds) < batch_size:
        raise ValueError(
            f"reflow dataset yields no full batches: {len(train_ds)} "
            f"windows < DATASET.BATCH_SIZE={batch_size}"
        )
    # Rectification retrains on conditional pasts only and builds its
    # couplings with the unguided teacher, so the student's unconditional
    # branch goes stale: CFG-guided sampling of it would silently degrade.
    if float(trainer.cfg.MODEL.FM.get("CFG_SCALE", 1.0)) != 1.0:
        raise ValueError(
            "reflow produces a guidance-free rectified field; its "
            "unconditional branch is not retrained, so sampling with "
            f"CFG_SCALE={trainer.cfg.MODEL.FM.CFG_SCALE} would apply "
            "guidance against stale null-condition predictions. Set "
            "MODEL.FM.CFG_SCALE to 1.0 before reflowing."
        )

    device = trainer.device
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(seed)

        def draws(kind: str, shape: tuple) -> torch.Tensor:
            if kind == "x0":
                return torch.randn(shape, generator=gen, device=device)
            return torch.rand(shape, generator=gen, device=device)

    tmp = trainer.cfg.MODEL.FM.TIME_MAX_POS
    teacher = copy.deepcopy(trainer._sample_model()).eval().requires_grad_(False)
    history: dict = {"rounds": [], "loss": {}}

    for r in range(1, rounds + 1):
        # The coupling set, from the teacher.
        pasts, x0s, x1s = [], [], []
        for past_b, future_b in train_ds.batches(batch_size, shuffle=False, seed=seed):
            past_b = past_b.to(device)
            x0, x1 = generate_coupling(
                teacher, past_b, tuple(future_b.shape), steps=coupling_steps,
                time_max_pos=tmp, x0=draws("x0", tuple(future_b.shape)))
            pasts.append(past_b)
            x0s.append(x0)
            x1s.append(x1)
        past_all, x0_all, x1_all = (torch.cat(a) for a in (pasts, x0s, x1s))
        n = past_all.shape[0]
        logging.info("reflow round %d: %d coupled pairs (teacher %d-step Euler)",
                     r, n, coupling_steps)

        # Retrain a copy of the teacher on the straight paths.
        student = copy.deepcopy(teacher).requires_grad_(True).eval()
        opt = adam(student.parameters(), lr, (0.9, 0.999))
        round_losses = []
        rng = np.random.default_rng(seed + r)
        for epoch in range(1, epochs_per_round + 1):
            order = torch.as_tensor(rng.permutation(n), device=device)
            losses = []
            for i in range(0, n - batch_size + 1, batch_size):
                sel = order[i:i + batch_size]
                opt.zero_grad(set_to_none=True)
                loss = reflow_loss(student, x0_all[sel], x1_all[sel], past_all[sel],
                                   t=draws("t", (batch_size,)), time_max_pos=tmp)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            epoch_loss = float(torch.stack(losses).mean())
            round_losses.append(epoch_loss)
            if tracker is not None:
                tracker.log({f"reflow_loss_r{r}": epoch_loss}, step=epoch)
            logging.info("reflow round %d, epoch %d/%d: loss %.5f",
                         r, epoch, epochs_per_round, epoch_loss)
            if not np.isfinite(epoch_loss):
                raise FloatingPointError(f"reflow diverged at round {r} epoch {epoch}")

        teacher = student.eval().requires_grad_(False)
        history["rounds"].append(r)
        history["loss"][r] = round_losses
        if save_dir and (save_intermediate or r == rounds):
            _save_tagged(trainer, teacher.state_dict(), save_dir, reflow_tag(r),
                         {"reflow_round": r, "coupling_steps": coupling_steps,
                          "reflow_loss": round_losses[-1]})

    with torch.no_grad():
        trainer.model.load_state_dict(teacher.state_dict())
        if trainer.ema_model is not None:
            trainer.ema_model.load_state_dict(teacher.state_dict())
    return history
