"""Few-step retraining of a trained model (port of the JAX package's
``train/distiller.py``): progressive distillation for the DDPM family
(``distilled_tag``, ``progressive_distill``) and ReFlow for flow matching
(``reflow_tag``, ``reflow``).

Progressive distillation halves a trained DDPM's sampler steps per phase:
each phase trains a student, initialised from its teacher, to reproduce in
one deterministic DDIM step what the teacher does in two
(:mod:`crowdmod_tpu_torch.models.diffusion.distill`); the student becomes
the next phase's teacher, ``start_steps -> start_steps/2 -> ... ->
target_steps``.  A step is two teacher forwards under ``no_grad`` and one
student forward and backward; both models are in eval mode, so the UNet's
level-0 blocks take the fused kernel in all three (the student's through
``FusedResblock``, whose backward is its twin's VJP).

Randomness: ReFlow's coupling x0 and step t, and distillation's per-example
step ``k`` and q-sample noise, come from a ``torch.Generator`` seeded
``seed`` on the trainer's device, or from the caller's ``draws(kind,
shape)``, called in the order the JAX package's key stream consumes them.
ReFlow: every coupling batch of a round ("x0", the batch's sample shape),
then every step ("t", (batch,)); its epoch permutations are numpy's
``default_rng(seed + round)``, as in the JAX package.  Distillation: each
step "k" (called with the shape (batch,) and the phase's n: integers in
[1, n]) then "eps" (the future's shape); its batches are the dataset's
shuffle with seed ``seed + epoch``.
"""

from __future__ import annotations

import copy
import logging
import os
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from crowdmod_tpu_torch.models.diffusion import as_eps_fn, distill_loss
from crowdmod_tpu_torch.models.flow_matching.reflow import generate_coupling, reflow_loss
from crowdmod_tpu_torch.train import checkpoint as ckpt
from crowdmod_tpu_torch.train.optim import adam

if TYPE_CHECKING:  # pragma: no cover
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.train.trainer import Trainer

Draws = Callable[..., torch.Tensor]


def distilled_tag(n_steps: int) -> str:
    """Checkpoint epoch tag of an ``n_steps`` distilled student (distinct
    from numeric epoch tags and the '000' best-loss tag)."""
    return f"D{n_steps:03d}"


def progressive_distill(
    trainer: "Trainer",
    train_ds: "WindowDataset",
    *,
    target_steps: int,
    start_steps: int = 64,
    epochs_per_phase: int = 8,
    lr: float = 1e-4,
    save_dir: str | None = None,
    save_intermediate: bool = False,
    tracker=None,
    seed: int = 0,
    draws: Draws | None = None,
) -> dict:
    """Run the halving phases from the trainer's sampling weights (EMA
    where it has them).  Each phase trains a copy of its teacher in eval
    mode (no dropout) with plain Adam (b1 0.9, b2 0.999, no decay); both
    run through the PRED_TYPE adapter in eps space.  Leaves the final
    student in the trainer's weights and its EMA copy, and (with
    ``save_dir``) saves it under the :func:`distilled_tag` checkpoint name;
    returns a history dict: the phases' step counts and loss curves."""
    if trainer.family != "DDPM":
        raise ValueError(
            f"progressive distillation targets the DDPM family, got "
            f"{trainer.arch!r}"
        )
    if not trainer._ready:
        raise ValueError("trainer has no restored state; load a checkpoint "
                         "before distilling")
    if target_steps < 1 or start_steps < target_steps:
        raise ValueError(
            f"need start_steps >= target_steps >= 1, got "
            f"{start_steps} -> {target_steps}"
        )
    ratio = start_steps / target_steps
    if 2 ** int(round(np.log2(ratio))) != ratio:
        raise ValueError(
            f"start_steps/target_steps must be a power of two, got "
            f"{start_steps}/{target_steps}"
        )
    sched = trainer.sched
    if 2 * start_steps > sched.timesteps:
        raise ValueError(
            f"first teacher grid (2*{start_steps}) exceeds the schedule's "
            f"{sched.timesteps} timesteps"
        )
    pred_type = trainer.cfg.MODEL.DDPM.get("PRED_TYPE", "eps")
    batch_size = trainer.cfg.DATASET.BATCH_SIZE
    if len(train_ds) < batch_size:
        raise ValueError(
            f"distillation dataset yields no full batches: {len(train_ds)} "
            f"windows < DATASET.BATCH_SIZE={batch_size}"
        )
    device = trainer.device
    if draws is None:
        gen = torch.Generator(device=device).manual_seed(seed)

        def draws(kind: str, shape: tuple, n: int = 0) -> torch.Tensor:
            if kind == "k":
                return torch.randint(1, n + 1, shape, generator=gen, device=device)
            return torch.randn(shape, generator=gen, device=device)

    teacher = copy.deepcopy(trainer._sample_model()).eval().requires_grad_(False)
    history: dict = {"phases": [], "loss": {}}
    n = start_steps
    while n >= target_steps:
        teacher_fn = as_eps_fn(teacher, sched, pred_type)
        student = copy.deepcopy(teacher).requires_grad_(True).eval()
        student_fn = as_eps_fn(student, sched, pred_type)
        opt = adam(student.parameters(), lr, (0.9, 0.999))
        phase_losses = []
        for epoch in range(1, epochs_per_phase + 1):
            losses = []
            for past_b, future_b in train_ds.batches(batch_size, shuffle=True,
                                                     seed=seed + epoch):
                past_b, future_b = past_b.to(device), future_b.to(device)
                k = draws("k", (future_b.shape[0],), n)
                eps = draws("eps", tuple(future_b.shape))
                opt.zero_grad(set_to_none=True)
                loss = distill_loss(student_fn, teacher_fn, sched, n, future_b, past_b,
                                    k=k, eps=eps)
                loss.backward()
                opt.step()
                losses.append(loss.detach())
            epoch_loss = float(torch.stack(losses).mean())
            phase_losses.append(epoch_loss)
            if tracker is not None:
                tracker.log({f"distill_loss_n{n}": epoch_loss}, step=epoch)
            logging.info("distill %d-step phase, epoch %d/%d: loss %.5f",
                         n, epoch, epochs_per_phase, epoch_loss)
            if not np.isfinite(epoch_loss):
                raise FloatingPointError(
                    f"distillation diverged at {n}-step phase epoch {epoch}"
                )
        teacher = student.eval().requires_grad_(False)
        history["phases"].append(n)
        history["loss"][n] = phase_losses
        if save_dir and (save_intermediate or n == target_steps):
            _save_student(trainer, teacher.state_dict(), save_dir, n, phase_losses[-1])
        if n == target_steps:
            break
        n //= 2

    with torch.no_grad():
        trainer.model.load_state_dict(teacher.state_dict())
        if trainer.ema_model is not None:
            trainer.ema_model.load_state_dict(teacher.state_dict())
    return history


def _save_student(trainer, params: dict, save_dir: str, n_steps: int,
                  final_loss: float) -> str:
    return _save_tagged(trainer, params, save_dir, distilled_tag(n_steps),
                        {"distilled_steps": n_steps, "distill_loss": final_loss})


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
