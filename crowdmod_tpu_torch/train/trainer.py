"""Trainer for the DDPM and flow-matching families, with the DiT or UNet3D
backbone, and for the ConvRNN forecaster (port of the JAX package's
``train/trainer.py``: ``_loss_fn``, ``setup``, ``fit``, ``evaluate``,
``resume_from_abort``, ``save``/``load``, ``sample`` with every sampler and
the metric protocol, ``select_ids``/``select_past``/``generate_metrics``).

Weights: ``model`` holds the live training weights; with EMA on, the train
state's second module (``ema_model``) holds their moving average, and
sampling uses it (``sample_weights``) without touching the training
weights.  ``params`` and ``ema_params`` read both as state_dicts in the
reference torch layout.

Randomness: every draw of a training step — t, ε (DDPM) or x0 (FM), the CFG
keep mask and the dropout masks — comes from the trainer's
``torch.Generator`` on its device,
seeded from ``seed`` at the start of :meth:`Trainer.fit`.  :class:`StepDraws`
carries the generator into the loss; a caller may inject any of the draws
instead (``fit(draws=...)``, ``evaluate(draws=...)``).  The metric
protocol likewise draws each batch's window selection and sampler noise from
a generator seeded from ``seed``, or takes them injected as
:class:`ProtocolDraws` (``generate_metrics(draws=...)``).

Data parallelism (``mesh``, a ``("data", "model")`` device mesh over a
process group): ``DATASET.BATCH_SIZE`` is the global batch.  Every process
reads the same shuffled batch and trains on its rows
(:func:`~crowdmod_tpu_torch.parallel.multiprocess.global_batch`) under DDP
(``param_sharding="tp"``) or FSDP (``"fsdp"``); each draws the global
batch's draws from the shared generator and keeps its rows (the dropout
masks through :class:`~crowdmod_tpu_torch.ops.dropout.BatchRows`), so a run
on W processes takes the steps of the one-process run.  A "model" axis
over more than one process adds tensor parallelism: the model is cut to
each rank's output features (:func:`~crowdmod_tpu_torch.parallel.sharding.
shard_params`), the EMA alike, and the rows are cut by the data index, so
the ranks of one model group train on the same rows with the same draws.
The epoch and eval losses are averaged over the data axis, and held equal
on every process, since they decide the learning rate, the NaN watchdog
and the checkpoints.  Sampling splits the batch over the data axis and
gathers the samples; checkpoints are collective and written once, in the
one-process format.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from dataclasses import dataclass

import numpy as np
import torch

from crowdmod_tpu_torch.config import FrozenConfig
from crowdmod_tpu_torch.core.schedule import (
    ddim_tau_schedule,
    linear_schedule,
    respaced_taus,
)
from crowdmod_tpu_torch.data.windows import WindowDataset
from crowdmod_tpu_torch.metrics.generator import MetricsEngine, compute_metrics
from crowdmod_tpu_torch.models import factory
from crowdmod_tpu_torch.models.convrnn import convrnn_loss, exp_log_channels
from crowdmod_tpu_torch.models.diffusion import (
    as_eps_fn,
    ddim_eta_sample,
    ddim_sample,
    ddpm_loss,
    ddpm_sample,
    distilled_sample,
    dpm_solver_sample,
)
from crowdmod_tpu_torch.models.diffusion.ddpm import Noise, gaussian_noise
from crowdmod_tpu_torch.models.flow_matching import INTEGRATORS, fm_loss
from crowdmod_tpu_torch.models.guidance import cfg_denoise_fn, drop_condition
from crowdmod_tpu_torch.ops.dropout import BatchRows
from crowdmod_tpu_torch.parallel import multiprocess
from crowdmod_tpu_torch.train import checkpoint as ckpt
from crowdmod_tpu_torch.train.optim import (
    PlateauState,
    adam,
    get_learning_rate,
    set_learning_rate,
)
from crowdmod_tpu_torch.train.state import TrainState, ema_copy, train_step
from crowdmod_tpu_torch.utils.tracker import RunTracker


def solver_node(cfg: FrozenConfig, arch: str) -> FrozenConfig:
    """The ``TRAIN`` node of ``arch``: ``MODEL.CONVRNN.TRAIN`` or the
    backbone's."""
    if arch == "ConvRNN":
        return cfg.MODEL.CONVRNN.TRAIN
    return factory.backbone_cfg(cfg, arch).TRAIN


def check_sampler_guidance(node) -> None:
    """Refuse the fast samplers' guided configs (the eager sampler and an
    export alike), rather than sample them unguided: DPM-Solver implements
    no guidance; a distilled student jumps along the trajectories it was
    trained on, and guidance or a CFG-scaled denoiser would push x off
    them."""
    if node.SAMPLER == "DPM-Solver" and node.GUIDANCE not in ("None", None):
        raise ValueError(
            "the DPM-Solver sampler does not implement "
            f"guidance; got GUIDANCE={node.GUIDANCE!r} — use "
            "DDPM, DDIM, or DDIM-eta for guided sampling"
        )
    if node.SAMPLER == "Distilled":
        if node.GUIDANCE not in ("None", None):
            raise ValueError(
                "the Distilled sampler is guidance-free; trained "
                f"trajectories ignore GUIDANCE={node.GUIDANCE!r}"
            )
        if float(node.get("CFG_SCALE", 1.0)) != 1.0:
            raise ValueError(
                "the Distilled sampler is guidance-free; a CFG-"
                "scaled denoiser would push x off the trajectory "
                f"the student was trained on (CFG_SCALE="
                f"{node.CFG_SCALE})"
            )


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent (the port runs on the card unless told to use the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on the GPU by default "
                "— pass device='cpu' to run on the CPU"
            )
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; expected cuda or cpu")
    return device


@dataclass
class StepDraws:
    """The random draws of one loss evaluation.  Each of ``t`` (B,): the
    DDPM timestep, or FM's uniform time; ``eps`` (DDPM) or ``x0`` (FM), the
    future's shape; and ``keep`` (the CFG keep mask, (B,) bool) left None is
    drawn from ``generator``, as are the dropout masks."""

    generator: torch.Generator | None = None
    t: torch.Tensor | None = None
    eps: torch.Tensor | None = None
    keep: torch.Tensor | None = None
    x0: torch.Tensor | None = None


@dataclass
class ProtocolDraws:
    """The random draws of one protocol batch of
    :meth:`Trainer.generate_metrics`: ``perm`` (the permutation of the
    batch's rows that :meth:`Trainer.select_ids` selects from) and
    ``noise`` (the sampler's draws, see
    :mod:`crowdmod_tpu_torch.models.diffusion.ddpm`); each left None is
    drawn from ``generator``."""

    generator: torch.Generator | None = None
    perm: torch.Tensor | None = None
    noise: Noise | None = None


class _StepTimer:
    """Each step's milliseconds: on the card a pair of CUDA events around
    it, read after the epoch (no synchronization between steps); on the
    CPU, whose operations run as they are called, the host clock."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._stream = torch.cuda.current_stream(device) if self._cuda else None
        self._spans: list = []

    def __enter__(self):
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            self._spans.append([start, None])
        else:
            self._spans.append([time.perf_counter(), None])

    def __exit__(self, *exc):
        span = self._spans[-1]
        if self._cuda:
            span[1] = torch.cuda.Event(enable_timing=True)
            span[1].record(self._stream)
        else:
            span[1] = time.perf_counter()

    def ms(self) -> list[float]:
        if self._cuda:
            if self._spans:
                self._spans[-1][1].synchronize()
            return [a.elapsed_time(b) for a, b in self._spans]
        return [1e3 * (b - a) for a, b in self._spans]


class Trainer:
    def __init__(
        self,
        cfg: FrozenConfig,
        arch: str,
        mprops_count: int | None = None,
        *,
        device="cuda",
        run_dir: str | None = None,
        compute_dtype: torch.dtype | None = None,
        seed: int = 42,
        conv_impl: str = "im2col",
        mesh=None,
        param_sharding: str = "tp",
    ):
        self.device = resolve_device(device)
        if param_sharding not in ("tp", "fsdp"):
            raise ValueError(f"unknown param-sharding mode {param_sharding!r}; "
                             "expected 'tp' or 'fsdp'")
        # "tp": DDP over "data" (weights replicated, or cut over "model");
        # "fsdp": parameters, Adam moments and EMA also sharded over "data".
        self.mesh = mesh
        self.param_sharding = param_sharding
        self.conv_impl = conv_impl
        self.cfg = cfg
        self.arch = arch
        self.family = "ConvRNN" if arch == "ConvRNN" else arch.split("-")[0]
        # ConvRNN models all 4 macroprops; the generative models 3.
        self.mprops_count = (mprops_count if mprops_count is not None
                             else (4 if arch == "ConvRNN" else 3))
        if compute_dtype is None:
            # bf16 where the JAX package would use it, with the card in the
            # TPU's place; float32 on the CPU.
            name = cfg.get_path("TPU.COMPUTE_DTYPE", "float32")
            compute_dtype = (
                torch.bfloat16
                if (name == "bfloat16" and self.device.type == "cuda")
                else torch.float32
            )
        self.compute_dtype = compute_dtype
        self.model = factory.build_backbone(
            cfg, arch, self.mprops_count, dtype=compute_dtype,
            conv_impl=conv_impl,
        )
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()
        # What training calls: the model, or its DDP wrapper.  ``model``
        # stays the bare module that sampling, checkpoints and the EMA read
        # (under FSDP, sharded in place).
        self._train_module = self.model
        if mesh is not None:
            from crowdmod_tpu_torch.parallel.sharding import shard_params

            self._train_module = shard_params(self.model, mesh, param_sharding)
        self.seed = seed
        # "ema" (EMA weights when present) or "raw" (the training weights).
        self.sample_weights = "ema"
        self.run_dir = run_dir or os.path.join(cfg.DATA_FS.OUTPUT_DIR, "runs", arch)
        train = solver_node(cfg, arch)
        self.total_epochs = train.EPOCHS
        self.ema_decay = float(train.get("EMA_DECAY", 0.0))
        solver = train.SOLVER
        self.plateau = PlateauState(
            lr=solver.LR,
            factor=solver.SCHEDULER.FACTOR,
            patience=solver.SCHEDULER.PATIENCE,
            min_lr=solver.SCHEDULER.MIN_LR,
        )
        self.sched = (
            linear_schedule(cfg.MODEL.DDPM.TIMESTEPS, scale=cfg.MODEL.DDPM.SCALE)
            if self.family == "DDPM" else None
        )
        self.state = self._new_state()
        self._ready = False
        self._resumed = False

    def _new_state(self) -> TrainState:
        solver = solver_node(self.cfg, self.arch).SOLVER
        opt = adam(self.model.parameters(), self.plateau.lr, tuple(solver.BETAS),
                   solver.WEIGHT_DECAY, amsgrad=self.arch == "ConvRNN")
        ema = self._ema_copy() if self.ema_decay else None
        return TrainState(self.model, opt, ema_decay=self.ema_decay, ema_model=ema)

    def _ema_copy(self):
        """A module to hold the EMA, equal to the weights: a copy of the
        model, or under FSDP a new model sharded the same way, so that the
        average updates shard by shard."""
        if not (self.mesh is not None and self.param_sharding == "fsdp"):
            return ema_copy(self.model)
        from crowdmod_tpu_torch.parallel.sharding import shard_params

        ema = factory.build_backbone(self.cfg, self.arch, self.mprops_count,
                                     dtype=self.compute_dtype, conv_impl=self.conv_impl)
        ema = shard_params(ema.to(self.device), self.mesh, "fsdp")
        with torch.no_grad():
            for e, p in zip(ema.parameters(), self.model.parameters()):
                e.copy_(p)
        return ema.eval().requires_grad_(False)

    @property
    def ema_model(self):
        return self.state.ema_model

    @property
    def params(self) -> dict:
        """The training weights as a state_dict (views of the model's; under
        FSDP whole tensors, gathered: every process must read it)."""
        return ckpt.full_state_dict(self.model)

    @property
    def ema_params(self) -> dict | None:
        return None if self.ema_model is None else ckpt.full_state_dict(self.ema_model)

    def _grid_shapes(self):
        c = self.cfg
        return (
            c.DATASET.PAST_LEN, c.DATASET.FUTURE_LEN,
            c.MACROPROPS.ROWS, c.MACROPROPS.COLS,
        )

    # ------------------------------------------------------------------
    # Setup
    # ------------------------------------------------------------------
    def _loss_fn(self, *, deterministic: bool = False):
        """Loss closure ``(batch, draws) -> loss``; ``deterministic=True``
        is the eval variant: dropout and the CFG condition drop off."""
        model = self.model if deterministic else self._train_module
        sched, device = self.sched, self.device
        if self.family == "ConvRNN":
            tf = bool(self.cfg.MODEL.CONVRNN.TEACHER_FORCING)
            eps = self.cfg.MACROPROPS.EPS

            def convrnn(batch, draws: StepDraws) -> torch.Tensor:
                past, future = (x.to(device) for x in batch)
                pred = model(past, target=future, teacher_forcing=tf)
                rho_loss, vel_loss, _, _ = convrnn_loss(pred, future, eps)
                return rho_loss + vel_loss

            return convrnn
        node = getattr(self.cfg.MODEL, self.family)  # MODEL.DDPM or MODEL.FM
        cfg_drop = float(node.get("CFG_DROP_PROB", 0.0))

        if self.family == "DDPM":
            pred_type = node.get("PRED_TYPE", "eps")

            def family_loss(u_fn, future, past, draws, gen):
                return ddpm_loss(u_fn, sched, future, past, t=draws.t, eps=draws.eps,
                                 generator=gen, pred_type=pred_type)
        else:
            w_type, tmax = node.W_TYPE, node.TIME_MAX_POS

            def family_loss(u_fn, future, past, draws, gen):
                return fm_loss(u_fn, future, past, t=draws.t, x0=draws.x0, generator=gen,
                               w_type=w_type, time_max_pos=tmax)

        def loss(batch, draws: StepDraws) -> torch.Tensor:
            past, future = (x.to(device) for x in batch)
            model.train(not deterministic)
            if cfg_drop > 0.0 and not deterministic:
                past = drop_condition(past, cfg_drop, keep=draws.keep,
                                      generator=draws.generator)
            gen = draws.generator
            return family_loss(lambda x, t, c: model(x, t, c, generator=gen),
                               future, past, draws, gen)

        return loss

    def resume_from_abort(self) -> bool:
        """Restore the emergency 'abort' checkpoint when present; → True
        when the state was restored."""
        path = os.path.join(
            self.cfg.DATA_FS.SAVE_DIR,
            ckpt.checkpoint_name(self.cfg, self.arch, "abort"),
        )
        if not os.path.isdir(path):
            return False
        self.load(path)
        self._resumed = True
        logging.info("resumed from emergency checkpoint %s", path)
        return True

    def setup(self, baseline_ckpt: str | None = None):
        """A fresh train state (step 0, new Adam moments, EMA copied from the
        weights); ``baseline_ckpt`` warm-starts the weights only."""
        if baseline_ckpt:
            payload, _ = ckpt.load_checkpoint(baseline_ckpt)
            ckpt.load_full_state_dict(self.model, payload["params"])
            logging.info("baseline checkpoint loaded from %s", baseline_ckpt)
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(
                f"TRAIN.EMA_DECAY must be in [0, 1); got {self.ema_decay}"
            )
        self.state = self._new_state()
        self._train_loss = self._loss_fn()
        self._ready = True
        return self

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _train_step(self, batch, draws: StepDraws) -> torch.Tensor:
        return train_step(self.state, self._train_loss, batch, draws)

    # ------------------------------------------------------------------
    # Data parallelism
    # ------------------------------------------------------------------
    def _rank_draws(self, draws: StepDraws, future: torch.Tensor, *,
                    deterministic: bool) -> StepDraws:
        """This process's rows of the global batch's draws: each draw the
        loss makes for the whole batch (``future``, B rows) that ``draws``
        does not inject, from its generator in the loss's order (the CFG
        keep mask, then t and ε, or x0 and t), then every draw cut to this
        process's rows; the generator goes on as a :class:`BatchRows` for
        the dropout masks."""
        if self.family == "ConvRNN":  # its loss draws nothing
            return draws
        b, dev, gen = future.shape[0], self.device, draws.generator
        keep, t, eps, x0 = draws.keep, draws.t, draws.eps, draws.x0
        node = getattr(self.cfg.MODEL, self.family)
        cfg_drop = float(node.get("CFG_DROP_PROB", 0.0))
        if cfg_drop > 0.0 and not deterministic and keep is None:
            keep = torch.rand((b,), generator=gen, device=dev) < 1.0 - cfg_drop
        if self.family == "DDPM":
            if t is None:
                t = torch.randint(0, self.sched.timesteps, (b,), generator=gen, device=dev)
            if eps is None:
                eps = torch.randn(future.shape, generator=gen, device=dev, dtype=future.dtype)
        else:
            if x0 is None:
                x0 = torch.randn(future.shape, generator=gen, device=dev, dtype=future.dtype)
            if t is None:
                t = torch.rand((b,), generator=gen, device=dev)
        rows = multiprocess.rank_rows(b, self.mesh)

        def cut(x):
            return None if x is None else x[rows]

        return StepDraws(
            generator=None if gen is None else BatchRows(gen, rows.start, rows.stop, b),
            t=cut(t), eps=cut(eps), keep=cut(keep), x0=cut(x0))

    def _rank_args(self, batch, draws: StepDraws, *, deterministic: bool = False):
        """``(batch, draws)`` of this process: its rows of both under a
        mesh, both as they are without one."""
        if self.mesh is None:
            return batch, draws
        return (multiprocess.global_batch(batch, self.mesh),
                self._rank_draws(draws, batch[1], deterministic=deterministic))

    def _process_mean(self, losses: torch.Tensor, name: str) -> torch.Tensor:
        """``losses`` (one a batch) averaged over the processes — the global
        batch's losses: every process holds an equal share of the rows —
        and held equal on every process, since they decide the learning
        rate, the NaN watchdog and the checkpoints: a process that branched
        alone would wait alone in the collective save."""
        if self.mesh is None:
            return losses
        losses = multiprocess.mean_over_processes(losses, self.mesh)
        if not multiprocess.all_processes_equal(losses, name=name):
            raise RuntimeError(f"the {name} differs between the processes")
        return losses

    def fit(
        self,
        train_ds: WindowDataset,
        val_ds: WindowDataset | None = None,
        *,
        baseline_ckpt: str | None = None,
        epochs: int | None = None,
        tracker: RunTracker | None = None,
        draws=None,
    ) -> dict:
        """Train for ``epochs`` (default ``TRAIN.EPOCHS``); → history: an
        epoch's ``train_loss``, ``val_loss`` and ``lr``, its per-step losses
        (``step_loss``) and milliseconds (``step_ms``: CUDA events on the
        card, read once the epoch's losses are), and ``aborted``.

        ``train_ds``: a :class:`WindowDataset`, or anything with its
        ``batches(batch_size, shuffle=, seed=)`` (a
        :class:`~crowdmod_tpu_torch.data.prefetch.FileWindowStream`).
        ``draws``: a callable giving each step's :class:`StepDraws` (default:
        the trainer's generator), for the global batch under a mesh."""
        if not self._ready:
            self.setup(baseline_ckpt)
        epochs = epochs or self.total_epochs
        cfg = self.cfg
        batch_size = cfg.DATASET.BATCH_SIZE
        if hasattr(train_ds, "__len__") and len(train_ds) < batch_size:
            raise ValueError(
                f"training dataset yields no full batches: {len(train_ds)} "
                f"windows < DATASET.BATCH_SIZE={batch_size}; lower the batch "
                "size or provide more data"
            )
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        next_draws = draws or (lambda: StepDraws(generator=gen))

        save_dir = cfg.DATA_FS.SAVE_DIR
        keep = cfg.get_path(f"MODEL.{self.family.upper()}.CHECKPOINTS_TO_KEEP", 0)
        rng = np.random.default_rng(self.seed)
        late = []
        if keep:
            # Without replacement, from the last 25% of the epochs:
            # duplicates would save fewer late checkpoints than configured.
            lo = max(1, int(epochs * 0.75))
            pool = np.arange(lo, epochs + 1)
            late = rng.choice(pool, size=min(keep, len(pool)), replace=False)

        own_tracker = tracker is None
        if own_tracker:
            tracker = RunTracker(self.run_dir, config=cfg, use_wandb=False)

        best = float("inf")
        if self._resumed:
            # A resumed run must not overwrite '000' with a first epoch worse
            # than the pre-crash best; a fresh run may replace a stale one.
            prev = ckpt.read_metadata(os.path.join(
                save_dir, ckpt.checkpoint_name(cfg, self.arch, "000")))
            if prev and isinstance(prev.get("epoch_loss"), (int, float)):
                best = float(prev["epoch_loss"])
        nan_streak = 0
        completed = aborted = False
        history = {"train_loss": [], "val_loss": [], "lr": [], "step_loss": [],
                   "step_ms": [], "aborted": False}

        # SIGINT lands only at step boundaries, so the emergency save below
        # sees a whole step's state; a second Ctrl-C interrupts at once.
        deferred = {"sig": False}

        def defer_sigint(signum, frame):
            if deferred["sig"]:
                raise KeyboardInterrupt
            deferred["sig"] = True
            logging.warning("SIGINT received; aborting at the next step boundary "
                            "(press again to interrupt immediately)")

        def boundary():
            if deferred["sig"]:
                raise KeyboardInterrupt

        try:
            prev_handler = signal.signal(signal.SIGINT, defer_sigint)
        except ValueError:
            prev_handler = None  # not the main thread; leave delivery as-is
        try:
            for epoch in range(1, epochs + 1):
                losses, timer = [], _StepTimer(self.device)
                for batch in train_ds.batches(batch_size, shuffle=True,
                                              seed=self.seed + epoch):
                    args = self._rank_args(batch, next_draws())
                    with timer:
                        losses.append(self._train_step(*args))
                    boundary()
                step_losses = self._process_mean(torch.stack(losses), "step losses")
                epoch_loss = float(step_losses.mean())
                history["step_ms"].append(timer.ms())
                val_loss = None if val_ds is None else self.evaluate(val_ds)

                self.plateau = self.plateau.step(epoch_loss)
                set_learning_rate(self.state.optimizer, self.plateau.lr)
                lr = get_learning_rate(self.state.optimizer)
                history["train_loss"].append(epoch_loss)
                history["step_loss"].append(step_losses.tolist())
                history["val_loss"].append(val_loss)
                history["lr"].append(lr)
                log = {"train_loss": epoch_loss, "lr": lr}
                if val_loss is not None:
                    log["val_loss"] = val_loss
                tracker.log(log, step=epoch)

                # NaN watchdog: 3 consecutive NaN epochs abort the run.
                if np.isnan(epoch_loss):
                    nan_streak += 1
                    logging.warning("epoch %d: NaN loss (%d consecutive)", epoch,
                                    nan_streak)
                    if nan_streak >= 3:
                        # Not a completed run: the retention sweep below must
                        # not delete earlier runs' checkpoints on its account.
                        logging.error("3 consecutive NaN epochs; aborting")
                        aborted = True
                        break
                else:
                    nan_streak = 0

                if epoch_loss < best:
                    best = epoch_loss
                    self.save(save_dir, "000", extra={"epoch_loss": epoch_loss})
                if epoch in late:
                    self.save(save_dir, epoch, extra={"epoch_loss": epoch_loss})
                boundary()
            completed = not aborted
            history["aborted"] = aborted
        except BaseException:
            if multiprocess.process_count() > 1:
                # The save is collective, and the other processes may be
                # anywhere: resume from the last committed checkpoint.
                logging.error("training aborted on process %d; the emergency "
                              "checkpoint is skipped in a multi-process run",
                              multiprocess.process_index())
                raise
            # Persist the in-flight state so a long run resumes
            # (resume_from_abort) instead of restarting.
            try:
                self.save(save_dir, "abort")
                logging.error("training aborted; emergency checkpoint saved")
            except Exception:
                logging.exception("emergency checkpoint failed")
            raise
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGINT, prev_handler)
            if own_tracker:
                tracker.finish()
            self.model.eval()
        if completed and multiprocess.is_main():
            # The crash-recovery point is obsolete and only the newest `keep`
            # late checkpoints stay; with keep == 0 the sweep is skipped (it
            # would delete numbered checkpoints of earlier runs).
            ckpt.gc_checkpoints(save_dir, cfg, self.arch,
                                keep_epochs=keep if keep else None, remove_abort=True)
        return history

    def evaluate(self, ds: WindowDataset, *, draws=None) -> float:
        """Mean eval loss over ``ds`` with the training weights: dropout and
        the CFG drop off, no gradient, draws from a generator seeded 0 each
        call (``draws`` injects them instead).  Full batches only, as the
        reference's val loader (a dataset under one batch keeps its one
        partial batch)."""
        if not hasattr(self, "_eval_loss"):
            self._eval_loss = self._loss_fn(deterministic=True)
        gen = torch.Generator(device=self.device).manual_seed(0)
        next_draws = draws or (lambda: StepDraws(generator=gen))
        batch_size = self.cfg.DATASET.BATCH_SIZE
        losses = []
        with torch.no_grad():
            for batch in ds.batches(batch_size, shuffle=False,
                                    drop_last=len(ds) >= batch_size):
                rows, draws = self._rank_args(batch, next_draws(), deterministic=True)
                losses.append(torch.as_tensor(self._eval_loss(rows, draws)))
        self.model.eval()
        return float(self._process_mean(torch.stack(losses), "eval losses").mean())

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    def save(self, save_dir: str, epoch: int | str, extra: dict | None = None):
        """The weights, EMA, step, Adam state and learning rate, with the
        JAX package's metadata, under ``save_dir``.  Under a mesh every
        process calls it: the state is gathered whole and process 0 writes
        the files of a one-process save."""
        name = ckpt.checkpoint_name(self.cfg, self.arch, epoch)
        payload = {
            "params": self.params,
            "step": self.state.step,
            "optimizer": ckpt.full_optimizer_state(self.state.optimizer, self.model),
            "lr": get_learning_rate(self.state.optimizer),
        }
        if self.ema_model is not None:
            payload["ema_params"] = self.ema_params
        meta = ckpt.build_metadata(self.cfg, self.arch, epoch, extra)
        save = ckpt.save_checkpoint if self.mesh is None else ckpt.commit_checkpoint
        return save(os.path.join(save_dir, name), payload, meta)

    def load(self, path: str):
        """Load a port checkpoint directory — weights, EMA and, where it
        holds them, the step, Adam state and learning rate; returns its
        metadata."""
        if not self._ready:
            self.setup()
        payload, meta = ckpt.load_checkpoint(path)
        want = set(self.model.state_dict())
        for name in ("params", "ema_params"):
            if name in payload and set(payload[name]) != want:
                got = set(payload[name])
                raise ValueError(
                    f"checkpoint {path} {name} does not fit the configured "
                    f"model: missing {sorted(want - got)}, unexpected "
                    f"{sorted(got - want)}"
                )
        state = self.state
        ckpt.load_full_state_dict(self.model, payload["params"])
        if "ema_params" in payload and state.ema_model is None:
            state.ema_model = self._ema_copy()
        if state.ema_model is not None:
            # EMA enabled but the checkpoint predates it: seed from weights.
            ckpt.load_full_state_dict(state.ema_model,
                                      payload.get("ema_params", payload["params"]))
        if "step" in payload:
            state.step = int(payload["step"])
        if "optimizer" in payload:
            ckpt.load_optimizer_state(state.optimizer, payload["optimizer"], self.model)
            self.plateau = self.plateau._replace(lr=get_learning_rate(state.optimizer))
        return meta

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------
    def _sample_model(self):
        """The EMA module when present (smoother samples), else the model
        with the raw training weights."""
        if self.sample_weights == "raw" or self.ema_model is None:
            return self.model
        return self.ema_model

    def _denoise_fn(self, model=None):
        """The sampler's denoiser over ``model`` (default: the sampling
        weights' module, in eval mode), with classifier-free guidance; for
        DDPM in eps space (the PRED_TYPE adapter), for FM the velocity."""
        model = (self._sample_model() if model is None else model).eval()
        node = getattr(self.cfg.MODEL, self.family)
        fn = cfg_denoise_fn(model, float(node.get("CFG_SCALE", 1.0)))
        if self.family == "FM":
            return fn
        return as_eps_fn(fn, self.sched, node.get("PRED_TYPE", "eps"))

    @torch.no_grad()
    def sample(
        self,
        past,
        generator: torch.Generator | None = None,
        *,
        noise=None,
        history: bool = False,
    ):
        """Generate future blocks conditioned on ``past`` ``(N, P, H, W, C)``
        with the configured sampler; returns ``(N, F, H, W, C)`` on the
        trainer's device.  Draws come from ``generator`` (a generator on that
        device) unless ``noise`` injects them (see
        :mod:`crowdmod_tpu_torch.models.diffusion.ddpm`).  ConvRNN draws
        nothing: its rollout is deterministic.

        Under a mesh (``history`` aside) every process calls it with the
        same batch: the batch is padded to a multiple of the data size by
        repeating its last row, each data index samples its rows with its
        rows of each step's draws for the whole batch (drawn a step at a
        time; a model group's ranks sample theirs together), and the samples
        are gathered on every process, padding cut."""
        past = torch.as_tensor(past, dtype=torch.float32, device=self.device)
        if self.mesh is None or history:
            return self._sample_impl(past, generator, noise=noise, history=history)
        n = past.shape[0]
        pad = (-n) % multiprocess.data_coords(self.mesh)[1]
        rows = multiprocess.rank_rows(n + pad, self.mesh)

        def padded(x):
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x

        if self.family != "ConvRNN":
            whole = noise
            if whole is None:
                if generator is None:
                    raise ValueError("sampling needs noise= or an explicit generator")
                _, f, h, w = self._grid_shapes()
                whole = gaussian_noise((n, f, h, w, self.mprops_count), self.device,
                                       generator)

            def noise(t):  # this process's rows of the whole batch's draw
                return padded(whole(t))[rows]

        out = self._sample_impl(padded(past)[rows], None, noise=noise)
        return multiprocess.all_gather_rows(out, self.mesh)[:n]

    def _sample_impl(self, past, generator, *, noise=None, history=False):
        _, f, h, w = self._grid_shapes()
        shape = (past.shape[0], f, h, w, self.mprops_count)
        if self.family == "ConvRNN":
            # The deterministic rollout, density and variance exp'd out of
            # log space.
            out = self._sample_model().eval()(past, future_len=f, teacher_forcing=False)
            return exp_log_channels(out)
        if self.family == "FM":
            # The integrators keep no trajectory: ``history`` is ignored, as
            # in the JAX package.
            node = self.cfg.MODEL.FM
            try:
                integrator = INTEGRATORS[node.INTEGRATOR]
            except KeyError:
                raise ValueError(
                    f"unknown integrator {node.INTEGRATOR!r}; "
                    f"expected {list(INTEGRATORS)}"
                ) from None
            steps = getattr(node.INTEGRATOR_STEPS, node.INTEGRATOR.upper())
            return integrator(
                self._denoise_fn(), past, shape, steps=steps,
                time_max_pos=node.TIME_MAX_POS, noise=noise, generator=generator,
                device=self.device,
            )
        node = self.cfg.MODEL.DDPM
        common = dict(
            noise=noise, generator=generator, device=self.device,
            guidance=node.GUIDANCE,
            lambda_guidance=node.get("LAMBDA_GUIDANCE", 0.0), history=history,
        )
        fn = self._denoise_fn()
        if node.SAMPLER == "DDIM":
            taus = ddim_tau_schedule(node.TIMESTEPS, node.DDIM_DIVIDER)
            return ddim_sample(
                fn, self.sched, past, shape, taus, sigma=node.SIGMA, **common
            )
        if node.SAMPLER == "DDIM-eta":
            taus = respaced_taus(node.TIMESTEPS, node.get("ETA_STEPS", 50))
            return ddim_eta_sample(
                fn, self.sched, past, shape, taus,
                eta=node.get("ETA", 1.0), **common,
            )
        check_sampler_guidance(node)
        if node.SAMPLER == "DPM-Solver":
            return dpm_solver_sample(
                fn, self.sched, past, shape, steps=node.get("DPM_STEPS", 20),
                noise=noise, generator=generator, device=self.device, history=history,
            )
        if node.SAMPLER == "Distilled":
            return distilled_sample(
                fn, self.sched, past, shape, node.get("DISTILL_STEPS", 8),
                eta=float(node.get("DISTILL_ETA", 0.0)), noise=noise,
                generator=generator, device=self.device, history=history,
            )
        if node.SAMPLER != "DDPM":
            raise ValueError(f"unknown DDPM sampler {node.SAMPLER!r}")
        return ddpm_sample(fn, self.sched, past, shape, **common)

    # ------------------------------------------------------------------
    # Metric protocol
    # ------------------------------------------------------------------
    @staticmethod
    def select_ids(
        n: int,
        nsamples: int,
        generator: torch.Generator | None = None,
        *,
        perm=None,
        same_past: bool = False,
        chunk: int = 1,
    ) -> torch.Tensor:
        """Window ids of the sampling protocol: the first ``nsamples`` of a
        permutation of ``range(n)`` (``perm``, or drawn from ``generator``
        on its device), each repeated ``chunk`` times in a row, and wrapped
        around so that there are always exactly ``nsamples`` (a ragged
        batch does not change the sampler's batch)."""
        if perm is None:
            if generator is None:
                raise ValueError("select_ids needs perm or an explicit generator")
            perm = torch.randperm(n, generator=generator, device=generator.device)
        idx = torch.as_tensor(perm)[: min(nsamples, n)]
        if same_past:
            idx = idx[:1].repeat(idx.shape[0])
        if chunk > 1:
            idx = idx.repeat_interleave(chunk)
        if idx.shape[0] < nsamples:
            idx = idx.repeat(-(-nsamples // idx.shape[0]))
        return idx[:nsamples]

    @staticmethod
    def select_past(
        past: torch.Tensor,
        future: torch.Tensor,
        nsamples: int,
        generator: torch.Generator | None = None,
        *,
        perm=None,
        same_past: bool = False,
        chunk: int = 1,
    ):
        """The protocol's rows of a batch: ``(past[idx], future[idx], idx)``
        with ``idx`` from :meth:`select_ids`."""
        idx = Trainer.select_ids(past.shape[0], nsamples, generator, perm=perm,
                                 same_past=same_past, chunk=chunk)
        idx = idx.to(past.device)
        return past[idx], future[idx], idx

    def generate_metrics(
        self,
        test_ds: WindowDataset,
        *,
        metric: str = "ALL",
        chunk: int = 20,
        batches_to_use: int = 1,
        output_dir: str | None = None,
        epoch_tag: str | int = "000",
        seed: int = 42,
        draws=None,
        boxplots: bool = False,
    ) -> dict:
        """The repeated-past protocol and the metric suite: each of the
        first ``batches_to_use`` batches of ``BATCH_SIZE × chunk`` test
        windows gives ``BATCH_SIZE`` windows, each sampled ``chunk`` times
        in one :meth:`sample` call; the metrics of the samples against
        their futures are written under ``output_dir`` (default: the run
        directory) and returned.

        ``draws``: a callable giving each protocol batch's
        :class:`ProtocolDraws` (default: a generator seeded ``seed`` on the
        trainer's device).  ``boxplots``: also draw the boxplot PNGs (the
        JAX method always does; here the caller asks, since the card's host
        may have no matplotlib)."""
        cfg = self.cfg
        samples_per_batch = cfg.DATASET.BATCH_SIZE * chunk
        gen = torch.Generator(device=self.device).manual_seed(seed)
        next_draws = draws or (lambda: ProtocolDraws(generator=gen))
        preds, gts = [], []
        # drop_last as the reference's test DataLoader; with fewer windows
        # than one batch the one partial batch is kept and the selection
        # wraps it around to samples_per_batch rows.
        drop_last = len(test_ds) >= samples_per_batch
        t0 = time.perf_counter()
        for b, (past, future) in enumerate(
            test_ds.batches(samples_per_batch, shuffle=False, drop_last=drop_last)
        ):
            if b >= batches_to_use:
                break
            d = next_draws()
            past_s, future_s, _ = self.select_past(
                past, future, samples_per_batch, d.generator, perm=d.perm,
                chunk=chunk)
            preds.append(self.sample(past_s, d.generator, noise=d.noise))
            gts.append(future_s.to(self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the sampling time, logged
        t1 = time.perf_counter()

        pred = torch.cat(preds)[..., :3]
        gt = torch.cat(gts)[..., :3]
        engine = MetricsEngine(
            pred, gt, cfg.METRICS,
            output_dir=output_dir or self.run_dir,
            past_len=cfg.DATASET.PAST_LEN,
        )
        title = (
            f"{cfg.DATASET.BATCH_SIZE * chunk * batches_to_use} samples in "
            f"total (BS:{cfg.DATASET.BATCH_SIZE}, Rep:{chunk}, "
            f"TB:{batches_to_use})-({self.arch})"
        )
        data = compute_metrics(
            engine, metric, chunk,
            eps=cfg.MACROPROPS.EPS,
            run_tag=ckpt.run_tag(cfg, self.arch, epoch_tag),
            title=title,
            samples_per_batch=samples_per_batch,
            boxplots=boxplots,
        )
        logging.info("metric protocol: %d samples in %d sample call(s), "
                     "sampling %.3f s, metric suite %.3f s", pred.shape[0],
                     len(preds), t1 - t0, time.perf_counter() - t1)
        return data
