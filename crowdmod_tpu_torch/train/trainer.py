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
from crowdmod_tpu_torch.models.diffusion.ddpm import Noise
from crowdmod_tpu_torch.models.flow_matching import INTEGRATORS, fm_loss
from crowdmod_tpu_torch.models.guidance import cfg_denoise_fn, drop_condition
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
    ):
        self.device = resolve_device(device)
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
        return TrainState(self.model, opt, ema_decay=self.ema_decay)

    @property
    def ema_model(self):
        return self.state.ema_model

    @property
    def params(self) -> dict:
        """The training weights as a state_dict (views of the model's)."""
        return self.model.state_dict()

    @property
    def ema_params(self) -> dict | None:
        return None if self.ema_model is None else self.ema_model.state_dict()

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
        model, sched, device = self.model, self.sched, self.device
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
            self.model.load_state_dict(payload["params"])
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
        """Train for ``epochs`` (default ``TRAIN.EPOCHS``); → history.

        ``draws``: a callable giving each step's :class:`StepDraws` (default:
        the trainer's generator)."""
        if not self._ready:
            self.setup(baseline_ckpt)
        epochs = epochs or self.total_epochs
        cfg = self.cfg
        batch_size = cfg.DATASET.BATCH_SIZE
        if len(train_ds) < batch_size:
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
            tracker = RunTracker(self.run_dir, config=cfg)

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
        history = {"train_loss": [], "val_loss": [], "lr": [], "aborted": False}

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
                losses = []
                for batch in train_ds.batches(batch_size, shuffle=True,
                                              seed=self.seed + epoch):
                    losses.append(self._train_step(batch, next_draws()))
                    boundary()
                epoch_loss = float(torch.stack(losses).mean())
                val_loss = None if val_ds is None else self.evaluate(val_ds)

                self.plateau = self.plateau.step(epoch_loss)
                set_learning_rate(self.state.optimizer, self.plateau.lr)
                lr = get_learning_rate(self.state.optimizer)
                history["train_loss"].append(epoch_loss)
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
        if completed:
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
                losses.append(torch.as_tensor(self._eval_loss(batch, next_draws())))
        self.model.eval()
        return float(torch.stack(losses).mean())

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    def save(self, save_dir: str, epoch: int | str, extra: dict | None = None):
        """The weights, EMA, step, Adam state and learning rate, with the
        JAX package's metadata, under ``save_dir``."""
        name = ckpt.checkpoint_name(self.cfg, self.arch, epoch)
        payload = {
            "params": self.params,
            "step": self.state.step,
            "optimizer": self.state.optimizer.state_dict(),
            "lr": get_learning_rate(self.state.optimizer),
        }
        if self.ema_model is not None:
            payload["ema_params"] = self.ema_params
        meta = ckpt.build_metadata(self.cfg, self.arch, epoch, extra)
        return ckpt.save_checkpoint(os.path.join(save_dir, name), payload, meta)

    def load(self, path: str):
        """Load a port checkpoint directory — weights, EMA and, where it
        holds them, the step, Adam state and learning rate; returns its
        metadata."""
        if not self._ready:
            self.setup()
        payload, meta = ckpt.load_checkpoint(path)
        want = set(self.params)
        for name in ("params", "ema_params"):
            if name in payload and set(payload[name]) != want:
                got = set(payload[name])
                raise ValueError(
                    f"checkpoint {path} {name} does not fit the configured "
                    f"model: missing {sorted(want - got)}, unexpected "
                    f"{sorted(got - want)}"
                )
        state = self.state
        self.model.load_state_dict(payload["params"])
        if "ema_params" in payload and state.ema_model is None:
            state.ema_model = ema_copy(self.model)
        if state.ema_model is not None:
            # EMA enabled but the checkpoint predates it: seed from weights.
            state.ema_model.load_state_dict(payload.get("ema_params", payload["params"]))
        if "step" in payload:
            state.step = int(payload["step"])
        if "optimizer" in payload:
            state.optimizer.load_state_dict(payload["optimizer"])
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
        nothing: its rollout is deterministic."""
        past = torch.as_tensor(past, dtype=torch.float32, device=self.device)
        return self._sample_impl(past, generator, noise=noise, history=history)

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
    ) -> dict:
        """The repeated-past protocol and the metric suite: each of the
        first ``batches_to_use`` batches of ``BATCH_SIZE × chunk`` test
        windows gives ``BATCH_SIZE`` windows, each sampled ``chunk`` times
        in one :meth:`sample` call; the metrics of the samples against
        their futures are written under ``output_dir`` (default: the run
        directory) and returned.

        ``draws``: a callable giving each protocol batch's
        :class:`ProtocolDraws` (default: a generator seeded ``seed`` on the
        trainer's device).  The JAX package's boxplots are not written: the
        plots are not ported yet."""
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
        )
        logging.info("metric protocol: %d samples in %d sample call(s), "
                     "sampling %.3f s, metric suite %.3f s", pred.shape[0],
                     len(preds), t1 - t0, time.perf_counter() - t1)
        return data
