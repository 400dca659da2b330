"""Serialized sampler artifacts via ``torch.export`` (port of the JAX
package's ``export_artifact.py``).

A trained sampler — the whole reverse chain, the sampling weights (EMA where
enabled) baked in — is exported as one ``torch.export`` ``ExportedProgram``
a batch bucket, saved with ``torch.export.save`` beside a ``.json``
sidecar.  A later process loads it with :func:`load_sampler` or serves it
with :class:`ArtifactPredictor`, importing only the port's operator library
(:mod:`crowdmod_tpu_torch.ops.kernels`): no model class, config or
checkpoint.  On the card the program calls the port's kernels as the
``crowdmod::`` operators, and their launches count as the wrappers' do.

  * **Calling convention**: ``(past float32 (B, P, H, W, C) on the
    artifact's device, seed int64 scalar on the host) → future``.
  * **Draws** come from the seed inside the program: each is one
    ``crowdmod::normal`` call, a ``torch.Generator`` seeded from ``(seed,
    step)`` (:func:`~crowdmod_tpu_torch.ops.kernels.library.draw_seed`;
    step −1 is x_T), as the JAX package folds each step into its key.  No
    chain's noise is drawn up front: at T = 1000 and batch 64 it would be
    about 1 GB.
  * **One loop**: every sampler's steps run under
    ``torch._higher_order_ops.scan``, so the program holds one traced step
    whatever the step count (T = 1000 ancestral included), as the JAX
    package exports its ``fori_loop``.  The per-step coefficients and
    timesteps are the scan's inputs, tables computed on the host with the
    float32 arithmetic of the eager samplers (:mod:`..models.diffusion`).
    The model is a frozen copy whose conv and fused-block packs are made
    once, before the trace (``UNet3D.pin_packs``).
  * ``--device`` (the JAX ``--platform``): an artifact exported on the card
    runs on a card; one exported on the CPU runs the kernels' plain twins.

Exportable samplers: DDPM (ancestral, guidance None or Sparsity), DDIM and
DDIM-eta (None or Sparsity), the flow-matching Euler and Heun integrators,
and the ConvRNN rollout.  DPM-Solver, Distilled and mass-preservation
guidance are refused (ROADMAP.md Queue 1 item 14).
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from crowdmod_tpu_torch.ops.kernels import fused_ancestral_update
from crowdmod_tpu_torch.ops.kernels.library import normal

NOT_EXPORTABLE = "not exportable yet (ROADMAP.md Queue 1 item 14)"


class SamplerModule(nn.Module):
    """A trainer's configured sampler as ``(past, seed) → future``, over a
    frozen copy of its sampling weights.  Called directly it is the
    un-exported sampler the artifact is held to: both run the same scan."""

    def __init__(self, trainer):
        super().__init__()
        model = copy.deepcopy(trainer._sample_model()).eval().requires_grad_(False)
        if hasattr(model, "pin_packs"):
            model.pin_packs()
        self.model = model
        self.family = trainer.family
        _, f, h, w = trainer._grid_shapes()
        self.future_shape = (f, h, w, trainer.mprops_count)
        if self.family != "ConvRNN":
            device = next(model.parameters()).device
            self._register("start", np.int64(-1))  # x_T's draw
            self.step, self.tables = self._build(trainer, self._denoiser(trainer, device),
                                                 device)

    def _register(self, name: str, value, device=None) -> None:
        """A (non-persistent) buffer from an array or tensor, on ``device``
        or on the host: a trace reads a module's tensors as its own."""
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
        self.register_buffer(name, t if device is None else t.to(device), persistent=False)

    def _denoiser(self, trainer, device) -> Callable:
        """``trainer._denoise_fn`` over the frozen copy, the PRED_TYPE
        adapter reading the schedule from this module's buffers rather than
        the schedule's cache."""
        from crowdmod_tpu_torch.core.schedule import _BUFFERS
        from crowdmod_tpu_torch.models.diffusion.ddpm import as_eps_fn
        from crowdmod_tpu_torch.models.guidance import cfg_denoise_fn

        node = getattr(trainer.cfg.MODEL, self.family)
        fn = cfg_denoise_fn(self.model, float(node.get("CFG_SCALE", 1.0)))
        if self.family == "FM":
            return fn
        for name in _BUFFERS:
            self._register(f"sched_{name}", getattr(trainer.sched, name), device)
        return as_eps_fn(fn, _BufferSchedule(self), node.get("PRED_TYPE", "eps"))

    def _build(self, trainer, fn, device) -> tuple[Callable, tuple[str, ...]]:
        """The configured sampler's step ``(x, past, draw, *row) → x`` over
        the denoiser ``fn``, and the buffers whose rows the scan walks."""
        if self.family == "FM":
            from crowdmod_tpu_torch.models.flow_matching.fm import _time_grid

            node = trainer.cfg.MODEL.FM
            if node.INTEGRATOR not in ("Euler", "Heun"):
                raise ValueError(f"unknown integrator {node.INTEGRATOR!r}")
            n = getattr(node.INTEGRATOR_STEPS, node.INTEGRATOR.upper())
            self._register("ts", _time_grid(n, node.TIME_MAX_POS)[1], device)
            delta = 1.0 / n

            def euler(x, past, draw, t):
                return x + delta * fn(x, t.expand(x.shape[0]), past)

            def heun(x, past, draw, t):
                k1 = fn(x, t.expand(x.shape[0]), past)
                k2 = fn(x + delta * k1, (t + 1.0).expand(x.shape[0]), past)
                return x + 0.5 * delta * (k1 + k2)

            return (euler if node.INTEGRATOR == "Euler" else heun), ("ts",)

        from crowdmod_tpu_torch.core.schedule import ddim_tau_schedule, respaced_taus
        from crowdmod_tpu_torch.models.diffusion.ddpm import (
            ancestral_coefficients,
            check_ddim_guidance,
            ddim_coefficients,
            ddim_eta_coefficients,
            ddim_update,
        )

        node, sched = trainer.cfg.MODEL.DDPM, trainer.sched
        sampler, guidance = node.SAMPLER, node.GUIDANCE
        lam = float(node.get("LAMBDA_GUIDANCE", 0.0))
        if guidance == "mass_preservation":
            raise ValueError(f"mass-preservation guidance is {NOT_EXPORTABLE}: "
                             "its gradient needs autograd inside the loop")
        if sampler == "DDPM":
            ts = np.arange(sched.timesteps - 1, -1, -1)
            self._register("rows", ancestral_coefficients(sched, device).flip(0))
            self._register("z_scale", (ts > 0).astype(np.float32), device)  # z = 0 at t = 0

            def ancestral(x, past, draw, row, t, step, z_scale):
                eps = fn(x, t.expand(x.shape[0]), past)
                return fused_ancestral_update(x, eps, draw(step) * z_scale, row,
                                              lambda_guidance=lam,
                                              sparsity=guidance == "Sparsity")

            step, tables = ancestral, ("rows", "ts", "steps", "z_scale")
        else:
            if sampler == "DDIM-eta":
                ts = respaced_taus(node.TIMESTEPS, node.get("ETA_STEPS", 50))[::-1]
                rows = [ddim_eta_coefficients(sched, t, tp, node.get("ETA", 1.0), lam, guidance)
                        for t, tp in zip(ts, [*ts[1:], -1])]
            elif sampler == "DDIM":
                check_ddim_guidance(guidance)
                ts, rows = zip(*ddim_coefficients(
                    sched, ddim_tau_schedule(node.TIMESTEPS, node.DDIM_DIVIDER), node.SIGMA, lam))
            else:
                raise ValueError(
                    f"the {sampler} sampler is {NOT_EXPORTABLE}; DDPM, DDIM and "
                    "DDIM-eta export")
            self._register("rows", np.array(rows, np.float32), device)

            def ddim(x, past, draw, row, t, step):
                eps = fn(x, t.expand(x.shape[0]), past)
                return ddim_update(x, eps, draw(step), row, guidance)

            step, tables = ddim, ("rows", "ts", "steps")
        self._register("ts", np.array(ts, np.int64), device)
        self._register("steps", np.array(ts, np.int64))  # the draws' keys, on the host
        return step, tables

    def forward(self, past: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        from torch._higher_order_ops.scan import scan

        from crowdmod_tpu_torch.models.convrnn import exp_log_channels

        with torch.no_grad():
            if self.family == "ConvRNN":  # the deterministic rollout
                return exp_log_channels(self.model(
                    past, future_len=self.future_shape[0], teacher_forcing=False))
            shape = (past.shape[0], *self.future_shape)

            def draw(step):
                return normal(seed, step, shape, past.device)

            def body(x, row):
                return self.step(x, past, draw, *row), []

            xs = tuple(getattr(self, name) for name in self.tables)
            return scan(body, draw(self.start), xs)[0]


class _BufferSchedule:
    """A schedule whose device buffers are a :class:`SamplerModule`'s."""

    def __init__(self, module: SamplerModule):
        self.module = module

    def on(self, device) -> dict[str, torch.Tensor]:
        from crowdmod_tpu_torch.core.schedule import _BUFFERS

        return {name: getattr(self.module, f"sched_{name}") for name in _BUFFERS}


def sampler_fn(trainer) -> SamplerModule:
    """The trainer's configured sampler as ``(past, seed int64 scalar) →
    future`` with the sampling weights (EMA when enabled) baked in."""
    return SamplerModule(trainer)


def export_sampler(trainer, path: str | os.PathLike, *, batch_size: int) -> dict:
    """Export the trainer's sampler at ``batch_size`` to ``path`` (+ a
    ``.json`` sidecar), on the trainer's device; returns the sidecar."""
    from torch._export.serde.schema import SCHEMA_VERSION

    p, f, h, w = trainer._grid_shapes()
    c = trainer.mprops_count
    past = torch.zeros((batch_size, p, h, w, c), device=trainer.device)
    seed = torch.tensor(0, dtype=torch.int64)
    program = torch.export.export(sampler_fn(trainer), (past, seed))
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    meta = {
        "format": "torch.export",
        "arch": trainer.arch,
        "platforms": [trainer.device.type],
        "batch_size": batch_size,
        "past_shape": [batch_size, p, h, w, c],
        "future_shape": [batch_size, f, h, w, c],
        "serialization_schema_version": list(SCHEMA_VERSION),
        "torch_version": torch.__version__,
        "bytes": os.path.getsize(path),
    }
    with open(path + ".json", "w") as fh:
        json.dump(meta, fh, indent=2)
    return meta


def load_sampler(path: str | os.PathLike) -> tuple[Callable, dict]:
    """Load an exported sampler: ``(callable(past, seed), metadata)``.  The
    callable takes ``past`` as an array or tensor and ``seed`` as an int,
    and returns the future as a tensor on the artifact's device."""
    import crowdmod_tpu_torch.ops.kernels  # noqa: F401  (the crowdmod:: operators)

    path = os.fspath(path)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as fh:
            meta = json.load(fh)
    program = torch.export.load(path).module()
    device = meta.get("platforms", ["cpu"])[0]

    def sample(past, seed):
        past = torch.as_tensor(past, dtype=torch.float32).to(device)
        with torch.no_grad():
            return program(past, torch.tensor(int(seed), dtype=torch.int64))

    return sample, meta


class ArtifactPredictor:
    """Serving predictor backed by exported artifacts, one a batch bucket:
    ``Predictor``'s surface (``warmup``, ``predict``, ``batch_buckets``,
    ``input_spec``, ``stats``), so it works behind ``ServingApp`` and
    ``BatchingQueue`` unchanged, with no model class, config or checkpoint
    loaded."""

    def __init__(self, paths: Sequence[str | os.PathLike]):
        from crowdmod_tpu_torch.serving import PredictorStats

        if not paths:
            raise ValueError("ArtifactPredictor needs at least one artifact")
        self._fns: dict[int, Callable] = {}
        meta = None
        for p in paths:
            fn, m = load_sampler(p)
            if not m:
                raise ValueError(f"{p}: missing .json metadata sidecar")
            if meta is not None and m["past_shape"][1:] != meta["past_shape"][1:]:
                raise ValueError(
                    f"{p}: geometry {m['past_shape'][1:]} differs from "
                    f"{meta['past_shape'][1:]}"
                )
            self._fns[int(m["batch_size"])] = fn
            meta = meta or m
        self.batch_buckets = tuple(sorted(self._fns))
        _, p_len, h, w, c = meta["past_shape"]
        self._shape = (p_len, meta["future_shape"][1], h, w, c)
        self.arch = meta.get("arch", "?")
        self.meta = meta
        self.stats = PredictorStats()
        self._lock = threading.Lock()
        self._counter = 0

    @property
    def input_spec(self) -> tuple[int, int, int, int, int]:
        return self._shape

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"request batch {n} exceeds largest bucket {self.batch_buckets[-1]}"
        )

    def warmup(self):
        p, _, h, w, c = self._shape
        for b in self.batch_buckets:
            self.predict(np.zeros((b, p, h, w, c), np.float32), seed=0)
        return self

    def predict(self, past, seed: int | None = None) -> np.ndarray:
        """``(N, P, H, W, C)`` past → ``(N, F, H, W, C)`` future, N padded
        to the nearest bucket; without a seed, the next of a counter."""
        past = np.asarray(past, np.float32)
        n = past.shape[0]
        bucket = self._bucket(n)
        if bucket != n:
            past = np.concatenate([past, np.zeros((bucket - n,) + past.shape[1:], np.float32)])
        with self._lock:
            if seed is None:
                self._counter += 1
                seed = self._counter
            t0 = time.perf_counter()
            out = self._fns[bucket](past, seed)[:n].cpu().numpy()
            self.stats.record(n, time.perf_counter() - t0)
        return out

    @property
    def mean_latency_ms(self) -> float:
        s = self.stats
        return 1e3 * s.total_latency_s / s.requests if s.requests else 0.0


def build_parser():
    from crowdmod_tpu_torch.cli import common_parser

    p = common_parser("Export a trained sampler as torch.export artifacts.")
    p.add_argument("--model-to-load", type=str, default="000",
                   help="Checkpoint epoch tag; 000 = best-loss model.")
    p.add_argument("--batch", type=int, action="append", default=None,
                   help="Batch size to specialize to; repeat for one artifact "
                        "per serving bucket (default DATASET.BATCH_SIZE).")
    p.add_argument("--output", type=str, required=True,
                   help="Artifact path; a .json metadata sidecar is written "
                        "next to it (with several --batch, NAME.b<B>.EXT).")
    return p


def run(argv=None) -> int:
    """``python -m crowdmod_tpu_torch.cli export``: checkpoint → one
    artifact a batch bucket."""
    import logging

    from crowdmod_tpu_torch.cli import setup_logging
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.config.validate import require_valid
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import Trainer

    args = build_parser().parse_args(argv)
    cfg = load_config(args.config_yml_file, args.configList_yml_file)
    require_valid(cfg, args.arch)
    setup_logging(os.path.join(cfg.DATA_FS.OUTPUT_DIR, "logs", "export.log"))

    trainer = Trainer(cfg, args.arch, device=args.device, seed=args.seed)
    path = os.path.join(cfg.DATA_FS.SAVE_DIR,
                        ckpt.checkpoint_name(cfg, args.arch, args.model_to_load))
    trainer.load(path)
    logging.info("checkpoint restored from %s", path)
    batches = args.batch or [cfg.DATASET.BATCH_SIZE]
    for b in batches:
        out = args.output
        if len(batches) > 1:
            root, ext = os.path.splitext(args.output)
            out = f"{root}.b{b}{ext}"
        t0 = time.perf_counter()
        meta = export_sampler(trainer, out, batch_size=b)
        logging.info("exported %s in %.1f s: %s", out, time.perf_counter() - t0,
                     json.dumps(meta))
        print(out)
    return 0
