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
    ``torch._higher_order_ops.scan`` while exporting, so the program holds
    one traced step whatever the step count (T = 1000 ancestral
    included), as the JAX package exports its ``fori_loop``; called
    directly, :class:`SamplerModule` runs the same step in a Python loop.  The per-step coefficients and
    timesteps are the scan's inputs, tables computed on the host with the
    float32 arithmetic of the eager samplers (:mod:`..models.diffusion`).
    The model is a frozen copy whose conv and fused-block packs are made
    once, before the trace (``UNet3D.pin_packs``).
  * **Platforms** (the JAX package's ``platforms``): an artifact holds a
    program for each platform it was exported for, ``cuda`` (the card:
    the ``crowdmod::`` operators, bf16 compute where the config asks for
    it, tanh-GELU, the pinned conv and fused-block packs) or ``cpu`` (the
    kernels' plain twins, float32, exact GELU), by default the device of
    the exporting trainer.  :func:`load_sampler` runs the program of the
    current device, and refuses an artifact that has none.
  * **Cross-device export** (``export --platform cuda`` on a host without
    a card): the program is traced on ``meta`` tensors under
    :func:`~crowdmod_tpu_torch.ops.kernels.library.tracing_for`, so every
    device-dependent choice is the card's, and its devices are then
    rewritten ``meta`` → ``cuda:0``.  (A CPU build of torch cannot trace
    fake CUDA tensors: indexing and matmul set a CUDA device guard.)  The
    weights stay on the host in the saved program and move to the card at
    load (:func:`_place`), so no CUDA device is queried while exporting;
    the kernels' plans are made in the operators' CUDA implementations, at
    run time.

Every sampler exports: DDPM (ancestral; guidance None, Sparsity or mass
preservation, its closed-form gradient in the loop), DDIM (None or
Sparsity), DDIM-eta (any guidance), DPM-Solver++(2M) (the carry holds the
previous x0 prediction), Distilled (η = 0 or η > 0), the flow-matching Euler
and Heun integrators, and the ConvRNN rollout.
"""

from __future__ import annotations

import copy
import io
import json
import os
import threading
import time
import zipfile
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from crowdmod_tpu_torch.ops.kernels import fused_ancestral_update
from crowdmod_tpu_torch.ops.kernels.library import normal, tracing_for

PLATFORMS = ("cpu", "cuda")
MULTI_FORMAT = "torch.export, a program a platform"  # a zip of <platform>.pt2


def _sampling_model(trainer, platform: str) -> nn.Module:
    """A frozen copy of the trainer's sampling weights as ``platform``'s
    program computes with them: in that platform's compute dtype, on the
    CPU for a CPU program, else where the trainer's weights are."""
    from crowdmod_tpu_torch.models import factory
    from crowdmod_tpu_torch.train.trainer import platform_compute_dtype

    source = trainer._sample_model()
    dtype = (trainer.compute_dtype if platform == trainer.device.type
             else platform_compute_dtype(trainer.cfg, platform))
    if dtype == trainer.compute_dtype:
        model = copy.deepcopy(source)
    else:
        model = factory.build_backbone(trainer.cfg, trainer.arch, trainer.mprops_count,
                                       dtype=dtype, conv_impl=trainer.conv_impl)
        model.load_state_dict(source.state_dict())
    device = "cpu" if platform == "cpu" else trainer.device
    return model.to(device).eval().requires_grad_(False)


class SamplerModule(nn.Module):
    """A trainer's configured sampler as ``(past, seed) → future``, over a
    frozen copy of its sampling weights, as ``platform``'s program (default:
    the trainer's device's).  Called directly it is the un-exported sampler
    the artifact is held to: both run the same step over the same tables."""

    def __init__(self, trainer, platform: str | None = None):
        super().__init__()
        self.platform = platform or trainer.device.type
        model = _sampling_model(trainer, self.platform)
        if hasattr(model, "pin_packs"):
            model.pin_packs()
        self.model = model
        self.family = trainer.family
        _, f, h, w = trainer._grid_shapes()
        self.future_shape = (f, h, w, trainer.mprops_count)
        self.x0_prev = False  # DPM-Solver's carry holds the previous x0
        self.host_buffers: set[str] = set()  # read on the host in every program
        if self.family != "ConvRNN":
            device = next(model.parameters()).device
            self._register("start", np.int64(-1))  # x_T's draw
            self.step, self.tables = self._build(trainer, self._denoiser(trainer, device),
                                                 device)

    def _register(self, name: str, value, device=None) -> None:
        """A (non-persistent) buffer from an array or tensor, on ``device``
        or on the host: a trace reads a module's tensors as its own."""
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
        if device is None:
            self.host_buffers.add(name)
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
        """The configured sampler's step ``(carry, past, draw, *row) →
        carry`` over the denoiser ``fn``, and the buffers whose rows the scan
        walks.  The carry is ``(x,)``, or ``(x, x0_prev)`` for DPM-Solver."""
        if self.family == "FM":
            from crowdmod_tpu_torch.models.flow_matching.fm import _time_grid

            node = trainer.cfg.MODEL.FM
            if node.INTEGRATOR not in ("Euler", "Heun"):
                raise ValueError(f"unknown integrator {node.INTEGRATOR!r}")
            n = getattr(node.INTEGRATOR_STEPS, node.INTEGRATOR.upper())
            self._register("ts", _time_grid(n, node.TIME_MAX_POS)[1], device)
            delta = 1.0 / n

            def euler(carry, past, draw, t):
                (x,) = carry
                return (x + delta * fn(x, t.expand(x.shape[0]), past),)

            def heun(carry, past, draw, t):
                (x,) = carry
                k1 = fn(x, t.expand(x.shape[0]), past)
                k2 = fn(x + delta * k1, (t + 1.0).expand(x.shape[0]), past)
                return (x + 0.5 * delta * (k1 + k2),)

            return (euler if node.INTEGRATOR == "Euler" else heun), ("ts",)

        from crowdmod_tpu_torch.core.schedule import ddim_tau_schedule, respaced_taus
        from crowdmod_tpu_torch.models.diffusion.ddpm import (
            ancestral_coefficients,
            check_ddim_guidance,
            ddim_coefficients,
            ddim_eta_coefficients,
            ddim_update,
        )
        from crowdmod_tpu_torch.models.guidance import mass_preservation_gradient
        from crowdmod_tpu_torch.train.trainer import check_sampler_guidance

        node, sched = trainer.cfg.MODEL.DDPM, trainer.sched
        sampler, guidance = node.SAMPLER, node.GUIDANCE
        lam = float(node.get("LAMBDA_GUIDANCE", 0.0))
        check_sampler_guidance(node)
        if sampler == "DDPM":
            ts = np.arange(sched.timesteps - 1, -1, -1)
            self._register("rows", ancestral_coefficients(sched, device).flip(0), device)
            self._register("z_scale", (ts > 0).astype(np.float32), device)  # z = 0 at t = 0
            if guidance == "mass_preservation":
                # The composite step of ``ddpm_sample``: strength 1 − α_t = β_t.
                self._register("strength", (np.float32(1.0) - (np.float32(1.0) - sched.beta))[ts],
                               device)

                def ancestral(carry, past, draw, row, t, step, z_scale, strength):
                    (x,) = carry
                    eps = fn(x, t.expand(x.shape[0]), past)
                    x = row[0] * (x - row[1] * eps) + row[2] * (draw(step) * z_scale)
                    return (x - strength * mass_preservation_gradient(x, 1.0, 1.0),)

                step, tables = ancestral, ("rows", "ts", "steps", "z_scale", "strength")
            else:
                def ancestral(carry, past, draw, row, t, step, z_scale):
                    (x,) = carry
                    eps = fn(x, t.expand(x.shape[0]), past)
                    return (fused_ancestral_update(x, eps, draw(step) * z_scale, row,
                                                   lambda_guidance=lam,
                                                   sparsity=guidance == "Sparsity"),)

                step, tables = ancestral, ("rows", "ts", "steps", "z_scale")
        elif sampler == "DPM-Solver":
            ts, rows = dpm_rows(sched, node.get("DPM_STEPS", 20))
            self._register("rows", rows, device)
            self.x0_prev = True

            def dpm(carry, past, draw, row, t):
                x, x0_prev = carry
                eps = fn(x, t.expand(x.shape[0]), past)
                x0 = (x - row[4] * eps) * row[5]
                return row[0] * x - row[1] * (row[2] * x0 - row[3] * x0_prev), x0

            step, tables = dpm, ("rows", "ts")
        else:
            noisy = True
            if sampler == "DDIM-eta":
                ts = respaced_taus(node.TIMESTEPS, node.get("ETA_STEPS", 50))[::-1]
                rows = [ddim_eta_coefficients(sched, t, tp, node.get("ETA", 1.0), lam, guidance)
                        for t, tp in zip(ts, [*ts[1:], -1])]
            elif sampler == "DDIM":
                check_ddim_guidance(guidance)
                ts, rows = zip(*ddim_coefficients(
                    sched, ddim_tau_schedule(node.TIMESTEPS, node.DDIM_DIVIDER), node.SIGMA, lam))
            elif sampler == "Distilled":
                eta = float(node.get("DISTILL_ETA", 0.0))
                ts, rows = distilled_rows(sched, node.get("DISTILL_STEPS", 8), eta)
                noisy = eta != 0.0  # η = 0 draws nothing but x_T
            else:
                raise ValueError(f"unknown DDPM sampler {sampler!r}")
            self._register("rows", np.array(rows, np.float32), device)

            def ddim(carry, past, draw, row, t, step):
                (x,) = carry
                eps = fn(x, t.expand(x.shape[0]), past)
                return (ddim_update(x, eps, draw(step) if noisy else None, row, guidance),)

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

            def body(carry, row):
                return self.step(carry, past, draw, *row), []

            x = draw(self.start)
            carry = (x, torch.zeros_like(x)) if self.x0_prev else (x,)
            xs = tuple(getattr(self, name) for name in self.tables)
            if torch.compiler.is_compiling():
                return scan(body, carry, xs)[0][0]
            # Called directly, the same step a row at a time: an eager scan
            # compiles its body with dynamo for every module and shape.
            for row in zip(*xs):
                carry = self.step(carry, past, draw, *row)
            return carry[0]


def dpm_rows(sched, steps: int) -> tuple[np.ndarray, np.ndarray]:
    """DPM-Solver++(2M)'s ``steps`` timesteps (the model's t, from T−1) and
    its ``(steps, 6)`` float32 rows, from ``dpm_timesteps`` with the eager
    sampler's float32 arithmetic: (σ ratio, α·expm1(−h), 1 + c, c,
    σ_t, 1/α_t) of x' = r₀·x − r₁·(r₂·x0 − r₃·x0_prev), x0 = (x − r₄·ε̂)·r₅
    (the product with the reciprocal is what CUDA computes for the eager
    sampler's division by a Python float).  The first step is first order:
    r₂ = 1, r₃ = 0."""
    from crowdmod_tpu_torch.models.diffusion.dpm_solver import check_dpm_steps, dpm_timesteps

    check_dpm_steps(sched, steps)
    ts = [int(t) for t in dpm_timesteps(sched.timesteps, steps)]
    alpha, sigma = sched.sqrt_alpha_bar, sched.sqrt_one_minus_alpha_bar
    lam = np.log(alpha) - np.log(sigma)
    one = np.float32(1.0)
    rows = []
    for idx in range(steps):
        t, t_im1 = ts[idx + 1], ts[idx]
        h = lam[t] - lam[t_im1]
        if idx == 0:
            w1, w2 = one, np.float32(0.0)
        else:
            c = one / (np.float32(2.0) * ((lam[t_im1] - lam[ts[idx - 1]]) / h))
            w1, w2 = one + c, c
        rows.append((sigma[t] / sigma[t_im1], alpha[t] * np.expm1(-h), w1, w2,
                     sigma[t_im1], one / alpha[t_im1]))
    return np.array(ts[:-1], np.int64), np.array(rows, np.float32)


def distilled_rows(sched, n_steps: int, eta: float) -> tuple[np.ndarray, list]:
    """The Distilled sampler's ``n_steps`` timesteps t_hi (the model's t and
    the key of the step's draw) and its :func:`ddim_update` rows over
    ``distill_grid``: at η = 0 ``ddim_det_step``'s coefficients (σ = 0), at
    η > 0 the respaced posterior's, σ = 0 on the last step, to clean data."""
    from crowdmod_tpu_torch.models.diffusion.distill import distill_grid

    grid = [int(t) for t in distill_grid(sched.timesteps, n_steps)]
    one, zero = np.float32(1.0), np.float32(0.0)
    ts, rows = [], []
    for k in range(n_steps, 0, -1):
        t_hi, t_lo = grid[k], grid[k - 1]
        ts.append(t_hi)
        if eta == 0.0:
            sab_lo, somab_lo = ((one, zero) if t_lo < 0 else
                                (sched.sqrt_alpha_bar[t_lo], sched.sqrt_one_minus_alpha_bar[t_lo]))
            rows.append((sched.sqrt_one_minus_alpha_bar[t_hi], one / sched.sqrt_alpha_bar[t_hi],
                         sab_lo, somab_lo, zero, zero))
            continue
        ab_hi = sched.alpha_bar[t_hi]
        ab_lo = sched.alpha_bar[t_lo] if t_lo >= 0 else one
        sigma = (np.float32(eta) * np.sqrt(np.maximum((one - ab_lo) / (one - ab_hi), zero))
                 * np.sqrt(np.maximum(one - ab_hi / ab_lo, zero)))
        rows.append((np.sqrt(one - ab_hi), one / np.sqrt(ab_hi), np.sqrt(ab_lo),
                     np.sqrt(np.maximum(one - ab_lo - sigma**2, zero)), sigma, zero))
    return np.array(ts, np.int64), rows


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


def export_sampler(trainer, path: str | os.PathLike, *, batch_size: int,
                   platforms: Sequence[str] | None = None) -> dict:
    """Export the trainer's sampler at ``batch_size`` to ``path`` (+ a
    ``.json`` sidecar), a program for each of ``platforms`` (default: the
    trainer's device's); returns the sidecar.  One platform's artifact is
    that program's ``torch.export`` archive, several platforms' a zip of
    one archive each, ``<platform>.pt2``."""
    from torch._export.serde.schema import SCHEMA_VERSION

    platforms = list(dict.fromkeys(platforms or [trainer.device.type]))
    for platform in platforms:
        if platform not in PLATFORMS:
            raise ValueError(f"unknown platform {platform!r}; expected one of {PLATFORMS}")
    p, f, h, w = trainer._grid_shapes()
    c = trainer.mprops_count
    programs = {pl: export_program(SamplerModule(trainer, pl), (batch_size, p, h, w, c))
                for pl in platforms}
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if len(programs) == 1:
        torch.export.save(programs[platforms[0]], path)
    else:
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
            for platform, program in programs.items():
                buf = io.BytesIO()
                torch.export.save(program, buf)
                zf.writestr(f"{platform}.pt2", buf.getvalue())
    meta = {
        "format": "torch.export" if len(programs) == 1 else MULTI_FORMAT,
        "arch": trainer.arch,
        "platforms": platforms,
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


def export_program(module: SamplerModule, past_shape) -> torch.export.ExportedProgram:
    """``torch.export`` of ``module`` for its platform: traced on the
    device its weights are on, or, for ``cuda`` from weights on the host,
    traced on ``meta`` as the card's program (:func:`_export_cross`)."""
    device = next(module.model.parameters()).device
    seed = torch.tensor(0, dtype=torch.int64)
    if device.type == module.platform:
        return torch.export.export(module, (torch.zeros(past_shape, device=device), seed))
    return _export_cross(module, past_shape, seed)


def _export_cross(module: SamplerModule, past_shape, seed) -> torch.export.ExportedProgram:
    """The card's program of ``module`` (weights on the host), traced on
    ``meta``: while it is traced under :func:`tracing_for`, every tensor of
    the module but the host buffers is a ``meta`` tensor of its shape,
    strides and dtype (in place: the sampler's step closes over its own
    model); then each ``meta`` device in the graphs and their tensors'
    metadata becomes ``cuda:0``, and the program's weights are the host's
    real tensors."""
    import torch.utils._pytree as pytree

    target = torch.device("cuda:0")
    real, slots_of = {}, {}
    for prefix, m in module.named_modules():
        for slots in (m._parameters, m._buffers):
            for k, t in slots.items():
                if t is None or (m is module and k in module.host_buffers):
                    continue
                name = f"{prefix}.{k}" if prefix else k
                real[name], slots_of[name] = t, (slots, k)
                fake = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")
                slots[k] = (nn.Parameter(fake, requires_grad=False)
                            if isinstance(t, nn.Parameter) else fake)
    try:
        with tracing_for(module.platform):
            program = torch.export.export(
                module, (torch.empty(past_shape, device="meta"), seed))
    finally:
        for name, (slots, k) in slots_of.items():
            slots[k] = real[name]

    def on_target(v):
        if isinstance(v, torch.device) and v.type == "meta":
            return target
        if isinstance(v, torch.Tensor) and v.device.type == "meta":
            v.fake_device = target  # a FakeTensor's device
        return v

    for gm in program.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            node.args = pytree.tree_map(on_target, node.args)
            node.kwargs = pytree.tree_map(on_target, node.kwargs)
            if "val" in node.meta:
                pytree.tree_map(on_target, node.meta["val"])
        gm.recompile()
    for table in (program._state_dict, program._constants):
        for name, t in table.items():
            if isinstance(t, torch.Tensor) and t.device.type == "meta":
                if name not in real:
                    raise ValueError(
                        f"cross-device export: the program's tensor {name!r} is not a "
                        "parameter or buffer of the sampler, so its value cannot cross")
                table[name] = (nn.Parameter(real[name], requires_grad=False)
                               if isinstance(t, nn.Parameter) else real[name])
    program._example_inputs = None
    return program


def _place(program: torch.export.ExportedProgram) -> torch.export.ExportedProgram:
    """Move each weight the program holds on the host, where its graph
    computes on a card, to that card (a cross-device export's)."""
    from torch.export.graph_signature import InputKind

    placeholders = {n.name: n for n in program.graph.nodes if n.op == "placeholder"}
    for spec in program.graph_signature.input_specs:
        if spec.kind not in (InputKind.PARAMETER, InputKind.BUFFER,
                             InputKind.CONSTANT_TENSOR):
            continue
        want = placeholders[spec.arg.name].meta["val"].device
        table = program._state_dict if spec.target in program._state_dict \
            else program._constants
        t = table[spec.target]
        if t.device != want:
            table[spec.target] = (nn.Parameter(t.to(want), requires_grad=False)
                                  if isinstance(t, nn.Parameter) else t.to(want))
    return program


def load_sampler(path: str | os.PathLike) -> tuple[Callable, dict]:
    """Load an exported sampler: ``(callable(past, seed), metadata)``, the
    program for this process's platform — ``cuda`` where a card is
    visible, else ``cpu``, as the JAX package runs its default backend's —
    which must be one of the artifact's.  The callable takes ``past`` as an
    array or tensor and ``seed`` as an int, and returns the future as a
    tensor on that platform's device."""
    import crowdmod_tpu_torch.ops.kernels  # noqa: F401  (the crowdmod:: operators)

    path = os.fspath(path)
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as fh:
            meta = json.load(fh)
    platform = "cuda" if torch.cuda.is_available() else "cpu"
    platforms = meta.get("platforms", ["cpu"])
    if platform not in platforms:
        raise ValueError(
            f"{path}: the artifact holds programs for {platforms}, not for this "
            f"process's platform {platform!r}; export it with --platform {platform}")
    if meta.get("format") == MULTI_FORMAT:
        with zipfile.ZipFile(path) as zf:
            source = io.BytesIO(zf.read(f"{platform}.pt2"))
    else:
        source = path
    program = _place(torch.export.load(source)).module()

    def sample(past, seed):
        past = torch.as_tensor(past, dtype=torch.float32).to(platform)
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
    p.add_argument("--platform", action="append", default=None, choices=PLATFORMS,
                   help="Target platform(s), e.g. --platform cuda from a host "
                        "without a card (repeatable: one artifact with a program "
                        "per platform; default: the --device's).")
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
        meta = export_sampler(trainer, out, batch_size=b, platforms=args.platform)
        logging.info("exported %s in %.1f s: %s", out, time.perf_counter() - t0,
                     json.dumps(meta))
        print(out)
    return 0
