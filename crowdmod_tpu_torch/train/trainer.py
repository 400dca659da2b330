"""Trainer, inference part (port of the JAX package's ``train/trainer.py``:
construction, ``load``/``save``, ``_sample_params``, ``_denoise_fn`` and
``sample`` for the DDPM family).

``fit`` and the optimizer come with the training slice.  The weights are
held as state_dicts (``params`` and, with EMA on, ``ema_params``) in the
reference torch layout; sampling binds EMA first, as the JAX package does.
"""

from __future__ import annotations

import os

import torch

from crowdmod_tpu_torch.config import FrozenConfig
from crowdmod_tpu_torch.core.schedule import (
    ddim_tau_schedule,
    linear_schedule,
    respaced_taus,
)
from crowdmod_tpu_torch.models import factory
from crowdmod_tpu_torch.models.diffusion import (
    as_eps_fn,
    ddim_eta_sample,
    ddim_sample,
    ddpm_sample,
)
from crowdmod_tpu_torch.models.guidance import cfg_denoise_fn
from crowdmod_tpu_torch.train import checkpoint as ckpt


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


class Trainer:
    def __init__(
        self,
        cfg: FrozenConfig,
        arch: str,
        mprops_count: int | None = None,
        *,
        device="cuda",
        compute_dtype: torch.dtype | None = None,
        seed: int = 42,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.arch = arch
        self.family = "ConvRNN" if arch == "ConvRNN" else arch.split("-")[0]
        if self.family != "DDPM":
            raise NotImplementedError(
                f"the {self.family} family is not ported to PyTorch yet: "
                "ROADMAP.md Queue 1 items 12-13"
            )
        self.mprops_count = mprops_count if mprops_count is not None else 3
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
            cfg, arch, self.mprops_count, dtype=compute_dtype
        )
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device).eval()
        self.seed = seed
        # "ema" (EMA weights when present) or "raw" (the training weights).
        self.sample_weights = "ema"
        node = factory.backbone_cfg(cfg, arch)
        self.ema_decay = float(node.TRAIN.get("EMA_DECAY", 0.0))
        self.sched = linear_schedule(
            cfg.MODEL.DDPM.TIMESTEPS, scale=cfg.MODEL.DDPM.SCALE
        )
        self.params = self._copy(self.model.state_dict())
        self.ema_params = self._copy(self.params) if self.ema_decay else None
        self._bound = None

    def _copy(self, sd: dict) -> dict:
        return {k: v.detach().to(self.device, copy=True) for k, v in sd.items()}

    def _grid_shapes(self):
        c = self.cfg
        return (
            c.DATASET.PAST_LEN, c.DATASET.FUTURE_LEN,
            c.MACROPROPS.ROWS, c.MACROPROPS.COLS,
        )

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    def save(self, save_dir: str, epoch: int | str, extra: dict | None = None):
        name = ckpt.checkpoint_name(self.cfg, self.arch, epoch)
        payload = {"params": self.params}
        if self.ema_params is not None:
            payload["ema_params"] = self.ema_params
        meta = ckpt.build_metadata(self.cfg, self.arch, epoch, extra)
        return ckpt.save_checkpoint(os.path.join(save_dir, name), payload, meta)

    def load(self, path: str):
        """Load a port checkpoint directory; returns its metadata."""
        payload, meta = ckpt.load_checkpoint(path)
        want = set(self.params)
        for name, sd in payload.items():
            if set(sd) != want:
                raise ValueError(
                    f"checkpoint {path} {name} does not fit the configured "
                    f"model: missing {sorted(want - set(sd))}, unexpected "
                    f"{sorted(set(sd) - want)}"
                )
        self.params = self._copy(payload["params"])
        if "ema_params" in payload:
            self.ema_params = self._copy(payload["ema_params"])
        elif self.ema_decay:
            # EMA enabled but the checkpoint predates it: seed from weights.
            self.ema_params = self._copy(self.params)
        self._bound = None
        return meta

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------
    def _sample_params(self) -> dict:
        """EMA weights when enabled (smoother samples), else the raw
        training weights."""
        if self.sample_weights == "raw" or self.ema_params is None:
            return self.params
        return self.ema_params

    def _denoise_fn(self, params: dict | None = None):
        """The eps-space denoiser over ``params`` (default: the sampling
        weights), with classifier-free guidance and the PRED_TYPE adapter."""
        params = self._sample_params() if params is None else params
        if params is not self._bound:
            self.model.load_state_dict(params)
            self._bound = params
        node = self.cfg.MODEL.DDPM
        fn = cfg_denoise_fn(self.model, float(node.get("CFG_SCALE", 1.0)))
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
        :mod:`crowdmod_tpu_torch.models.diffusion.ddpm`)."""
        past = torch.as_tensor(past, dtype=torch.float32, device=self.device)
        return self._sample_impl(past, generator, noise=noise, history=history)

    def _sample_impl(self, past, generator, *, noise=None, history=False):
        node = self.cfg.MODEL.DDPM
        _, f, h, w = self._grid_shapes()
        shape = (past.shape[0], f, h, w, self.mprops_count)
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
        if node.SAMPLER in ("DPM-Solver", "Distilled"):
            raise NotImplementedError(
                f"the {node.SAMPLER} sampler is not ported to PyTorch yet: "
                "ROADMAP.md Queue 1 item 11"
            )
        if node.SAMPLER != "DDPM":
            raise ValueError(f"unknown DDPM sampler {node.SAMPLER!r}")
        return ddpm_sample(fn, self.sched, past, shape, **common)
