"""Metric suite orchestration (port of the JAX package's
``metrics/generator.py``).

:class:`MetricsEngine` takes the whole prediction and GT stacks as tensors
on one device, computes each selected metric there in batched PyTorch
(:mod:`.functional`), moves each result to the host once, and writes the
CSVs and the ``metrics_files.json`` manifest under the JAX package's file
names, headers and number format, so the comparison tooling reads either
package's output.

As in the JAX package, ``ENERGY`` applies the per-channel
``PRED_MPROPS_FACTOR`` before the continuity energy (the reference used the
factor before assigning it).  The boxplots need ``viz``, which is not ported
yet (ROADMAP.md Queue 1 item 17): :meth:`MetricsEngine.save_boxplots`
raises.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from crowdmod_tpu_torch.metrics import functional as F
from crowdmod_tpu_torch.models.guidance import continuity_energy

HEADERS = {
    "PSNR": "rho,vx,vy",
    "MASK_PSNR": "rho,vx,vy",
    "SSIM": "rho,vx,vy",
    "MAX_PSNR": "rho,vx,vy",
    "MAX_MASK_PSNR": "rho,vx,vy",
    "MAX_SSIM": "rho,vx,vy",
    "MF_MSE": "MSE_Hist_2D_Based,MSE_Hist_1D_Based",
    "MF_BHATT_DIST": "BHATT_DIST_Hist_2D_Based,BHATT_DIST_Hist_1D_Based",
    "MF_BHATT_COEF": "BHATT_COEF_Hist_2D_Based,BHATT_COEF_Hist_1D_Based",
    "ENERGY": "GT,PRED",
    "MIN-ENERGY": "GT,PRED",
    "RE_DENSITY": None,       # per-frame columns, built dynamically
    "MIN_RE_DENSITY": None,
    "PSNR_OVER_TIME": None,
    "MASK_PSNR_OVER_TIME": None,
    "SSIM_OVER_TIME": None,
    "TV_OVER_TIME": None,
    "MAX_PSNR_OVER_TIME": None,
    "MAX_MASK_PSNR_OVER_TIME": None,
    "MAX_SSIM_OVER_TIME": None,
}

_CHANNELS = ("rho", "vx", "vy")

METRIC_CHOICES = (
    "PSNR", "MASK_PSNR", "SSIM", "MF_MSE", "MF_BHATT", "ENERGY",
    "RE_DENSITY", "TV", "ALL",
)


def _host(x: torch.Tensor) -> np.ndarray:
    """One device-to-host copy of a result."""
    return x.cpu().numpy()


def _flatten_over_time(x: np.ndarray) -> np.ndarray:
    """(N, F, C) → (N, F*C) in the reference's ch-within-frame column order."""
    n, f, c = x.shape
    return x.reshape(n, f * c)


def _ot_header(pred_len: int, past_len: int = 5) -> str:
    """e.g. 'rho_f6,vx_f6,vy_f6,rho_f7,...': frame ids continue the past
    numbering, as the reference's fixed headers do (f6..f8 for P=5,F=3)."""
    cols = []
    for j in range(pred_len):
        fid = past_len + 1 + j
        cols += [f"{ch}_f{fid}" for ch in _CHANNELS]
    return ",".join(cols)


def _re_header(pred_len: int, past_len: int = 5) -> str:
    return ",".join(f"re_f{past_len + 1 + j}" for j in range(pred_len))


@dataclass
class MetricsEngine:
    """Compute fidelity metrics for predicted vs GT future blocks.

    Args:
      pred, gt: ``(N, F, H, W, C)`` native-layout stacks (C = 3) on one
        device; the metrics run there.
      params: the METRICS config node (MPROPS_COUNT, MOTION_FEATURE,
        PRED_MPROPS_FACTOR).
      output_dir: CSV/manifest destination (created on demand).
      past_len: only used for over-time column labels.
    """

    pred: torch.Tensor
    gt: torch.Tensor
    params: object
    output_dir: str | None = None
    past_len: int = 5
    data: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.pred.shape != self.gt.shape:
            raise ValueError(
                f"pred {tuple(self.pred.shape)} vs gt {tuple(self.gt.shape)} "
                "shape mismatch"
            )
        self.ranges = F.channel_ranges(self.gt)

    # ------------------------------------------------------------------
    @property
    def pred_len(self) -> int:
        return self.pred.shape[1]

    def compute_psnr(self, chunk: int, eps: float = 1e-6, masked: bool = False):
        ot = F.psnr_over_time(self.pred, self.gt, self.ranges, eps, masked)
        per_seq = ot.mean(1)  # (N, C)
        tag = "MASK_PSNR" if masked else "PSNR"
        self.data[tag] = _host(per_seq)
        self.data[f"MAX_{tag}"] = _host(F.chunk_reduce(per_seq, chunk))
        flat = ot.reshape(ot.shape[0], -1)
        self.data[f"{tag}_OVER_TIME"] = _host(flat)
        self.data[f"MAX_{tag}_OVER_TIME"] = _host(F.chunk_reduce(flat, chunk))

    def compute_ssim(self, chunk: int):
        ot = F.ssim_over_time(self.pred, self.gt, self.ranges)
        per_seq = ot.mean(1)
        self.data["SSIM"] = _host(per_seq)
        self.data["MAX_SSIM"] = _host(F.chunk_reduce(per_seq, chunk))
        flat = ot.reshape(ot.shape[0], -1)
        self.data["SSIM_OVER_TIME"] = _host(flat)
        self.data["MAX_SSIM_OVER_TIME"] = _host(F.chunk_reduce(flat, chunk))

    def compute_motion_features(self, mse: bool = True, bhatt: bool = True):
        mf = self.params.MOTION_FEATURE
        p2 = F.motion_feature_2d(self.pred, f=mf.f, k=mf.k)
        g2 = F.motion_feature_2d(self.gt, f=mf.f, k=mf.k)
        p1 = F.motion_feature_1d(self.pred, f=mf.f, k=mf.k, gamma=mf.GAMMA)
        g1 = F.motion_feature_1d(self.gt, f=mf.f, k=mf.k, gamma=mf.GAMMA)
        if mse:
            self.data["MF_MSE"] = _host(
                torch.stack([F.mse_vec(p2, g2), F.mse_vec(p1, g1)], 1))
        if bhatt:
            d2, c2 = F.bhattacharyya(g2, p2)
            d1, c1 = F.bhattacharyya(g1, p1)
            self.data["MF_BHATT_DIST"] = _host(torch.stack([d2, d1], 1))
            self.data["MF_BHATT_COEF"] = _host(torch.stack([c2, c1], 1))

    def compute_energy(self, chunk: int):
        factor = torch.tensor(
            list(self.params.PRED_MPROPS_FACTOR), dtype=torch.float32,
            device=self.pred.device,
        )
        e_pred = continuity_energy(self.pred * factor, delta_t=1.0, delta_l=1.0)
        e_gt = continuity_energy(self.gt * factor, delta_t=1.0, delta_l=1.0)
        both = torch.stack([e_gt, e_pred], 1)
        self.data["ENERGY"] = _host(both)
        self.data["MIN-ENERGY"] = _host(F.chunk_reduce(both, chunk, op="min"))

    def compute_re_density(self, chunk: int, eps: float = 1e-6):
        re = F.re_density(self.pred, self.gt, eps)
        self.data["RE_DENSITY"] = _host(re)
        self.data["MIN_RE_DENSITY"] = _host(F.chunk_reduce(re, chunk, op="min"))

    def compute_tv(self):
        ot = F.tv_over_time(self.pred, self.gt)
        self.data["TV_OVER_TIME"] = _flatten_over_time(_host(ot))

    # ------------------------------------------------------------------
    def _header(self, name: str) -> str:
        fixed = HEADERS.get(name)
        if fixed:
            return fixed
        if "RE_DENSITY" in name:
            return _re_header(self.pred_len, self.past_len)
        return _ot_header(self.pred_len, self.past_len)

    def save(self, run_tag: str, title: str, samples_per_batch: int) -> dict:
        """Write the CSVs and the metrics_files.json manifest."""
        if not self.output_dir:
            raise ValueError("output_dir required to save metrics")
        os.makedirs(self.output_dir, exist_ok=True)
        manifest = {"title": title}
        for name in HEADERS:
            data = self.data.get(name)
            if data is None:
                continue
            path = os.path.join(
                self.output_dir, f"{name}_NS{samples_per_batch}_{run_tag}.csv"
            )
            np.savetxt(
                path, data, delimiter=",", header=self._header(name),
                comments="", fmt="%.4f",
            )
            manifest[name] = path
        with open(os.path.join(self.output_dir, "metrics_files.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        return manifest

    def save_boxplots(self, title: str):
        """The boxplot suite needs the plotting module, which is not ported
        yet."""
        raise NotImplementedError(
            "metric boxplots are not ported to PyTorch yet: ROADMAP.md "
            "Queue 1 item 17 (viz)"
        )


def compute_metrics(
    engine: MetricsEngine,
    metric: str,
    chunk: int,
    *,
    eps: float = 1e-6,
    run_tag: str = "run",
    title: str = "",
    samples_per_batch: int = 0,
    save: bool = True,
    boxplots: bool = False,
) -> dict:
    """Run ``metric`` ∈ METRIC_CHOICES ('ALL': the full suite, ENERGY
    included) and, with ``save``, write the CSVs and manifest; → the
    engine's data.  ``boxplots`` (off unless asked for) reaches
    :meth:`MetricsEngine.save_boxplots`, which raises until ``viz`` is
    ported."""
    if metric not in METRIC_CHOICES:
        raise ValueError(f"metric {metric!r} not in {METRIC_CHOICES}")
    if metric in ("PSNR", "ALL"):
        engine.compute_psnr(chunk, eps)
    if metric in ("MASK_PSNR", "ALL"):
        engine.compute_psnr(chunk, eps, masked=True)
    if metric in ("SSIM", "ALL"):
        engine.compute_ssim(chunk)
    if metric in ("MF_MSE", "MF_BHATT", "ALL"):
        engine.compute_motion_features(
            mse=metric in ("MF_MSE", "ALL"), bhatt=metric in ("MF_BHATT", "ALL")
        )
    if metric in ("ENERGY", "ALL"):
        engine.compute_energy(chunk)
    if metric in ("RE_DENSITY", "ALL"):
        engine.compute_re_density(chunk, eps)
    if metric in ("TV", "ALL"):
        engine.compute_tv()

    if save and engine.output_dir:
        engine.save(run_tag, title, samples_per_batch)
        if boxplots:
            engine.save_boxplots(title)
    return engine.data
