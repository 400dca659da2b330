"""Prediction plots: static SVG grids, per-sequence GIFs, density curves
(port of the JAX package's ``viz/plot_samples.py``).

Sequences are time-major ``(N, T, H, W, C)``, as in the JAX package.  The
GIFs' per-frame overlay metrics (PSNR, masked PSNR, SSIM, TV) are computed
by :func:`overlay_metrics` with :mod:`crowdmod_tpu_torch.metrics.
functional` on the tensors' device (the card, for ``generate-samples``),
batched over sequences and frames in one call each; only the drawing
moves to numpy on the host.  Matplotlib is imported lazily with the Agg
backend.  The drawing code is the JAX package's, so both write the same
bytes from the same arrays and overlays.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from crowdmod_tpu_torch.metrics import functional as F

# The reference's FIGSIZE_MAP (plot_sampled_mprops.py:10-17) with the
# other shipped dataset geometries.
FIGSIZE_MAP = {
    "ATC": (7, 4),
    "ATC4TEST": (7, 4),
    "HERMES-BO": (7, 4),
    "HERMES-BN": (4, 7),
    "HERMES-CR-90": (5, 4),
    "HERMES-CR-90-OBST": (5, 4),
    "HERMES-CR-120": (7, 6),
    "HERMES-CR-120-OBST": (7, 6),
    "ETH-UCY": (6, 4),
}

PLOT_MPROPS = ("Density", "Density&Vel", "Uncertainty")
PLOT_PASTS = ("All", "Last2", "Alternate")


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def frame_indexes(past_len: int, future_len: int, plot_past: str) -> list[int]:
    """Which frames of the (past+future) sequence to show
    (reference ``_get_j_indexes``, plot_sampled_mprops.py:37-54)."""
    past = list(range(past_len))
    future = list(range(past_len, past_len + future_len))
    if plot_past == "Last2":
        sel = past[-2:]
    elif plot_past == "Alternate":
        sel = past[::2]
        if past[-1] not in sel:
            sel[-1] = past[-1]
    else:
        sel = past
    return sel + future


@dataclass
class MacropropPlotter:
    """Renders sampled macroprop sequences.

    ``seqs`` passed to the plot methods are ``(2*N, T, H, W, C)`` arrays with
    prediction/GT interleaved: even rows are predictions, odd rows ground
    truth (matching the reference's ``seq_frames`` list order,
    plot_sampled_mprops.py:234-244).
    """

    cfg: object
    output_dir: str
    arch: str = "DDPM-UNet"
    vel_scale: float = 0.5
    vel_unc_scale: float = 1.0
    headwidth: int = 5
    run_tag: str = ""
    fps: int = 2
    static_samples: int = 4

    dataset_name: str = field(init=False)

    def __post_init__(self):
        cfg = self.cfg
        self.dataset_name = cfg.DATASET.NAME
        self.max_rho = cfg.DATASET.MAX_RHO_4_PLOT
        self.samples4plot = cfg.MODEL.NSAMPLES4PLOTS
        self.past_len = cfg.DATASET.PAST_LEN
        self.future_len = cfg.DATASET.FUTURE_LEN
        self.rows = cfg.MACROPROPS.ROWS
        self.cols = cfg.MACROPROPS.COLS
        self.eps = cfg.MACROPROPS.EPS
        os.makedirs(self.output_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def _title(self) -> str:
        return (
            f"Sampling macroprops with {self.arch} architecture\n"
            f"Past Len:{self.past_len} and Future Len:{self.future_len}"
        )

    def _draw_frame(self, ax, frame: np.ndarray, plot_mprop: str):
        """Density matshow + optional quiver / uncertainty circles for one
        (H, W, C) frame — delegates to the package-wide frame renderer."""
        from crowdmod_tpu_torch.viz.plot_crowd import Crowd, draw_macroprops

        frame = np.asarray(frame)
        im = draw_macroprops(
            ax, Crowd.from_frame(frame), info="", rho_max=self.max_rho,
            vel_scale=self.vel_scale,
            draw_vel=plot_mprop == "Density&Vel",
            draw_unc=plot_mprop == "Uncertainty" and frame.shape[-1] > 3,
            unc_scale=self.vel_unc_scale, headwidth=self.headwidth,
        )
        ax.grid(False)
        return im

    # ------------------------------------------------------------------
    def plot_static(
        self, seqs: np.ndarray, plot_mprop: str = "Density&Vel",
        plot_past: str = "All",
    ) -> str:
        """4 pred/GT row pairs × selected frames → one SVG
        (reference ``plotStatic``, plot_sampled_mprops.py:69-123)."""
        plt = _plt()
        seqs = np.asarray(seqs)
        idxs = frame_indexes(self.past_len, self.future_len, plot_past)
        nrows = min(self.static_samples, seqs.shape[0] // 2) * 2

        fig, ax = plt.subplots(
            nrows, len(idxs), figsize=(10, 8), facecolor="white",
            squeeze=False,
        )
        fig.subplots_adjust(hspace=0.1, wspace=0.1)
        im = None
        for i in range(nrows):
            label = "Pred" if i % 2 == 0 else "GT"
            for col, j in enumerate(idxs):
                im = self._draw_frame(ax[i, col], seqs[i, j], plot_mprop)
            ax[i, 0].set_ylabel(f"{label}\nseq-{i // 2 + 1}", fontsize=8)
            fig.text(
                0.11, 0.845 - i / (nrows + 4.6), f"{label}\nseq-{i // 2 + 1}",
                fontsize=8, ha="center", va="center", rotation=90,
            )
        cbar = fig.colorbar(
            im, ax=ax.ravel().tolist(), pad=0.04, shrink=0.45,
            orientation="horizontal",
        )
        cbar.set_label("Density rho", fontsize=9)
        cbar.ax.tick_params(labelsize=8)

        kind = {"Density": "_4Density", "Uncertainty": "_4Uncertainty"}.get(
            plot_mprop, ""
        )
        fig.suptitle(self._title(), y=0.95)
        path = os.path.join(
            self.output_dir,
            f"mpSampling_{self.arch}{kind}_{self.run_tag}.svg",
        )
        fig.savefig(path, format="svg", bbox_inches="tight")
        plt.close(fig)
        return path

    # ------------------------------------------------------------------
    def plot_dynamic(
        self,
        seqs: np.ndarray,
        overlays: dict[str, np.ndarray] | None = None,
    ) -> list[str]:
        """One GIF per sequence with per-frame metric text overlays
        (reference ``plotDynamic``, plot_sampled_mprops.py:125-200): past
        frames labeled black, predicted frames blue; GT GIFs carry no
        metric text."""
        plt = _plt()
        from matplotlib import animation
        from matplotlib.animation import PillowWriter

        seqs = np.asarray(seqs)
        idxs = frame_indexes(self.past_len, self.future_len, "All")
        figsize = FIGSIZE_MAP.get(self.dataset_name)
        if figsize is None:
            logging.warning(
                "dataset %s has no FIGSIZE_MAP entry; skipping GIFs",
                self.dataset_name,
            )
            return []

        paths = []
        total = min(self.samples4plot, seqs.shape[0] // 2) * 2
        for i in range(total):
            is_gt = i % 2 == 1
            seq_idx = i // 2
            fig, ax = plt.subplots(1, 1, figsize=figsize, facecolor="white")
            fig.subplots_adjust(hspace=0.1, wspace=0.1)
            frame0 = seqs[i, idxs[0]]
            im = ax.matshow(
                frame0[..., 0], cmap=plt.cm.Blues, vmin=0.0, vmax=self.max_rho
            )
            quiv = ax.quiver(
                frame0[..., 1], -frame0[..., 2], color="green", angles="xy",
                scale_units="xy", scale=self.vel_scale, minshaft=3.5,
                width=0.009, headwidth=self.headwidth,
            )
            cbar = fig.colorbar(im, ax=ax, orientation="vertical", fraction=0.015)
            cbar.set_label("Density rho", fontsize=11)
            cbar.ax.tick_params(labelsize=10)
            ax.set_title(self._title(), fontsize=12)
            text = ax.text(
                0.5, -0.24, "", transform=ax.transAxes, ha="center", fontsize=10
            )

            def update(frame, i=i, is_gt=is_gt, seq_idx=seq_idx,
                       im=im, quiv=quiv, text=text):
                j = idxs[frame]
                fr = seqs[i, j]
                im.set_array(fr[..., 0])
                quiv.set_UVC(fr[..., 1], -fr[..., 2])
                lines = [f"Frame: {frame + 1}/{len(idxs)}"]
                if not is_gt and overlays:
                    for name in ("psnr", "mpsnr", "ssim", "tv"):
                        vals = overlays.get(name)
                        if vals is None:
                            continue
                        lines.append(
                            ", ".join(
                                f"{name}_{ch}:{vals[seq_idx, frame, k]:.3f}"
                                for k, ch in enumerate(("rho", "vx", "vy"))
                            )
                        )
                    text.set_color("black" if frame < self.past_len else "blue")
                else:
                    text.set_color("black")
                text.set_text("\n".join(lines))

            ani = animation.FuncAnimation(
                fig, update, frames=len(idxs), repeat=True
            )
            name = (
                f"mprops_GT_seq_{seq_idx + 1}.gif" if is_gt
                else f"mprops_seq_{seq_idx + 1}.gif"
            )
            path = os.path.join(self.output_dir, name)
            ani.save(path, writer=PillowWriter(fps=self.fps))
            plt.close(fig)
            paths.append(path)
        return paths

    # ------------------------------------------------------------------
    def plot_density_over_time(self, seqs: np.ndarray) -> list[str]:
        """Σρ over frames: past (blue) / predicted (red) / GT (green)
        scatter (reference ``plotDensityOverTime``,
        plot_sampled_mprops.py:202-228)."""
        plt = _plt()
        seqs = np.asarray(seqs)
        L = seqs.shape[1]
        frames = np.arange(1, L + 1)
        paths = []
        for i in range(min(self.samples4plot, seqs.shape[0] // 2)):
            rho_pred = seqs[2 * i, ..., 0].sum(axis=(1, 2))
            rho_gt = seqs[2 * i + 1, ..., 0].sum(axis=(1, 2))
            fig, ax = plt.subplots(figsize=(6, 6))
            p = self.past_len
            ax.scatter(frames[:p], rho_gt[:p], color="blue", marker="o",
                       label="Past")
            ax.scatter(frames[p:], rho_pred[p:], color="red", marker="o",
                       label="Predicted")
            ax.scatter(frames[p:], rho_gt[p:], color="green", marker="o",
                       label="Ground Truth")
            ax.set_xlabel("Frame")
            ax.set_ylabel("Sum of density ρ")
            ax.set_title("Sum of density over time")
            ax.legend()
            path = os.path.join(self.output_dir, f"rho_seq_{i + 1}.png")
            fig.savefig(path)
            plt.close(fig)
            paths.append(path)
        return paths


# ----------------------------------------------------------------------
# Orchestration
# ----------------------------------------------------------------------

def overlay_metrics(
    pred_seqs, gt_seqs, metrics_cfg, eps: float
) -> dict[str, np.ndarray]:
    """Per-frame overlay metrics of the GIFs, ``(N, T, 3)`` each, computed
    on the tensors' device in one batched call a metric and moved to the
    host once (the reference's get_psnr_per_seq / get_ssim_per_seq /
    get_tv_per_seq loops, plot_sampled_mprops.py:260-374)."""
    pred = torch.as_tensor(pred_seqs)[..., :3]
    gt = torch.as_tensor(gt_seqs, device=pred.device)[..., :3]
    ranges = F.channel_ranges(gt)
    mthr = metrics_cfg.get("MASK_THRESHOLD", 1e-5)
    out = {
        "psnr": F.psnr_over_time(pred, gt, ranges, eps=eps),
        "mpsnr": F.psnr_over_time(
            pred, gt, ranges, eps=eps, masked=True, mask_threshold=mthr
        ),
        "ssim": F.ssim_over_time(pred, gt, ranges),
        "tv": F.tv_over_time(pred, gt),
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


def interleave(predictions, past, future_gt):
    """Past + prediction and past + GT along time, and both interleaved
    (even rows predictions, odd rows ground truth) → ``(pred_seq, gt_seq,
    seqs)``, on the predictions' device."""
    predictions = torch.as_tensor(predictions)
    past = torch.as_tensor(past, device=predictions.device)
    future_gt = torch.as_tensor(future_gt, device=predictions.device)
    pred_seq = torch.cat([past, predictions], dim=1)
    gt_seq = torch.cat([past, future_gt], dim=1)
    seqs = torch.stack([pred_seq, gt_seq], dim=1).reshape(
        (-1,) + tuple(pred_seq.shape[1:])
    )
    return pred_seq, gt_seq, seqs


def render_predictions(
    plotter: MacropropPlotter,
    seqs: np.ndarray,
    overlays: dict[str, np.ndarray],
    *,
    plot_type: str = "Static",
    plot_mprop: str = "Density&Vel",
    plot_past: str = "All",
) -> dict:
    """The requested plots of interleaved host ``seqs`` (see
    :func:`interleave`) and their ``overlays``: the static SVG or the GIFs,
    then the density curves → ``{"overlays", "static" | "gifs",
    "density"}``."""
    if plot_type not in ("Static", "Dynamic"):
        raise ValueError(f"unknown plot_type {plot_type!r}")
    artifacts: dict[str, object] = {"overlays": overlays}
    if plot_type == "Static":
        artifacts["static"] = plotter.plot_static(seqs, plot_mprop, plot_past)
    else:
        artifacts["gifs"] = plotter.plot_dynamic(seqs, overlays)
    artifacts["density"] = plotter.plot_density_over_time(seqs)
    return artifacts


def setup_predictions_plot(
    predictions,
    past,
    future_gt,
    plotter: MacropropPlotter,
    *,
    plot_type: str = "Static",
    plot_mprop: str = "Density&Vel",
    plot_past: str = "All",
) -> dict:
    """Concatenate past + prediction / past + GT along time, compute the
    overlays on the tensors' device and draw the requested plots
    (the reference's ``setup_predictions_plot``,
    plot_sampled_mprops.py:230-258).  All inputs ``(N, T, H, W, C)``."""
    pred_seq, gt_seq, seqs = interleave(predictions, past, future_gt)
    overlays = overlay_metrics(pred_seq, gt_seq, plotter.cfg.METRICS, plotter.eps)
    return render_predictions(
        plotter, seqs.cpu().numpy(), overlays, plot_type=plot_type,
        plot_mprop=plot_mprop, plot_past=plot_past,
    )
