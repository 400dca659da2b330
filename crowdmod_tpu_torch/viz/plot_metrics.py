"""Metric boxplots (port of the JAX package's ``viz/plot_metrics.py``).

The reference's per-channel boxplots, interleaved plain / MAX (or MIN)
variants and the Bhattacharyya coefficient / distance pair figure
(``utils/plot/plot_metrics.py`` and ``save_metrics_boxplots``), drawn from
the host arrays of :class:`~crowdmod_tpu_torch.metrics.generator.
MetricsEngine`.  Matplotlib is imported lazily (Agg), so the metric suite
runs on a host without it.
"""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def labeled_boxplot(ax, values, labels):
    """``ax.boxplot`` with per-box labels across matplotlib versions: the
    kwarg was ``labels`` before 3.9 and is ``tick_labels`` since."""
    import matplotlib

    kw = ("tick_labels"
          if tuple(int(x) for x in matplotlib.__version__.split(".")[:2])
          >= (3, 9) else "labels")
    return ax.boxplot(values, **{kw: labels})


def boxplot(data: dict[str, np.ndarray], title: str, save_path: str,
            ytick_step: float | None = None, annotate_outliers: bool = False):
    """One boxplot per named column."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(data)), 5))
    labels = list(data)
    values = [np.asarray(v).ravel() for v in data.values()]
    values = [v[np.isfinite(v)] for v in values]
    labeled_boxplot(ax, values, labels)
    if annotate_outliers:
        for i, v in enumerate(values, start=1):
            if len(v) == 0:
                continue
            q1, q3 = np.percentile(v, [25, 75])
            iqr = q3 - q1
            out = v[(v < q1 - 1.5 * iqr) | (v > q3 + 1.5 * iqr)]
            if len(out):
                ax.annotate(f"{len(out)} outliers", (i, np.max(v)),
                            ha="center", fontsize=8)
    if ytick_step:
        lo, hi = ax.get_ylim()
        # Cap the fixed-step tick count: eps-regularized metrics
        # (RE_DENSITY on near-empty ground-truth cells) can span 1e6+, and
        # asking matplotlib for millions of tick artists spins for hours.
        # Past the cap, matplotlib's auto-locator is the sane rendering.
        if np.isfinite([lo, hi]).all() and (hi - lo) / ytick_step <= 200:
            ax.set_yticks(
                np.arange(np.floor(lo), hi + ytick_step, ytick_step)
            )
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


def merged_boxplot(df_plain: np.ndarray, df_max: np.ndarray, columns, title,
                   save_path, prefix="max-", ytick_step=None,
                   annotate_outliers=False):
    """Interleave plain and chunk-reduced columns (reference
    merge_and_plot_boxplot)."""
    data = {}
    for j, col in enumerate(columns):
        data[col] = df_plain[:, j]
        data[f"{prefix}{col}"] = df_max[:, j]
    boxplot(data, title, save_path, ytick_step, annotate_outliers)


def bhatt_pair_plot(coef: np.ndarray, dist: np.ndarray, title, save_path):
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    for ax, mat, name in [
        (axes[0], coef, "BHATT_COEF"), (axes[1], dist, "BHATT_DIST")
    ]:
        labeled_boxplot(ax, [mat[:, 0], mat[:, 1]], ["hist2D", "hist1D"])
        ax.set_title(name)
        ax.grid(True, alpha=0.3)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


def save_metric_boxplots(data: dict, headers: dict, output_dir: str,
                         title: str, pred_len: int = 3, past_len: int = 5):
    """Emit the BP_*.png suite for whichever metrics were computed."""
    os.makedirs(output_dir, exist_ok=True)
    ch = ["rho", "vx", "vy"]

    def have(*names):
        return all(data.get(n) is not None for n in names)

    if have("PSNR", "MAX_PSNR"):
        merged_boxplot(data["PSNR"], data["MAX_PSNR"], ch,
                       f"PSNR and MAX_PSNR of {title}",
                       os.path.join(output_dir, "BP_PSNR.png"), ytick_step=5)
    if have("SSIM", "MAX_SSIM"):
        merged_boxplot(data["SSIM"], data["MAX_SSIM"], ch,
                       f"SSIM and MAX_SSIM of {title}",
                       os.path.join(output_dir, "BP_SSIM.png"), ytick_step=0.2)
    if have("MF_MSE"):
        boxplot({"MSE_Hist_2D": data["MF_MSE"][:, 0],
                 "MSE_Hist_1D": data["MF_MSE"][:, 1]},
                f"MSE of Motion feature of {title}",
                os.path.join(output_dir, "BP_MF_MSE.png"))
    if have("MF_BHATT_COEF", "MF_BHATT_DIST"):
        bhatt_pair_plot(data["MF_BHATT_COEF"], data["MF_BHATT_DIST"],
                        f"BHATT of Motion feature of {title}",
                        os.path.join(output_dir, "BP_BHATT.png"))
    if have("ENERGY", "MIN-ENERGY"):
        merged_boxplot(data["ENERGY"], data["MIN-ENERGY"], ["GT", "PRED"],
                       f"ENERGY and MIN-ENERGY of {title}",
                       os.path.join(output_dir, "BP_ENERGY.png"), prefix="min-")
    if have("RE_DENSITY", "MIN_RE_DENSITY"):
        cols = [f"re_f{past_len + 1 + j}" for j in range(pred_len)]
        merged_boxplot(data["RE_DENSITY"], data["MIN_RE_DENSITY"], cols,
                       f"Relative DENSITY and MIN_RE_DENSITY of {title}",
                       os.path.join(output_dir, "BP_RE_DENSITY.png"),
                       prefix="min-", ytick_step=2, annotate_outliers=True)


def plot_motion_hist2d(hist: np.ndarray, save_path: str, vmax=None):
    """Single 2-D motion-feature histogram figure with pi-fraction ticks."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(hist, origin="lower", aspect="auto", vmax=vmax,
                   extent=[-np.pi, np.pi, 0, 8])
    ticks = np.linspace(-np.pi, np.pi, 5)
    ax.set_xticks(ticks)
    ax.set_xticklabels([r"$-\pi$", r"$-\pi/2$", "0", r"$\pi/2$", r"$\pi$"])
    ax.set_xlabel("angle")
    ax.set_ylabel("log2 magnitude")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)


def plot_motion_hist1d(hist: np.ndarray, save_path: str):
    plt = _plt()
    nbins = len(hist)
    centers = np.linspace(-np.pi, np.pi, nbins, endpoint=False) + np.pi / nbins
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.bar(centers, hist, width=2 * np.pi / nbins)
    ax.set_xticks([-np.pi, -np.pi / 2, 0, np.pi / 2, np.pi])
    ax.set_xticklabels([r"$-\pi$", r"$-\pi/2$", "0", r"$\pi/2$", r"$\pi$"])
    ax.set_xlabel("angle")
    ax.set_ylabel(r"$\sum \|v\|^\gamma$")
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
