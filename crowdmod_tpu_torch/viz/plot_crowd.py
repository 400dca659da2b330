"""Crowd frames, GIFs, loss curves and name helpers (port of the JAX
package's ``viz/plot_crowd.py``).

The reference's frame and GIF renderers (``utils/plot/plot.py``,
``utils/crowd.py``, ``utils/plot/plot_helpers.py``) for the time-major
``(T, H, W, C)`` / channels-last layout.  Everything here is numpy and
matplotlib on the host: callers move tensors off the card first.
Matplotlib is imported lazily with the Agg backend, and GIFs are written
frame by frame with PillowWriter, so no display and no imageio are needed.
The drawing code is the JAX package's, so both write the same bytes from
the same arrays.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# ----------------------------------------------------------------------
# Crowd container (reference utils/crowd.py:14-26)
# ----------------------------------------------------------------------

@dataclass
class Crowd:
    """One macroprop frame split into named fields."""

    rho: np.ndarray        # (H, W)
    mu_v: np.ndarray       # (H, W, 2)
    sigma2_v: np.ndarray   # (H, W)

    @classmethod
    def from_frame(cls, frame: np.ndarray) -> "Crowd":
        """Split a channels-last (H, W, C) frame."""
        frame = np.asarray(frame)
        sigma2 = (
            frame[..., 3] if frame.shape[-1] > 3
            else np.zeros(frame.shape[:2], frame.dtype)
        )
        return cls(rho=frame[..., 0], mu_v=frame[..., 1:3], sigma2_v=sigma2)


def max_rho(seqs: np.ndarray) -> float:
    """Global density max for consistent color scale
    (reference getMaxRho, crowd.py:39-54)."""
    return float(np.max(np.asarray(seqs)[..., 0]))


# ----------------------------------------------------------------------
# Single-frame drawing (reference plot.py:7-63)
# ----------------------------------------------------------------------

def draw_macroprops(ax, crowd: Crowd, info: str, rho_max: float,
                    vel_scale: float = 0.5, draw_vel: bool = True,
                    draw_unc: bool = False, unc_scale: float = 1.0,
                    headwidth: int | None = None):
    """Density matshow + optional velocity quiver / σ circles on ``ax``.

    The single frame renderer for the whole viz package — plot_samples'
    static grids delegate here so the color map, velocity-sign convention
    (vy negated for matshow's row-down axes), and circle style live in one
    place.
    """
    plt = _plt()
    im = ax.matshow(crowd.rho, cmap=plt.cm.Blues, vmin=0.0, vmax=rho_max)
    if draw_vel:
        extra = {} if headwidth is None else {"headwidth": headwidth}
        ax.quiver(
            crowd.mu_v[..., 0], -crowd.mu_v[..., 1], color="green",
            angles="xy", scale_units="xy", scale=vel_scale, minshaft=3.5,
            width=0.009, **extra,
        )
    if draw_unc:
        rows, cols = crowd.rho.shape
        sigma = np.sqrt(np.maximum(crowd.sigma2_v, 0.0))
        for r in range(rows):
            for c in range(cols):
                ax.add_artist(plt.Circle(
                    (c, r), unc_scale * sigma[r, c], fill=False,
                    color="green", lw=0.7,
                ))
    if info:
        ax.set_title(info, fontsize=9)
    ax.axis("off")
    return im


def draw_pred_vs_gt(frame_pred: np.ndarray, frame_gt: np.ndarray, info: str,
                    rho_max: float, save_path: str | None = None,
                    draw_unc_gt: bool = False, draw_unc_pred: bool = False):
    """Two-panel GT | prediction figure (reference drawPredMacroProps,
    plot.py:29-63)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(12, 4), facecolor="white")
    draw_macroprops(axes[0], Crowd.from_frame(frame_gt), f"GT {info}",
                    rho_max, draw_unc=draw_unc_gt)
    im = draw_macroprops(axes[1], Crowd.from_frame(frame_pred),
                         f"Pred {info}", rho_max, draw_unc=draw_unc_pred)
    fig.colorbar(im, ax=axes.ravel().tolist(), fraction=0.02)
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


# ----------------------------------------------------------------------
# Trajectory/density scatter (reference plot.py:65-203)
# ----------------------------------------------------------------------

def plot_people_density(x, y, lu, title: str, save_path: str | None = None,
                        grid_hw: tuple[int, int] | None = None,
                        cell: tuple[float, float] = (1.0, 1.0)):
    """Scatter pedestrian positions with the macroprop grid window overlaid
    (reference plotPeopleDensity / plotDensityAndGrid)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.scatter(np.asarray(x), np.asarray(y), s=2, alpha=0.4)
    if grid_hw is not None:
        rows, cols = grid_hw
        dx, dy = cell
        x0, y0 = lu
        for r in range(rows + 1):
            ax.axhline(y0 - r * dy, color="red", lw=0.4)
        for c in range(cols + 1):
            ax.axvline(x0 + c * dx, color="red", lw=0.4)
    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def plot_rotation_comparison(ox, oy, rx, ry, theta: float, save_path: str):
    """Original vs rotated positions side by side (reference
    plotDataAndItsRotation, plot.py:128-169)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    axes[0].scatter(np.asarray(ox), np.asarray(oy), s=2, alpha=0.4)
    axes[0].set_title("original")
    axes[1].scatter(np.asarray(rx), np.asarray(ry), s=2, alpha=0.4)
    axes[1].set_title(f"rotated by θ={theta:.4f} rad")
    for ax in axes:
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_losses(train_losses, val_losses, subtitle: str, save_path: str,
                title: str = "Overall"):
    """Train/val loss curves (reference plot_losses, plot.py:204-216)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    epochs = np.arange(1, len(train_losses) + 1)
    ax.plot(epochs, train_losses, label="train")
    if val_losses is not None and any(v is not None for v in val_losses):
        vals = [np.nan if v is None else v for v in val_losses]
        ax.plot(epochs, vals, label="val")
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(f"{title} loss\n{subtitle}")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return save_path


# ----------------------------------------------------------------------
# GIF rendering (reference crowd.py:56-145)
# ----------------------------------------------------------------------

def render_sequence_gif(seq: np.ndarray, gif_path: str, *, fps: int = 3,
                        rho_max: float | None = None, vel_scale: float = 0.5,
                        titles: list[str] | None = None):
    """Render a (T, H, W, C) macroprop sequence to an animated GIF
    (reference plotMacropropsFromFile / plotAllMacropropsFromFile)."""
    plt = _plt()
    from matplotlib import animation
    from matplotlib.animation import PillowWriter

    seq = np.asarray(seq)
    rho_max = rho_max if rho_max is not None else max_rho(seq)
    fig, ax = plt.subplots(figsize=(7, 4), facecolor="white")
    im = ax.matshow(seq[0, ..., 0], cmap=plt.cm.Blues, vmin=0, vmax=rho_max)
    quiv = ax.quiver(
        seq[0, ..., 1], -seq[0, ..., 2], color="green", angles="xy",
        scale_units="xy", scale=vel_scale, minshaft=3.5, width=0.009,
    )
    fig.colorbar(im, ax=ax, fraction=0.02)
    ax.axis("off")

    def update(t):
        im.set_array(seq[t, ..., 0])
        quiv.set_UVC(seq[t, ..., 1], -seq[t, ..., 2])
        ax.set_title(titles[t] if titles else f"frame {t + 1}/{len(seq)}")

    ani = animation.FuncAnimation(fig, update, frames=len(seq), repeat=True)
    os.makedirs(os.path.dirname(gif_path) or ".", exist_ok=True)
    ani.save(gif_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return gif_path


def render_pred_vs_gt_gif(pred_seq: np.ndarray, gt_seq: np.ndarray,
                          gif_path: str, *, fps: int = 2,
                          draw_unc_gt: bool = False,
                          draw_unc_pred: bool = False):
    """GT | prediction two-panel GIF (reference plotPredictedMacroprops,
    crowd.py:122-145)."""
    plt = _plt()
    from matplotlib import animation
    from matplotlib.animation import PillowWriter

    pred_seq, gt_seq = np.asarray(pred_seq), np.asarray(gt_seq)
    rho_max = max(max_rho(pred_seq), max_rho(gt_seq))
    fig, axes = plt.subplots(1, 2, figsize=(12, 4), facecolor="white")

    def update(t):
        for ax in axes:
            ax.clear()
        draw_macroprops(axes[0], Crowd.from_frame(gt_seq[t]),
                        f"GT frame {t + 1}", rho_max, draw_unc=draw_unc_gt)
        draw_macroprops(axes[1], Crowd.from_frame(pred_seq[t]),
                        f"Pred frame {t + 1}", rho_max,
                        draw_unc=draw_unc_pred)

    ani = animation.FuncAnimation(
        fig, update, frames=len(pred_seq), repeat=True
    )
    os.makedirs(os.path.dirname(gif_path) or ".", exist_ok=True)
    ani.save(gif_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return gif_path


# ----------------------------------------------------------------------
# Model-name helpers (reference plot_helpers.py:3-28)
# ----------------------------------------------------------------------

def make_short_name(long_name: str) -> str:
    """Compress a run/checkpoint name to ``arch-DDIM<k>`` style labels."""
    arch = long_name.split("_")[0]
    m = re.search(r"DDIM[-_]?(\d+)", long_name)
    if m:
        return f"{arch}-DDIM{m.group(1)}"
    if "DDPM" in long_name.upper():
        return arch
    return arch


def ddim_sort_key(long_name: str):
    """Sort key placing plain DDPM first, then DDIM by divider."""
    m = re.search(r"DDIM[-_]?(\d+)", long_name)
    return (1, int(m.group(1))) if m else (0, 0)
