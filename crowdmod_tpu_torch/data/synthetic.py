"""Synthetic crowd data: deterministic walkers (port of the JAX package's
``data/synthetic.py``, ``synthetic_walkers`` only).

Known-dynamics "pedestrians" traverse a fixed row left→right (vx=+v) or
right→left (vx=-v), one column per frame.  Native layout ``(B, T, H, W, C)``,
returned as a numpy array like the JAX package's, so both packages serve the
same request pasts.
"""

from __future__ import annotations

import numpy as np


def _walker(h: int, w: int, t: int, vel_x: float, row: int, forward: bool):
    frames = np.arange(min(t, w))
    cols = frames if forward else (w - 1 - frames)
    grid = np.zeros((t, h, w, 3), dtype=np.float32)
    grid[frames, row, cols, 0] = 1.0
    grid[frames, row, cols, 1] = vel_x if forward else -vel_x
    return grid


def synthetic_walkers(
    batch: int,
    h: int,
    w: int,
    t: int,
    *,
    vel_x: float = 0.8,
    row: int = 6,
    kind: str = "ALL",
) -> np.ndarray:
    """``(B, T, H, W, 3)`` walker field; kind ∈ {FORWARD, BACKWARD, ALL}."""
    grid = np.zeros((t, h, w, 3), dtype=np.float32)
    if kind in ("FORWARD", "ALL"):
        grid += _walker(h, w, t, vel_x, row, forward=True)
    if kind in ("BACKWARD", "ALL"):
        grid += _walker(h, w, t, vel_x, row, forward=False)
    return np.broadcast_to(grid, (batch,) + grid.shape).copy()
