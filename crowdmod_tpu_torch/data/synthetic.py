"""Synthetic crowd data: deterministic walkers (port of the JAX package's
``data/synthetic.py``).

Known-dynamics "pedestrians" traverse a fixed row left→right (vx=+v) or
right→left (vx=-v), one column per frame.  Native layout ``(B, T, H, W, C)``,
returned as a numpy array like the JAX package's, so both packages serve the
same request pasts.  :func:`synthetic_raw_trajectories` is the same walkers
as raw ATC sensor rows, the ETL's input (a frame of columns, ``dict[str,
np.ndarray]``: the port imports no pandas).
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


ATC_COLUMNS = ("time", "personID", "pos_x", "pos_y", "pos_z", "vel", "motion_angle",
               "facing_angle")


def synthetic_raw_trajectories(
    *,
    n_frames: int,
    rows: int,
    cols: int,
    lu,
    theta: float,
    dataset: str = "ATC",
    dx: float = 1.0,
    dy: float = 1.0,
    time_res: float = 0.5,
    walkers_per_row: int = 2,
    subsamples: int = 1,
    t0: float = 1_352_862_000.0,
    speed_mps: float = 2.0,
    jitter: float = 0.15,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Walker dynamics as RAW ATC trajectory rows: the 8 sensor columns
    (epoch-seconds ``time``, millimetre ``pos_x/pos_y``, mm/s ``vel``,
    radian angles), positions and angles inverse-rotated out of the
    LU-anchored grid so that the ETL's rotation, LU filter and binning
    recover the walker field.  ``subsamples`` > 1 emits that many readings a
    pedestrian per TIME_RES bin, so the 500 ms aggregation has work.

    The JAX function's values, row order and draws (one ``uniform`` of
    ``n_frames`` for x, then one for y, a walker), vectorized over frames
    and readings."""
    theta_eff = float(theta)
    if dataset in ("ATC", "ATC4TEST"):
        theta_eff = np.pi - theta_eff
    c, s = np.cos(theta_eff), np.sin(theta_eff)
    rot = np.array([[c, -s], [s, c]])
    rlu = rot @ np.asarray(list(lu), float)
    rlu[0] -= cols

    rng = np.random.default_rng(seed)
    cells_per_frame = speed_mps * time_res / dx
    f = np.arange(n_frames)[:, None]
    frac = (np.arange(subsamples) / subsamples)[None, :]
    out = {k: [] for k in ATC_COLUMNS}
    pid = 0
    for r in range(rows):
        for k in range(walkers_per_row):
            pid += 1
            forward = (r + k) % 2 == 0
            x0 = (k * cols) / walkers_per_row
            phi = 0.0 if forward else np.pi
            sgn = 1.0 if forward else -1.0
            jx = rng.uniform(-jitter, jitter, n_frames)[:, None]
            jy = rng.uniform(-jitter, jitter, n_frames)[:, None]
            base_x = (x0 + sgn * f * cells_per_frame) % cols
            gx = rlu[0] + (base_x + 0.5 + jx) * dx + sgn * frac * 0.1 * dx
            gy = np.broadcast_to(rlu[1] - (r + 0.5) * dy + jy, gx.shape)
            shape = gx.shape
            # One matrix product over every row, as the JAX function's one
            # a row: the same BLAS rounding.
            raw = rot.T @ np.stack([gx.ravel(), gy.ravel()])
            out["time"].append(t0 + f * time_res + frac * time_res)
            out["personID"].append(np.full(shape, pid, np.int64))
            out["pos_x"].append(raw[0] * 1000.0)
            out["pos_y"].append(raw[1] * 1000.0)
            out["pos_z"].append(np.full(shape, 1350.0))
            out["vel"].append(np.full(shape, speed_mps * 1000.0))
            out["motion_angle"].append(np.full(shape, phi - theta_eff))
            out["facing_angle"].append(np.full(shape, phi - theta_eff))
    return {k: np.concatenate([a.ravel() for a in v]) for k, v in out.items()}


def write_atc_raw_csv(df: dict[str, np.ndarray], path: str) -> None:
    """Raw trajectories in the on-disk ATC format: a headerless CSV of the
    8 sensor columns (what ``aggregate_atc_files`` reads)."""
    from crowdmod_tpu_torch.data.etl import write_csv

    write_csv(path, {k: df[k] for k in ATC_COLUMNS}, header=False)


def synthetic_dataset(
    base: np.ndarray, *, vel_x: float = 0.8, row: int = 6, kind: str = "ALL"
) -> np.ndarray:
    """Add walkers onto real sequences: ``base`` ``(B, T, H, W, C)`` with C
    >= 3 → a copy with the walker field added to the first 3 channels."""
    b, t, h, w, c = base.shape
    out = np.array(base, dtype=np.float32, copy=True)
    out[..., :3] += synthetic_walkers(b, h, w, t, vel_x=vel_x, row=row, kind=kind)
    return out
