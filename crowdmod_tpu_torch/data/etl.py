"""Trajectory → macroproperty ETL (port of the JAX package's ``data/etl.py``).

The port imports no pandas: a *frame* is a ``dict[str, np.ndarray]`` of
equal-length columns, read and written as CSV by the helpers below.  The
functions keep the JAX package's names, arguments and values:

  * :func:`bin_frames` — every frame of a file binned into the (ROWS, COLS)
    grid in one pass on the device: density, velocity means and the
    velocity-norm variance, as :func:`bin_frame` (one frame, the JAX
    function) does per frame with its two ``segment_sum`` passes.  Rows are
    sorted by ``(frame·H·W + cell)`` segment (stable, so a cell keeps its
    rows' time order) and each segment's sum is taken one rank at a time in
    that order: the float32 additions of the JAX scatter, in its order, on
    either device, with no atomics, so the card's result is bitwise
    repeatable.
  * :func:`preprocess_trajectories` — rotation by THETA, mm → m, velocity
    components from speed and angle, the rotated LU.
  * :func:`filter_by_grid` — the LU-anchored spatial filter.
  * :func:`compute_macroprop_sequences` — the (P+F)-frame windows over a
    file's timespan, with the OVERLAP/WINDOWSIZE stride.
  * :func:`aggregate_atc` — 500 ms per-pedestrian means with the +9 h
    shift, bins aligned as ``pandas.Grouper`` aligns them, float64 sums in
    pandas' compensated order.
  * the ETH/UCY helpers and :func:`count_samples`.

Aggregated CSVs are the JAX package's: a leading index column and a
datetime-string ``time`` (or, read only, epoch seconds); each package reads
the other's.  Outputs are native layout ``(N, T, H, W, 4)`` float32.
"""

from __future__ import annotations

import logging
import os
import pickle
from pathlib import Path

import numpy as np
import torch

from crowdmod_tpu_torch.config import FrozenConfig

Frame = dict  # column name → np.ndarray, all of one length

ATC_COLUMNS = [
    "time", "personID", "pos_x", "pos_y", "pos_z", "vel", "motion_angle",
    "facing_angle",
]
ATC_READ_COLUMNS = ["time", "personID", "pos_x", "pos_y", "vel", "motion_angle"]

_NS = 10**9
_CSV_CHUNK = 200_000  # rows formatted at once


# --------------------------------------------------------------------------
# Frames and CSV files
# --------------------------------------------------------------------------

def _rows(df: Frame, keep) -> Frame:
    """The rows ``keep`` (a mask or an index array) of every column."""
    return {k: v[keep] for k, v in df.items()}


def _nrows(df: Frame) -> int:
    return len(next(iter(df.values()))) if df else 0


def _format(col: np.ndarray) -> np.ndarray:
    """A column as CSV strings: floats in their shortest round-trip form,
    datetimes as ``YYYY-MM-DD HH:MM:SS[.fff]`` (what pandas writes)."""
    if np.issubdtype(col.dtype, np.datetime64):
        ns = col.astype("datetime64[ns]")
        whole_ms = not (ns.astype(np.int64) % 10**6).any()
        text = np.datetime_as_string(ns, unit="ms" if whole_ms else "ns")
        return np.char.replace(text, "T", " ")
    return col.astype(str)


def write_csv(path, df: Frame, *, header: bool = True, index: bool = False) -> None:
    """Write ``df``'s columns as CSV; ``index`` adds the leading unnamed
    0..n−1 column of a pandas ``to_csv``."""
    names = list(df)
    n = _nrows(df)
    with open(path, "w") as fh:
        if header:
            fh.write(",".join(([""] if index else []) + names) + "\n")
        for lo in range(0, n, _CSV_CHUNK):
            hi = min(lo + _CSV_CHUNK, n)
            cols = [_format(df[k][lo:hi]).tolist() for k in names]
            if index:
                cols.insert(0, np.arange(lo, hi).astype(str).tolist())
            fh.write("\n".join(map(",".join, zip(*cols))) + "\n")


def _is_int(token: str) -> bool:
    return token.strip().lstrip("+-").isdigit()


def _load_columns(path, names, usecols, ints=(), delimiter=",", skiprows=0) -> Frame:
    """Numeric columns ``usecols`` of a CSV as float64 (``ints`` as int64),
    named ``names``."""
    data = np.loadtxt(path, delimiter=delimiter, skiprows=skiprows, usecols=usecols,
                      ndmin=2, dtype=np.float64)
    return {name: (data[:, k].astype(np.int64) if name in ints else data[:, k])
            for k, name in enumerate(names)}


def seconds_to_datetime(seconds) -> np.ndarray:
    """Epoch seconds → ``datetime64[ns]`` as ``pandas.to_datetime(unit="s")``
    converts floats: the whole seconds, plus the fraction rounded to 9
    decimals, times 10⁹, truncated."""
    seconds = np.asarray(seconds, np.float64)
    base = seconds.astype(np.int64)
    frac = np.round(seconds - base, 9)
    return (base * _NS + (frac * _NS).astype(np.int64)).astype("datetime64[ns]")


# --------------------------------------------------------------------------
# Core binning (device-side)
# --------------------------------------------------------------------------

def grid_index(pos_x, pos_y, *, rows, cols, dx, dy, lu):
    """Pedestrian position → (i, j) cell index, float32 arithmetic (the
    divisions by a device tensor: on CUDA a division by a Python scalar is
    a product with its reciprocal)."""
    dy = torch.tensor(dy, dtype=pos_y.dtype, device=pos_y.device)
    dx = torch.tensor(dx, dtype=pos_x.dtype, device=pos_x.device)
    i = torch.floor((pos_y - (float(lu[1]) - 1)) / dy).abs().to(torch.int64)
    j = torch.floor((pos_x - float(lu[0])) / dx).to(torch.int64)
    return i, j


def _ordered_sums(vals: torch.Tensor, group: torch.Tensor, rank: torch.Tensor,
                  n_groups: int, depth: int) -> torch.Tensor:
    """Per-group sums of the rows of ``vals`` ``(n, K)``, each group's rows
    added one at a time in ``rank`` order from 0: a scatter-add's float
    additions in its order, deterministic on any device."""
    table = vals.new_zeros((n_groups, depth) + vals.shape[1:])
    table[group, rank] = vals
    acc = vals.new_zeros((n_groups,) + vals.shape[1:])
    for r in range(depth):
        acc = acc + table[:, r]
    return acc


def bin_frames(frame, pos_x, pos_y, vel_x, vel_y, vel_norm, *, n_frames: int, rows: int,
               cols: int, dx: float, dy: float, lu, eps: float = 1e-6) -> torch.Tensor:
    """Bin pedestrians (float32 tensors on one device; ``frame`` int64, the
    frame of each row, rows outside ``[0, n_frames)`` ignored) → ``(n_frames,
    rows, cols, 4)`` macroprops (ρ, μ_vx, μ_vy, σ²_v) on that device.

    Two passes, as the reference's: sums → means, then squared deviations of
    the velocity norm from its cell mean.  Rows outside the grid are
    dropped."""
    device = pos_x.device
    i, j = grid_index(pos_x, pos_y, rows=rows, cols=cols, dx=dx, dy=dy, lu=lu)
    ok = (i >= 0) & (i < rows) & (j >= 0) & (j < cols) & (frame >= 0) & (frame < n_frames)
    cells = rows * cols
    out = torch.zeros((n_frames * cells, 4), dtype=torch.float32, device=device)
    seg = ((frame * rows + i) * cols + j)[ok]
    if seg.numel() == 0:
        return out.reshape(n_frames, rows, cols, 4)
    seg, order = torch.sort(seg, stable=True)
    sel = ok.nonzero().squeeze(1)[order]
    vn = vel_norm[sel]
    vals = torch.stack([torch.ones_like(vn), vel_x[sel], vel_y[sel], vn], dim=-1)
    uniq, counts = torch.unique_consecutive(seg, return_counts=True)
    group = torch.repeat_interleave(torch.arange(len(uniq), device=device), counts)
    rank = torch.arange(len(seg), device=device) - (torch.cumsum(counts, 0) - counts)[group]
    depth = int(counts.max())
    sums = _ordered_sums(vals, group, rank, len(uniq), depth)
    rho = sums[:, 0]
    denom = rho + eps
    means = sums[:, 1:] / denom[:, None]
    dev = torch.square(vn - means[group, 2])
    sigma2 = _ordered_sums(dev, group, rank, len(uniq), depth) / denom
    out[uniq] = torch.stack([rho, means[:, 0], means[:, 1], sigma2], dim=-1)
    return out.reshape(n_frames, rows, cols, 4)


def bin_frame(pos_x, pos_y, vel_x, vel_y, vel_norm, mask, *, rows: int, cols: int,
              dx: float, dy: float, lu, eps: float = 1e-6) -> torch.Tensor:
    """Bin one frame's pedestrians → ``(rows, cols, 4)``: the JAX function's
    signature (``mask`` marks the valid rows) over :func:`bin_frames`."""
    frame = torch.where(mask, 0, -1).to(torch.int64)
    return bin_frames(frame, pos_x, pos_y, vel_x, vel_y, vel_norm, n_frames=1, rows=rows,
                      cols=cols, dx=dx, dy=dy, lu=lu, eps=eps)[0]


# --------------------------------------------------------------------------
# Trajectory preprocessing (host, float64)
# --------------------------------------------------------------------------

def preprocess_trajectories(df: Frame, cfg: FrozenConfig, lu=None):
    """Rotate positions and velocities, mm → m, add the velocity
    components → ``(df, rotated_lu)``, with the dataset's THETA convention
    (π − THETA for ATC)."""
    lu = np.asarray(lu if lu is not None else list(cfg.MACROPROPS.LU), float)
    theta = float(cfg.MACROPROPS.THETA)
    if cfg.DATASET.NAME in ("ATC", "ATC4TEST"):
        theta = np.pi - theta
    rot = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])

    df = dict(df)
    pos = rot @ np.stack([np.asarray(df["pos_x"]) / 1000.0, np.asarray(df["pos_y"]) / 1000.0])
    df["pos_x"], df["pos_y"] = pos[0], pos[1]
    speed = np.asarray(df["vel"]) / 1000.0
    ang = np.asarray(df["motion_angle"]) + theta
    df["vel_x"] = speed * np.cos(ang)
    df["vel_y"] = speed * np.sin(ang)
    df["vel_norm"] = np.hypot(df["vel_x"], df["vel_y"])

    rotated_lu = rot @ lu
    rotated_lu[0] -= cfg.MACROPROPS.COLS
    return df, rotated_lu


def filter_by_grid(df: Frame, cfg: FrozenConfig, lu) -> Frame:
    """Keep the pedestrians inside the LU-anchored grid."""
    w = cfg.MACROPROPS.COLS * cfg.MACROPROPS.DX
    h = cfg.MACROPROPS.ROWS * cfg.MACROPROPS.DY
    x, y = df["pos_x"], df["pos_y"]
    return _rows(df, (x >= lu[0]) & (x < lu[0] + w) & (y <= lu[1]) & (y > lu[1] - h))


def _frames_from_df(df: Frame, t0, n_frames: int, time_res: float) -> list[Frame]:
    """Split a time-sorted frame into per-frame pedestrian arrays (float32),
    as the JAX function does before binning each."""
    edges = t0 + np.arange(n_frames + 1) * np.timedelta64(int(time_res * 1e9), "ns")
    idx = np.searchsorted(df["time"], edges)
    cols = ["pos_x", "pos_y", "vel_x", "vel_y", "vel_norm"]
    arrs = {c: np.asarray(df[c], np.float32) for c in cols}
    return [{c: arrs[c][idx[k]: idx[k + 1]] for c in cols} for k in range(n_frames)]


def macroprop_frames(df: Frame, cfg: FrozenConfig, lu, t_init=None, t_final=None,
                     *, device="cuda") -> torch.Tensor:
    """Every TIME_RES frame of a file's timespan binned on ``device`` →
    ``(total_frames, H, W, 4)``; the span is ``[t_init, t_final]`` (default:
    the rows' own), and a frame holds the rows in ``[t0 + k·res, t0 +
    (k+1)·res)``."""
    from crowdmod_tpu_torch.train.trainer import resolve_device

    device = resolve_device(device)
    m = cfg.MACROPROPS
    order = np.argsort(df["time"], kind="stable")
    t = np.asarray(df["time"])[order].astype("datetime64[ns]")
    t0 = np.datetime64(t_init if t_init is not None else t.min(), "ns")
    t1 = np.datetime64(t_final if t_final is not None else t.max(), "ns")
    res = np.timedelta64(int(m.TIME_RES * 1e9), "ns")
    total = int(np.floor((t1 - t0) / res)) if len(t) else 0
    frame = ((t - t0) // res).astype(np.int64)

    def col(name):
        return torch.from_numpy(np.asarray(df[name], np.float32)[order]).to(device)

    return bin_frames(torch.from_numpy(frame).to(device), col("pos_x"), col("pos_y"),
                      col("vel_x"), col("vel_y"), col("vel_norm"), n_frames=max(total, 0),
                      rows=m.ROWS, cols=m.COLS, dx=m.DX, dy=m.DY,
                      lu=tuple(np.asarray(lu, float)), eps=m.EPS)


def macroprop_windows(frames: torch.Tensor, cfg: FrozenConfig) -> np.ndarray:
    """The (P+F)-frame windows of a frame stack → ``(N, T, H, W, 4)``
    float32 on the host; the stride is WINDOWSIZE frames when OVERLAP is
    set, else a whole window."""
    window = cfg.DATASET.PAST_LEN + cfg.DATASET.FUTURE_LEN
    total = frames.shape[0]
    if total < window:
        return np.zeros((0, window) + tuple(frames.shape[1:]), np.float32)
    overlap = bool(cfg.MACROPROPS.get("OVERLAP"))
    stride = int(cfg.MACROPROPS.get("WINDOWSIZE") or 1) if overlap else window
    starts = torch.arange(0, total - window + 1, stride, device=frames.device)
    idx = starts[:, None] + torch.arange(window, device=frames.device)
    return frames[idx].cpu().numpy()


def compute_macroprop_sequences(df: Frame, cfg: FrozenConfig, lu, t_init=None,
                                t_final=None, *, device="cuda") -> np.ndarray:
    """Build all (P+F)-frame macroprop windows → ``(N, T, H, W, 4)``: the
    frames binned once over the whole span (:func:`macroprop_frames`), the
    windows views into them (:func:`macroprop_windows`)."""
    return macroprop_windows(
        macroprop_frames(df, cfg, lu, t_init, t_final, device=device), cfg)


def read_aggregated_csv(path: str) -> Frame:
    """An aggregated-trajectory CSV in the canonical columns.  Both
    conventions: the aggregation's own output (a leading unnamed index
    column, a datetime-string ``time``) and index-free epoch-seconds CSVs.
    Integer columns stay int64, the others float64; ``time`` becomes
    ``datetime64[ns]``."""
    with open(path) as fh:
        names = fh.readline().rstrip("\r\n").split(",")
        first = fh.readline().rstrip("\r\n").split(",")
    keep = [k for k, n in enumerate(names) if n and not n.startswith("Unnamed")]
    ti = names.index("time")
    try:
        float(first[ti])
        numeric_time = True
    except ValueError:
        numeric_time = False
    usecols = [k for k in keep if numeric_time or k != ti]
    ints = {names[k] for k in usecols if k != ti and _is_int(first[k])}
    df = _load_columns(path, [names[k] for k in usecols], usecols, ints, skiprows=1)
    if numeric_time:
        df["time"] = seconds_to_datetime(df["time"])
    else:
        text = np.loadtxt(path, delimiter=",", skiprows=1, usecols=[ti], dtype="U32", ndmin=1)
        df["time"] = text.astype("datetime64[ns]")
    return {names[k]: df[names[k]] for k in keep}


def macroprops_from_aggregated(df: Frame, cfg: FrozenConfig, *, device="cuda") -> np.ndarray:
    """Aggregated trajectories → ``(N, T, H, W, 4)`` macroprop windows:
    preprocess/rotate → LU filter → bin at TIME_RES on ``device`` → windows,
    the span taken from the *unfiltered* file's time extent."""
    pre, rlu = preprocess_trajectories(df, cfg)
    filt = filter_by_grid(pre, cfg, rlu)
    return compute_macroprop_sequences(filt, cfg, rlu, t_init=pre["time"].min(),
                                       t_final=pre["time"].max(), device=device)


def to_reference_pickle_layout(seqs: np.ndarray) -> np.ndarray:
    """``(N, T, H, W, C)`` native → ``(N, C, H, W, T)`` reference pickle
    layout."""
    return np.ascontiguousarray(seqs.transpose(0, 4, 2, 3, 1))


# --------------------------------------------------------------------------
# ATC aggregation
# --------------------------------------------------------------------------

def _compensated_means(vals: np.ndarray, starts: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Means of the row groups ``[starts[g], starts[g] + sizes[g])`` of
    ``vals`` ``(n, K)``, NaNs skipped: Kahan sums in row order divided by
    the counts, the arithmetic of pandas' ``groupby(...).mean()``."""
    g = len(starts)
    total = np.zeros((g, vals.shape[1]))
    comp = np.zeros_like(total)
    nobs = np.zeros_like(total)
    for r in range(int(sizes.max()) if g else 0):
        live = np.nonzero(sizes > r)[0]
        v = vals[starts[live] + r]
        ok = ~np.isnan(v)
        s, c = total[live], comp[live]
        y = np.where(ok, v - c, 0.0)
        t = s + y
        c_new = (t - s) - y
        c_new[np.isnan(c_new)] = 0.0
        total[live] = np.where(ok, t, s)
        comp[live] = np.where(ok, c_new, c)
        nobs[live] += ok
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(nobs > 0, total / nobs, np.nan)


def aggregate_atc(df: Frame, time_res_ms: int = 500) -> Frame:
    """Per-pedestrian means in ``time_res_ms`` bins with the reference's +9 h
    timezone shift: rows ``(bin start, personID)`` in ascending order, every
    other column averaged in float64."""
    t = seconds_to_datetime(df["time"]).astype(np.int64) + 9 * 3600 * _NS
    step = time_res_ms * 10**6  # bins from midnight, as pandas.Grouper's origin
    bins = (t // step) * step
    pid = np.asarray(df["personID"])
    by_time = np.argsort(t, kind="stable")
    order = by_time[np.lexsort((pid[by_time], bins[by_time]))]
    b, p = bins[order], pid[order]
    new = np.ones(len(order), bool)
    new[1:] = (b[1:] != b[:-1]) | (p[1:] != p[:-1])
    starts = np.nonzero(new)[0]
    sizes = np.diff(np.append(starts, len(order)))
    rest = [k for k in df if k not in ("time", "personID")]
    vals = np.stack([np.asarray(df[k], np.float64)[order] for k in rest], axis=1)
    means = _compensated_means(vals, starts, sizes)
    out = {"time": b[starts].astype("datetime64[ns]"), "personID": p[starts]}
    out.update({k: means[:, n] for n, k in enumerate(rest)})
    return out


def read_atc_raw(path) -> Frame:
    """A raw, headerless ATC sensor CSV → the columns ``ATC_READ_COLUMNS``."""
    return _load_columns(path, ATC_READ_COLUMNS,
                         [ATC_COLUMNS.index(c) for c in ATC_READ_COLUMNS], ints=("personID",))


def aggregate_atc_files(cfg: FrozenConfig, filenames, in_dir=None, out_dir=None):
    in_dir = Path(in_dir or cfg.DATA_FS.RAW_DATA_DIR)
    out_dir = Path(out_dir or cfg.DATA_FS.AGG_DATA_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    for k, fn in enumerate(filenames):
        logging.info("aggregating %s (%d/%d)", fn, k + 1, len(filenames))
        write_csv(out_dir / fn, aggregate_atc(read_atc_raw(in_dir / fn)), index=True)


# --------------------------------------------------------------------------
# ETH / UCY preprocessing
# --------------------------------------------------------------------------

def eth_frames_to_unixtime(df: Frame, init_time: float = 1694563200.0) -> Frame:
    """frame id → seconds (0.4 s per 10 frames)."""
    df = dict(df)
    df["time"] = init_time + np.asarray(df["time"], float) * 0.4 / 10.0
    return df


def eth_read_raw(path: str, hotel_rotation: bool | None = None) -> Frame:
    """Read a tab-separated ETH/UCY txt; rotate biwi_hotel 90°."""
    df = _load_columns(path, ["time", "agent_ID", "pos_x", "pos_y"], [0, 1, 2, 3],
                       delimiter="\t")
    df = eth_frames_to_unixtime(df)
    if hotel_rotation is None:
        hotel_rotation = os.path.basename(path) == "biwi_hotel.txt"
    if hotel_rotation:
        df["pos_x"], df["pos_y"] = -df["pos_y"], df["pos_x"].copy()
    return df


def crop_to_lu(df: Frame, lu, cols: int, rows: int) -> Frame:
    """Crop to an LU-anchored window, rebasing coordinates to [0, cols] ×
    [0, rows]."""
    x, y = df["pos_x"], df["pos_y"]
    out = _rows(df, (x > lu[0]) & (x < lu[0] + cols) & (y > lu[1] - rows) & (y < lu[1]))
    out["pos_x"] = out["pos_x"] - lu[0]
    out["pos_y"] = out["pos_y"] - (lu[1] - rows)
    return out


def find_max_density_lu(df: Frame, cols: int, rows: int):
    """The integer LU window holding the most samples (the first in x-major
    order among equals), from a 2-D histogram and its box sums."""
    x, y = np.asarray(df["pos_x"]), np.asarray(df["pos_y"])
    min_x, min_y = int(x.min()) + 1, int(y.min()) + 1
    max_x, max_y = int(x.max()), int(y.max())
    xs = np.arange(min_x, max_x + 2)
    ys = np.arange(min_y - rows, max_y + 2)
    hist, _, _ = np.histogram2d(x, y, bins=[xs, ys])
    c = np.zeros((hist.shape[0] + 1, hist.shape[1] + 1))
    c[1:, 1:] = hist.cumsum(0).cumsum(1)
    nx, ny = hist.shape[0] - cols + 1, hist.shape[1] - rows + 1
    if nx <= 0 or ny <= 0:
        return (0, rows)
    box = (c[cols:cols + nx, rows:rows + ny] - c[:nx, rows:rows + ny]
           - c[cols:cols + nx, :ny] + c[:nx, :ny])
    ix, iy = np.unravel_index(np.argmax(box), box.shape)
    return (xs[ix], ys[iy] + rows)


def _bfill_within(values: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Each NaN takes the next non-NaN value of its own group (``ends[i]``:
    one past the last row of row i's group); a group's trailing NaNs stay."""
    n = len(values)
    idx = np.where(np.isnan(values), n, np.arange(n))
    nxt = np.minimum.accumulate(idx[::-1])[::-1]
    take = nxt < ends
    out = values.copy()
    out[take] = values[nxt[take]]
    return out


def add_velocity_and_angle(df: Frame) -> Frame:
    """Finite-difference speed and motion angle per agent, positions scaled
    m → mm first; single-observation agents are dropped, and each agent's
    first row (any NaN) takes its next row's value."""
    df = dict(df)
    df["pos_x"] = np.asarray(df["pos_x"]) * 1000.0
    df["pos_y"] = np.asarray(df["pos_y"]) * 1000.0
    agent = np.asarray(df["agent_ID"])
    _, inverse, counts = np.unique(agent, return_inverse=True, return_counts=True)
    df = _rows(df, counts[inverse] > 1)
    df = _rows(df, np.lexsort((df["time"], df["agent_ID"])))
    agent = df["agent_ID"]
    first = np.ones(len(agent), bool)
    first[1:] = agent[1:] != agent[:-1]

    def diff(v):
        d = np.empty(len(v))
        d[1:] = v[1:] - v[:-1]
        d[first] = np.nan
        return d

    dx, dy, dt = diff(df["pos_x"]), diff(df["pos_y"]), diff(np.asarray(df["time"], float))
    starts = np.nonzero(first)[0]
    ends = np.repeat(np.append(starts[1:], len(agent)), np.diff(np.append(starts, len(agent))))
    with np.errstate(invalid="ignore", divide="ignore"):
        df["vel"] = _bfill_within(np.hypot(dx, dy) / dt, ends)
    df["motion_angle"] = _bfill_within(np.arctan2(dy, dx), ends)
    return df


# --------------------------------------------------------------------------
# Sample counting
# --------------------------------------------------------------------------

def count_samples(pickle_dir: str, out_yaml: str | None = None) -> list:
    """Per-file sample counts → DATA_LIST entries."""
    import yaml

    entries = []
    for fn in sorted(os.listdir(pickle_dir)):
        if not fn.endswith(".pkl"):
            continue
        with open(os.path.join(pickle_dir, fn), "rb") as f:
            arr = pickle.load(f)
        entries.append([fn, int(len(arr))])
    if out_yaml:
        with open(out_yaml, "w") as f:
            yaml.safe_dump({"DATA_LIST": entries}, f)
    return entries
