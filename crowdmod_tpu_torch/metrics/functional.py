"""Fidelity metrics on batches of sequences (port of the JAX package's
``metrics/functional.py``).

Every function works on whole stacks: ``pred``/``gt`` are ``(N, F, H, W, C)``
with C = 3 (rho, vx, vy), and where the JAX package vmaps a per-sequence
function over N, the port's function takes the leading batch dimensions
itself.  "Over time" results are ``(N, F, C)``; flattened, column ``j*C + c``
is channel c of frame j (the reference's column order).

The JAX package computes these in XLA, outside any Pallas kernel, so the
port's are plain PyTorch on whichever device holds the stack.  Three points
keep the port's numbers where the JAX package's are:

  * SSIM pads symmetrically (the edge pixel repeated, ``jnp.pad``'s
    ``"symmetric"``), built from flipped slices: ``F.pad``'s ``"reflect"``
    is numpy's ``reflect`` and does not repeat it;
  * the 1-D histogram's edges are the JAX package's float32 values bit for
    bit (``_ANGLE_EDGES_16``), and the 2-D bucket is its float32 arithmetic,
    operation for operation (``_bucket``);
  * the histograms are sums whose result does not depend on the order the
    device adds in: counts are sums of 1.0 (exact in float32), and the
    magnitude-weighted 1-D histogram adds each volume's elements in their
    index order, one elementwise pass a position, as XLA's scatter does on
    the CPU.  So two calls on the card give the same bits.
"""

from __future__ import annotations

import math

import torch


# --------------------------------------------------------------------------
# Ranges
# --------------------------------------------------------------------------

def channel_ranges(gt: torch.Tensor) -> torch.Tensor:
    """Global per-channel (max - min) over all GT samples → ``(C,)``."""
    flat = gt.reshape(-1, gt.shape[-1])
    return flat.amax(0) - flat.amin(0)


# --------------------------------------------------------------------------
# PSNR
# --------------------------------------------------------------------------

def _psnr_from_err(err: torch.Tensor, data_range: torch.Tensor, eps: float):
    # torch.maximum propagates NaN (an empty mask), as jnp.maximum does.
    err = torch.maximum(err, torch.full_like(err, eps))
    return 20.0 * torch.log10(data_range) - 10.0 * torch.log10(err)


def psnr_over_time(
    pred: torch.Tensor, gt: torch.Tensor, ranges: torch.Tensor,
    eps: float = 1e-6, masked: bool = False, mask_threshold: float = 1e-5,
) -> torch.Tensor:
    """Per-frame per-channel PSNR → ``(N, F, C)``.

    ``masked=True`` restricts the MSE to cells where the GT density exceeds
    ``mask_threshold``; an empty mask gives NaN (numpy's mean of nothing).
    """
    sq = torch.square(gt - pred)  # (N, F, H, W, C)
    if masked:
        mask = (gt[..., 0] > mask_threshold)[..., None]  # (N, F, H, W, 1)
        count = mask.sum(dim=(2, 3))
        err = (sq * mask).sum(dim=(2, 3)) / count  # NaN where count == 0
    else:
        err = sq.mean(dim=(2, 3))
    return _psnr_from_err(err, ranges[None, None, :], eps)


# --------------------------------------------------------------------------
# SSIM (scikit-image default semantics)
# --------------------------------------------------------------------------

def _symmetric_pad(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """Pad ``pad`` on both sides of ``dim`` with the edge pixel repeated
    (``jnp.pad(mode="symmetric")``, scipy.ndimage's ``reflect``)."""
    n = x.shape[dim]
    left = x.narrow(dim, 0, pad).flip(dim)
    right = x.narrow(dim, n - pad, pad).flip(dim)
    return torch.cat([left, x, right], dim)


def _uniform_filter_2d(x: torch.Tensor, win: int) -> torch.Tensor:
    """scipy.ndimage.uniform_filter (mode='reflect') over the last 2 dims:
    a symmetric pad, then a separable box filter, each pass the difference
    of two cumulative sums."""
    pad = win // 2
    padded = _symmetric_pad(_symmetric_pad(x, pad, -2), pad, -1)

    def avg(dim, arr):
        n = arr.shape[dim]
        zero = torch.zeros_like(arr.narrow(dim, 0, 1))
        csum = torch.cumsum(torch.cat([zero, arr], dim), dim)
        return (csum.narrow(dim, win, n - win + 1)
                - csum.narrow(dim, 0, n - win + 1)) / win

    return avg(-1, avg(-2, padded))


def ssim_frame(
    gt: torch.Tensor, pred: torch.Tensor, data_range: torch.Tensor, win: int = 7
) -> torch.Tensor:
    """SSIM of a batch of 2-D fields over the last two dims.

    skimage.metrics.structural_similarity defaults: uniform 7×7 window,
    K1=0.01 / K2=0.03, unbiased covariance (N/(N-1)), the mean taken over
    the centre region with (win//2)-pixel edges cropped.
    """
    def f(a):
        return _uniform_filter_2d(a, win)

    np_ = win * win
    cov_norm = np_ / (np_ - 1.0)
    ux, uy = f(gt), f(pred)
    uxx, uyy, uxy = f(gt * gt), f(pred * pred), f(gt * pred)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    dr = data_range
    c1 = (0.01 * dr) ** 2
    c2 = (0.03 * dr) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2)
    )
    pad = win // 2
    return s[..., pad:-pad, pad:-pad].mean(dim=(-2, -1))


def ssim_over_time(
    pred: torch.Tensor, gt: torch.Tensor, ranges: torch.Tensor, win: int = 7
) -> torch.Tensor:
    """Per-frame per-channel SSIM → ``(N, F, C)``."""
    # (N, F, H, W, C) → (N, F, C, H, W) so frames batch over leading dims.
    p = torch.movedim(pred, -1, 2)
    g = torch.movedim(gt, -1, 2)
    return ssim_frame(g, p, ranges[None, None, :, None, None], win=win)


# --------------------------------------------------------------------------
# Total variation / density
# --------------------------------------------------------------------------

def tv_over_time(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """|TV(pred) − TV(gt)| per frame/channel → ``(N, F, C)``."""

    def tv(x):
        dr = torch.diff(x, dim=2).abs().sum(dim=(2, 3))
        dc = torch.diff(x, dim=3).abs().sum(dim=(2, 3))
        return dr + dc  # (N, F, C)

    return (tv(pred) - tv(gt)).abs()


def re_density(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-6):
    """Relative total-density error per frame → ``(N, F)``."""
    p = pred[..., 0].sum(dim=(2, 3))
    g = gt[..., 0].sum(dim=(2, 3))
    return (p - g).abs() / (g + eps)


# --------------------------------------------------------------------------
# Chunked (repeated-past protocol) reductions
# --------------------------------------------------------------------------

def chunk_reduce(x: torch.Tensor, chunk: int, op: str = "max") -> torch.Tensor:
    """Reduce over groups of ``chunk`` consecutive samples (the reference's
    MAX/MIN over a repeated past)."""
    if x.shape[0] % chunk:
        raise ValueError(
            f"chunk_reduce: {x.shape[0]} samples is not a multiple of "
            f"chunk={chunk}; refusing to silently drop the trailing "
            f"{x.shape[0] % chunk} samples from the MAX/MIN aggregate"
        )
    n = x.shape[0] // chunk
    grouped = x.reshape((n, chunk) + tuple(x.shape[1:]))
    return grouped.amax(1) if op == "max" else grouped.amin(1)


# --------------------------------------------------------------------------
# Motion features
# --------------------------------------------------------------------------

def _minmax_per_cell(mag: torch.Tensor, lo: float = 0.0, hi: float = 255.0):
    """MinMaxScaler semantics on ``(..., F, cells)``: each grid cell's time
    series is scaled on its own to [0, 255]."""
    mn = mag.amin(dim=-2, keepdim=True)
    mx = mag.amax(dim=-2, keepdim=True)
    # A true division: ``scalar / tensor`` is a reciprocal times the scalar.
    scale = torch.where(mx > mn, torch.full_like(mx, hi - lo) / (mx - mn),
                        torch.ones_like(mx))
    return (mag - mn) * scale + lo


def magnitude_angle(seq: torch.Tensor):
    """``(..., F, H, W, C)`` → transformed magnitude and angle, each
    ``(..., F, H, W)``.

    magnitude: |v| → per-cell min-max to [0,255] → log2(x+1) ∈ [0, 8];
    angle: atan2(vy, vx).
    """
    *lead, f, h, w, _ = seq.shape
    vx, vy = seq[..., 1], seq[..., 2]
    mag = torch.sqrt(vx * vx + vy * vy).reshape(*lead, f, h * w)
    mag = torch.log2(_minmax_per_cell(mag) + 1.0).reshape(*lead, f, h, w)
    angle = torch.atan2(vy, vx)
    return mag, angle


def _volumes(x: torch.Tensor, f: int, k: int) -> torch.Tensor:
    """Partition ``(..., F, H, W)`` into (f, k, k) volumes → ``(..., V,
    f*k*k)``.  Requires F % f == H % k == W % k == 0."""
    *lead, F, H, W = x.shape
    nl = len(lead)
    x = x.reshape(*lead, F // f, f, H // k, k, W // k, k)
    x = x.permute(*range(nl), nl, nl + 2, nl + 4, nl + 1, nl + 3, nl + 5)
    return x.reshape(*lead, -1, f * k * k)


# ``jnp.linspace(-jnp.pi, jnp.pi, 17)`` as XLA computes it on the CPU, as
# float32 bit patterns: XLA folds ``stop * (iota / 16)`` into ``iota * (π /
# 16)`` and contracts products into fused multiply-adds, so no plain float32
# formula (``torch.linspace`` included) gives all 17 bits.
_ANGLE_EDGES_16 = (
    0xC0490FDB, 0xC02FEDE0, 0xC016CBE5, 0xBFFB53D2, 0xBFC90FDA, 0xBF96CBE5,
    0xBF490FDC, 0xBEC90FDA, 0x00000000, 0x3EC90FDA, 0x3F490FDC, 0x3F96CBE4,
    0x3FC90FDB, 0x3FFB53D2, 0x4016CBE4, 0x402FEDE0, 0x40490FDB,
)


def _angle_edges(angle_bins: int, device=None) -> torch.Tensor:
    """The JAX package's 1-D histogram edges over [-π, π], bit for bit,
    on ``device``.  Only the 16 bins every config uses are held."""
    if angle_bins != 16:
        raise ValueError(
            f"angle_bins={angle_bins}: the port holds the JAX package's "
            "histogram edges for 16 angle bins only")
    bits = torch.tensor(_ANGLE_EDGES_16, dtype=torch.int64).to(torch.int32)
    return bits.view(torch.float32).to(device)


def _bucket(x: torch.Tensor, lo: float, hi: float, nbins: int):
    """``np.histogram2d`` bucketing on a fixed range: the bin index and
    whether x lies in ``[lo, hi]`` (the right edge counts in the last bin).
    The float32 arithmetic of the JAX package: ``(x − lo)`` over ``(hi −
    lo)`` (a double, rounded once), times ``nbins``, each a true division or
    product on a float32 tensor of x's device (a division by a Python scalar
    becomes a product with its reciprocal on the card)."""
    width = torch.tensor(hi - lo, dtype=x.dtype, device=x.device)
    idx = torch.floor((x - lo) / width * nbins).to(torch.int64)
    idx = torch.where(x == hi, nbins - 1, idx)
    valid = (x >= lo) & (x <= hi)
    return idx, valid


def motion_volumes(seq: torch.Tensor, f: int = 1, k: int = 4):
    """The magnitude and angle of ``seq`` ``(..., F, H, W, C)`` cut into
    volumes, each ``(..., V, f*k*k)``: the inputs of both histograms."""
    mag, angle = magnitude_angle(seq)
    return _volumes(mag, f, k), _volumes(angle, f, k)


def motion_bins(mv: torch.Tensor, av: torch.Tensor,
                mag_bins: int = 16, angle_bins: int = 16):
    """The bins of each element of the volumes ``mv``, ``av``: ``(2-D flat
    bin, 2-D valid, 1-D bin, 1-D valid)``, each of their shape: what both
    histograms count."""
    mi, mvalid = _bucket(mv, 0.0, 8.0, mag_bins)
    ai, avalid = _bucket(av, -math.pi, math.pi, angle_bins)
    edges = _angle_edges(angle_bins, av.device)
    bins = torch.searchsorted(edges, av.contiguous(), right=True) - 1
    return (mi * angle_bins + ai, mvalid & avalid,
            bins, (bins >= 0) & (bins < angle_bins))


def motion_feature_2d(
    seq: torch.Tensor, f: int = 1, k: int = 4,
    mag_bins: int = 16, angle_bins: int = 16,
) -> torch.Tensor:
    """Per-sequence 2-D (magnitude × angle) histogram feature vector of
    ``seq`` ``(..., F, H, W, C)`` → ``(..., V·mag_bins·angle_bins)``.

    Values outside the fixed ranges are dropped; the lowest magnitude row
    collapses onto angle bin ``angle_bins // 2`` (the reference's
    set_zero_angle_to_smallMag).  Returns the (sum+1)-normalized vector.
    """
    flat_bin, valid, _, _ = motion_bins(*motion_volumes(seq, f, k), mag_bins,
                                        angle_bins)
    *lead, v, s = flat_bin.shape
    nb = mag_bins * angle_bins
    vol_ids = torch.arange(v, device=seq.device)[:, None] * nb
    idx = torch.where(valid, vol_ids + flat_bin, 0).reshape(*lead, v * s)
    # Sums of 1.0 and 0.0: exact in float32 in any order.
    hist = torch.zeros(*lead, v * nb, dtype=seq.dtype, device=seq.device)
    hist.scatter_add_(-1, idx, valid.to(seq.dtype).reshape(*lead, v * s))
    hist = hist.reshape(*lead, v, mag_bins, angle_bins)

    first_row_total = hist[..., 0, :].sum(-1)
    hist[..., 0, :] = 0.0
    hist[..., 0, angle_bins // 2] = first_row_total

    vec = hist.reshape(*lead, -1)
    return vec / (vec.sum(-1, keepdim=True) + 1.0)


def motion_feature_1d(
    seq: torch.Tensor, f: int = 1, k: int = 4,
    angle_bins: int = 16, gamma: float = 0.5,
) -> torch.Tensor:
    """Per-sequence 1-D angle histogram weighted by magnitude^gamma of
    ``seq`` ``(..., F, H, W, C)`` → ``(..., V·angle_bins)``.

    np.digitize semantics: angle == +π lands past the last bin and is
    dropped, as in the reference.
    """
    mv, av = motion_volumes(seq, f, k)
    _, _, bins, valid = motion_bins(mv, av, angle_bins=angle_bins)
    weights = torch.where(valid, torch.pow(mv, gamma), 0.0)
    one_hot = bins[..., None] == torch.arange(angle_bins, device=seq.device)
    hist = torch.zeros(*mv.shape[:-1], angle_bins, dtype=mv.dtype, device=mv.device)
    for s in range(mv.shape[-1]):  # each volume's elements in index order
        hist = hist + torch.where(one_hot[..., s, :], weights[..., s, None], 0.0)
    vec = hist.reshape(*hist.shape[:-2], -1)
    return vec / (vec.sum(-1, keepdim=True) + 1.0)


def bhattacharyya(p: torch.Tensor, q: torch.Tensor, eps: float = 1e-2):
    """Bhattacharyya (distance, coefficient) between discrete distributions
    over the last dim (with the reference's 1e-2 clip)."""
    coef = torch.clamp(torch.sqrt(p * q).sum(-1), eps, 1.0)
    return -torch.log(coef), coef


def mse_vec(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared difference over the last dim."""
    return torch.square(a - b).mean(-1)
