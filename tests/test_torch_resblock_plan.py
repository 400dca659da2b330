"""The fused resblock's plan and its GN2 partial sums, without a card.

In bf16, ``csrc/resblock.cu`` hands GN2's moments from conv1 to their
consumers as per-tile partial sums, (m_tiles, n_tiles, 2 sample slots, G, 2
moments) in a workspace that ``resblock_plan`` (``ops/kernels/resblock.py``)
sizes, and sums them in tile order: no atomics, so a call gives the same
bits every run.  These tests replay that bookkeeping in numpy, tile by tile as the
kernel cuts the rows (a tile of BM rows spans at most two samples; rows of
the second go to slot 1), and hold the combined moments to the direct
per-(sample, group) moments.
"""

import numpy as np
import pytest
import torch

from crowdmod_tpu_torch.ops.kernels import fused_resblock, resblock_reference
from crowdmod_tpu_torch.ops.kernels.resblock import MIN_VOLUME, resblock_plan

VOLUMES = {"level0": (8, 12, 36), "v1080": (5, 12, 18)}  # 3456 and 1080 positions
GROUPS, EPS = 8, 1e-5


def kernel_partials(h1, vol, bm, bn, groups):
    """conv1's epilogue, replayed: for each (row tile, column tile) the sum
    and sum of squares of h1 by (sample slot, group), as float32."""
    positions, cout = h1.shape
    m_tiles, n_tiles = -(-positions // bm), -(-cout // bn)
    cg = cout // groups
    part = np.zeros((m_tiles, n_tiles, 2, groups, 2), np.float32)
    for t in range(m_tiles):
        rows = np.arange(t * bm, min((t + 1) * bm, positions))
        slot = rows // vol - rows[0] // vol
        assert slot.max() <= 1, "a tile spans at most two samples"
        for nt in range(n_tiles):
            for g in range(groups):
                lo, hi = max(g * cg, nt * bn), min((g + 1) * cg, (nt + 1) * bn, cout)
                for s in (0, 1):
                    v = h1[rows[slot == s], lo:hi].astype(np.float64)
                    part[t, nt, s, g] = v.sum(), (v * v).sum()
    return part


def combined_moments(part, batch, vol, bm, groups, cg):
    """GN2's (mean, variance) of each (sample, group): the partials of the
    tiles holding the sample's rows, in tile order, then column tiles in
    order, summed in float32; variance E[h²] − E[h]²."""
    mean = np.zeros((batch, groups), np.float32)
    var = np.zeros((batch, groups), np.float32)
    n = np.float32(vol * cg)
    for b in range(batch):
        for g in range(groups):
            s = q = np.float32(0)
            for t in range(b * vol // bm, ((b + 1) * vol - 1) // bm + 1):
                slot = b - t * bm // vol
                for nt in range(part.shape[1]):
                    s += part[t, nt, slot, g, 0]
                    q += part[t, nt, slot, g, 1]
            mean[b, g] = s / n
            var[b, g] = max(q / n - mean[b, g] * mean[b, g], np.float32(0))
    return mean, var


def direct_moments(h1, batch, groups):
    hg = h1.astype(np.float64).reshape(batch, -1, groups, h1.shape[1] // groups)
    return hg.mean(axis=(1, 3)), hg.var(axis=(1, 3)), (hg * hg).mean(axis=(1, 3))


@pytest.mark.parametrize("bm", [128, 256])
@pytest.mark.parametrize("vol", VOLUMES, ids=VOLUMES.keys())
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("cout,bn", [(32, 32), (48, 32)], ids=["one_tile", "split_group"])
def test_partials_combine_to_the_direct_moments(batch, vol, bm, cout, bn):
    """48 channels in 32-wide column tiles: group 5 (channels 30-35) spans
    two column tiles, whose partials sum in order."""
    t, h, w = VOLUMES[vol]
    volume = t * h * w
    rng = np.random.default_rng(batch * 1000 + volume + bm)
    h1 = (rng.normal(size=(batch * volume, cout)) * 1.5 + 0.3).astype(np.float32)
    part = kernel_partials(h1, volume, bm, bn, GROUPS)
    assert part.shape[:2] == (-(-batch * volume // bm), -(-cout // bn))
    mean, var = combined_moments(part, batch, volume, bm, GROUPS, cout // GROUPS)
    want_mean, want_var, want_sq = direct_moments(h1, batch, GROUPS)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=1e-6 * np.sqrt(want_sq).max())
    np.testing.assert_allclose(var, want_var, rtol=1e-6 * want_sq.max() / want_var.min())


@pytest.mark.parametrize("vol", VOLUMES, ids=VOLUMES.keys())
def test_partials_are_of_the_rounded_h1(vol):
    """bf16: conv1 rounds h1 to bf16 before it is stored and summed, so
    GN2's moments are those of the stored h1, which GN2 then normalises
    (as the twin's GN2 takes the moments of its bf16 h), not those of the
    f32 accumulators."""
    t, h, w = VOLUMES[vol]
    volume, batch, cout = t * h * w, 3, 32
    rng = np.random.default_rng(volume)
    acc = (rng.normal(size=(batch * volume, cout)) * 1.5 + 0.3).astype(np.float32)
    stored = torch.from_numpy(acc).bfloat16().float().numpy()
    plan = resblock_plan(batch, t, h, w, 32, cout, GROUPS, torch.bfloat16)
    part = kernel_partials(stored, volume, plan.bm, plan.bn, GROUPS)
    mean, var = combined_moments(part, batch, volume, plan.bm, GROUPS, cout // GROUPS)
    want_mean, want_var, _ = direct_moments(stored, batch, GROUPS)
    f32_mean, f32_var, _ = direct_moments(acc, batch, GROUPS)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=1e-6)
    np.testing.assert_allclose(var, want_var, rtol=1e-6)
    # The rounding moves the moments by far more than the sums' own error.
    assert np.abs(want_var - f32_var).max() > 1e-5
    assert np.abs(var - f32_var).max() > 10 * np.abs(var - want_var).max()


@pytest.mark.parametrize("cin", [32, 64, 96])
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_workspace_sizes(batch, cin):
    t, h, w = VOLUMES["level0"]
    positions, cout = batch * t * h * w, 32
    bf = resblock_plan(batch, t, h, w, cin, cout, GROUPS, torch.bfloat16)
    assert (bf.bm, bf.bn, bf.bk, bf.launches) == (128, 32, 32, 5)
    assert (bf.m_tiles, bf.n_tiles) == (positions // 128, 1)  # 3456 = 27 · 128
    assert bf.a1_elems == positions * cin and bf.h1_elems == positions * cout
    # GN1's (mean, rstd), then the GN2 partials (bf16) or GN2's (f32).
    assert bf.workspace_floats == 2 * batch * GROUPS + bf.m_tiles * 2 * GROUPS * 2
    f32 = resblock_plan(batch, t, h, w, cin, cout, GROUPS, torch.float32)
    assert (f32.bm, f32.bk, f32.launches, f32.a1_elems) == (128, 16, 4, 0)
    assert f32.bn == 32 and f32.h1_elems == positions * cout
    assert f32.workspace_floats == 2 * 2 * batch * GROUPS


def test_tiles_span_at_most_two_samples():
    """The wrapper's least volume is the tiles' rows, so no tile spans
    three samples; the f32 tile is 64 channels wide only where that still
    makes two waves on 132 SMs."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = resblock_plan(4, 1, 1, MIN_VOLUME, 32, 32, GROUPS, dtype)
        assert plan.bm <= MIN_VOLUME
    wide = resblock_plan(64, 8, 12, 36, 64, 64, GROUPS, torch.float32)
    narrow = resblock_plan(1, 1, 1, 128, 64, 64, GROUPS, torch.float32)
    assert (wide.bn, wide.n_tiles) == (64, 1) and (narrow.bn, narrow.n_tiles) == (32, 2)
    assert resblock_plan(2, 1, 1, 128, 16, 16, GROUPS, torch.float32).bn == 16


def test_cpu_wrapper_is_the_twin_in_bf16():
    """On CPU tensors the wrapper runs the twin in the input dtype, which
    rounds h1 to bf16 where the kernel rounds it, and launches nothing."""
    rng = np.random.default_rng(5)
    n = lambda shape, sc: torch.from_numpy((rng.normal(size=shape) * sc).astype(np.float32))  # noqa: E731
    w = {"gn1_scale": 1 + n((16,), 0.1), "gn1_bias": n((16,), 0.1),
         "w1": n((3, 3, 3, 16, 8), 0.05), "b1": n((8,), 0.1),
         "gn2_scale": 1 + n((8,), 0.1), "gn2_bias": n((8,), 0.1),
         "w2": n((3, 3, 3, 8, 8), 0.05), "b2": n((8,), 0.1),
         "w_skip": n((1, 1, 1, 16, 8), 0.1), "b_skip": n((8,), 0.1)}
    x = n((2, 2, 8, 8, 16), 1.0).bfloat16()
    temb = n((2, 8), 1.0).bfloat16()
    fused_resblock.launches = 0
    out = fused_resblock(x, temb, w)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 2, 8, 8, 8)
    torch.testing.assert_close(out, resblock_reference(x, temb, w), rtol=0, atol=0)
    assert fused_resblock.launches == 0
