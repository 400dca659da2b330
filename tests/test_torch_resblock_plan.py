"""The fused resblock's plan and its GN2 partial sums, without a card.

In bf16, ``csrc/resblock.cu`` runs both convs on the halo-box kernel: a work
item is an output tile of whole rows of one sample (tb t slices × hb rows
× all of W, its GEMM rows W + 2 a row), and conv1 hands GN2's moments to
their consumers as per-tile partial sums, (batch, tiles a sample, n_tiles,
G, 2 moments) in a workspace that ``resblock_plan``
(``ops/kernels/resblock.py``) sizes, summed in tile order: no atomics, so a
call gives the same bits every run.  These tests replay that bookkeeping in
numpy, tile by tile as the kernel cuts the rows, and hold the combined
moments to the direct per-(sample, group) moments; check the plans'
shared memory and registers against the card's limits at every planned
shape; and replay the whole blocked computation (chunk by chunk, tap by
tap, the skip as extra K) in torch against the twin and the JAX Pallas
kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import LEVELS, RESBLOCK_SHAPES
from crowdmod_tpu.ops.pallas.resblock import fused_resblock as jax_fused_resblock
from crowdmod_tpu_torch.ops.kernels import fused_resblock, resblock_reference
from crowdmod_tpu_torch.ops.kernels.resblock import (
    HALO_BLOCKS,
    HALO_REGISTERS,
    MIN_VOLUME,
    MOMENT_ROWS,
    SMEM_LIMIT,
    _res_tile,
    halo_registers,
    halo_smem_bytes,
    pack_resblock,
    resblock_plan,
)

VOLUMES = {"level0": (8, 12, 36), "v1080": (5, 12, 18)}  # 3456 and 1080 positions
GROUPS, EPS = 8, 1e-5


def tile_rows(shape, tile):
    """Each work item's output positions, in the kernel's item order: per
    sample, the (t, h) tiles in order, a tile's rows of all of W."""
    batch, t, h, w = shape
    tb, hb = tile
    pos = np.arange(batch * t * h * w).reshape(batch, t, h, w)
    return [pos[b, t0:t0 + tb, h0:h0 + hb].reshape(-1) for b in range(batch)
            for t0 in range(0, t, tb) for h0 in range(0, h, hb)]


def kernel_partials(h1, shape, tile, bn, groups):
    """conv1's epilogue, replayed: for each tile and column tile the sum and
    sum of squares of h1 by group, as float32, (batch, tiles, n_tiles, G, 2)."""
    positions, cout = h1.shape
    items = tile_rows(shape, tile)
    n_tiles, cg = -(-cout // bn), cout // groups
    part = np.zeros((shape[0], len(items) // shape[0], n_tiles, groups, 2), np.float32)
    for i, rows in enumerate(items):
        b, ts = divmod(i, part.shape[1])
        assert np.all(rows // (positions // shape[0]) == b), "a tile lies in one sample"
        for nt in range(n_tiles):
            for g in range(groups):
                lo, hi = max(g * cg, nt * bn), min((g + 1) * cg, (nt + 1) * bn, cout)
                v = h1[rows, lo:hi].astype(np.float64)
                part[b, ts, nt, g] = v.sum(), (v * v).sum()
    return part


def combined_moments(part, vol, cg):
    """GN2's (mean, variance) of each (sample, group): the sample's tiles'
    partials in tile order, each tile's column tiles in order, summed in
    float32; variance E[h²] − E[h]²."""
    batch, tiles, n_tiles, groups, _ = part.shape
    mean = np.zeros((batch, groups), np.float32)
    var = np.zeros((batch, groups), np.float32)
    n = np.float32(vol * cg)
    for b in range(batch):
        for g in range(groups):
            s = q = np.float32(0)
            for ts in range(tiles):
                for nt in range(n_tiles):
                    s += part[b, ts, nt, g, 0]
                    q += part[b, ts, nt, g, 1]
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
    """Tiles of ``bm`` GEMM rows (the plan's tile for that block); 48
    channels in 32-wide column tiles: group 5 (channels 30-35) spans two
    column tiles, whose partials sum in order."""
    t, h, w = VOLUMES[vol]
    volume = t * h * w
    tile = _res_tile(t, h, w, bm)[0]
    rng = np.random.default_rng(batch * 1000 + volume + bm)
    h1 = (rng.normal(size=(batch * volume, cout)) * 1.5 + 0.3).astype(np.float32)
    part = kernel_partials(h1, (batch, t, h, w), tile, bn, GROUPS)
    assert part.shape[1:3] == (-(-t // tile[0]) * -(-h // tile[1]), -(-cout // bn))
    mean, var = combined_moments(part, volume, cout // GROUPS)
    want_mean, want_var, want_sq = direct_moments(h1, batch, GROUPS)
    np.testing.assert_allclose(mean, want_mean, rtol=0, atol=1e-6 * np.sqrt(want_sq).max())
    np.testing.assert_allclose(var, want_var, rtol=1e-6 * want_sq.max() / want_var.min())


@pytest.mark.parametrize("cin", [32, 96])
@pytest.mark.parametrize("vol", VOLUMES, ids=VOLUMES.keys())
def test_gn1_partials_combine_to_the_direct_moments(vol, cin):
    """bf16's GN1 moments in one pass: each block's sums and sums of squares
    of MOMENT_ROWS positions of one sample by group (96 channels: groups of
    12, which 8-channel loads straddle), summed in chunk order as GN2's."""
    t, h, w = VOLUMES[vol]
    volume, batch = t * h * w, 3
    rng = np.random.default_rng(volume + cin)
    x = torch.from_numpy((rng.normal(size=(batch * volume, cin)) * 1.5 + 0.3)
                         .astype(np.float32)).bfloat16().float().numpy()
    chunks, cg = -(-volume // MOMENT_ROWS), cin // GROUPS
    part = np.zeros((batch, chunks, 1, GROUPS, 2), np.float32)
    for b in range(batch):
        for k in range(chunks):
            rows = x[b * volume + k * MOMENT_ROWS:b * volume + min((k + 1) * MOMENT_ROWS, volume)]
            for g in range(GROUPS):
                v = rows[:, g * cg:(g + 1) * cg].astype(np.float64)
                part[b, k, 0, g] = v.sum(), (v * v).sum()
    mean, var = combined_moments(part, volume, cg)
    want_mean, want_var, want_sq = direct_moments(x, batch, GROUPS)
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
    part = kernel_partials(stored, (batch, t, h, w), plan.tile, plan.bn, GROUPS)
    assert part.shape[1] * batch == plan.m_tiles
    mean, var = combined_moments(part, volume, cout // GROUPS)
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
    # The halo block: 128 GEMM rows a 64-row tile pair, one 32-channel atom.
    assert bf.bm in (128, 256, 512) and (bf.bn, bf.bk, bf.launches) == (32, 0, 5)
    tb, hb = bf.tile
    assert tb * hb * (w + 2) <= bf.bm and bf.box == (tb + 2, hb + 2, w + 2)
    assert bf.m_tiles == batch * -(-t // tb) * -(-h // hb) and bf.n_tiles == 1
    assert bf.a1_elems == positions * cin and bf.h1_elems == positions * cout
    # GN1's partials (bf16: a chunk of MOMENT_ROWS positions each) or its
    # (mean, rstd) (f32), then the GN2 partials (bf16) or GN2's (f32).
    chunks = -(-(t * h * w) // MOMENT_ROWS)
    assert bf.workspace_floats == 2 * batch * GROUPS * chunks + bf.m_tiles * 2 * GROUPS
    f32 = resblock_plan(batch, t, h, w, cin, cout, GROUPS, torch.float32)
    assert (f32.bm, f32.bk, f32.launches, f32.a1_elems) == (128, 16, 4, 0)
    assert f32.bn == 32 and f32.h1_elems == positions * cout
    assert f32.workspace_floats == 2 * 2 * batch * GROUPS


def test_tiles_span_at_most_two_samples():
    """The wrapper's least volume is the f32 tiles' rows, so no f32 tile
    spans three samples, and a bf16 tile (whole rows of W + 2 columns,
    more than 128 at the least volume) lies in one sample; the f32 tile is
    64 channels wide only where that still makes two waves on 132 SMs."""
    f32 = resblock_plan(4, 1, 1, MIN_VOLUME, 32, 32, GROUPS, torch.float32)
    assert f32.bm <= MIN_VOLUME
    for t, h, w in ((1, 1, MIN_VOLUME), (2, 8, 8), (8, 12, 36)):
        bf = resblock_plan(4, t, h, w, 32, 32, GROUPS, torch.bfloat16)
        assert bf.tile[0] <= t and bf.tile[1] <= h and bf.m_tiles % 4 == 0
    wide = resblock_plan(64, 8, 12, 36, 64, 64, GROUPS, torch.float32)
    narrow = resblock_plan(1, 1, 1, 128, 64, 64, GROUPS, torch.float32)
    assert (wide.bn, wide.n_tiles) == (64, 1) and (narrow.bn, narrow.n_tiles) == (32, 2)
    assert resblock_plan(2, 1, 1, 128, 16, 16, GROUPS, torch.float32).bn == 16


# Fused block shapes: the serving UNet's level 0 at every bucket, then the
# other configs' and the quickstarts' widths (base 16 and 64, a widening).
PLANNED = ([(b, *LEVELS[0], ci, co) for b in (1, 2, 4, 8, 16, 32, 64, 256)
            for ci, co in RESBLOCK_SHAPES]
           + [(b, *LEVELS[0], ci, co) for b in (1, 8, 64)
              for ci, co in ((16, 16), (48, 16), (32, 16), (64, 64), (192, 64), (128, 64),
                             (32, 64), (24, 24), (128, 128))]
           + [(4, 16, 12, 36, 32, 32), (8, 8, 14, 24, 96, 32), (2, 4, 16, 16, 64, 32)])


@pytest.mark.parametrize("shape", PLANNED, ids=["x".join(map(str, s)) for s in PLANNED])
def test_halo_plans_fit_the_card(shape):
    """At every planned shape both convs' blocks are built ones, their
    shared memory is at most 227 KB (the library's own count: the same
    formula), the registers a consumer thread's arrays take are at most
    224 (65,536 over 288 threads), and the work items cover the volume."""
    batch, t, h, w, cin, cout = shape
    plan = resblock_plan(batch, t, h, w, cin, cout, GROUPS, torch.bfloat16)
    mt, na = plan.bm // 128, plan.bn // 32
    tb, hb = plan.tile
    for i, conv1 in enumerate((True, False)):
        assert (mt, na, plan.kc[i]) in HALO_BLOCKS
        assert 2 <= plan.stages[i] <= 4 and plan.nbox[i] in (1, 2)
        npos = (tb + 2) * (hb + 2) * (w + 2)
        assert plan.smem_bytes[i] == halo_smem_bytes(conv1, na, plan.kc[i], npos,
                                                     plan.stages[i], plan.nbox[i])
        assert plan.smem_bytes[i] <= SMEM_LIMIT
    assert plan.registers == max(halo_registers(mt, na, k) for k in plan.kc)
    assert plan.registers <= HALO_REGISTERS <= 255
    assert tb * hb * (w + 2) <= plan.bm and w + 2 <= 256
    assert plan.m_tiles == batch * -(-t // tb) * -(-h // hb)
    assert plan.n_tiles == -(-cout // plan.bn)
    # The work items fill 90% of the card, or the block is the smallest.
    assert plan.m_tiles * plan.n_tiles >= 0.9 * 132 or mt == 1


def _silu(x):
    return x * torch.sigmoid(x)


def _halo_conv(a, wmat, cin, cout, plan, kc, skip=None):
    """One conv as the kernel cuts it, in f32: per work item (a tile of
    whole rows of one sample), the chunks of kc channels in order, each
    chunk's 27 taps in order (A the zero-padded input's rows at the tap's
    offset, against the weight rows of that tap and chunk), then with
    ``skip = (x, Cin)`` each chunk of x at the centre against the rows after
    27·cin; → the (B, T, H, W, Cout) sums."""
    batch, t, h, w, _ = a.shape
    tb, hb = plan.tile
    pad = F.pad(a, (0, 0, 1, 1, 1, 1 + hb, 1, 1 + tb))
    out = torch.zeros(batch, t, h, w, cout)
    for b in range(batch):
        for t0 in range(0, t, tb):
            for h0 in range(0, h, hb):
                acc = torch.zeros(tb, hb, w, cout)
                for c0 in range(0, cin, kc):
                    c1 = min(c0 + kc, cin)
                    for j in range(27):
                        dt, dh, dw = j // 9, j // 3 % 3, j % 3
                        rows = pad[b, t0 + dt:t0 + dt + tb, h0 + dh:h0 + dh + hb,
                                   dw:dw + w, c0:c1]
                        acc = acc + rows @ wmat[j * cin + c0:j * cin + c1]
                if skip is not None:
                    x, xc = skip
                    xp = F.pad(x, (0, 0, 0, 0, 0, hb, 0, tb))
                    for c0 in range(0, xc, kc):
                        c1 = min(c0 + kc, xc)
                        rows = xp[b, t0:t0 + tb, h0:h0 + hb, :, c0:c1]
                        acc = acc + rows @ wmat[27 * cin + c0:27 * cin + c1]
                te, he = min(tb, t - t0), min(hb, h - h0)
                out[b, t0:t0 + te, h0:h0 + he] = acc[:te, :he]
    return out


def _gn_silu(h, part, vol, gamma, beta):
    """silu(GN(h)) with each (sample, group)'s moments from ``part`` summed
    in order (E[h²] − E[h]²), f32."""
    cg = h.shape[-1] // GROUPS
    mean, var = combined_moments(part, vol, cg)
    rstd = 1.0 / np.sqrt(var + np.float32(EPS))
    m = torch.from_numpy(np.repeat(mean, cg, axis=1))[:, None, None, None, :]
    r = torch.from_numpy(np.repeat(rstd, cg, axis=1))[:, None, None, None, :]
    return _silu((h - m) * r * gamma + beta)


def _resblock_replay(x, temb, w, plan):
    """The bf16 path in f32 on the kernel's tiles and sums: GN1's moments
    from chunks of MOMENT_ROWS positions; GN1 + SiLU; conv1 (+ b1 +
    temb_proj); GN2's from the tiles' partials summed in tile order; GN2 +
    SiLU; conv2 with the skip as extra K (+ b2 [+ b_skip], or + x)."""
    p = pack_resblock(w, torch.float32)
    batch, t, h, wd, cin = x.shape
    cout, vol = p["cout"], t * h * wd
    rows = [np.arange(k, min(k + MOMENT_ROWS, vol)) for k in range(0, vol, MOMENT_ROWS)]
    xs = x.reshape(batch, vol, cin).numpy().astype(np.float64)
    part1 = np.zeros((batch, len(rows), 1, GROUPS, 2), np.float32)
    for b in range(batch):
        for k, r in enumerate(rows):
            for g in range(GROUPS):
                v = xs[b, r, g * (cin // GROUPS):(g + 1) * (cin // GROUPS)]
                part1[b, k, 0, g] = v.sum(), (v * v).sum()
    a1 = _gn_silu(x, part1, vol, p["gamma1"], p["beta1"])
    h1 = _halo_conv(a1, p["w1"], cin, cout, plan, plan.kc[0])
    h1 = h1 + (temb.float() + p["b1"])[:, None, None, None, :]
    part = kernel_partials(h1.reshape(-1, cout).numpy(), (batch, t, h, wd), plan.tile,
                           plan.bn, GROUPS)
    a2 = _gn_silu(h1, part, vol, p["gamma2"], p["beta2"])
    out = _halo_conv(a2, p["w2"], cout, cout, plan, plan.kc[1],
                     (x, cin) if p["has_skip"] else None) + p["bias2"]
    return out if p["has_skip"] else out + x


@pytest.mark.parametrize("cin,cout", [(16, 16), (48, 16), (32, 64)],
                         ids=["identity", "skip_chunks", "widening"])
def test_blocked_replay_matches_the_twin_and_jax(cin, cout):
    """A small volume (2 samples of 4 × 6 × 8, two tiles each; 48 channels
    in three 16-deep chunks, the skip's too): the replay of the kernel's
    tiles, chunks, taps and GN2 partials equals the f32 twin and the JAX
    Pallas kernel in interpret mode within 1e-5 of max|ref|."""
    rng = np.random.default_rng(cin * 100 + cout)
    n = lambda shape, sc: (rng.normal(size=shape) * sc).astype(np.float32)  # noqa: E731
    w = {"gn1_scale": 1 + n((cin,), 0.1), "gn1_bias": n((cin,), 0.1),
         "w1": n((3, 3, 3, cin, cout), (27 * cin) ** -0.5), "b1": n((cout,), 0.1),
         "gn2_scale": 1 + n((cout,), 0.1), "gn2_bias": n((cout,), 0.1),
         "w2": n((3, 3, 3, cout, cout), (27 * cout) ** -0.5), "b2": n((cout,), 0.1)}
    if cin != cout:
        w["w_skip"] = n((1, 1, 1, cin, cout), cin ** -0.5)
        w["b_skip"] = n((cout,), 0.1)
    x, temb = n((2, 4, 6, 8, cin), 1.0), n((2, cout), 1.0)
    plan = resblock_plan(2, 4, 6, 8, cin, cout, GROUPS, torch.bfloat16, mt=1)
    assert plan.m_tiles == 4, plan  # two tiles a sample
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = _resblock_replay(torch.from_numpy(x), torch.from_numpy(temb), tw, plan)
    ref = resblock_reference(torch.from_numpy(x), torch.from_numpy(temb), tw)
    jax_out = np.asarray(jax_fused_resblock(x, temb, {k: jnp.asarray(v) for k, v in w.items()},
                                            mode="interpret"))
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=0, atol=1e-5 * scale)


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
