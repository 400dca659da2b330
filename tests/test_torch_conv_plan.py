"""The conv kernels' halo plans, checked without a card.

``im2col_plan``/``tapgemm_plan`` (``crowdmod_tpu_torch/ops/kernels/conv3d.py``)
decide how each conv call is cut into blocks; the bf16 kernel in
``csrc/conv3d.cu`` loads, per block and channel chunk, a halo box of the
input by TMA and reads every tap at a constant offset of its flat
positions.  These tests replay that arithmetic in Python for every conv
shape of the UNet's serving path (``chip_smoke.CONV_SHAPES`` at batch 64)
and at a small size: the tiles cover each output once, every tap lands on
its input position in the box (on a zero exactly outside the volume), the
K walk reduces each (tap, channel) once, the shared memory and TMA boxes
keep the card's limits, the thin level-2 grid fills the card, and an
emulation of the blocked computation gives the plain twin's and the JAX
package's conv.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CONV_SHAPES, LEVELS, UNET_BATCH
from crowdmod_tpu.ops.pallas.conv3d import conv3d_same_im2col as jax_conv3d_im2col
from crowdmod_tpu.ops.pallas.conv3d import conv3d_same_tapgemm as jax_conv3d_tapgemm
from crowdmod_tpu_torch.ops.kernels import (
    conv3d_same_im2col,
    conv3d_same_reference,
    conv3d_same_tapgemm,
    reset_launch_counts,
)
from crowdmod_tpu_torch.ops.kernels.conv3d import (
    HALO_TILES,
    IM2COL_MAX_WIDTH,
    MAX_STAGES,
    SMEM_LIMIT,
    SMS,
    TAPGEMM_MAX_WIDTH,
    halo_plan,
    halo_smem_bytes,
    im2col_plan,
    narrow_smem_bytes,
    pack_im2col,
    pack_tapgemm,
    stage_rows,
    tapgemm_plan,
)

SMALL = (2, 2, 3, 9)  # batch and the level-2 volume of a tiny UNet
SIZES = {"b64": lambda level: (UNET_BATCH, *LEVELS[level]),
         "small": lambda level: SMALL}
CASES = [(size, level, cin, cout) for size in SIZES
         for level, cin, cout in CONV_SHAPES]
IDS = [f"{s}-L{lv}-{ci}to{co}" for s, lv, ci, co in CASES]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
PLANNERS = {"im2col": im2col_plan, "tapgemm": tapgemm_plan}


def _shape(size, level, cin):
    return (*SIZES[size](level), cin)


# ---------------------------------------------------------------------------
# The kernel's index arithmetic, written out (csrc/conv3d.cu,
# conv3d_halo_kernel)
# ---------------------------------------------------------------------------

def _blocks(shape, plan):
    """The output tiles' origins (b0, t0, h0), in blockIdx.x order."""
    b, t, h = shape[:3]
    bb, tb, hb = plan.tile
    return [(bi * bb, ti * tb, hi * hb) for bi in range(-(-b // bb))
            for ti in range(-(-t // tb)) for hi in range(-(-h // hb))]


def _centers(plan, w):
    """Box position under each GEMM row at tap offset 0 (rows past the tile
    read an interior position)."""
    bb, tb, hb = plan.tile
    pt, ph, pw = tb + 2, hb + 2, w + 2
    m = np.arange(plan.bm)
    r = m // pw
    hh, r = r % hb, r // hb
    center = ((r // tb * pt + r % tb + 1) * ph + hh + 1) * pw + m % pw
    return np.where(m < plan.rows, center, (ph + 1) * pw + 1)


def _tap_offsets(impl, plan, w):
    """Flat box offset of each im2col tap (kd, kh, kw) or tap-GEMM slab
    (kd, kh)."""
    ph, pw = plan.tile[2] + 2, w + 2
    if impl == "tapgemm":
        return [(j // 3 - 1) * ph * pw + (j % 3 - 1) * pw for j in range(9)]
    return [(j // 9 - 1) * ph * pw + (j // 3 % 3 - 1) * pw + (j % 3 - 1) for j in range(27)]


def _out_index(shape, plan, origin):
    """Flat output position (b, t, h, w) of each GEMM row of the tile at
    ``origin``, or -1 (a pad column, a row past the tile or outside the
    volume)."""
    b, t, h, w = shape[:4]
    bb, tb, hb = plan.tile
    pw = w + 2
    m = np.arange(plan.bm)
    r = m // pw
    hh, r = r % hb, r // hb
    bi, ti, hi = origin[0] + r // tb, origin[1] + r % tb, origin[2] + hh
    live = (m < plan.rows) & (m % pw >= 1) & (m % pw <= w) & (bi < b) & (ti < t) & (hi < h)
    return np.where(live, ((bi * t + ti) * h + hi) * w + m % pw - 1, -1)


def _box(x, plan, origin, c0):
    """The halo box TMA loads: positions (bb, tb+2, hb+2, W+2) from (b0,
    t0-1, h0-1, -1), channels c0 .. c0 + kc, zero outside the volume and
    past Cin; flattened to (positions, kc)."""
    b, t, h, w, cin = x.shape
    bb, tb, hb = plan.tile
    kc = plan.kc
    xp = torch.zeros((b + bb, t + tb + 2, h + hb + 2, w + 2, cin + kc), dtype=x.dtype)
    xp[:b, 1:t + 1, 1:h + 1, 1:w + 1, :cin] = x
    b0, t0, h0 = origin
    box = xp[b0:b0 + bb, t0:t0 + tb + 2, h0:h0 + hb + 2, :, c0:c0 + kc]
    return box.reshape(-1, kc)


def emulate(impl, x, w_packed, bias, plan):
    """The blocked halo computation in f32 torch: per tile, split and
    channel chunk, the box; per tap the A rows at the clamped flat offsets,
    times the packed weight's rows (tap · Cin + c0 ..; TMA gives zeros past
    its end); then the epilogue (tap-GEMM: the shifted accumulate); splits
    summed in order, the bias last."""
    b, t, h, w, cin = x.shape
    tap = impl == "tapgemm"
    taps = 9 if tap else 27
    wmat = w_packed.reshape(taps * cin, -1).float()
    ncol = wmat.shape[1]
    cout = ncol // 3 if tap else ncol
    kc, pw = plan.kc, w + 2
    wpad = torch.cat([wmat, torch.zeros((kc, ncol))])
    centers = _centers(plan, w)
    offsets = _tap_offsets(impl, plan, w)
    npos = int(np.prod(plan.box))
    out = torch.zeros((b, t, h, w, cout))
    for origin in _blocks(x.shape, plan):
        partials = []
        for lo, hi in plan.split_taps(taps):
            acc = torch.zeros((plan.bm, ncol))
            for c0 in range(0, cin, kc):
                box = _box(x.float(), plan, origin, c0)
                for j in range(lo, hi):
                    p = np.clip(centers + offsets[j], 0, npos - 1)
                    acc += box[p] @ wpad[j * cin + c0:j * cin + c0 + kc]
            partials.append(acc)
        index = _out_index(x.shape, plan, origin)
        m = np.nonzero(index >= 0)[0]
        for acc in partials:
            if tap:  # out[w] = Z[w, kw 0] + Z[w + 1, kw 1] + Z[w + 2, kw 2]
                z = sum(acc[m - 1 + kw, kw * cout:(kw + 1) * cout] for kw in range(3))
            else:
                z = acc[m, :cout]
            out.view(-1, cout)[index[m]] += z
    return out + (0 if bias is None else bias.float())


# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", PLANNERS)
@pytest.mark.parametrize("size,level,cin,cout", CASES, ids=IDS)
def test_tiles_cover_each_output_once(size, level, cin, cout, impl):
    shape = _shape(size, level, cin)
    plan = PLANNERS[impl](shape, cout, torch.bfloat16)
    seen = np.zeros(int(np.prod(shape[:4])), dtype=int)
    origins = _blocks(shape, plan)
    ntiles = 1 if impl == "tapgemm" and plan.bn < 192 else -(-cout // 64)
    assert plan.blocks == len(origins) * ntiles * plan.splits
    for origin in origins:
        index = _out_index(shape, plan, origin)
        np.add.at(seen, index[index >= 0], 1)
    np.testing.assert_array_equal(seen, 1)


TAP_CASES = [c for c in CASES if c[0] == "small"] + [("b1", 0, 3, 32)]


@pytest.mark.parametrize("impl", PLANNERS)
@pytest.mark.parametrize("size,level,cin,cout", TAP_CASES,
                         ids=[f"{s}-L{lv}-{ci}to{co}" for s, lv, ci, co in TAP_CASES])
def test_taps_land_on_their_input_in_the_box(size, level, cin, cout, impl):
    """Every tap of every live row reads, inside the box, the position it
    shifts to, and a zero exactly where that leaves the volume (the box
    holds each input position's id + 1)."""
    shape = _shape(size, level, cin) if size in SIZES else (1, *LEVELS[level], cin)
    b, t, h, w = shape[:4]
    plan = PLANNERS[impl](shape, cout, torch.bfloat16)
    ids = torch.arange(1, b * t * h * w + 1, dtype=torch.float64).reshape(b, t, h, w, 1)
    centers = _centers(plan, w)
    npos = int(np.prod(plan.box))
    # Each live row's output coordinates, and every tap (slab and kw) shift.
    shifts = np.array([(j // 9 - 1, j // 3 % 3 - 1, j % 3 - 1) for j in range(27)])
    slab = np.array([(j // 9) * 3 + j // 3 % 3 for j in range(27)])
    offsets = np.array(_tap_offsets(impl, plan, w))
    # tap-GEMM reads slab (kd, kh) at every padded column: kw is the column
    # offset of the row it sums into (the shifted accumulate).
    tap_off = offsets[slab] + shifts[:, 2] if impl == "tapgemm" else offsets
    for origin in _blocks(shape, plan):
        box = _box(ids, plan, origin, 0)[:, 0].numpy()
        index = _out_index(shape, plan, origin)
        m = np.nonzero(index >= 0)[0]
        pos = np.stack(np.unravel_index(index[m], (b, t, h, w)), axis=1)
        p = centers[m][:, None] + tap_off[None, :]
        assert ((p >= 0) & (p < npos)).all()
        q = pos[:, None, 1:] + shifts[None]
        inside = ((q >= 0) & (q < np.array([t, h, w]))).all(axis=2)
        want = np.where(inside, 1 + np.ravel_multi_index(
            (np.broadcast_to(pos[:, None, 0], inside.shape), *np.moveaxis(
                np.clip(q, 0, np.array([t, h, w]) - 1), 2, 0)), (b, t, h, w)), 0)
        np.testing.assert_array_equal(box[p], want)


def _k_walk(impl, plan, cin):
    """The (tap, channel) pairs each split reduces, in the kernel's order:
    per channel chunk of kc, the split's taps (slabs); channels past Cin
    read zeros."""
    taps = 9 if impl == "tapgemm" else 27
    return [[(j, c) for c0 in range(0, cin, plan.kc) for j in range(lo, hi)
             for c in range(c0, min(c0 + plan.kc, cin))]
            for lo, hi in plan.split_taps(taps)]


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("size,level,cin,cout", CASES, ids=IDS)
def test_im2col_chunks_cover_k_once_on_whole_taps(size, level, cin, cout, dtype):
    plan = im2col_plan(_shape(size, level, cin), cout, dtype)
    if plan.route != "halo":  # the f32 kernels walk the flat K themselves
        assert plan.splits == 1
        return
    splits = plan.split_taps()
    assert len(splits) == plan.splits in (1, 2, 3, 9)
    assert splits[0][0] == 0 and splits[-1][1] == 27
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(splits, splits[1:]))
    seen = np.zeros((27, cin), dtype=int)
    for (lo, hi), walk in zip(splits, _k_walk("im2col", plan, cin)):
        for j, c in walk:
            seen[j, c] += 1
            assert lo <= j < hi
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("size,level,cin,cout", CASES, ids=IDS)
def test_plans_of_the_path(size, level, cin, cout):
    shape = _shape(size, level, cin)
    b, t, h, w = shape[:4]
    positions = b * t * h * w
    for impl, planner in PLANNERS.items():
        bf, f32 = planner(shape, cout, torch.bfloat16), planner(shape, cout, torch.float32)
        assert f32.splits == 1 and f32.route in ("simt", "narrow")
        assert bf.route == "halo" and (impl, bf.bm, bf.bn, bf.kc) in HALO_TILES
        # The chunk is 64 channels where Cin takes them, else 32 (16 or 8
        # for a narrow Cin); TMA carries the box where positions are 16-byte
        # runs.
        assert bf.kc == (64 if cin % 64 == 0 else 32 if cin > 16 else 16 if cin > 8 else 8)
        assert bf.kc > 8 or bf.splits == 1  # the packed stages walk all 27 taps
        assert bf.tma_x == (cin % 8 == 0) and bf.tma_w == (cout % 8 == 0)
        bb, tb, hb = bf.tile
        assert bf.box == (bb, tb + 2, hb + 2, w + 2) and bf.rows == bb * tb * hb * (w + 2)
        assert bf.rows <= bf.bm and (bb == 1 or (tb, hb) == (t, h))
        assert 2 <= bf.stages <= MAX_STAGES and bf.nbox in (1, 2)
        # The workspace: one f32 partial output a split, none unsplit.
        want = bf.splits * positions * cout if bf.splits > 1 else 0
        assert bf.workspace_elems(positions, cout) == want
    tap = tapgemm_plan(shape, cout, torch.bfloat16)
    # Three kw atoms of 64 channels, or the compact 3·Cout columns.
    assert tap.bm == 128 and tap.bn == (192 if 3 * cout > 128 else 64 * -(-3 * cout // 64))
    # f32 Cout <= 4 (the final conv) takes the narrow kernel.
    assert (im2col_plan(shape, cout, torch.float32).route == "narrow") == (cout <= 4)


@pytest.mark.parametrize("impl", PLANNERS)
@pytest.mark.parametrize("size,level,cin,cout", CASES, ids=IDS)
def test_blocks_keep_the_cards_limits(size, level, cin, cout, impl):
    """Shared memory within 232,448 bytes (the boxes, the stages and
    tap-GEMM's Z tile, as the kernel lays them out), TMA box dimensions of
    at most 256 with inner rows of a multiple of 16 bytes, and the swizzle
    spans the chunk and atom rows need."""
    shape = _shape(size, level, cin)
    for dtype in DTYPES.values():
        plan = PLANNERS[impl](shape, cout, dtype)
        assert plan.smem_bytes <= SMEM_LIMIT == 232448
        if plan.route == "narrow":
            assert plan.smem_bytes == narrow_smem_bytes(cin, *plan.tile[1:], shape[3])
            assert plan.smem_bytes <= SMEM_LIMIT // 2  # two blocks a multiprocessor
        if plan.route != "halo":
            continue
        npos = int(np.prod(plan.box))
        assert plan.smem_bytes == halo_smem_bytes(impl == "tapgemm", plan.bm, plan.bn,
                                                  plan.kc, npos, plan.stages, plan.nbox)
        assert max(plan.box) <= 256 and plan.kc <= 256
        # x box: kc bf16 a position (no swizzle, or a 32-, 64- or 128-byte
        # span); weight box: 64 bf16 columns (128 bytes).
        assert (plan.kc * 2) % 16 == 0 and plan.kc * 2 in (16, 32, 64, 128) and 64 * 2 == 128
        # Each box and stage starts on a 1024-byte swizzle repeat.
        assert (plan.bn // 64 * stage_rows(plan.kc) * 128) % 1024 == 0


@pytest.mark.parametrize("level,cin,cout", [k for k in CONV_SHAPES if k[0] == 2],
                         ids=lambda v: str(v))
def test_level2_grids_fill_the_card(level, cin, cout):
    shape = (UNET_BATCH, *LEVELS[level], cin)
    plan = im2col_plan(shape, cout, torch.bfloat16)
    assert plan.splits > 1 and plan.blocks >= 0.9 * SMS
    assert tapgemm_plan(shape, cout, torch.bfloat16).blocks >= 0.9 * SMS
    # Without the split the tiles alone are under 90% of one wave.
    assert plan.blocks // plan.splits < 0.9 * SMS
    # A card with more multiprocessors splits where this one does not.
    wide = im2col_plan((UNET_BATCH, *LEVELS[1], 128), 128, torch.bfloat16)
    assert wide.splits == 1 and wide.blocks < 2 * SMS
    assert im2col_plan((UNET_BATCH, *LEVELS[1], 128), 128, torch.bfloat16,
                       2 * wide.blocks).splits == 2


def test_thin_grids_take_the_128_row_im2col_block():
    """The serving bucket of 1 (and 8 below level 0) makes under a quarter
    of the card's items with 256-row tiles: im2col takes 128-row blocks,
    with the most splits that keep one wave; batch 64 keeps 256 rows."""
    for batch, level, cin, cout, bm, splits in [
            (1, 0, 64, 64, 128, 3), (1, 1, 32, 64, 128, 9), (1, 2, 128, 128, 128, 9),
            (8, 0, 64, 64, 256, 1), (8, 1, 64, 64, 128, 3),
            (64, 1, 64, 64, 256, 1), (64, 2, 128, 128, 256, 3)]:
        plan = im2col_plan((batch, *LEVELS[level], cin), cout, torch.bfloat16)
        assert (plan.bm, plan.splits) == (bm, splits), (batch, level, plan)
        assert plan.blocks <= SMS or plan.splits == 1


def test_unsplit_level0_plans_keep_whole_tiles():
    plan = im2col_plan((UNET_BATCH, *LEVELS[0], 64), 64, torch.bfloat16)
    assert (plan.bm, plan.bn, plan.kc, plan.tile, plan.box, plan.splits, plan.blocks) == (
        256, 64, 64, (1, 2, 3), (1, 4, 5, 38), 1, 1024)
    assert plan.tma_x and plan.tma_w and plan.rows == 228
    first = im2col_plan((UNET_BATCH, *LEVELS[0], 3), 32, torch.bfloat16)
    assert (first.kc, first.splits, first.tma_x, first.tma_w) == (8, 1, False, True)
    final = im2col_plan((UNET_BATCH, *LEVELS[0], 32), 3, torch.float32)
    assert (final.route, final.tile, final.splits, final.blocks) == ("narrow", (1, 2, 2), 1, 1536)


@pytest.mark.parametrize("volume", [(1, 1, 1, 5), SMALL, (64, 8, 12, 36)],
                         ids=["one_row", "small", "level0"])
def test_every_plan_names_a_built_tile(volume):
    """Any channel counts, not only the path's: the plan picks a halo block
    the kernels are built with, a chunk that block holds, and a tile whose
    rows fit it."""
    for cin in (3, 8, 24, 32, 40, 64, 96, 128, 192, 256):
        for cout in (1, 3, 8, 16, 32, 48, 64, 96, 128, 200):
            shape = (*volume, cin)
            for impl, planner in PLANNERS.items():
                p = planner(shape, cout, torch.bfloat16)
                assert (impl, p.bm, p.bn, p.kc) in HALO_TILES, (cin, cout, p)
                assert p.rows <= p.bm and p.smem_bytes <= SMEM_LIMIT


def test_forced_blocks_hold_their_columns():
    """``--conv-tiles`` forces each built block: a compact tap-GEMM block
    takes only a Cout whose 3·Cout columns it holds."""
    shape = (UNET_BATCH, *LEVELS[0], 64)
    for bn in (64, 128):
        with pytest.raises(ValueError, match="do not fit"):
            halo_plan("tapgemm", shape, 64, block=(128, bn))
    assert halo_plan("tapgemm", shape, 32, block=(128, 128)).bn == 128
    assert halo_plan("tapgemm", shape, 64, block=(128, 192)).bn == 192
    assert [halo_plan("im2col", shape, 64, splits=k).splits for k in (1, 2, 3, 9)] == [1, 2, 3, 9]


def test_tapgemm_width_limit():
    assert TAPGEMM_MAX_WIDTH == 126
    tapgemm_plan((1, 1, 1, TAPGEMM_MAX_WIDTH, 8), 8, torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        tapgemm_plan((1, 1, 1, TAPGEMM_MAX_WIDTH + 1, 8), 8, torch.bfloat16)


def test_im2col_width_limit():
    """A 256-row block holds one padded row of up to 254 columns."""
    assert IM2COL_MAX_WIDTH == 254
    wide = im2col_plan((1, 1, 1, IM2COL_MAX_WIDTH, 8), 128, torch.bfloat16)
    assert (wide.bm, wide.bn, wide.rows) == (256, 64, 256)
    with pytest.raises(ValueError, match="does not fit"):
        im2col_plan((1, 1, 1, IM2COL_MAX_WIDTH + 1, 8), 8, torch.bfloat16)


# ---------------------------------------------------------------------------
# The blocked computation against the twin and the JAX package
# ---------------------------------------------------------------------------

# (volume, Cin, Cout, multiprocessors the plan fills): Cin 3 and 8 take the
# packed stages; the card's 132 multiprocessors give the small volumes
# 128-row im2col blocks and 9 splits; 6 make (1, 3, 4, 5) split in 3, 8
# give (1, 5, 5, 14) ragged 256-row tiles in 3 splits, 2 the last 2 splits.
EMULATED = [(SMALL, 24, 16, SMS), (SMALL, 3, 8, SMS), (SMALL, 8, 24, SMS),
            (SMALL, 40, 3, SMS), ((1, 3, 4, 5), 64, 72, 6), ((1, 5, 5, 14), 16, 24, 8),
            ((3, 2, 3, 4), 16, 8, 2)]


@pytest.mark.parametrize("impl", PLANNERS)
@pytest.mark.parametrize("volume,cin,cout,sms", EMULATED, ids=lambda v: str(v))
def test_halo_emulation_matches_twin_and_jax(volume, cin, cout, sms, impl):
    """The kernel's blocks, chunks, tap offsets and epilogue, emulated in
    f32 at a small size (ragged tiles, Cin % 8 != 0, Cin past a chunk,
    Cout % 8 != 0, two splits or three), against the plain twin and the JAX
    package's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(cin * 100 + cout)
    x = rng.normal(size=(*volume, cin)).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, 3, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    plan = PLANNERS[impl](x.shape, cout, torch.bfloat16, sms)
    pack = pack_tapgemm if impl == "tapgemm" else pack_im2col
    got = emulate(impl, torch.from_numpy(x), pack(torch.from_numpy(kernel)),
                  torch.from_numpy(bias), plan)
    twin = conv3d_same_reference(torch.from_numpy(x), torch.from_numpy(kernel),
                                 torch.from_numpy(bias))
    torch.testing.assert_close(got, twin, rtol=1e-5, atol=1e-5)
    jax_conv = jax_conv3d_tapgemm if impl == "tapgemm" else jax_conv3d_im2col
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(kernel), interpret=True)) + bias
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_emulation_runs_the_split_and_ragged_plans():
    """The emulated cases take the plans they are there for."""
    plans = {(v, ci, co, impl): PLANNERS[impl]((*v, ci), co, torch.bfloat16, sms)
             for (v, ci, co, sms), impl in itertools.product(EMULATED, PLANNERS)}
    assert {p.splits for p in plans.values()} >= {2, 3, 9}
    assert any(not p.tma_x for p in plans.values()) and any(not p.tma_w for p in plans.values())
    assert any(ci > p.kc for (v, ci, co, impl), p in plans.items())
    assert {p.kc for p in plans.values()} == {8, 16, 32, 64}
    assert {p.bm for (v, ci, co, impl), p in plans.items() if impl == "im2col"} == {128, 256}
    assert any(any(n % k for n, k in zip(v, p.tile)) for (v, ci, co, impl), p in plans.items())


@pytest.mark.parametrize("cin,cout", [(64, 32), (256, 16), (3, 32), (24, 3)],
                         ids=["split", "wide", "cin3", "cout3"])
def test_cpu_wrappers_run_the_twin_and_count_no_launch(cin, cout):
    """A CPU tensor takes the twin whatever the plan (here a split-K one
    where Cin > 8), and no launch is counted."""
    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.normal(size=(*SMALL, cin)).astype(np.float32))
    kernel = torch.from_numpy(
        (rng.normal(size=(3, 3, 3, cin, cout)) * 0.05).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    assert (im2col_plan(tuple(x.shape), cout, torch.bfloat16).splits > 1) == (cin > 8)
    reset_launch_counts()
    ref = conv3d_same_reference(x, kernel, bias)
    torch.testing.assert_close(conv3d_same_im2col(x, pack_im2col(kernel), bias), ref,
                               rtol=0, atol=0)
    torch.testing.assert_close(conv3d_same_tapgemm(x, pack_tapgemm(kernel), bias), ref,
                               rtol=0, atol=0)
    assert conv3d_same_im2col.launches == 0 and conv3d_same_tapgemm.launches == 0
