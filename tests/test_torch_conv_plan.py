"""The conv kernels' tile plans, checked without a card.

``im2col_plan``/``tapgemm_plan`` (``crowdmod_tpu_torch/ops/kernels/conv3d.py``)
decide how each conv call is cut into blocks; the kernels in
``csrc/conv3d.cu`` walk K in the chunks the plan names.  These tests replay
that walk in Python for every conv shape of the UNet's serving path
(``chip_smoke.CONV_SHAPES`` at batch 64) and at a small size: each K index
is reduced exactly once, split-K splits cover whole taps, the workspace
matches its formula, and the thin level-2 grid fills the card.
"""

import numpy as np
import pytest
import torch

from chip_smoke import CONV_SHAPES, LEVELS, UNET_BATCH
from crowdmod_tpu_torch.ops.kernels import (
    conv3d_same_im2col,
    conv3d_same_reference,
    conv3d_same_tapgemm,
    reset_launch_counts,
)
from crowdmod_tpu_torch.ops.kernels.conv3d import (
    IM2COL_TILES,
    SMS,
    TAPGEMM_MAX_WIDTH,
    TAPGEMM_TILES,
    im2col_plan,
    pack_im2col,
    pack_tapgemm,
    tapgemm_plan,
)

SMALL = (2, 2, 3, 9)  # batch and the level-2 volume of a tiny UNet
SIZES = {"b64": lambda level: (UNET_BATCH, *LEVELS[level]),
         "small": lambda level: SMALL}
CASES = [(size, level, cin, cout) for size in SIZES
         for level, cin, cout in CONV_SHAPES]
IDS = [f"{s}-L{lv}-{ci}to{co}" for s, lv, ci, co in CASES]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _shape(size, level, cin):
    return (*SIZES[size](level), cin)


def _im2col_chunks(plan, cin):
    """The K index ranges each split reduces, in the kernel's order: chunks
    of ``kc`` channels of one tap, or ``bk``-wide chunks of the flat K."""
    K = 27 * cin
    if plan.kc == 0:
        return [[(k0, min(k0 + plan.bk, K)) for k0 in range(0, K, plan.bk)]]
    cpt = cin // plan.kc
    out = []
    for lo, hi in plan.split_taps():
        ranges = []
        for i in range((hi - lo) * cpt):
            chunk = lo * cpt + i
            tap, c0 = chunk // cpt, chunk % cpt * plan.kc
            ranges.append((tap * cin + c0, tap * cin + c0 + plan.kc))
        out.append(ranges)
    return out


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("size,level,cin,cout", CASES, ids=IDS)
def test_im2col_chunks_cover_k_once_on_whole_taps(size, level, cin, cout, dtype):
    plan = im2col_plan(_shape(size, level, cin), cout, dtype)
    splits = plan.split_taps()
    assert len(splits) == plan.splits in (1, 9)
    assert splits[0][0] == 0 and splits[-1][1] == 27
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(splits, splits[1:]))
    seen = np.zeros(27 * cin, dtype=int)
    for (lo, hi), ranges in zip(splits, _im2col_chunks(plan, cin)):
        for k0, k1 in ranges:
            seen[k0:k1] += 1
            if plan.kc:  # a chunk lies in one tap, inside its split's taps
                assert k0 // cin == (k1 - 1) // cin
                assert lo <= k0 // cin < hi
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("size,level,cin,cout", CASES, ids=IDS)
def test_plans_of_the_path(size, level, cin, cout):
    shape = _shape(size, level, cin)
    positions = int(np.prod(shape[:-1]))
    for planner in (im2col_plan, tapgemm_plan):
        bf, f32 = planner(shape, cout, torch.bfloat16), planner(shape, cout, torch.float32)
        assert f32.splits == 1 and f32.kc == 0 and f32.bk == 16
        # The K chunk divides Cin wherever rows are 16-byte runs.
        if cin % 8 == 0:
            assert bf.kc in (8, 16, 32, 64) and bf.kc <= bf.bk and cin % bf.kc == 0
        else:
            assert bf.kc == 0
        # The workspace: one f32 partial output a split, none unsplit.
        want = bf.splits * positions * cout if bf.splits > 1 else 0
        assert bf.workspace_elems(positions, cout) == want
    tap = tapgemm_plan(shape, cout, torch.bfloat16)
    assert tap.splits == 1 and tap.bn == 96
    b, t, h, w = shape[:-1]
    assert tap.blocks == -(-(b * t * h) // (tap.bm // (w + 2))) * -(-cout // 32)
    # f32 Cout <= 4 (the final conv) takes the narrow kernel (bn 4).
    assert (im2col_plan(shape, cout, torch.float32).bn == 4) == (cout <= 4)


@pytest.mark.parametrize("level,cin,cout", [k for k in CONV_SHAPES if k[0] == 2],
                         ids=lambda v: str(v))
def test_level2_grids_fill_the_card(level, cin, cout):
    shape = (UNET_BATCH, *LEVELS[level], cin)
    plan = im2col_plan(shape, cout, torch.bfloat16)
    assert plan.splits > 1 and plan.blocks >= SMS
    assert tapgemm_plan(shape, cout, torch.bfloat16).blocks >= SMS
    # Without the split the row x column tiles alone are under one wave.
    assert plan.blocks // plan.splits < SMS
    # A card with fewer multiprocessors splits where this one does not.
    wide = im2col_plan((UNET_BATCH, *LEVELS[1], 128), 128, torch.bfloat16)
    assert wide.splits == 1 and wide.blocks < 2 * SMS
    assert im2col_plan((UNET_BATCH, *LEVELS[1], 128), 128, torch.bfloat16,
                       wide.blocks + 1).splits == 9


def test_unsplit_level0_plans_keep_whole_tiles():
    plan = im2col_plan((UNET_BATCH, *LEVELS[0], 64), 64, torch.bfloat16)
    assert (plan.bm, plan.bn, plan.bk, plan.kc, plan.splits, plan.blocks) == (
        256, 64, 64, 64, 1, 864)
    first = im2col_plan((UNET_BATCH, *LEVELS[0], 3), 32, torch.bfloat16)
    assert (first.kc, first.splits) == (0, 1)


@pytest.mark.parametrize("volume", [(1, 1, 1, 5), SMALL, (64, 8, 12, 36)],
                         ids=["one_row", "small", "level0"])
def test_every_plan_names_a_built_tile(volume):
    """Any channel counts, not only the path's: the plan picks a tile the
    kernels are built with, and a K chunk that tile holds."""
    for cin in (3, 8, 24, 32, 40, 64, 96, 128, 192, 256):
        for cout in (1, 3, 8, 16, 32, 48, 64, 96, 128, 200):
            shape = (*volume, cin)
            p = im2col_plan(shape, cout, torch.bfloat16)
            q = tapgemm_plan(shape, cout, torch.bfloat16)
            assert (p.bm, p.bn, p.bk) in IM2COL_TILES, (cin, cout, p)
            assert (q.bm, q.bn, q.bk) in TAPGEMM_TILES, (cin, cout, q)
            for plan in (p, q):
                assert plan.kc <= plan.bk and (plan.kc == 0 or cin % plan.kc == 0)


def test_tapgemm_width_limit():
    assert TAPGEMM_MAX_WIDTH == 126
    tapgemm_plan((1, 1, 1, TAPGEMM_MAX_WIDTH, 8), 8, torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        tapgemm_plan((1, 1, 1, TAPGEMM_MAX_WIDTH + 1, 8), 8, torch.bfloat16)


@pytest.mark.parametrize("cin,cout", [(64, 32), (256, 16), (3, 32), (24, 3)],
                         ids=["split", "wide", "cin3", "cout3"])
def test_cpu_wrappers_run_the_twin_and_count_no_launch(cin, cout):
    """A CPU tensor takes the twin whatever the plan (here a split-K one
    for Cin % 8 == 0), and no launch is counted."""
    rng = np.random.default_rng(cin + cout)
    x = torch.from_numpy(rng.normal(size=(*SMALL, cin)).astype(np.float32))
    kernel = torch.from_numpy(
        (rng.normal(size=(3, 3, 3, cin, cout)) * 0.05).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    assert (im2col_plan(tuple(x.shape), cout, torch.bfloat16).splits > 1) == (cin % 8 == 0)
    reset_launch_counts()
    ref = conv3d_same_reference(x, kernel, bias)
    torch.testing.assert_close(conv3d_same_im2col(x, pack_im2col(kernel), bias), ref,
                               rtol=0, atol=0)
    torch.testing.assert_close(conv3d_same_tapgemm(x, pack_tapgemm(kernel), bias), ref,
                               rtol=0, atol=0)
    assert conv3d_same_im2col.launches == 0 and conv3d_same_tapgemm.launches == 0
