"""Every bundled dataset's geometry on the port, held on the CPU (the
card's half is ``chip_smoke.py`` phase 19).  The grids split over two
files for time; this one holds ATC, ETHUCY, HERMES-BO and HERMES-BN
(``tests/test_torch_geometries_large.py`` the rest) and:

  * each arch's f32 forward at batch 2 and a narrow width on each grid
    against the JAX package's (weights by ``state_dict_from_jax``, one JAX
    compile a case), within 1e-4; the kernel wrappers' calls a forward
    equal to ``chip_smoke.unet_shape_tables`` (the UNets; their fused
    blocks also to the JAX ``_eligible``'s) and ``dit_attention_shapes``;
  * ``unet_shape_tables(configs/serving/ATC.yml)`` equal to the tables
    ``chip_smoke.py`` held phases 2-18 to before it derived them;
  * every plan function at every full-width kernel shape of every config
    (``chip_smoke.geometry_cases``) at the serving buckets 1, 8, 64 and
    256, within the card's shared-memory and TMA limits, its tiles
    covering each output once.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.ops.kernels.attention import MAX_SMEM, WGMMA_KEYS, attention_plan
from crowdmod_tpu_torch.ops.kernels.conv3d import halo_smem_bytes, im2col_plan, tapgemm_plan
from crowdmod_tpu_torch.ops.kernels.fused_step import ancestral_update_plan
from crowdmod_tpu_torch.ops.kernels.groupnorm import MAX_CHUNK, group_norm_plan
from crowdmod_tpu_torch.ops.kernels.resblock import (
    HALO_BLOCKS,
    HALO_REGISTERS,
    SMEM_LIMIT,
    halo_registers,
    resblock_plan,
)
from tests import torch_geometries as geo
from tests.test_torch_conv_plan import _blocks, _out_index

GRIDS = ("ATC", "ETHUCY", "HERMES-BO", "HERMES-BN")
CASES = [(g, a) for g in GRIDS for a in geo.ARCHS]
BUCKETS = (1, 8, 64, 256)
SMS = 132
# The dataset configs phase 19 runs, and ATC's own (phases 2-18's grid).
CONFIGS = ("ATC",) + chip_smoke.GEOMETRIES


@pytest.mark.parametrize("name,arch", CASES, ids=[f"{g}-{a}" for g, a in CASES])
def test_forward_and_kernel_calls_match_jax(name, arch):
    geo.check_forward(name, arch)


def test_serving_tables_are_the_atc_constants():
    """The literal tables phases 2-18 held their kernel cases and launches
    to until ``unet_shape_tables`` derived them."""
    tables = chip_smoke.unet_shape_tables(load_config("serving/ATC.yml"), "DDPM-UNet")
    assert tables["levels"] == {0: (8, 12, 36), 1: (4, 6, 18), 2: (2, 3, 9)}
    assert tables["conv"] == {
        (0, 3, 32): 1, (0, 64, 64): 1, (0, 32, 3): 1, (1, 32, 64): 1, (1, 64, 64): 3,
        (1, 192, 64): 1, (1, 96, 64): 1, (1, 128, 128): 1, (2, 64, 128): 1,
        (2, 128, 128): 7, (2, 256, 128): 1, (2, 192, 128): 1}
    assert tables["gn"] == {
        (0, 32, True): 1, (1, 32, True): 1, (1, 64, True): 3, (1, 192, True): 1,
        (1, 96, True): 1, (2, 64, True): 1, (2, 128, True): 7, (2, 128, False): 4,
        (2, 256, True): 1, (2, 192, True): 1}
    assert tables["resblock"] == [(32, 32), (96, 32), (64, 32)]
    assert tables["attention"] == {(54, 4, 32): 4}
    assert (chip_smoke.LEVELS, chip_smoke.CONV_SHAPES, chip_smoke.GN_SHAPES,
            chip_smoke.RESBLOCK_SHAPES) == tuple(
        tables[k] for k in ("levels", "conv", "gn", "resblock"))
    cfg = load_config("serving/ATC.yml")
    assert chip_smoke.PER_FORWARD["DDPM-UNet"](cfg) == {
        "fused_resblock": 3, "conv3d_same_im2col": 20, "fused_group_norm": 21,
        "fused_attention": 4}
    assert chip_smoke.TRAIN_PER_STEP["FM-UNet"](cfg) == {
        "conv3d_same_im2col": 26, "fused_group_norm": 27, "fused_attention": 4}


def test_obst_configs_share_their_base_geometry():
    assert chip_smoke.check_shared_geometries() == chip_smoke.SHARED_GEOMETRY


def _conv_fits(shape, cout, impl, dtype):
    plan = (im2col_plan if impl == "im2col" else tapgemm_plan)(shape, cout, dtype)
    assert plan.smem_bytes <= SMEM_LIMIT == 232448, (shape, cout, plan)
    if plan.route != "halo":
        return
    assert plan.smem_bytes == halo_smem_bytes(impl == "tapgemm", plan.bm, plan.bn, plan.kc,
                                              int(np.prod(plan.box)), plan.stages, plan.nbox)
    assert max(plan.box) <= 256 and plan.kc * 2 in (16, 32, 64, 128)
    seen = np.bincount(_out_indices(shape, plan), minlength=int(np.prod(shape[:4])))
    assert (seen == 1).all(), (shape, cout, impl)


def _out_indices(shape, plan) -> np.ndarray:
    """``tests/test_torch_conv_plan.py::_out_index`` over every tile at
    once: the flat output position of each live GEMM row of each block."""
    b, t, h, w = shape[:4]
    _, tb, hb = plan.tile
    pw = w + 2
    origins = np.array(_blocks(shape, plan))
    m = np.arange(plan.bm)
    r = m // pw
    hh, r = r % hb, r // hb
    bi, ti, hi = (origins[:, :1] + r // tb, origins[:, 1:2] + r % tb,
                  origins[:, 2:3] + hh)
    live = (m < plan.rows) & (m % pw >= 1) & (m % pw <= w) & (bi < b) & (ti < t) & (hi < h)
    return (((bi * t + ti) * h + hi) * w + m % pw - 1)[live]


def test_out_indices_are_the_conv_tests():
    shape = (3, 4, 6, 18, 32)
    plan = im2col_plan(shape, 64, torch.bfloat16)
    want = np.concatenate([i[i >= 0] for i in (_out_index(shape, plan, o)
                                                for o in _blocks(shape, plan))])
    np.testing.assert_array_equal(np.sort(_out_indices(shape, plan)), np.sort(want))


def _resblock_fits(shape):
    """As ``tests/test_torch_resblock_plan.py::test_halo_plans_fit_the_card``."""
    batch, t, h, w, cin, cout = shape
    plan = resblock_plan(batch, t, h, w, cin, cout, 8, torch.bfloat16)
    mt, na = plan.bm // 128, plan.bn // 32
    tb, hb = plan.tile
    for i in range(2):
        assert (mt, na, plan.kc[i]) in HALO_BLOCKS
        assert 2 <= plan.stages[i] <= 4 and plan.nbox[i] in (1, 2)
        assert plan.smem_bytes[i] <= SMEM_LIMIT
    assert plan.registers == max(halo_registers(mt, na, k) for k in plan.kc) <= HALO_REGISTERS
    assert tb * hb * (w + 2) <= plan.bm and w + 2 <= 256
    assert plan.m_tiles == batch * -(-t // tb) * -(-h // hb)
    assert plan.n_tiles == -(-cout // plan.bn)


def _attention_fits(b, h, sq, sk, dh):
    for dtype in (torch.float32, torch.bfloat16):
        plan = attention_plan(b, h, sq, sk, dh, dtype)
        assert plan.smem_bytes <= MAX_SMEM, (b, h, sq, sk, dh, plan)
        if plan.route == "wgmma":
            split, nk = plan.key_split, plan.key_block
            assert nk in WGMMA_KEYS and split * nk >= sk > (split - 1) * nk
            assert plan.smem_bytes <= (MAX_SMEM // 2 if split == 1 else MAX_SMEM)
            assert nk // 2 + dh // 2 + nk // 4 + dh // 4 <= 255


@pytest.mark.parametrize("batch", BUCKETS)
@pytest.mark.parametrize("name", CONFIGS)
def test_plans_fit_the_card_at_every_shape(name, batch):
    """Every kernel shape of the config's four models at full width and the
    bucket's batch: attention, GroupNorm, both convs (bf16; the final conv
    and every conv in f32 too), the fused blocks and the step."""
    cfg = chip_smoke.geometry_config(name)
    plan = chip_smoke.geometry_cases(cfg)
    levels, cases = plan["levels"], plan["cases"]
    for (b, h, sq, sk, dh) in cases["attention"]:
        _attention_fits(b // chip_smoke.UNET_BATCH * batch, h, sq, sk, dh)
    for level, c, _ in cases["gn"]:
        s = int(np.prod(levels[level]))
        for dtype in (torch.float32, torch.bfloat16):
            gn = group_norm_plan(batch, s, c, 8, dtype, SMS)
            assert gn.launches == 1 and gn.smem_bytes <= MAX_CHUNK < SMEM_LIMIT
    for level, cin, cout in cases["conv"]:
        shape = (batch, *levels[level], cin)
        for dtype in (torch.float32, torch.bfloat16):
            _conv_fits(shape, cout, "im2col", dtype)
        _conv_fits(shape, cout, "tapgemm", torch.bfloat16)
    for cin, cout in cases["resblock"]:
        _resblock_fits((batch, *levels[0], cin, cout))
    n = batch * cfg.DATASET.FUTURE_LEN * cfg.MACROPROPS.ROWS * cfg.MACROPROPS.COLS * 3
    step = ancestral_update_plan(n, 3, SMS)
    assert step.vec == 4 and step.head + 4 * step.vectors + step.tail == n
    assert 1 <= step.blocks
