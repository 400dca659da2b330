"""The attention kernel's plan and its routes' arithmetic, without a card.

``attention_plan`` (``crowdmod_tpu_torch/ops/kernels/attention.py``) picks the
route of ``csrc/attention.cu`` and the block shape from the call's shape and
dtype; the wrapper passes the plan to the kernel, which rejects a plan whose
shared memory is not its own.  These tests pin the routes at the serving
shapes (the row and tile routes up to 64 keys) and at FM-DiT's (216, 336
and 432 tokens) — every other case of ``chip_smoke.py``'s phase 2 where
commit ed2c182's plan sent it — the shared-memory and register bounds at
any number of keys, the tile route's persistent walk, the row-alignment
check, and replay the row and tile routes' sums, the wgmma route's tiles
and sums, the mma route's and the streamed SIMT form's key-block sweeps in
torch against the twin (and the JAX reference and kernel in interpret
mode).
"""

from collections import Counter


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ROW_SHAPES, SHORT_ATTENTION, baseline_attention_plan
from crowdmod_tpu.ops.pallas.attention import attention_reference as jax_attention_reference
from crowdmod_tpu.ops.pallas.attention import fused_attention as jax_fused_attention

from crowdmod_tpu_torch.ops.kernels import attention_reference, fused_attention
from crowdmod_tpu_torch.ops.kernels.attention import (
    HEAD_DIMS,
    MAX_SMEM,
    ROW_KEYS,
    ROW_MAX_QUERIES,
    SM_SMEM,
    STREAM_KEYS,
    TILE_CONSUMERS,
    WGMMA_KEYS,
    WGMMA_QUERY_TILE,
    attention_plan,
    check_rows,
    rows_aligned,
    tile_smem_bytes,
    wgmma_smem_bytes,
)
from crowdmod_tpu_torch.ops.kernels.attention import _tile_plan

# (B·T_p or B, H, Sq, Sk, Dh) at batch 64: the DiT's spatial and temporal
# attention, the UNet's level-2 attention, and the contract's largest
# problem (S = 216, Dh = 32), which chip_smoke.py checks as an edge.
SHAPES = {
    "dit_spatial": (128, 4, 27, 27, 64),
    "dit_temporal": (1728, 4, 1, 2, 64),
    "unet_level2": (64, 4, 54, 54, 32),
    "edge_s216": (16, 4, 216, 216, 32),
    # FM-DiT (DiT2D): all T·N tokens, 8 × 27 on configs/serving/ATC.yml,
    # 8 × 42 on HERMES-CR-120, 16 × 27 on ATC_medium.
    "fm_dit_s216": (64, 4, 216, 216, 64),
    "fm_dit_s336": (64, 4, 336, 336, 64),
    "fm_dit_s432": (64, 4, 432, 432, 64),
}


@pytest.mark.parametrize(
    "name,route,per_block,warps,keys,blocks",
    [("dit_spatial", "tile", 4, 9, 32, 264), ("unet_level2", "tile", 2, 9, 64, 256),
     ("edge_s216", "wgmma", 1, 4, 224, 64), ("fm_dit_s216", "wgmma", 1, 4, 224, 256),
     ("fm_dit_s336", "wgmma", 1, 8, 384, 256), ("fm_dit_s432", "wgmma", 1, 8, 448, 256)],
)
def test_bf16_serving_shapes_take_the_mma_route(name, route, per_block, warps, keys,
                                                blocks):
    """The tensor-core routes: up to 64 keys the tile route (persistent
    CTAs, 8 // tiles teams of a warp a 16-row query tile, two CTAs a
    multiprocessor of 132); past them, at Dh 32 and 64, the wgmma route (a
    CTA a problem, a warpgroup a 64-row query tile holding the logits of up
    to 224 keys, two warpgroups splitting the keys past that)."""
    plan = attention_plan(*SHAPES[name], torch.bfloat16)
    assert plan.route == route
    assert (plan.problems_per_block, plan.warps, plan.keys_padded, plan.blocks) == (
        per_block, warps, keys, blocks)
    b, h, sq, sk, dh = SHAPES[name]
    assert plan.smem_bytes <= MAX_SMEM and not plan.streamed
    if route == "tile":
        tiles = -(-sq // 16)
        # A team of a warp a 16-row tile for each problem in flight, and
        # the producer; the whole problem one work item.
        assert plan.warps == 1 + plan.problems_per_block * tiles <= 1 + TILE_CONSUMERS
        assert (plan.query_rows, plan.key_block, plan.query_tile) == (16 * tiles, keys, 16)
        assert plan.smem_bytes == tile_smem_bytes(dh, 16 * tiles, keys, plan.warps - 1,
                                                  plan.stages)
        assert plan.stages == plan.problems_per_block
        assert plan.blocks == min(b * h, 2 * 132) and 2 * (plan.smem_bytes + 1024) <= SM_SMEM
    else:
        assert plan.blocks * plan.problems_per_block >= b * h
        assert plan.query_rows == sq
        assert plan.warps == 4 * plan.key_split and plan.query_tile == WGMMA_QUERY_TILE
        assert plan.key_split * plan.key_block == keys >= sk > keys - plan.key_block
        assert plan.smem_bytes == wgmma_smem_bytes(dh, plan.key_block, plan.key_split)


@pytest.mark.parametrize("name", SHAPES)
def test_f32_takes_the_simt_route(name):
    plan = attention_plan(*SHAPES[name], torch.float32)
    assert plan.route == "simt" and plan.warps == 8
    assert plan.keys_padded % 4 == 0 and plan.keys_padded >= SHAPES[name][3]
    assert plan.smem_bytes <= MAX_SMEM


@pytest.mark.parametrize("name,streamed", [("fm_dit_s216", False), ("fm_dit_s336", False),
                                           ("fm_dit_s432", True)])
def test_f32_streams_keys_past_shared_memory(name, streamed):
    """f32 at FM-DiT's shapes: K and V resident up to 336 tokens (190,208
    bytes); at 432 they would need 243,968, so the block takes one problem
    and 32 query rows and streams the keys 128 at a time."""
    b, h, sq, sk, dh = SHAPES[name]
    plan = attention_plan(b, h, sq, sk, dh, torch.float32)
    resident = 4 * (sk * (2 * dh + 4) + 8 * (dh + plan.keys_padded))
    assert plan.streamed == streamed == (resident > MAX_SMEM)
    if streamed:
        assert (plan.problems_per_block, plan.query_rows, plan.key_block) == (1, 32, STREAM_KEYS)
        assert plan.blocks == b * h * -(-sq // 32)
        assert plan.smem_bytes == 4 * (STREAM_KEYS * (2 * dh + 4) + 8 * (4 * dh + STREAM_KEYS))
    else:
        assert plan.smem_bytes == resident and plan.query_rows == sq


def test_one_query_takes_the_simt_route_in_bf16():
    """The DiT's temporal attention, one query against two keys: the row
    route (a 16-row tile would be 15/16 waste), 4 lanes' groups a warp, 16
    query rows a block of 4 warps.  Past ROW_KEYS keys or ROW_MAX_QUERIES
    queries, up to 64 keys: the tile route, with a masked 16-row tile."""
    plan = attention_plan(*SHAPES["dit_temporal"], torch.bfloat16)
    assert plan.route == "row"
    assert (plan.problems_per_block, plan.blocks) == (16, 432)
    assert (plan.keys_padded, plan.query_rows, plan.smem_bytes) == (2, 1, 0)
    assert attention_plan(4, 4, 15, 15, 64, torch.bfloat16).route == "tile"
    assert attention_plan(4, 4, 16, 15, 64, torch.bfloat16).route == "tile"
    assert attention_plan(4, 4, ROW_MAX_QUERIES, ROW_KEYS, 64, torch.bfloat16).route == "row"
    assert attention_plan(4, 4, 1, ROW_KEYS + 1, 64, torch.bfloat16).route == "tile"
    assert attention_plan(4, 4, 1, 2, 8, torch.bfloat16).route == "simt"


@pytest.mark.parametrize("dh,route", [(8, "simt"), (16, "mma"), (32, "wgmma"), (64, "wgmma")])
def test_narrow_heads_route_by_the_mma_tile(dh, route):
    """A UNet at a base width of 16 attends with 4 heads of 8 at its
    bottleneck: 8 has no 16-deep mma k-slice, so bf16 takes the SIMT route
    there, the mma route at 16 and, its 96 keys being past 64, the wgmma
    route at 32 and 64; f32 takes the SIMT route at every head dim the
    kernel is compiled for."""
    assert HEAD_DIMS == (8, 16, 32, 64)
    assert attention_plan(8, 4, 96, 96, dh, torch.bfloat16).route == route
    plan = attention_plan(8, 4, 96, 96, dh, torch.float32)
    assert plan.route == "simt" and plan.smem_bytes == 4 * (
        plan.problems_per_block * 96 * (2 * dh + 4) + 8 * (dh + 96))


@pytest.mark.parametrize("sq", [1, 16, 54, 216, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_shared_memory_fits_at_the_most_keys(dtype, sq):
    """No key count has a limit: every plan fits a block's shared memory,
    the bf16 problems too large for the mma route taking the streamed SIMT
    form."""
    for sk in (256, 336, 432, 1000, 4096, 100_000):
        for dh in HEAD_DIMS:
            plan = attention_plan(1, 1, sq, sk, dh, dtype)
            assert plan.smem_bytes <= MAX_SMEM == 232448, plan
            assert plan.keys_padded >= sk
            if plan.streamed:
                assert plan.route == "simt" and plan.key_block == STREAM_KEYS
                assert plan.query_rows == 8 * min(4, -(-sq // 8))


def test_row_alignment_check():
    # Packed QKV (B, S, 3, H, Dh) in bf16: the k view starts H·Dh elements in.
    h, dh, s = 4, 64, 27
    strides = (s * 3 * h * dh, dh, 3 * h * dh)
    assert rows_aligned(4096, strides, 2)
    assert rows_aligned(4096 + h * dh * 2, strides, 2)
    assert not rows_aligned(4096 + 8, strides, 2)       # base off by 8 bytes
    assert not rows_aligned(4096, (s * 3 * h * 36, 36, 3 * h * 36), 2)  # 72-byte rows
    rows = {"q": (4096, strides), "k": (4096 + 2, strides)}
    with pytest.raises(ValueError, match="k .*16-byte"):
        check_rows("mma", rows, 2)
    # The SIMT route takes any rows: element loads where they are unaligned.
    assert check_rows("simt", rows, 2) is False
    assert check_rows("mma", {"q": (4096, strides)}, 2) is True


def _mma_replay(q, k, v, scale, key_block=64):
    """The mma route's arithmetic in torch f32: logits of 64-key blocks; the
    row max and sum rescaled online over the blocks; each block's weights
    e / l normalised in f32, then rounded to V's dtype; W·V summed in f32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sk = k.shape[2]
    blocks = [(lo, min(lo + key_block, sk)) for lo in range(0, sk, key_block)]
    logits = lambda lo, hi: qf @ kf[:, :, lo:hi].transpose(-1, -2) * scale  # noqa: E731
    m = torch.full(q.shape[:3] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    for lo, hi in blocks:
        s = logits(lo, hi)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
        m = mn
    out = torch.zeros(q.shape[:3] + (v.shape[-1],))
    for lo, hi in blocks:
        w = (torch.exp(logits(lo, hi) - m) / l).to(v.dtype).float()
        out = out + w @ vf[:, :, lo:hi]
    return out


def _simt_streamed_replay(q, k, v, scale, key_block=STREAM_KEYS):
    """The streamed SIMT form's arithmetic in torch f32: a sweep of
    128-key blocks for each row's max and its sum, rescaled online; a
    second for each block's weights exp(s - m) / l, rounded to V's dtype,
    times V, summed in f32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sk = k.shape[2]
    blocks = [(lo, min(lo + key_block, sk)) for lo in range(0, sk, key_block)]
    logits = lambda lo, hi: qf @ kf[:, :, lo:hi].transpose(-1, -2) * scale  # noqa: E731
    m = torch.full(q.shape[:3] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    for lo, hi in blocks:
        s = logits(lo, hi)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        l = l * torch.exp(m - mn) + torch.exp(s - mn).sum(-1, keepdim=True)
        m = mn
    out = torch.zeros(q.shape[:3] + (v.shape[-1],))
    for lo, hi in blocks:
        out = out + (torch.exp(logits(lo, hi) - m) / l).to(v.dtype).float() @ vf[:, :, lo:hi]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sk", [432, 1000])
def test_simt_streamed_sweeps_match_the_twin(sk, dtype):
    """4 or 8 key blocks: in f32 the online sum differs from the twin's by
    its rounding only (the card's run holds 1e-5); in bf16 the rounded
    weights agree to a few bf16 ulps."""
    rng = np.random.default_rng(sk)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, s, 64)).astype(np.float32)).to(dtype)
               for s in (40, sk, sk))
    scale = 64 ** -0.5
    want = attention_reference(q, k, v, scale).float()
    got = _simt_streamed_replay(q, k, v, scale)
    tol = 1e-6 if dtype == torch.float32 else 2 * 2.0 ** -8 * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["dit_spatial", "unet_level2", "edge_s216", "fm_dit_s432"])
def test_mma_sweeps_match_the_twin(name):
    """One key block (27, 54 keys), four (216) or seven (432): the
    normalised bf16 weights are the twin's up to the f32 rounding of l, so
    the outputs agree to a few bf16 ulps of the weights."""
    _, h, sq, sk, dh = SHAPES[name]
    rng = np.random.default_rng(sk)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, h, s, dh)).astype(np.float32))
               .bfloat16() for s in (sq, sk, sk))
    scale = dh ** -0.5
    want = attention_reference(q, k, v, scale).float()
    got = _mma_replay(q, k, v, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2 * 2.0 ** -8 * float(want.abs().max()))
    # The CPU wrapper is the twin itself, and launches nothing.
    fused_attention.launches = 0
    torch.testing.assert_close(fused_attention(q, k, v, scale=scale).float(), want,
                               rtol=0, atol=0)
    assert fused_attention.launches == 0


def _tile_walk(plan, items: int) -> Counter:
    """The tile kernel's loops (csrc/attention.cu): CTA c's producer loads
    items c, c + grid, … (its k-th into stage k % stages); team t of its
    consumers computes its k-th for k ≡ t (mod teams).  Asserts each team
    takes the producer's items in its order; → how often each item ran."""
    seen = Counter()
    teams = plan.problems_per_block
    for cta in range(plan.blocks):
        produced = list(range(cta, items, plan.blocks))
        for team in range(teams):
            consumed = list(range(cta + team * plan.blocks, items, teams * plan.blocks))
            assert consumed == produced[team::teams]
            seen.update(consumed)
    return seen


def _ring_run(items: int, stages: int, teams: int, rng) -> bool:
    """One CTA's stages as the tile kernel drives them (csrc/attention.cu,
    attention_tile_kernel), its producer, its teams and the landing of its
    TMA loads interleaved at random: the producer issues item k's load into
    stage k % stages once the stage's ``empty`` barrier passes a wait on
    parity (k // stages - 1) & 1 (k ≥ stages); a load lands at any later
    time, in any order, and completes a phase of the stage's ``full``
    barrier; team k % teams reads item k once ``full`` passes a wait on
    parity (k // stages) & 1, then arrives on ``empty``.  A parity wait
    passes while the barrier's count of completed phases has the other
    parity.  → whether every team read its own landed item and all drained
    (no hang)."""
    full, empty, held = [0] * stages, [0] * stages, [None] * stages
    flying, issued, nxt = [], 0, list(range(teams))
    while True:
        ready = [t for t in range(teams)
                 if nxt[t] < items and full[nxt[t] % stages] % 2 != (nxt[t] // stages) % 2]
        if issued < items and (issued < stages or empty[issued % stages] % 2
                               != (issued // stages - 1) % 2):
            ready.append(-1)
        ready += [-2 - i for i in range(len(flying))]
        if not ready:
            return issued == items and all(k >= items for k in nxt)
        who = ready[rng.integers(len(ready))]
        if who == -1:
            flying.append(issued)
            issued += 1
        elif who < -1:  # a load lands
            k = flying.pop(-2 - who)
            held[k % stages] = k
            full[k % stages] += 1
        else:
            s = nxt[who] % stages
            if held[s] != nxt[who]:
                return False
            empty[s] += 1
            nxt[who] += teams


def test_tile_ring_reads_each_item_from_its_stage():
    """With the stages a multiple of the teams (the plan's one a team), every
    random interleaving of the producer, the teams and the loads' landing
    reads each item from its own stage and drains; with stages the teams
    share (teams + 2, as the first plan had them, or fewer than the teams)
    a team's parity wait passes on another item's phase, which the plan
    refuses."""
    rng = np.random.default_rng(21)
    for teams in (1, 2, 4, 8):
        for stages in (teams, 2 * teams):
            assert all(_ring_run(37, stages, teams, rng) for _ in range(40)), (teams, stages)
    for teams, stages in ((2, 3), (4, 6), (8, 10), (8, 2)):
        assert not all(_ring_run(37, stages, teams, rng) for _ in range(200)), (teams, stages)
    assert _tile_plan(128, 4, 27, 27, 64).stages == 4
    for stages in (2, 6, 10):
        with pytest.raises(ValueError, match="stages"):
            _tile_plan(1728, 4, 1, 2, 64, stages=stages)


def test_plan_covers_every_problem_once():
    """Blocks × problems a block cover all B·H problems, the last block
    partly, and every query row once (the streamed form: ⌈Sq / query
    rows⌉ blocks a problem; the row route: query rows a block; the tile
    route: its persistent walk over problems × query chunks)."""
    for b, h, sq, sk, dh in list(SHAPES.values()) + [(4, 4, 700, 1000, 64), (2, 4, 100, 30, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            plan = attention_plan(b, h, sq, sk, dh, dtype)
            n = b * h
            chunks = -(-sq // plan.query_rows)
            assert (chunks - 1) * plan.query_rows < sq <= chunks * plan.query_rows
            if plan.route == "tile":
                assert _tile_walk(plan, n * chunks) == Counter(range(n * chunks))
            elif plan.route == "row":
                assert -(-n * sq // plan.problems_per_block) == plan.blocks
            else:
                assert plan.blocks == -(-n // plan.problems_per_block) * chunks


# chip_smoke.py phase 2's attention cases: (B·H problems as (B, H), Sq, Sk, Dh).
PHASE2 = {
    "spatial_b64": (128, 4, 27, 27, 64), "temporal_b64": (1728, 4, 1, 2, 64),
    "spatial_b256": (512, 4, 27, 27, 64), "temporal_b256": (6912, 4, 1, 2, 64),
    "edge_s216": (16, 4, 216, 216, 32), "unet_b64": (64, 4, 54, 54, 32),
    "fm_dit_s216": (64, 4, 216, 216, 64), "fm_dit_s336": (64, 4, 336, 336, 64),
    "fm_dit_s432": (64, 4, 432, 432, 64), "edge_s432_dh32": (16, 4, 432, 432, 32),
    "edge_s1000": (4, 4, 1000, 1000, 64), "narrow_dh8": (16, 4, 96, 96, 8),
    "narrow_dh16": (16, 4, 96, 96, 16), "edge_s2500_dh8": (4, 4, 2500, 2500, 8),
    "short_dh16": (16, 4, 40, 40, 16), "short_row_dh32": (64, 4, 8, 8, 32),
    "short_row_dh16": (64, 4, 3, 5, 16), "spatial_b1280": (2560, 4, 27, 27, 64),
    "unet_b1280": (1280, 4, 54, 54, 32),
}
WGMMA_CASES = {"edge_s216", "fm_dit_s216", "fm_dit_s336", "fm_dit_s432", "edge_s432_dh32"}
SHORT_CASES = {"spatial_b64": "tile", "temporal_b64": "row", "spatial_b256": "tile",
               "temporal_b256": "row", "unet_b64": "tile", "short_dh16": "tile",
               "short_row_dh32": "row", "short_row_dh16": "row", "spatial_b1280": "tile",
               "unet_b1280": "tile"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", PHASE2)
def test_phase2_cases_keep_their_routes(name, dtype):
    """bf16 past 64 keys at Dh 32 and 64 takes the wgmma route, up to 64
    keys the row or the tile route; every other case keeps commit
    ed2c182's plan, field for field."""
    plan = attention_plan(*PHASE2[name], dtype)
    if dtype == torch.bfloat16 and name in WGMMA_CASES:
        assert plan.route == "wgmma" and plan.problems_per_block == 1
        return
    if dtype == torch.bfloat16 and name in SHORT_CASES:
        assert plan.route == SHORT_CASES[name]
        assert plan.stages == (plan.problems_per_block if plan.route == "tile" else 1)
        return
    route, per_block, warps, keys, rows, key_block, smem = baseline_attention_plan(
        *PHASE2[name], dtype)
    assert plan.route == ("simt", "mma")[route]
    assert (plan.problems_per_block, plan.warps, plan.keys_padded, plan.query_rows,
            plan.key_block, plan.smem_bytes) == (per_block, warps, keys, rows, key_block, smem)


# The bundled geometries' short attention shapes at batch 64 (chip_smoke.py
# phase 19, ``geometry_cases``): the UNets' level 2, the DiT's spatial and
# temporal attention at ETHUCY, HERMES-BO, -BN, -CR-90, -CR-120 and
# ATC_medium.
PHASE19_SHORT = [(64, 4, 12, 12, 32), (128, 4, 6, 6, 64), (384, 4, 1, 2, 64),
                 (64, 4, 36, 36, 32), (128, 4, 18, 18, 64), (1152, 4, 1, 2, 64),
                 (64, 4, 56, 56, 32), (128, 4, 28, 28, 64), (1792, 4, 1, 2, 64),
                 (64, 4, 30, 30, 32), (128, 4, 15, 15, 64), (960, 4, 1, 2, 64),
                 (128, 4, 42, 42, 64), (2688, 4, 1, 2, 64), (256, 4, 27, 27, 64),
                 (1728, 4, 2, 4, 64)]


@pytest.mark.parametrize("batch", [64, 8, 1])
def test_short_plans_fit_and_walk_every_problem_once(batch):
    """Every phase-2 and phase-19 short shape at the batch (problems scaled
    from batch 64): the row or tile route; a tile CTA's shared memory ≤ 227
    KB and two of them a multiprocessor where the plan counts two, its
    consumers ≤ 8; the persistent walk runs every work item once; the row
    route's blocks cover every query row once.  Then every tile plan from 1
    to 64 queries and keys fits too."""
    shapes = [PHASE2[n] for n in SHORT_CASES] + PHASE19_SHORT
    for b, h, sq, sk, dh in shapes:
        b = max(1, b * batch // 64)
        plan = attention_plan(b, h, sq, sk, dh, torch.bfloat16)
        assert plan.route == ("row" if sk <= ROW_KEYS and sq <= ROW_MAX_QUERIES else "tile")
        if plan.route == "row":
            rows = b * h * sq
            assert (plan.blocks - 1) * plan.problems_per_block < rows
            assert plan.blocks * plan.problems_per_block >= rows
            assert plan.problems_per_block == plan.warps * 32 // (dh // 8)
            continue
        items = b * h * -(-sq // plan.query_rows)
        assert _tile_walk(plan, items) == Counter(range(items))
        assert plan.blocks == min(items, (2 if 2 * (plan.smem_bytes + 1024) <= SM_SMEM else 1)
                                  * 132)
    for dh in (16, 32, 64):
        for sq in range(1, 65, 3):
            for sk in range(1, 65, 3):
                plan = _tile_plan(2, 4, sq, sk, dh)
                assert plan.smem_bytes <= MAX_SMEM and plan.warps - 1 <= TILE_CONSUMERS
                assert plan.keys_padded % 16 == 0 and sk <= plan.keys_padded < sk + 16
                assert plan.query_rows % 16 == 0 and sq <= plan.query_rows < sq + 16


@pytest.mark.parametrize("name", ROW_SHAPES)
def test_row_shapes_replace_the_simt_route(name):
    """``chip_smoke.check_row_is_simt``'s shapes: this tree's plan takes the
    row route, commit ed2c182's the resident simt route, whose bits the row
    route keeps; the replay of the one is the order of the other's sums."""
    b, h, sq, sk, dh = ROW_SHAPES[name]
    plan = attention_plan(b, h, sq, sk, dh, torch.bfloat16)
    assert (plan.route, plan.keys_padded, plan.query_rows, plan.smem_bytes) == ("row", sk, sq, 0)
    route, per_block, warps, keys, rows, key_block, smem = baseline_attention_plan(
        b, h, sq, sk, dh, torch.bfloat16)
    assert (route, warps, rows, key_block) == (0, 8, sq, keys) and keys < STREAM_KEYS


@pytest.mark.parametrize("name", SHORT_ATTENTION)
def test_short_attention_cases_take_the_short_routes(name):
    """``chip_smoke.py --short-attention``'s shapes: the row route up to 8
    keys and 8 queries, else the tile route, in shared memory that fits."""
    b, h, sq, sk, dh, _ = SHORT_ATTENTION[name]
    plan = attention_plan(b, h, sq, sk, dh, torch.bfloat16)
    assert plan.route == ("row" if sk <= ROW_KEYS and sq <= ROW_MAX_QUERIES else "tile")
    assert plan.smem_bytes <= MAX_SMEM


def test_wgmma_plans_fit_the_card():
    """Every wgmma plan from 65 to 448 keys and 16 to 512 queries: shared
    memory ≤ 227 KB (one warpgroup: at most half of it, two CTAs a
    multiprocessor), a warpgroup's NK keys cover its share, and the
    registers a thread's arrays take
    (the logits NK / 2, the output Dh / 2, the weights' fragments NK / 4,
    the query fragments Dh / 4) ≤ 255."""
    seen = set()
    for dh in (32, 64):
        for sq in (16, 27, 64, 65, 216, 336, 432, 512):
            for sk in list(range(65, 449, 7)) + [128, 192, 224, 225, 256, 384, 448]:
                plan = attention_plan(2, 4, sq, sk, dh, torch.bfloat16)
                if plan.route != "wgmma":
                    assert sq * (2 * sk + sq) * 2 * dh > MAX_SMEM, (sq, sk, dh)
                    continue
                split, nk = plan.key_split, plan.key_block
                assert nk in WGMMA_KEYS and split in (1, 2)
                assert split * nk >= sk > (split - 1) * nk
                assert plan.smem_bytes <= (MAX_SMEM // 2 if split == 1 else MAX_SMEM)
                assert nk // 2 + dh // 2 + nk // 4 + dh // 4 <= 255
                seen.add((split, nk))
    assert seen == {(s, n) for s in (1, 2) for n in WGMMA_KEYS}
    # 449 keys and more: not the wgmma route.
    assert attention_plan(2, 4, 216, 449, 64, torch.bfloat16).route != "wgmma"


def _wgmma_replay(q, k, v, scale, plan):
    """The wgmma route's arithmetic in torch f32: per 64-row query tile,
    each warpgroup's logits of its NK keys (base-2 units), its row max m_w
    and sum l_w of exp2(x − m_w); with two, m = max(m_0, m_1) and l = l_0
    2^(m_0 − m) + l_1 2^(m_1 − m); the weights e · (2^(m_w − m) / l) rounded
    to V's dtype, each warpgroup's W V in f32, added 0 then 1."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sq, sk = q.shape[2], k.shape[2]
    c = scale * 1.4426950408889634
    out = torch.zeros(q.shape[:3] + (v.shape[-1],))
    keys = [(j * plan.key_block, min((j + 1) * plan.key_block, sk))
            for j in range(plan.key_split)]
    for t0 in range(0, sq, plan.query_tile):
        qt = qf[:, :, t0:t0 + plan.query_tile]
        x = [qt @ kf[:, :, lo:hi].transpose(-1, -2) * c for lo, hi in keys]
        mr = [xj.amax(-1, keepdim=True) for xj in x]
        e = [torch.exp2(xj - mj) for xj, mj in zip(x, mr)]
        lr = [ej.sum(-1, keepdim=True) for ej in e]
        m = mr[0]
        for mj in mr[1:]:
            m = torch.maximum(m, mj)
        l = lr[0] * torch.exp2(mr[0] - m)
        for lj, mj in zip(lr[1:], mr[1:]):
            l = l + lj * torch.exp2(mj - m)
        o = None
        for ej, mj, (lo, hi) in zip(e, mr, keys):
            oj = (ej * (torch.exp2(mj - m) / l)).to(v.dtype).float() @ vf[:, :, lo:hi]
            o = oj if o is None else o + oj
        out[:, :, t0:t0 + plan.query_tile] = o
    return out


@pytest.mark.parametrize("sk,dh", [(216, 64), (432, 32)], ids=["s216", "s432_dh32"])
def test_wgmma_replay_matches_the_twin_and_jax(sk, dh):
    """8 problems: 216 keys (one warpgroup a tile) and 432 (two splitting
    the keys).  The replay equals the twin and the JAX Pallas kernel
    (interpret mode), bf16 in and out, within a few bf16 ulps of the
    output."""
    rng = np.random.default_rng(sk + dh)
    q, k, v = (rng.normal(size=(2, 4, sk, dh)).astype(np.float32) for _ in range(3))
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    scale = dh ** -0.5
    plan = attention_plan(2, 4, sk, sk, dh, torch.bfloat16)
    assert plan.route == "wgmma" and plan.key_split == (1 if sk <= 224 else 2)
    got = _wgmma_replay(qb, kb, vb, scale, plan)
    twin = attention_reference(qb, kb, vb, scale).float()
    jax_out = jax_fused_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                  scale=scale, mode="interpret")
    jax_out = torch.from_numpy(np.array(jax_out.astype(jnp.float32)))
    tol = 2 * 2.0 ** -8 * float(twin.abs().max())
    np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), jax_out.numpy(), rtol=0, atol=tol)
    # The output rounded as the kernel rounds it is the twin's within an ulp.
    np.testing.assert_allclose(got.bfloat16().float().numpy(), twin.numpy(), rtol=0,
                               atol=tol)


def _scale_log2(scale: float) -> torch.Tensor:
    """scale · log2 e as the kernel forms it: both f32, one f32 product."""
    return (torch.tensor(scale, dtype=torch.float32)
            * torch.tensor(1.4426950408889634, dtype=torch.float32))


def _row_replay(q, k, v, scale):
    """The row route's order of sums in torch f32, which is the simt
    route's: a logit sums the products in the order of Dh (each exact: a
    bf16 × bf16 product fits f32), then times the scale; exp past the row's
    max; the sum over the keys in the warp's butterfly order (offsets 4, 2,
    1 over 8 lanes, zeros past Sk); the weights e / l rounded to bf16;
    their products with V summed over the keys in order."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sk = k.shape[2]
    assert sk <= 8
    prod = qf[:, :, :, None, :] * kf[:, :, None, :, :]  # (B, H, Sq, Sk, Dh)
    dot = prod[..., 0]
    for d in range(1, prod.shape[-1]):
        dot = dot + prod[..., d]
    x = dot * torch.tensor(scale, dtype=torch.float32)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    e = torch.cat([e, torch.zeros(e.shape[:-1] + (8 - sk,))], -1)
    total = ((e[..., 0] + e[..., 4]) + (e[..., 2] + e[..., 6])) + (
        (e[..., 1] + e[..., 5]) + (e[..., 3] + e[..., 7]))
    w = (e[..., :sk] / total[..., None]).bfloat16().float()
    out = w[..., 0, None] * vf[:, :, None, 0]
    for j in range(1, sk):
        out = out + w[..., j, None] * vf[:, :, None, j]
    return out


def _tile_replay(q, k, v, scale, plan):
    """The tile route's arithmetic in torch f32: per work item of
    ``plan.query_rows`` query rows, S = Q Kᵀ over the keys padded to
    ``plan.keys_padded`` with zero rows (TMA's fill; the tensor cores' f32
    sums) × scale · log2 e, the padded keys at −inf; each row's max, exp2
    past it, their sum and its reciprocal; the weights e · (1 / l) rounded
    to bf16; W V summed in f32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    sk = k.shape[2]
    pad = torch.zeros(kf.shape[:2] + (plan.keys_padded - sk, kf.shape[-1]))
    kp, vp = torch.cat([kf, pad], 2), torch.cat([vf, pad], 2)
    out = torch.zeros(q.shape[:3] + (v.shape[-1],))
    for r0 in range(0, q.shape[2], plan.query_rows):
        x = qf[:, :, r0:r0 + plan.query_rows] @ kp.transpose(-1, -2) * _scale_log2(scale)
        x[..., sk:] = -torch.inf
        e = torch.exp2(x - x.amax(-1, keepdim=True))
        w = (e * (1.0 / e.sum(-1, keepdim=True))).bfloat16().float()
        out[:, :, r0:r0 + plan.query_rows] = w @ vp
    return out


# (B, H, Sq, Sk, Dh) of the short routes' replays: the DiT's spatial and
# temporal attention, the UNet's level 2, ETHUCY's 6 and HERMES-CR-90's 15
# tokens, and a problem of more queries than a work item holds.
SHORT_REPLAYS = {"dit_spatial": (2, 4, 27, 27, 64), "dit_temporal": (8, 4, 1, 2, 64),
                 "unet_level2": (2, 4, 54, 54, 32), "ethucy": (2, 4, 6, 6, 64),
                 "cr90": (2, 4, 15, 15, 64), "sq100_sk30": (1, 2, 100, 30, 16)}


@pytest.mark.parametrize("name", SHORT_REPLAYS)
def test_short_replay_matches_the_twin_and_jax(name):
    """The plan's route replayed (row at 1 × 2 and 6 × 6, tile at 27, 54,
    15 and 100 queries; under 16 queries the tile route's masked tile too)
    equals the twin, the JAX package's ``attention_reference`` and its
    Pallas kernel in interpret mode, bf16 in and out, within two bf16 ulps
    of the output's scale; the output rounded as the kernel rounds it too."""
    b, h, sq, sk, dh = SHORT_REPLAYS[name]
    rng = np.random.default_rng(100 * sq + sk)
    q = rng.normal(size=(b, h, sq, dh)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, sk, dh)).astype(np.float32) for _ in range(2))
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    scale = dh ** -0.5
    plan = attention_plan(b, h, sq, sk, dh, torch.bfloat16)
    assert plan.route == ("row" if name in ("dit_temporal", "ethucy") else "tile")
    routes = {plan.route, "tile"} if sq < 16 else {plan.route}
    twin = attention_reference(qb, kb, vb, scale).float()
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jax_ref = np.array(jax_attention_reference(jq, jk, jv, scale).astype(jnp.float32))
    jax_out = np.array(jax_fused_attention(jq, jk, jv, scale=scale, mode="interpret")
                       .astype(jnp.float32))
    tol = 2 * 2.0 ** -8 * float(twin.abs().max())
    for route in sorted(routes):
        got = (_row_replay(qb, kb, vb, scale) if route == "row"
               else _tile_replay(qb, kb, vb, scale, _tile_plan(b, h, sq, sk, dh)))
        for want in (twin.numpy(), jax_ref, jax_out):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
        np.testing.assert_allclose(got.bfloat16().float().numpy(), twin.numpy(), rtol=0,
                                   atol=tol)
