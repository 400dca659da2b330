"""The attention kernel's plan and its routes' arithmetic, without a card.

``attention_plan`` (``crowdmod_tpu_torch/ops/kernels/attention.py``) picks the
route of ``csrc/attention.cu`` and the block shape from the call's shape and
dtype; the wrapper passes the plan to the kernel, which rejects a plan whose
shared memory is not its own.  These tests pin the routes at the serving
shapes and at FM-DiT's (216, 336 and 432 tokens) — every other case of
``chip_smoke.py``'s phase 2 where commit ed2c182's plan sent it — the
shared-memory and register bounds at any number of keys, the
row-alignment check, and replay the wgmma route's tiles and sums, the mma
route's and the streamed SIMT form's key-block sweeps in torch against the
twin (and the JAX kernel in interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import baseline_attention_plan
from crowdmod_tpu.ops.pallas.attention import fused_attention as jax_fused_attention

from crowdmod_tpu_torch.ops.kernels import attention_reference, fused_attention
from crowdmod_tpu_torch.ops.kernels.attention import (
    HEAD_DIMS,
    MAX_SMEM,
    STREAM_KEYS,
    WGMMA_KEYS,
    WGMMA_QUERY_TILE,
    attention_plan,
    check_rows,
    rows_aligned,
    wgmma_smem_bytes,
)

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
    [("dit_spatial", "mma", 4, 8, 32, 128), ("unet_level2", "mma", 2, 8, 64, 128),
     ("edge_s216", "wgmma", 1, 4, 224, 64), ("fm_dit_s216", "wgmma", 1, 4, 224, 256),
     ("fm_dit_s336", "wgmma", 1, 8, 384, 256), ("fm_dit_s432", "wgmma", 1, 8, 448, 256)],
)
def test_bf16_serving_shapes_take_the_mma_route(name, route, per_block, warps, keys,
                                                blocks):
    """The tensor-core routes: up to 64 keys the mma route (a warp a
    16-row query tile); past them, at Dh 32 and 64, the wgmma route (a CTA
    a problem, a warpgroup a 64-row query tile holding the logits of up to
    224 keys, two warpgroups splitting the keys past that)."""
    plan = attention_plan(*SHAPES[name], torch.bfloat16)
    assert plan.route == route
    assert (plan.problems_per_block, plan.warps, plan.keys_padded, plan.blocks) == (
        per_block, warps, keys, blocks)
    b, h, sq, sk, dh = SHAPES[name]
    assert plan.blocks * plan.problems_per_block >= b * h
    assert plan.smem_bytes <= MAX_SMEM and not plan.streamed
    assert plan.query_rows == sq
    if route == "mma":
        tiles = -(-sq // 16)
        # A warp a 16-row query tile, every tile of the block's problems held.
        assert plan.warps == min(16, plan.problems_per_block * tiles)
        assert plan.smem_bytes == 2 * (dh + 8) * per_block * (tiles * 16 + 2 * keys)
        assert (plan.key_block, plan.query_tile) == (keys, 16)
    else:
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
    """The DiT's temporal attention: a 16-row tile would be 15/16 waste."""
    plan = attention_plan(*SHAPES["dit_temporal"], torch.bfloat16)
    assert plan.route == "simt"
    assert (plan.problems_per_block, plan.blocks) == (8, 864)
    assert attention_plan(4, 4, 15, 15, 64, torch.bfloat16).route == "simt"
    assert attention_plan(4, 4, 16, 15, 64, torch.bfloat16).route == "mma"


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


def test_plan_covers_every_problem_once():
    """Blocks × problems a block cover all B·H problems, the last block
    partly, and every query row once (the streamed form: ⌈Sq / query
    rows⌉ blocks a problem)."""
    for b, h, sq, sk, dh in list(SHAPES.values()) + [(4, 4, 700, 1000, 64)]:
        for dtype in (torch.float32, torch.bfloat16):
            plan = attention_plan(b, h, sq, sk, dh, dtype)
            n = b * h
            chunks = -(-sq // plan.query_rows)
            assert plan.blocks == -(-n // plan.problems_per_block) * chunks
            assert (chunks - 1) * plan.query_rows < sq <= chunks * plan.query_rows


# chip_smoke.py phase 2's attention cases: (B·H problems as (B, H), Sq, Sk, Dh).
PHASE2 = {
    "spatial_b64": (128, 4, 27, 27, 64), "temporal_b64": (1728, 4, 1, 2, 64),
    "spatial_b256": (512, 4, 27, 27, 64), "temporal_b256": (6912, 4, 1, 2, 64),
    "edge_s216": (16, 4, 216, 216, 32), "unet_b64": (64, 4, 54, 54, 32),
    "fm_dit_s216": (64, 4, 216, 216, 64), "fm_dit_s336": (64, 4, 336, 336, 64),
    "fm_dit_s432": (64, 4, 432, 432, 64), "edge_s432_dh32": (16, 4, 432, 432, 32),
    "edge_s1000": (4, 4, 1000, 1000, 64), "narrow_dh8": (16, 4, 96, 96, 8),
    "narrow_dh16": (16, 4, 96, 96, 16), "edge_s2500_dh8": (4, 4, 2500, 2500, 8),
}
WGMMA_CASES = {"edge_s216", "fm_dit_s216", "fm_dit_s336", "fm_dit_s432", "edge_s432_dh32"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", PHASE2)
def test_phase2_cases_keep_their_routes(name, dtype):
    """bf16 past 64 keys at Dh 32 and 64 takes the wgmma route; every other
    case keeps commit ed2c182's plan, field for field."""
    plan = attention_plan(*PHASE2[name], dtype)
    if dtype == torch.bfloat16 and name in WGMMA_CASES:
        assert plan.route == "wgmma" and plan.problems_per_block == 1
        return
    route, per_block, warps, keys, rows, key_block, smem = baseline_attention_plan(
        *PHASE2[name], dtype)
    assert plan.route == ("simt", "mma")[route]
    assert (plan.problems_per_block, plan.warps, plan.keys_padded, plan.query_rows,
            plan.key_block, plan.smem_bytes) == (per_block, warps, keys, rows, key_block, smem)


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
