"""The GroupNorm kernel's plan and its cluster route's arithmetic, without a card.

``group_norm_plan`` (``crowdmod_tpu_torch/ops/kernels/groupnorm.py``) picks
the route of ``csrc/groupnorm.cu`` (``"cluster"``: a sample in the shared
memory of k CTAs, read once; ``"stream"``: a block per (sample, group)),
the cluster size and the CTA shape from the call's shape and dtype.  These
tests pin the plan at every UNet GroupNorm shape and serving bucket, the
route past a cluster's capacity, and replay the cluster route's partition
and summation order in torch: the replay must match the plain twin and the
JAX package's Pallas kernel.
"""

import numpy as np
import pytest
import torch

from chip_smoke import GN_SHAPES, LEVELS
from crowdmod_tpu.ops.pallas.groupnorm import fused_group_norm as jax_fused_group_norm
from crowdmod_tpu_torch.ops.kernels import group_norm_reference
from crowdmod_tpu_torch.ops.kernels.groupnorm import (
    CLUSTER_SIZES,
    MAX_CHUNK,
    STREAM_BLOCK_BYTES,
    cluster_plan,
    group_norm_plan,
    stream_pass_bytes,
)

SMS = 132
SMEM_LIMIT = 232448  # 227 KB, a CTA's shared memory on the H100
GN_ATOL = 1e-5  # as tests/test_torch_unet_kernels.py::test_group_norm_twin_matches_jax
BUCKETS = (1, 8, 64, 256)


def _volume(level):
    return int(np.prod(LEVELS[level]))


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

# (dtype, batch) → the plan at each GN_SHAPES shape, in order, with 132
# multiprocessors: route (c: cluster, s: stream), cluster size, threads.
# chip_smoke.py --gn-plans measured every alternative (PERF.md).
PINNED = {
    ("bf16", 1): "c8x256 s1x256 s1x256 c8x288 s1x256 s1x256 s1x256 s1x256 s1x256 s1x256",
    ("bf16", 8): "c8x256 s1x256 s1x256 c8x288 s1x256 s1x256 s1x256 s1x256 s1x256 s1x256",
    ("bf16", 64): "c2x512 c1x256 c2x256 c2x576 c2x288 s1x256 s1x256 s1x256 s1x256 s1x256",
    ("bf16", 256): "c2x256 c1x256 c1x256 c2x288 c1x288 c1x256 c1x256 c1x256 c1x256 c1x288",
    ("f32", 1): " ".join(["s1x256"] * 10),
    ("f32", 8): " ".join(["s1x256"] * 10),
    ("f32", 64): " ".join(["s1x256"] * 10),
    ("f32", 256): " ".join(["s1x256"] * 10),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", BUCKETS)
def test_plan_at_every_path_shape(batch, dtype):
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    elsize = 2 if dtype == torch.bfloat16 else 4
    got = []
    for level, c, _ in GN_SHAPES:
        s = _volume(level)
        plan = group_norm_plan(batch, s, c, 8, dtype, SMS)
        got.append(f"{plan.route[0]}{plan.cluster}x{plan.threads}")
        assert plan.launches == 1
        if plan.route == "stream":
            assert (plan.cluster, plan.threads, plan.smem_bytes, plan.blocks) == (
                1, 256, 0, batch * 8)
            # bf16 takes it only where a block's three passes stay latency-bound.
            assert dtype == torch.float32 or (
                stream_pass_bytes(s, c, 8, elsize) <= STREAM_BLOCK_BYTES)
            continue
        assert plan.cluster in CLUSTER_SIZES
        assert plan.rows_per_cta == -(-s // plan.cluster)
        assert plan.blocks == batch * plan.cluster
        # A thread always sees one 16-byte window: threads a multiple of the
        # windows a row and of a warp.
        assert plan.vec == 16 // elsize
        assert plan.threads % 32 == 0 and plan.threads % (c // plan.vec) == 0
        assert 256 <= plan.threads <= 1024
        assert plan.smem_bytes == 8 * c + plan.rows_per_cta * c * elsize
        assert plan.smem_bytes <= MAX_CHUNK < SMEM_LIMIT
    assert " ".join(got) == PINNED[(name, batch)]


def test_stream_route_past_a_clusters_capacity():
    # ATC_medium's level-0 volume (16 × 12 × 36) at 192 channels: 2.65 MB a
    # bf16 sample, past 8 CTAs of 222 KB.
    s = 16 * 12 * 36
    for dtype in (torch.bfloat16, torch.float32):
        plan = group_norm_plan(2, s, 192, 8, dtype, SMS)
        assert (plan.route, plan.cluster, plan.smem_bytes, plan.blocks) == ("stream", 1, 0, 16)
    # The edge: the largest volume 8 CTAs hold, then one position more.
    c = 64
    rows = (MAX_CHUNK - 8 * c) // (c * 2)
    assert group_norm_plan(1, 8 * rows, c, 8, torch.bfloat16, SMS).route == "cluster"
    assert cluster_plan(1, 8 * rows, c, 8, torch.bfloat16, 8) is not None
    assert group_norm_plan(1, 8 * rows + 1, c, 8, torch.bfloat16, SMS).route == "stream"


@pytest.mark.parametrize("c,groups", [(12, 4), (128, 16)], ids=["ragged_vectors", "16_groups"])
def test_stream_route_for_shapes_the_cluster_kernel_does_not_take(c, groups):
    # Rows of 12 bf16 channels are not whole 16-byte vectors; the cluster
    # kernel sums at most 8 groups.
    assert cluster_plan(4, 54, c, groups, torch.bfloat16, 1) is None
    assert group_norm_plan(4, 54, c, groups, torch.bfloat16, SMS).route == "stream"


@pytest.mark.parametrize("c", [8, 24, 40, 96, 192])
def test_threads_keep_one_window(c):
    """Rows of 1, 3, 5, 12 or 24 bf16 windows: the CTA's threads are the
    least multiple of lcm(32, windows) from 256 up, so every thread keeps
    one window."""
    plan = cluster_plan(4, 54, c, 8, torch.bfloat16, 1)
    step = np.lcm(32, c // 8)
    assert plan.threads % step == 0 and 256 <= plan.threads < 256 + step


def test_small_calls_take_the_stream_route_large_ones_the_cluster():
    """The level-2 norms at batch 64 stay latency-bound; the same shape at
    batch 256, or a level-1 norm at 64, reads enough to take the cluster."""
    assert group_norm_plan(64, 54, 128, 8, torch.bfloat16, SMS).route == "stream"
    assert group_norm_plan(256, 54, 128, 8, torch.bfloat16, SMS).route == "cluster"
    assert group_norm_plan(64, 432, 32, 8, torch.bfloat16, SMS).route == "cluster"
    # A group slice past 16 KB a pass takes the cluster even for one sample.
    assert group_norm_plan(1, 432, 192, 8, torch.bfloat16, SMS).route == "cluster"


# ---------------------------------------------------------------------------
# The cluster route, replayed
# ---------------------------------------------------------------------------

def _butterfly(a):
    """A warp's xor butterfly over the last dim (32 lanes), as warp_sum:
    each lane adds its partner's value, offsets 16 down to 1."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        a = a + a[..., lanes ^ off]
    return a[..., 0]


def _cta_group_sums(s, lane_group, G):
    """csrc/groupnorm.cu's group sums for one CTA: ``s`` (B, threads,
    V) lane sums → (B, G).  Each thread folds its lanes into G partials (its
    lanes in order, zeros for other groups), each warp sums a partial by xor
    butterfly, and the CTA sums its warps in order."""
    B, T, V = s.shape
    p = torch.zeros(B, T, G, dtype=s.dtype)
    for e in range(V):
        p = p + torch.where(lane_group[None, :, e, None] == torch.arange(G),
                            s[:, :, e, None], torch.zeros((), dtype=s.dtype))
    warps = _butterfly(p.reshape(B, T // 32, 32, G).transpose(2, 3))  # (B, warps, G)
    total = torch.zeros(B, G, dtype=s.dtype)
    for w in range(T // 32):
        total = total + warps[:, w]
    return total


def replay_cluster(x, gamma, beta, eps, silu, plan, G=8):
    """The cluster route over f32 ``x`` (B, S, C) in torch, in the kernel's
    order: CTA r holds rows [r·⌈S/k⌉, …); thread t sums vectors t, t + T, …
    of its run lane by lane (its window: channels (t mod C/V)·V …); the
    CTA's group sums as ``_cta_group_sums``; the cluster's in rank order,
    as every thread of every CTA reads them.  The kernel fuses d·d + s into
    one FMA (emulated here in f64).  Returns the output and how many CTA
    runs hold each element."""
    B, S, C = x.shape
    V, T, k, rows = plan.vec, plan.threads, plan.cluster, plan.rows_per_cta
    windows, cg = C // V, C // G
    n = torch.tensor(float(S)) * cg
    owner = torch.zeros(B, S, C, dtype=torch.int64)
    runs = []
    for r in range(k):
        row0 = r * rows
        nr = max(0, min(rows, S - row0))
        owner[:, row0:row0 + nr] += 1
        runs.append(x[:, row0:row0 + nr].reshape(B, nr * windows, V))
    lane_group = ((torch.arange(T) % windows)[:, None] * V + torch.arange(V)) // cg  # (T, V)

    def cluster_sums(add):
        total = torch.zeros(B, G)
        for run in runs:
            s = torch.zeros(B, T, V)
            for j0 in range(0, run.shape[1], T):
                blk = run[:, j0:j0 + T]
                t = blk.shape[1]
                s[:, :t] = add(s[:, :t], blk, lane_group[:t])
            total = total + _cta_group_sums(s, lane_group, G)  # rank order
        return total

    mean = cluster_sums(lambda s, v, grp: s + v) / n

    def fma_sq_dev(s, v, grp):
        d = (v - mean[:, grp]).double()
        return (d * d + s.double()).float()

    var = cluster_sums(fma_sq_dev) / n
    rstd = torch.rsqrt(var + eps)
    ch_group = torch.arange(C) // cg
    y = (x - mean[:, None, ch_group]) * rstd[:, None, ch_group] * gamma + beta
    if silu:
        y = y / (1 + torch.exp(-y))
    return y, owner


@pytest.mark.parametrize("s", [55, 403])
@pytest.mark.parametrize("c", [32, 64, 192])
@pytest.mark.parametrize("k", CLUSTER_SIZES)
def test_cluster_replay_matches_twin_and_jax(k, c, s):
    """S = 55 and 403 are no multiples of k: the last CTA's run is short
    (at 403, threads take several vectors each).  The bf16 kernel's order
    is replayed in f32 on values rounded to bf16, against the twin on the
    same values."""
    b = 2
    rng = np.random.default_rng(100 * k + c + s)
    x = (rng.normal(size=(b, s, c)) * 2.0 + 0.5).astype(np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    gamma = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    plan = cluster_plan(b, s, c, 8, torch.bfloat16, k)
    got, owner = replay_cluster(*map(torch.from_numpy, (x, gamma, beta)), 1e-5, True, plan)
    assert torch.equal(owner, torch.ones_like(owner))  # every element in one CTA run
    ref = group_norm_reference(*map(torch.from_numpy, (x, gamma, beta)), 8, 1e-5, True)
    scale = ref.abs().max().item()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * scale)
    want = np.asarray(jax_fused_group_norm(x, gamma, beta, num_groups=8, eps=1e-5, silu=True,
                                           mode="interpret"))
    np.testing.assert_allclose(got.numpy(), want, atol=GN_ATOL, rtol=0)
