"""The ancestral step's plan and its vector pass, without a card.

``ancestral_update_plan`` (``crowdmod_tpu_torch/ops/kernels/fused_step.py``)
cuts a call of ``csrc/fused_step.cu`` into a scalar head (up to the first
16-byte boundary), float4 vectors and a scalar tail, over one wave of
blocks.  These tests pin the plan at the serving shapes, its alignment
rules, and replay the kernel's vector-lane → channel mapping (the ρ lanes of
each vector worked out from its first lane's channel) in torch: the replay
must equal the plain twin bit for bit, and the JAX package's Pallas kernel
within ``STEP_ATOL``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.ops.pallas.fused_step import (
    fused_ancestral_update as jax_fused_ancestral_update,
)
from crowdmod_tpu_torch.ops.kernels import ancestral_update_reference
from crowdmod_tpu_torch.ops.kernels.fused_step import (
    BLOCKS_PER_SM,
    THREADS,
    StepPlan,
    ancestral_update_plan,
)

STEP_ATOL = 1e-6  # f32 elementwise chain, as tests/test_torch_kernels.py
SMS = 132
COEFS = dict(inv_sqrt_alpha=1.0051, beta_over_somab=0.0632, sigma=0.1001)
LAMBDA = 0.6


@pytest.mark.parametrize("batch,blocks", [(1, 4), (8, 31), (64, 243), (256, 972)])
def test_serving_shapes_take_aligned_vectors_in_one_wave(batch, blocks):
    n = batch * 3 * 12 * 36 * 3  # (B, F, H, W, C) of the ATC serving config
    plan = ancestral_update_plan(n, 3, SMS)
    assert plan == StepPlan(vec=4, head=0, vectors=n // 4, tail=0, threads=THREADS,
                            blocks=blocks, index64=False)
    assert plan.blocks <= BLOCKS_PER_SM * SMS  # one wave: a thread a vector


def test_grid_stride_past_one_wave_and_64_bit_index():
    plan = ancestral_update_plan(2**31 + 6, 3, SMS)
    assert plan.blocks == BLOCKS_PER_SM * SMS == 1056
    assert plan.index64 and (plan.head, plan.vectors, plan.tail) == (0, 2**29 + 1, 2)
    assert not ancestral_update_plan(2**31 - 1, 3, SMS).index64


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_head_reaches_the_first_16_byte_boundary(phase):
    base = 1024 + 4 * phase
    plan = ancestral_update_plan(1001, 3, SMS, (base, base + 4096, base + 64, base + 16))
    assert plan.vec == 4 and plan.head == (4 - phase) % 4
    assert (base + 4 * plan.head) % 16 == 0
    assert plan.head + 4 * plan.vectors + plan.tail == 1001 and plan.tail < 4


def test_pointers_at_different_phases_take_the_scalar_path():
    plan = ancestral_update_plan(1001, 3, SMS, (0, 4, 0, 0))
    assert (plan.vec, plan.head, plan.vectors, plan.tail) == (1, 1001, 0, 0)
    assert plan.blocks == 4  # ⌈1001 / 256⌉ threads, one an element


@pytest.mark.parametrize("bad", [(2, 0, 0, 0), (0, 0, 0, 6), (0, 1, 1, 1)])
def test_raises_on_a_pointer_not_4_byte_aligned(bad):
    with pytest.raises(ValueError, match="4-byte aligned"):
        ancestral_update_plan(64, 3, SMS, bad)


def test_short_calls_are_all_head():
    plan = ancestral_update_plan(2, 3, SMS, (4, 4, 4, 4))  # 3 elements to the boundary
    assert (plan.head, plan.vectors, plan.tail, plan.blocks) == (2, 0, 0, 1)


def _replay(x, eps, z, plan: StepPlan, channels, rho):
    """The kernel's pass in torch over flat f32 ``x``, ``eps``, ``z``: every
    element's product chain, then the ρ lanes as the kernel finds them —
    per vector from its first element's channel (d = ρ − i mod C, lanes d,
    d + C, … below 4), per scalar of the head and tail from its own."""
    sigma = COEFS["sigma"]
    r = COEFS["inv_sqrt_alpha"] * (x - COEFS["beta_over_somab"] * eps) + sigma * z
    n = x.numel()
    guided = torch.zeros(n, dtype=torch.bool)
    for v in range(plan.vectors):
        i = plan.head + 4 * v
        d = (rho - i % channels) % channels
        for lane in range(d, 4, channels):
            guided[i + lane] = True
    tail0 = plan.head + 4 * plan.vectors
    for i in [*range(plan.head), *range(tail0, n)]:
        guided[i] = i % channels == rho
    lam_sigma = torch.tensor(LAMBDA * sigma, dtype=torch.float32)
    return torch.where(guided, r - lam_sigma * torch.sign(r), r)


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5])
def test_vector_lanes_find_the_rho_channel(channels, phase):
    """Head, vectors and tail of every (n mod 4, ρ) the channel count
    allows, with the arrays starting ``phase`` floats past a 16-byte
    boundary: bitwise the twin, and the JAX kernel within STEP_ATOL."""
    rng = np.random.default_rng(10 * channels + phase)
    tails = set()
    for rows in range(5, 13):  # n = rows·C covers every n mod 4 that C allows
        n = rows * channels
        ptr = 4 * phase
        plan = ancestral_update_plan(n, channels, SMS, (ptr,) * 4)
        tails.add(plan.tail)
        x, eps, z = (rng.normal(size=(1, rows, channels)).astype(np.float32) for _ in range(3))
        for rho in range(channels):
            got = _replay(*(torch.from_numpy(a).reshape(-1) for a in (x, eps, z)),
                          plan, channels, rho).reshape(x.shape)
            want = ancestral_update_reference(
                *map(torch.from_numpy, (x, eps, z)), lambda_guidance=LAMBDA,
                sparsity=True, rho_channel=rho, **COEFS)
            assert torch.equal(got, want), (n, rho, plan)
            if rows == 12:
                jax_out = np.asarray(jax_fused_ancestral_update(
                    x, eps, z, lambda_guidance=LAMBDA, sparsity=True, rho_channel=rho,
                    mode="interpret", **{k: jnp.float32(v) for k, v in COEFS.items()}))
                np.testing.assert_allclose(got.numpy(), jax_out, atol=STEP_ATOL, rtol=0)
    # Every tail length n − head − 4·vectors can take for this C and phase.
    assert tails == {(rows * channels - (4 - phase) % 4) % 4 for rows in range(5, 13)}
