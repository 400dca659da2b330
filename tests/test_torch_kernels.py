"""Port parity: the two kernel twins against the JAX package's kernels.

The JAX side runs the Pallas kernels in interpret mode (and the attention
oracle), as the JAX package's own kernel tests do on the CPU.  The port's
public wrappers, given CPU tensors, run their twins and launch nothing; the
CUDA kernels themselves are held against the twins on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.ops.pallas.attention import (
    attention_reference as jax_attention_reference,
    fused_attention as jax_fused_attention,
)
from crowdmod_tpu.ops.pallas.fused_step import (
    fused_ancestral_update as jax_fused_ancestral_update,
)
from crowdmod_tpu_torch.ops.kernels import (
    ancestral_update_reference,
    attention_reference,
    fused_ancestral_update,
    fused_attention,
    step_coefficients,
)
from crowdmod_tpu_torch.ops.kernels.attention import (
    _check as check_attention_inputs,
)

ATTN_ATOL = 1e-5  # f32 logits/softmax; only summation order differs
STEP_ATOL = 1e-6  # f32 elementwise chain


def _qkv(b, h, sq, sk, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.normal(size=(b, h, s, dh)).astype(np.float32) for s in (sq, sk, sk)
    )


@pytest.mark.parametrize(
    "sq,sk,dh", [(27, 27, 64), (1, 2, 64), (216, 216, 32)],
    ids=["spatial", "temporal", "edge"],
)
def test_attention_twin_matches_jax(sq, sk, dh):
    q, k, v = _qkv(2, 4, sq, sk, dh, seed=sq + sk)
    scale = 1.0 / dh**0.5
    got = attention_reference(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    want_kernel = np.asarray(jax_fused_attention(q, k, v, mode="interpret"))
    want_oracle = np.asarray(jax_attention_reference(q, k, v, scale))
    np.testing.assert_allclose(got, want_kernel, atol=ATTN_ATOL, rtol=0)
    np.testing.assert_allclose(got, want_oracle, atol=ATTN_ATOL, rtol=0)


def test_attention_twin_bf16_rounds_weights_like_jax():
    q, k, v = _qkv(1, 2, 27, 27, 64, seed=5)
    as_bf16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = attention_reference(*map(as_bf16, (q, k, v)), 0.125).float().numpy()
    want = jax_attention_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 0.125
    )
    np.testing.assert_allclose(
        got, np.asarray(want.astype(jnp.float32)), atol=2e-2, rtol=0
    )


@pytest.mark.parametrize("sparsity", [False, True], ids=["none", "sparsity"])
def test_ancestral_twin_matches_jax(sparsity):
    rng = np.random.default_rng(7)
    x, eps, z = (
        rng.normal(size=(4, 3, 12, 36, 3)).astype(np.float32) for _ in range(3)
    )
    coefs = dict(
        inv_sqrt_alpha=np.float32(1.0051), beta_over_somab=np.float32(0.0632),
        sigma=np.float32(0.1001),
    )
    got = ancestral_update_reference(
        *map(torch.from_numpy, (x, eps, z)), lambda_guidance=0.6,
        sparsity=sparsity, **coefs,
    ).numpy()
    want = np.asarray(jax_fused_ancestral_update(
        x, eps, z, lambda_guidance=0.6, sparsity=sparsity, mode="interpret",
        **{k: jnp.asarray(v) for k, v in coefs.items()},
    ))
    np.testing.assert_allclose(got, want, atol=STEP_ATOL, rtol=0)
    if sparsity:  # the term touches the rho channel only
        plain = ancestral_update_reference(
            *map(torch.from_numpy, (x, eps, z)), **coefs
        ).numpy()
        np.testing.assert_array_equal(got[..., 1:], plain[..., 1:])
        assert np.abs(got[..., 0] - plain[..., 0]).min() > 0.05


def test_sign_of_zero_is_zero():
    x = torch.zeros(1, 2, 3)
    out = ancestral_update_reference(
        x, x, x, inv_sqrt_alpha=1.0, beta_over_somab=0.0, sigma=0.5,
        lambda_guidance=0.6, sparsity=True,
    )
    assert torch.equal(out, x)


def test_cpu_wrappers_run_the_twins_and_launch_nothing():
    fused_attention.launches = 0
    fused_ancestral_update.launches = 0
    q, k, v = map(torch.from_numpy, _qkv(2, 4, 27, 27, 64, seed=9))
    torch.testing.assert_close(
        fused_attention(q, k, v), attention_reference(q, k, v, 0.125),
        rtol=0, atol=0,
    )
    x = torch.randn(2, 3, 12, 36, 3, generator=torch.Generator().manual_seed(0))
    coeffs = step_coefficients(1.01, 0.05, 0.1, "cpu")
    torch.testing.assert_close(
        fused_ancestral_update(x, x, x, coeffs, lambda_guidance=0.6, sparsity=True),
        ancestral_update_reference(
            x, x, x, inv_sqrt_alpha=coeffs[0], beta_over_somab=coeffs[1],
            sigma=coeffs[2], lambda_guidance=0.6, sparsity=True), rtol=0, atol=0,
    )
    assert fused_attention.launches == 0
    assert fused_ancestral_update.launches == 0


def test_cuda_route_checks_before_launching():
    """A wrapper never sends a tensor it cannot take to the kernel: mixed
    devices are refused before any build or launch is attempted."""
    q = torch.zeros(1, 1, 4, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        check_attention_inputs(q, q, q)
