"""The mass-preservation gradient in closed form (no autograd): against
``torch.autograd.grad`` of the port's ``continuity_energy`` and ``jax.grad``
of the JAX package's, within 1e-6·max|g|, and against the finite-difference
oracle (the reference's numerical scheme) within atol 5e-3 at eps 1e-3, as
``tests/test_guidance.py`` holds the JAX gradient; the port's FD oracle
against the JAX one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.models import guidance as jax_guidance
from crowdmod_tpu_torch.models import guidance

SHAPES = {"C3": (2, 4, 8, 12, 3), "C4": (2, 3, 6, 7, 4), "T2": (3, 2, 4, 5, 3)}


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("delta_t,delta_l", [(1.0, 1.0), (0.5, 1.0), (0.5, 0.7)])
def test_closed_form_matches_autograd_and_jax_grad(name, delta_t, delta_l):
    x = _x(SHAPES[name], seed=len(name))
    # inference mode: an autograd call inside would raise
    with torch.inference_mode():
        got = guidance.mass_preservation_gradient(torch.from_numpy(x), delta_t, delta_l)
    xg = torch.from_numpy(x).requires_grad_(True)
    (auto,) = torch.autograd.grad(guidance.continuity_energy(xg, delta_t, delta_l).sum(), xg)
    want = np.asarray(jax_guidance.mass_preservation_gradient(jnp.asarray(x), delta_t, delta_l))
    scale = np.abs(want).max()
    assert got.shape == x.shape and scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=0, atol=1e-6 * scale)
    if x.shape[-1] > 3:
        assert not got[..., 3:].any()  # σ² takes no part in the energy


@pytest.mark.parametrize("seed", [0, 1])
def test_closed_form_matches_finite_differences(seed):
    x = _x((2, 3, 4, 5, 3), seed, scale=0.5)
    exact = guidance.mass_preservation_gradient(torch.from_numpy(x), 0.5, 1.0)
    fd = guidance.mass_preservation_gradient_fd(torch.from_numpy(x), 0.5, 1.0, eps=1e-3)
    np.testing.assert_allclose(fd.numpy(), exact.numpy(), atol=5e-3)
    jfd = np.asarray(jax_guidance.mass_preservation_gradient_fd(jnp.asarray(x), 0.5, 1.0,
                                                                eps=1e-3))
    np.testing.assert_allclose(fd.numpy(), jfd, atol=5e-3)
