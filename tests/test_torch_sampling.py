"""Port parity: schedules, the three samplers, as_eps_fn and guidance.

Randomness crosses as data: the JAX samplers draw x_T from ``split(key)[0]``
and step t's noise from ``fold_in(split(key)[1], t)``; the tests regenerate
those arrays with ``jax.random`` and inject them into the port's samplers,
so both chains see the same draws.  The denoiser on both sides is the small
DiT4DFactorized with the same perturbed weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.core import schedule as jax_schedule
from crowdmod_tpu.models import guidance as jax_guidance
from crowdmod_tpu.models.backbones import dit as jax_dit
from crowdmod_tpu.models.diffusion import ddpm as jax_ddpm
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.core import schedule
from crowdmod_tpu_torch.models import guidance
from crowdmod_tpu_torch.models.backbones.dit import DiT4DFactorized
from crowdmod_tpu_torch.models.diffusion import ddpm

DIT = dict(
    out_channels=3, grid_rows=8, grid_cols=12, past_len=5, future_len=3,
    patch_size=4, t_patch_size=4, hidden_size=64, depth=2, num_heads=4,
)
SHAPE = (2, 3, 8, 12, 3)
CHAIN_ATOL = 1e-3
MAX_FLIP_SHARE = 1e-3  # of all elements


def perturbed(tree, seed, std=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0.0, std, np.shape(a)).astype(np.float32),
        tree,
    )


@pytest.fixture(scope="module")
def denoisers():
    """(jax_fn, port_fn, past) over one set of perturbed weights."""
    jmodel = jax_dit.DiT4DFactorized(dropout_rate=0.0, **DIT)
    past = np.random.default_rng(0).normal(size=(2, 5, 8, 12, 3)).astype(np.float32)
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE), jnp.zeros((2,)), past
    )
    params = perturbed(variables["params"], seed=1)
    tmodel = DiT4DFactorized(dropout_rate=0.0, **DIT).eval()
    tmodel.load_state_dict(state_dict_from_jax(params))
    jfn = lambda x, t, c: jmodel.apply({"params": params}, x, t, c)
    return jfn, tmodel, past


def jax_noise(key, taus):
    """The JAX samplers' draws as a port ``noise`` callable."""
    k_init, k_loop = jax.random.split(key)
    draws = {None: jax.random.normal(k_init, SHAPE, jnp.float32)}
    for t in taus:
        draws[int(t)] = jax.random.normal(
            jax.random.fold_in(k_loop, t), SHAPE, jnp.float32
        )
    return lambda t: torch.from_numpy(np.array(draws[t]))


def assert_chain_close(got, want, guidance_mode):
    """Elementwise within CHAIN_ATOL, except that under Sparsity a rho value
    within float error of 0 may take the other sign in the two chains and
    move by 2·λ·σ: such flips (rho elements off by more than the tolerance)
    must stay under MAX_FLIP_SHARE of all elements."""
    assert np.isfinite(got).all()
    off = np.abs(got - want) > CHAIN_ATOL
    if guidance_mode == "Sparsity":
        assert not off[..., 1:].any(), np.abs(got - want)[..., 1:].max()
        assert off.sum() <= MAX_FLIP_SHARE * off.size
    else:
        np.testing.assert_allclose(got, want, atol=CHAIN_ATOL, rtol=0)


@pytest.mark.parametrize("timesteps,scale", [(1000, 0.5), (1000, 1.0), (10, 1.0)])
def test_linear_schedule_matches_jax(timesteps, scale):
    """Same float32 formulas; XLA's linspace/cumprod round differently from
    numpy's in the last bits, so buffers agree to a few f32 ulp (16 ulp of
    1.0 absolute: sqrt(1 - alpha_bar) near t = 0 magnifies alpha_bar's last
    bit by cancellation)."""
    want = jax_schedule.linear_schedule(timesteps, scale=scale)
    got = schedule.linear_schedule(timesteps, scale=scale)
    ulp = np.finfo(np.float32).eps
    for name in ("beta", "alpha", "alpha_bar", "sqrt_alpha_bar",
                 "sqrt_one_minus_alpha_bar", "one_by_sqrt_alpha"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=16 * ulp, atol=16 * ulp,
                                   err_msg=name)


@pytest.mark.parametrize("timesteps,steps", [(1000, 25), (50, 5), (1000, 1), (10, 10)])
def test_tau_grids_match_jax(timesteps, steps):
    np.testing.assert_array_equal(
        schedule.respaced_taus(timesteps, steps),
        np.asarray(jax_schedule.respaced_taus(timesteps, steps)),
    )
    np.testing.assert_array_equal(
        schedule.ddim_tau_schedule(timesteps, 2),
        np.asarray(jax_schedule.ddim_tau_schedule(timesteps, 2)),
    )


@pytest.mark.parametrize("guidance_mode", ["None", "Sparsity", "mass_preservation"])
def test_ddpm_chain_matches_jax(denoisers, guidance_mode):
    jfn, tfn, past = denoisers
    T, lam = 10, 0.6
    key = jax.random.PRNGKey(11)
    want = jax_ddpm.ddpm_sample(
        jfn, jax_schedule.linear_schedule(T), past, key, SHAPE,
        guidance=guidance_mode, lambda_guidance=lam,
    )
    with torch.no_grad():
        got = ddpm.ddpm_sample(
            tfn, schedule.linear_schedule(T), torch.from_numpy(past), SHAPE,
            noise=jax_noise(key, range(T)), guidance=guidance_mode,
            lambda_guidance=lam,
        )
    assert_chain_close(got.numpy(), np.asarray(want), guidance_mode)


@pytest.mark.parametrize("guidance_mode", ["None", "Sparsity"])
def test_ddim_eta_chain_matches_jax(denoisers, guidance_mode):
    jfn, tfn, past = denoisers
    T, lam = 50, 0.6
    taus = schedule.respaced_taus(T, 5)
    key = jax.random.PRNGKey(12)
    want = jax_ddpm.ddim_eta_sample(
        jfn, jax_schedule.linear_schedule(T), past, key, SHAPE,
        jnp.asarray(taus), eta=1.0, guidance=guidance_mode, lambda_guidance=lam,
    )
    with torch.no_grad():
        got = ddpm.ddim_eta_sample(
            tfn, schedule.linear_schedule(T), torch.from_numpy(past), SHAPE,
            taus, noise=jax_noise(key, taus), eta=1.0, guidance=guidance_mode,
            lambda_guidance=lam,
        )
    assert_chain_close(got.numpy(), np.asarray(want), guidance_mode)


def test_ddim_chain_matches_jax(denoisers):
    jfn, tfn, past = denoisers
    T = 50
    taus = schedule.ddim_tau_schedule(T, 10)
    key = jax.random.PRNGKey(13)
    want = jax_ddpm.ddim_sample(
        jfn, jax_schedule.linear_schedule(T), past, key, SHAPE,
        jnp.asarray(taus), sigma=0.001, guidance="Sparsity", lambda_guidance=0.6,
    )
    with torch.no_grad():
        got = ddpm.ddim_sample(
            tfn, schedule.linear_schedule(T), torch.from_numpy(past), SHAPE,
            taus, noise=jax_noise(key, taus), sigma=0.001, guidance="Sparsity",
            lambda_guidance=0.6,
        )
    assert_chain_close(got.numpy(), np.asarray(want), "Sparsity")


@pytest.mark.parametrize("pred_type", ["eps", "v", "x0"])
def test_pred_type_adapters_match_jax(pred_type):
    """as_eps_fn (model output → eps) and prediction_target (the training
    target) for each parameterization."""
    T = 100
    rng = np.random.default_rng(5)
    x, out, eps = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(3))
    t = np.array([3, 97], np.int32)
    jsched, tsched = jax_schedule.linear_schedule(T), schedule.linear_schedule(T)
    tt = torch.from_numpy(t).long()
    want = jax_ddpm.as_eps_fn(lambda *_: out, jsched, pred_type)(x, t, None)
    got = ddpm.as_eps_fn(lambda *_: torch.from_numpy(out), tsched, pred_type)(
        torch.from_numpy(x), tt, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    want = jax_ddpm.prediction_target(jsched, pred_type, x, eps, t)
    got = ddpm.prediction_target(
        tsched, pred_type, torch.from_numpy(x), torch.from_numpy(eps), tt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mass_preservation_gradient_matches_jax_grad():
    x = np.random.default_rng(6).normal(size=(2, 4, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jax_guidance.mass_preservation_gradient(x, 1.0, 1.0))
    got = guidance.mass_preservation_gradient(torch.from_numpy(x), 1.0, 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(
        guidance.sparsity_gradient(torch.from_numpy(x)).numpy(),
        np.asarray(jax_guidance.sparsity_gradient(x)),
    )
