"""Port parity: flow matching's interpolants, loss, time grid and the Euler
and Heun integrators against the JAX package's ``models/flow_matching``.

Randomness crosses as data: the JAX loss draws x0 from ``split(key)[0]`` and
t from ``split(key)[1]``, the JAX integrators x0 from ``key``; the tests
regenerate those arrays with ``jax.random`` and inject them into the port.
The velocity model on both sides is a small DiT2D (FM-DiT's backbone) with
the same perturbed weights, in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.models import guidance as jax_guidance
from crowdmod_tpu.models.backbones import dit as jax_dit
from crowdmod_tpu.models.flow_matching import fm as jax_fm
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.models import guidance
from crowdmod_tpu_torch.models.backbones.dit import DiT2D
from crowdmod_tpu_torch.models.flow_matching import fm

P, F, H, W, C = 5, 3, 8, 12, 3
DIT2D = dict(out_channels=C, grid_rows=H, grid_cols=W, past_len=P, future_len=F,
             patch_size=4, hidden_size=32, depth=2, num_heads=4, dropout_rate=0.0)
SHAPE = (2, F, H, W, C)
LOSS_RTOL = 1e-5       # f32 mean of squares
CHAIN_ATOL = 1e-4      # f32, 25 Euler steps or 10 Heun steps of a DiT2D
CFG_SCALE = 2.0


def perturbed(tree, seed, std=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0.0, std, np.shape(a)).astype(np.float32),
        tree,
    )


@pytest.fixture(scope="module")
def velocity():
    """(jax u_fn, port model, past) over one set of perturbed weights."""
    jmodel = jax_dit.DiT2D(**DIT2D)
    past = np.random.default_rng(0).normal(size=(2, P, H, W, C)).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros(SHAPE), jnp.zeros((2,)), past)
    params = perturbed(variables["params"], seed=1)
    tmodel = DiT2D(**DIT2D).eval()
    tmodel.load_state_dict(state_dict_from_jax(params, "dit2d"))
    jfn = lambda x, t, c: jmodel.apply({"params": params}, x, t, c)  # noqa: E731
    return jfn, tmodel, past


def test_time_grid_bits_match_jnp_linspace():
    """Every step count of 1..1001: the grid and its embedding indices are
    the JAX package's float32 bits (torch.linspace's are not), traced as
    the JAX sampler runs it under jit (100 step counts a program: one
    compile each), and eagerly at the counts torch.linspace gets wrong."""
    for lo in range(1, 1002, 100):
        ns = range(lo, min(lo + 100, 1002))
        grids = jax.jit(lambda: [jax_fm._time_grid(n, 1000) for n in ns])()  # noqa: B023
        for n, (want_ts, want_idx) in zip(ns, grids):
            got_ts, got_idx = fm._time_grid(n, 1000)
            assert got_ts.dtype == got_idx.dtype == np.float32
            assert np.array_equal(got_ts, np.asarray(want_ts)), n
            assert np.array_equal(got_idx, np.asarray(want_idx)), n
    for n in (26, 51, 101, 1001):
        want_ts, want_idx = jax_fm._time_grid(n, 1000)
        got_ts, got_idx = fm._time_grid(n, 1000)
        assert np.array_equal(got_ts, np.asarray(want_ts)), n
        assert np.array_equal(got_idx, np.asarray(want_idx)), n


@pytest.mark.parametrize("name", ["Linear", "Conic"])
def test_interpolants_match_jax(name):
    rng = np.random.default_rng(3)
    x0, x1 = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    # t = 1 exactly: the conic interpolant's eps guard.
    t = np.array([0.25, 1.0], np.float32).reshape(2, 1, 1, 1, 1)
    want = jax_fm.INTERPOLANTS[name](jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(t))
    got = fm.INTERPOLANTS[name](*(torch.from_numpy(a) for a in (x0, x1, t)))
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("w_type", ["Linear", "Conic"])
def test_fm_loss_matches_jax_with_its_draws(velocity, w_type):
    jfn, tmodel, past = velocity
    future = np.random.default_rng(4).normal(size=SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = float(jax_fm.fm_loss(jfn, jnp.asarray(future), jnp.asarray(past), key,
                                w_type=w_type, time_max_pos=1000))
    k0, kt = jax.random.split(key)
    x0 = np.array(jax.random.normal(k0, SHAPE))
    t = np.array(jax.random.uniform(kt, (2,)))
    with torch.no_grad():
        got = float(fm.fm_loss(tmodel, torch.from_numpy(future), torch.from_numpy(past),
                               t=torch.from_numpy(t), x0=torch.from_numpy(x0),
                               w_type=w_type, time_max_pos=1000))
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    with pytest.raises(ValueError, match="generator"):
        fm.fm_loss(tmodel, torch.from_numpy(future), torch.from_numpy(past))


def _chain(velocity, integrator, steps, scale):
    jfn, tmodel, past = velocity
    key = jax.random.PRNGKey(7)
    jfn = jax_guidance.cfg_denoise_fn(jfn, scale)
    want = np.asarray(jax_fm.INTEGRATORS[integrator](
        jfn, jnp.asarray(past), key, SHAPE, steps=steps, time_max_pos=1000))
    x0 = torch.from_numpy(np.array(jax.random.normal(key, SHAPE, dtype=jnp.float32)))
    with torch.no_grad():
        got = fm.INTEGRATORS[integrator](
            guidance.cfg_denoise_fn(tmodel, scale), torch.from_numpy(past), SHAPE,
            steps=steps, time_max_pos=1000, noise=lambda t: x0).numpy()
    return got, want


@pytest.mark.parametrize("scale", [1.0, CFG_SCALE], ids=["cfg_off", "cfg_on"])
@pytest.mark.parametrize("integrator,steps", [("Euler", 25), ("Heun", 10)])
def test_chain_matches_jax_on_the_same_x0(velocity, integrator, steps, scale):
    got, want = _chain(velocity, integrator, steps, scale)
    assert got.shape == want.shape == SHAPE
    assert np.abs(want - np.asarray(jax.random.normal(jax.random.PRNGKey(7), SHAPE))
                  ).max() > 1e-2  # the field moved x
    np.testing.assert_allclose(got, want, atol=CHAIN_ATOL, rtol=0)


def test_euler_x_init_and_generator_draws():
    """``x_init`` replaces the draw; without noise or x_init the draw comes
    from the generator on the past's device, and the same seed repeats."""
    u = lambda x, t, c: torch.ones_like(x)  # noqa: E731
    past = torch.zeros((2, P, H, W, C))
    x = fm.euler_sample(u, past, SHAPE, steps=4, x_init=torch.zeros(SHAPE))
    torch.testing.assert_close(x, torch.ones(SHAPE))
    a, b = (fm.euler_sample(u, past, SHAPE, steps=4,
                            generator=torch.Generator().manual_seed(1)) for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    h = fm.heun_sample(u, past, SHAPE, steps=4, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(h, a, rtol=0, atol=1e-6)


def test_heun_second_stage_embeds_the_next_index():
    """The reference's +1 on the second stage's time index: the t vectors
    the field sees alternate idx, idx + 1."""
    seen = []

    def u(x, t, c):
        seen.append(float(t[0]))
        return torch.zeros_like(x)

    fm.heun_sample(u, None, SHAPE, steps=3, device="cpu",
                   noise=lambda t: torch.zeros(SHAPE))
    _, idx = fm._time_grid(3, 1000)
    assert seen == [v for i in idx for v in (float(i), float(i) + 1)]
