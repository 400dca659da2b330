"""Port parity: DPM-Solver++(2M) against the JAX package's
``models/diffusion/dpm_solver.py``, and the trainer's ``DPM-Solver`` branch.

* The timestep ladders, integer for integer, for every step count in
  [2, T-1] at each ``TIMESTEPS`` of ``configs/`` and at the tests' T = 50:
  each point against exact arithmetic away from exact .5 ties (on any
  host), and every ladder with a tie against JAX's, whose float32 rounding
  decides its side.  That rounding is XLA:CPU's code generation: the port
  reproduces jaxlib 0.9.0 on x86-64 with AVX2 and FMA at XLA's default
  vector width without fast math, so the tie check runs only on such a
  host (another vector width or fast math moves some tied points; a newer
  jaxlib that moves them fails it, as the reference then changed).  The
  JAX side holds those ladders in one jitted program (the same bits as a
  call each, checked at 20 steps and at a step count on each side of XLA's
  vector-loop threshold).
* 5-step chains with ``history`` on a small DiT4DFactorized (hidden 32,
  depth 2) and a small UNet3D (base 8, two levels) with the same perturbed
  weights, the JAX x_T injected: within 1e-4.
* ``Trainer.sample`` with ``SAMPLER: DPM-Solver`` against the JAX
  ``Trainer.sample`` (v-prediction through the PRED_TYPE adapter), and the
  guided-config refusal.
"""

import glob
import os
import platform
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from crowdmod_tpu.core import schedule as jax_schedule
from crowdmod_tpu.models.backbones import dit as jax_dit
from crowdmod_tpu.models.backbones.unet3d import UNet3D as JaxUNet3D
from crowdmod_tpu.models.diffusion import dpm_solver as jax_dpm
from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.core import schedule
from crowdmod_tpu_torch.models.backbones.dit import DiT4DFactorized
from crowdmod_tpu_torch.models.backbones.unet3d import UNet3D
from crowdmod_tpu_torch.models.diffusion import dpm_solver
from crowdmod_tpu_torch.train.trainer import Trainer
from torch_train_parity import perturbed, tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 3, 8, 12, 3)
PAST_SHAPE = (2, 5, 8, 12, 3)
T_SMALL = 50
CHAIN_ATOL = 1e-4
BACKBONES = {
    "dit": (jax_dit.DiT4DFactorized, DiT4DFactorized, dict(
        out_channels=3, grid_rows=8, grid_cols=12, past_len=5, future_len=3,
        patch_size=4, t_patch_size=4, hidden_size=32, depth=2, num_heads=4,
        dropout_rate=0.0)),
    "unet": (JaxUNet3D, UNet3D, dict(
        out_channels=3, base_channels=8, base_channels_multiples=(1, 2),
        apply_attention=(False, True), dropout_rate=0.0)),
}


def config_timesteps() -> list[int]:
    """Every ``MODEL.DDPM.TIMESTEPS`` in ``configs/``."""
    found = set()
    for path in glob.glob(os.path.join(REPO, "configs", "**", "*.yml"), recursive=True):
        node = (yaml.safe_load(open(path)) or {}).get("MODEL", {}).get("DDPM", {})
        if "TIMESTEPS" in node:
            found.add(int(node["TIMESTEPS"]))
    return sorted(found)


def denoisers(name, seed=1):
    """(jax_fn, port_module) over one set of perturbed weights."""
    jcls, pcls, kw = BACKBONES[name]
    jmodel = jcls(**kw)
    params = perturbed(jmodel.init(jax.random.PRNGKey(0), jnp.zeros(SHAPE), jnp.zeros((2,)),
                                   jnp.zeros(PAST_SHAPE))["params"], seed=seed)
    port = pcls(**kw).eval()
    port.load_state_dict(state_dict_from_jax(params))
    return (lambda x, t, c: jmodel.apply({"params": params}, x, t, c)), port


def past_frames(seed=0):
    return np.random.default_rng(seed).normal(size=PAST_SHAPE).astype(np.float32)


def exact_ladder(timesteps, steps):
    """The ladder in exact arithmetic, nearest integer; None at an exact .5
    tie (its side is float32's rounding)."""
    out = []
    for b in range(steps + 1):
        v = Fraction((timesteps - 1) * (steps - b), steps)
        out.append(None if v.denominator == 2 else round(v))
    return out


def xla_cpu_as_fitted() -> bool:
    """Whether JAX here evaluates ``jnp.linspace`` as ``dpm_timesteps``
    reproduces it: x86-64 with AVX2 and FMA, XLA's default 256-bit
    preferred vector width, fast math off."""
    if platform.machine() not in ("x86_64", "AMD64") or not os.path.exists("/proc/cpuinfo"):
        return False
    with open("/proc/cpuinfo") as f:
        cpu_flags = next((ln.split(":", 1)[1].split() for ln in f if ln.startswith("flags")), [])
    xla = dict(a.lstrip("-").split("=", 1) for a in os.environ.get("XLA_FLAGS", "").split()
               if "=" in a)
    return ({"avx2", "fma"} <= set(cpu_flags)
            and xla.get("xla_cpu_prefer_vector_width", "256") == "256"
            and xla.get("xla_cpu_enable_fast_math", "false").lower() == "false")


LADDER_TS = sorted(set(config_timesteps()) | {T_SMALL})


def tied_step_counts(timesteps):
    return [s for s in range(2, timesteps) if None in exact_ladder(timesteps, s)]


@pytest.mark.parametrize("timesteps", LADDER_TS)
def test_ladders_match_exact_arithmetic_away_from_ties(timesteps):
    for s in range(2, timesteps):
        got = dpm_solver.dpm_timesteps(timesteps, s)
        exact = exact_ladder(timesteps, s)
        assert got.dtype == np.int32 and got.shape == (s + 1,)
        assert got[0] == timesteps - 1 and got[-1] == 0
        for b, (e, g) in enumerate(zip(exact, got)):
            if e is None:  # a tie lands on one of its two neighbours
                v = Fraction((timesteps - 1) * (s - b), s)
                assert g in (v - Fraction(1, 2), v + Fraction(1, 2)), (s, b, g)
            else:
                assert e == g, (s, b, got, exact)


@pytest.mark.skipif(not xla_cpu_as_fitted(), reason=(
    "the JAX ladders' tied points are XLA:CPU's code generation; dpm_timesteps "
    "reproduces jaxlib 0.9.0 on x86-64 with AVX2 and FMA at the default vector "
    "width without fast math, which this host or XLA_FLAGS is not"))
@pytest.mark.parametrize("timesteps", LADDER_TS)
def test_ladders_at_ties_match_jax(timesteps):
    # Every ladder with a tie, against JAX's (one program; a point at least
    # 1/(2s) from a tie is the same integer in any float32 evaluation).
    tied = tied_step_counts(timesteps)
    want = jax.jit(lambda: [jax_dpm.dpm_timesteps(timesteps, s) for s in tied])()
    for s, w in zip(tied, want):
        np.testing.assert_array_equal(dpm_solver.dpm_timesteps(timesteps, s), np.asarray(w),
                                      err_msg=f"T={timesteps} steps={s}")
    for s in {20, 351, 362} & set(range(2, timesteps)):  # eager calls, as the sampler makes them
        np.testing.assert_array_equal(dpm_solver.dpm_timesteps(timesteps, s),
                                      np.asarray(jax_dpm.dpm_timesteps(timesteps, s)))
    if timesteps == 1000:  # 499.5 is a tie: XLA:CPU's float32 rounds it to 500
        assert dpm_solver.dpm_timesteps(1000, 20)[10] == 500


@pytest.mark.parametrize("steps", [1, T_SMALL, T_SMALL + 3])
def test_step_bounds_raise_as_jax(steps):
    sched = schedule.linear_schedule(T_SMALL)
    with pytest.raises(ValueError) as port_err:
        dpm_solver.dpm_solver_sample(lambda x, t, c: x, sched, None, SHAPE, steps=steps,
                                     device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_dpm.dpm_solver_sample(lambda x, t, c: x, jax_schedule.linear_schedule(T_SMALL),
                                  None, jax.random.PRNGKey(0), SHAPE, steps=steps)
    assert str(port_err.value) == str(jax_err.value)
    assert "DPM_STEPS must be in [2, TIMESTEPS-1] = [2, 49]" in str(port_err.value)


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_five_step_chain_with_history_matches_jax(backbone):
    jfn, port = denoisers(backbone)
    past, key = past_frames(), jax.random.PRNGKey(7)
    x_final, traj = jax_dpm.dpm_solver_sample(
        jfn, jax_schedule.linear_schedule(T_SMALL), jnp.asarray(past), key, SHAPE,
        steps=5, history=True)
    x_t = torch.from_numpy(np.array(jax.random.normal(key, SHAPE, jnp.float32)))
    calls = []

    def noise(t):
        calls.append(t)
        return x_t

    with torch.no_grad():
        got, got_traj = dpm_solver.dpm_solver_sample(
            port, schedule.linear_schedule(T_SMALL), torch.from_numpy(past), SHAPE,
            steps=5, noise=noise, history=True)
    assert calls == [None]  # x_T is the only draw
    assert got_traj.shape == (6,) + SHAPE == np.shape(traj)
    np.testing.assert_array_equal(got_traj[0].numpy(), np.asarray(traj)[0])
    assert np.abs(np.asarray(x_final) - np.asarray(traj)[0]).max() > 0.1  # the chain moved
    np.testing.assert_allclose(got_traj.numpy(), np.asarray(traj), atol=CHAIN_ATOL, rtol=0)
    np.testing.assert_array_equal(got.numpy(), got_traj[-1].numpy())


def test_trainer_samples_dpm_solver_as_jax_and_refuses_guidance(tmp_path):
    """The DPM-Solver branch of ``Trainer.sample`` (DiT, v-prediction,
    6 steps) against the JAX trainer's, and its refusal of a guided
    config with the JAX package's message."""
    ddpm = {"SAMPLER": "DPM-Solver", "DPM_STEPS": 6, "GUIDANCE": "None"}
    cfg, jcfg = tiny_config(tmp_path, **ddpm)
    jtr = JaxTrainer(jcfg, "DDPM-DiT", run_dir=str(tmp_path / "jrun"), seed=3).setup()
    params = perturbed(jtr.state.params, seed=4)
    jtr.state = jtr.state.replace(params=params, ema_params=params)
    past, key = past_frames(1)[:, :, :, :, :3], jax.random.PRNGKey(11)
    want = np.asarray(jtr.sample(jnp.asarray(past), key))

    tr = Trainer(cfg, "DDPM-DiT", device="cpu", seed=3).setup()
    sd = state_dict_from_jax(params["params"])
    tr.model.load_state_dict(sd)
    tr.ema_model.load_state_dict(sd)
    x_t = torch.from_numpy(np.array(jax.random.normal(key, SHAPE, jnp.float32)))
    got = tr.sample(past, noise=lambda t: x_t).numpy()
    np.testing.assert_allclose(got, want, atol=CHAIN_ATOL, rtol=0)

    guided_cfg, guided_jcfg = tiny_config(tmp_path, **{**ddpm, "GUIDANCE": "Sparsity"})
    with pytest.raises(ValueError) as port_err:
        Trainer(guided_cfg, "DDPM-DiT", device="cpu").setup().sample(past)
    guided = JaxTrainer(guided_jcfg, "DDPM-DiT", run_dir=str(tmp_path / "g"))
    guided.state = jtr.state
    with pytest.raises(ValueError) as jax_err:
        guided.sample(jnp.asarray(past), key)
    assert str(port_err.value) == str(jax_err.value)
    assert "does not implement guidance" in str(port_err.value)
