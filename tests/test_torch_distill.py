"""Port parity: progressive distillation (``models/diffusion/distill.py``,
``train/distiller.py``'s progressive half) and the trainer's ``Distilled``
sampler against the JAX package's.

* ``distill_grid``, at T = 50 and at each ``TIMESTEPS`` of ``configs/``:
  every n against exact rational arithmetic away from exact .5 ties (a
  point at least 1/(2n) from a tie is the same integer in any float32
  evaluation), and against the JAX function at every n whose grid has a
  tie (where float32's rounding decides) and every power of two; nesting
  ``grid(T, n)[k] == grid(T, 2n)[2k]``.
* ``ddim_det_step``, ``distill_targets`` and ``distill_loss`` on a small
  DiT4DFactorized and UNet3D (teacher and student with different perturbed
  weights), JAX's k and q-sample noise injected: within 1e-5 relative.
* ``distilled_sample`` at η 0 and 1 with ``history``, the JAX draws
  injected: within 1e-4.
* ``progressive_distill`` 4 → 2 steps, one epoch a phase, against the JAX
  one with its key stream replayed: the loss history within 1e-4 relative,
  the student's weights within 1% of the Adam steps' reach; the ``D002``
  checkpoint under the JAX name with its metadata, sampled by the
  ``Distilled`` sampler; the guards and the sampler's refusals.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.core import schedule as jax_schedule
from crowdmod_tpu.data.windows import WindowDataset as JaxWindowDataset
from crowdmod_tpu.models.diffusion import distill as jax_distill
from crowdmod_tpu.train import checkpoint as jax_ckpt
from crowdmod_tpu.train import distiller as jax_distiller
from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.core import schedule
from crowdmod_tpu_torch.data.windows import WindowDataset
from crowdmod_tpu_torch.models.diffusion import distill
from crowdmod_tpu_torch.train import checkpoint as ckpt
from crowdmod_tpu_torch.train import distiller
from crowdmod_tpu_torch.train.trainer import Trainer
from test_torch_dpm_solver import SHAPE, config_timesteps, denoisers, past_frames
from torch_train_parity import SEED, perturbed, tiny_config, walker_raw

T = 50
LOSS_RTOL = 1e-5
CHAIN_ATOL = 1e-4
LR = 1e-3
STEPS = 6  # two phases of one epoch of 3 batches
PARAM_SHARE = 1e-2  # of LR·STEPS, as tests/test_torch_reflow.py
HISTORY_RTOL = 1e-4


def _exact_grid(timesteps, n):
    """The grid in exact arithmetic, nearest integer; None at an exact .5
    tie (its side is float32's rounding)."""
    out = []
    for k in range(n + 1):
        v = Fraction(timesteps * k, n) - 1
        out.append(None if v.denominator == 2 else round(v))
    return out


def _has_tie(timesteps, n):
    return None in _exact_grid(timesteps, n)


@pytest.mark.parametrize("timesteps", sorted(set(config_timesteps()) | {T}))
def test_grid_matches_jax_and_nests(timesteps):
    for n in range(1, timesteps + 1):
        got = distill.distill_grid(timesteps, n)
        assert got.dtype == np.int32 and got[0] == -1 and got[-1] == timesteps - 1
        exact = _exact_grid(timesteps, n)
        assert all(e is None or e == g for e, g in zip(exact, got)), (n, got, exact)
        if 2 * n <= timesteps:
            np.testing.assert_array_equal(got, distill.distill_grid(timesteps, 2 * n)[::2])
        if _has_tie(timesteps, n) or n & (n - 1) == 0:
            np.testing.assert_array_equal(got, np.asarray(jax_distill.distill_grid(timesteps, n)),
                                          err_msg=f"T={timesteps} n={n}")
    for bad in (0, timesteps + 1):
        with pytest.raises(ValueError) as port_err:
            distill.distill_grid(timesteps, bad)
        with pytest.raises(ValueError) as jax_err:
            jax_distill.distill_grid(timesteps, bad)
        assert str(port_err.value) == str(jax_err.value)


@pytest.fixture(scope="module")
def scheds():
    return jax_schedule.linear_schedule(T), schedule.linear_schedule(T)


def test_ddim_det_step_matches_jax(scheds):
    jsched, sched = scheds
    rng = np.random.default_rng(3)
    x, eps = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(2))
    for t_from, t_to in ((49, 24), (12, -1), (np.array([40, 7]), np.array([20, -1]))):
        want = jax_distill.ddim_det_step(jsched, jnp.asarray(x), jnp.asarray(eps),
                                         jnp.asarray(t_from), jnp.asarray(t_to))
        as_port = (lambda t: torch.from_numpy(t) if isinstance(t, np.ndarray) else t)
        got = distill.ddim_det_step(sched, torch.from_numpy(x), torch.from_numpy(eps),
                                    as_port(t_from), as_port(t_to))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_RTOL, atol=1e-6)


def _loss_draws(key, n, shape):
    kk, kq = jax.random.split(key)
    k = jax.random.randint(kk, (shape[0],), 1, n + 1)
    eps = jax.random.normal(kq, shape, jnp.float32)
    return torch.from_numpy(np.array(k)).long(), torch.from_numpy(np.array(eps))


@pytest.mark.parametrize("backbone,n_steps", [("dit", 1), ("dit", 2), ("dit", 8), ("unet", 4)])
def test_targets_and_loss_match_jax(backbone, n_steps, scheds):
    jsched, sched = scheds
    jteacher, teacher = denoisers(backbone, seed=1)
    jstudent, student = denoisers(backbone, seed=2)
    past = past_frames(4)
    future = np.random.default_rng(5).normal(size=SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(n_steps)
    want = float(jax_distill.distill_loss(jstudent, jteacher, jsched, n_steps,
                                          jnp.asarray(future), jnp.asarray(past), key))
    k, eps = _loss_draws(key, n_steps, SHAPE)
    got = distill.distill_loss(student, teacher, sched, n_steps, torch.from_numpy(future),
                               torch.from_numpy(past), k=k, eps=eps)
    assert got.requires_grad and want > 0
    np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)

    # The targets of one (t_hi, t_mid, t_lo), detached from the teacher.
    grid2 = distill.distill_grid(T, 2 * n_steps)
    t = [np.full((2,), grid2[i], np.int32) for i in (2 * n_steps, 2 * n_steps - 1,
                                                      2 * n_steps - 2)]
    x_t = np.random.default_rng(6).normal(size=SHAPE).astype(np.float32)
    want_t = jax_distill.distill_targets(jteacher, jsched, jnp.asarray(x_t), *t,
                                         jnp.asarray(past))
    got_t = distill.distill_targets(teacher, sched, torch.from_numpy(x_t),
                                    *(torch.from_numpy(a).long() for a in t),
                                    torch.from_numpy(past))
    for g, w in zip(got_t, want_t):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=LOSS_RTOL, atol=1e-5)
    with pytest.raises(ValueError, match="generator"):
        distill.distill_loss(student, teacher, sched, n_steps, torch.from_numpy(future), None)


def _sample_noise(key, n_steps, shape=SHAPE, timesteps=T):
    """The JAX ``distilled_sample`` draws as a port ``noise`` callable."""
    k_init, k_loop = jax.random.split(key)
    draws = {None: jax.random.normal(k_init, shape, jnp.float32)}
    for t in distill.distill_grid(timesteps, n_steps)[1:]:
        draws[int(t)] = jax.random.normal(jax.random.fold_in(k_loop, int(t)), shape,
                                          jnp.float32)
    return lambda t: torch.from_numpy(np.array(draws[t]))


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_distilled_sample_matches_jax(eta, scheds):
    jsched, sched = scheds
    jfn, port = denoisers("dit")
    past, key = past_frames(7), jax.random.PRNGKey(8)
    _, traj = jax_distill.distilled_sample(jfn, jsched, jnp.asarray(past), key, SHAPE, 4,
                                           eta=eta, history=True)
    with torch.no_grad():
        got, got_traj = distill.distilled_sample(port, sched, torch.from_numpy(past), SHAPE,
                                                 4, eta=eta, noise=_sample_noise(key, 4),
                                                 history=True)
    assert got_traj.shape == (5,) + SHAPE
    np.testing.assert_allclose(got_traj.numpy(), np.asarray(traj), atol=CHAIN_ATOL, rtol=0)


def _jax_distill_draws(seed):
    """The JAX ``progressive_distill`` key stream as the port's ``draws``."""
    state = {"key": jax.random.PRNGKey(seed), "kq": None}

    def draws(kind, shape, n=None):
        if kind == "k":
            state["key"], sub = jax.random.split(state["key"])
            kk, state["kq"] = jax.random.split(sub)
            return torch.from_numpy(np.array(jax.random.randint(kk, shape, 1, n + 1))).long()
        return torch.from_numpy(np.array(jax.random.normal(state["kq"], shape, jnp.float32)))

    return draws


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax")
    _, jcfg = tiny_config(root)
    jtr = JaxTrainer(jcfg, "DDPM-DiT", run_dir=str(root / "run"), seed=SEED).setup()
    params = perturbed(jtr.state.params, seed=1)
    ema = perturbed(jtr.state.params, seed=2)
    jtr.state = jtr.state.replace(params=params, ema_params=ema)
    raw = walker_raw()
    ds = JaxWindowDataset(jnp.asarray(raw), past_len=5, future_len=3, stride=8)
    history = jax_distiller.progressive_distill(
        jtr, ds, target_steps=2, start_steps=4, epochs_per_phase=1, lr=LR, seed=0)
    return dict(trainer=jtr, params=params["params"], ema=ema["params"], raw=raw,
                history=history, student=jtr.state.params["params"])


def port_trainer(root, ref, **ddpm):
    cfg, _ = tiny_config(root, **ddpm)
    tr = Trainer(cfg, "DDPM-DiT", device="cpu", run_dir=str(root / "run"), seed=SEED).setup()
    tr.model.load_state_dict(state_dict_from_jax(ref["params"]))
    tr.ema_model.load_state_dict(state_dict_from_jax(ref["ema"]))
    return tr


def test_progressive_distill_matches_jax(jax_side, tmp_path):
    ref = jax_side
    tr = port_trainer(tmp_path, ref)
    ds = WindowDataset(torch.from_numpy(ref["raw"]), past_len=5, future_len=3, stride=8)
    got = distiller.progressive_distill(tr, ds, target_steps=2, start_steps=4,
                                        epochs_per_phase=1, lr=LR, seed=0,
                                        save_dir=str(tmp_path / "ckpts"),
                                        draws=_jax_distill_draws(0))
    want = ref["history"]
    assert got["phases"] == want["phases"] == [4, 2]
    for n in (4, 2):
        np.testing.assert_allclose(got["loss"][n], want["loss"][n], rtol=HISTORY_RTOL)
    sd = state_dict_from_jax(ref["student"])
    worst = max(float((module.state_dict()[name] - w).abs().max())
                for name, w in sd.items() for module in (tr.model, tr.ema_model))
    print(f"distill: student within {worst} of JAX's (bound {PARAM_SHARE * LR * STEPS})")
    assert worst <= PARAM_SHARE * LR * STEPS

    # The D002 checkpoint: the JAX package's name and metadata, and the
    # Distilled sampler's input.
    name = ckpt.checkpoint_name(tr.cfg, "DDPM-DiT", distiller.distilled_tag(2))
    assert distiller.distilled_tag(2) == jax_distiller.distilled_tag(2) == "D002"
    assert name == jax_ckpt.checkpoint_name(ref["trainer"].cfg, "DDPM-DiT", "D002")
    student = port_trainer(tmp_path / "d002", ref, SAMPLER="Distilled", DISTILL_STEPS=2,
                           DISTILL_ETA=1.0)
    meta = student.load(str(tmp_path / "ckpts" / name))
    assert meta["distilled_steps"] == 2 and meta["epoch"] == "D002"
    assert meta["distill_loss"] == pytest.approx(got["loss"][2][-1])
    for k, v in student.ema_model.state_dict().items():
        torch.testing.assert_close(v, tr.model.state_dict()[k], rtol=0, atol=0)
    out = student.sample(past_frames(9), torch.Generator().manual_seed(0))
    assert out.shape == SHAPE and torch.isfinite(out).all()


def test_trainer_distilled_sampler_matches_jax_and_refuses_guidance(jax_side, tmp_path):
    ref = jax_side
    ddpm = {"SAMPLER": "Distilled", "DISTILL_STEPS": 4, "DISTILL_ETA": 1.0}
    _, jcfg = tiny_config(tmp_path, **ddpm)
    jtr = JaxTrainer(jcfg, "DDPM-DiT", run_dir=str(tmp_path / "j"), seed=SEED)
    jtr.state = ref["trainer"].state.replace(
        params={"params": ref["params"]}, ema_params={"params": ref["ema"]})
    past, key = past_frames(10), jax.random.PRNGKey(12)
    want = np.asarray(jtr.sample(jnp.asarray(past), key))
    tr = port_trainer(tmp_path, ref, **ddpm)
    got = tr.sample(past, noise=_sample_noise(key, 4)).numpy()
    np.testing.assert_allclose(got, want, atol=CHAIN_ATOL, rtol=0)

    for bad in ({"GUIDANCE": "Sparsity"}, {"CFG_SCALE": 2.0}):
        cfg, jcfg = tiny_config(tmp_path, **ddpm, **bad)
        with pytest.raises(ValueError) as port_err:
            Trainer(cfg, "DDPM-DiT", device="cpu").setup().sample(past)
        guarded = JaxTrainer(jcfg, "DDPM-DiT", run_dir=str(tmp_path / "g"))
        guarded.state = jtr.state
        with pytest.raises(ValueError) as jax_err:
            guarded.sample(jnp.asarray(past), key)
        assert str(port_err.value) == str(jax_err.value)
        assert "Distilled sampler is guidance-free" in str(port_err.value)


def test_progressive_distill_guards(jax_side, tmp_path):
    ref = jax_side
    ds = WindowDataset(torch.from_numpy(ref["raw"]), past_len=5, future_len=3, stride=8)
    cfg, _ = tiny_config(tmp_path)
    fm = Trainer(cfg, "FM-DiT", device="cpu", seed=SEED).setup()
    with pytest.raises(ValueError, match="DDPM family"):
        distiller.progressive_distill(fm, ds, target_steps=2)
    with pytest.raises(ValueError, match="no restored state"):
        distiller.progressive_distill(Trainer(cfg, "DDPM-DiT", device="cpu"), ds,
                                      target_steps=2)
    tr = port_trainer(tmp_path, ref)
    for kw, match in (({"target_steps": 0}, "start_steps >= target_steps"),
                      ({"target_steps": 8, "start_steps": 4}, "start_steps >= target_steps"),
                      ({"target_steps": 2, "start_steps": 6}, "power of two"),
                      ({"target_steps": 8, "start_steps": 32}, "exceeds the schedule")):
        with pytest.raises(ValueError, match=match):
            distiller.progressive_distill(tr, ds, **kw)
    few = WindowDataset(torch.from_numpy(ref["raw"][:1]), past_len=5, future_len=3, stride=8)
    with pytest.raises(ValueError, match="no full batches"):
        distiller.progressive_distill(tr, few, target_steps=2, start_steps=4)
