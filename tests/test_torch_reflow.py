"""Port parity: ReFlow's coupling, its loss and one round of ``reflow``
against the JAX package's, and ``reflow``'s guards.

The JAX key stream crosses as data: ``reflow``'s ``key, sub = split(key)``
before each coupling batch (x0 from ``split(sub)[0]``) and each training
step (t from ``uniform(sub)``) is replayed by the ``draws`` callable the
port's ``reflow`` takes.  The model is the tiny FM-DiT of
``torch_train_parity`` (DiT2D, depth 2, hidden 64) with the same perturbed
weights on both sides, in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.data.windows import WindowDataset as JaxWindowDataset
from crowdmod_tpu.models.flow_matching import reflow as jax_reflow
from crowdmod_tpu.train import checkpoint as jax_ckpt
from crowdmod_tpu.train import distiller as jax_distiller
from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.data.windows import WindowDataset
from crowdmod_tpu_torch.models.flow_matching import reflow as port_reflow
from crowdmod_tpu_torch.train import checkpoint as ckpt
from crowdmod_tpu_torch.train import distiller
from crowdmod_tpu_torch.train.trainer import Trainer
from torch_train_parity import BATCH, LOSS_RTOL, SEED, perturbed, tiny_config, walker_raw

ARCH = "FM-DiT"
FSHAPE = (BATCH, 3, 8, 12, 3)
COUPLING_ATOL = 1e-5  # 4 Euler steps of the f32 DiT2D
LR = 1e-3
STEPS = 6  # 2 epochs of 3 batches
# Parameters after the round, each within this share of the Adam steps'
# reach LR·STEPS: the residuals the gradients come from are small (see
# below), so their f32 rounding moves later Adam updates by ~0.2% of LR (a
# wrong draw or pairing moves them by the whole LR).
PARAM_SHARE = 1e-2
# The round's epoch losses are means of squared residuals (x1 - x0) - u of
# ~2e-2 between terms of ~1e-1, after Adam steps whose parameters differ in
# the last bits: f32 rounding shows at ~1e-5 of the loss.
ROUND_LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax")
    _, jcfg = tiny_config(root)
    jtr = JaxTrainer(jcfg, ARCH, run_dir=str(root / "run"), seed=SEED).setup()
    params = perturbed(jtr.state.params, seed=1)
    jtr.state = jtr.state.replace(params=params,
                                  ema_params=jax.tree.map(jnp.asarray, params))
    raw = walker_raw()
    ds = JaxWindowDataset(jnp.asarray(raw), past_len=5, future_len=3, stride=8)
    return jtr, params["params"], raw, ds


def port_trainer(root, params, **fm):
    cfg, _ = tiny_config(root)
    if fm:
        cfg = cfg.updated({"MODEL": {"FM": fm}})
    tr = Trainer(cfg, ARCH, device="cpu", run_dir=str(root / "port_run"), seed=SEED).setup()
    sd = state_dict_from_jax(params)
    tr.model.load_state_dict(sd)
    tr.ema_model.load_state_dict(sd)
    return tr


def jax_draws(seed):
    """The JAX ``reflow`` key stream as the port's ``draws(kind, shape)``."""
    key = [jax.random.PRNGKey(seed)]

    def draws(kind, shape):
        key[0], sub = jax.random.split(key[0])
        if kind == "x0":
            arr = jax.random.normal(jax.random.split(sub)[0], shape, jnp.float32)
        else:
            arr = jax.random.uniform(sub, shape)
        return torch.from_numpy(np.array(arr))

    return draws


def test_coupling_and_loss_match_jax(jax_side, tmp_path):
    jtr, params, raw, _ = jax_side
    tr = port_trainer(tmp_path, params)
    jfn = lambda x, t, c: jtr.model.apply({"params": params}, x, t, c)  # noqa: E731
    ds = WindowDataset(torch.from_numpy(raw), past_len=5, future_len=3, stride=8)
    past = next(ds.batches(BATCH, shuffle=False))[0]
    key = jax.random.PRNGKey(3)
    jx0, jx1 = jax_reflow.generate_coupling(jfn, jnp.asarray(past.numpy()), key, FSHAPE,
                                            steps=4, time_max_pos=1000)
    x0 = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[0], FSHAPE)))
    x0_p, x1_p = port_reflow.generate_coupling(tr.model.eval(), past, FSHAPE, steps=4,
                                               time_max_pos=1000, x0=x0)
    np.testing.assert_array_equal(x0_p.numpy(), np.asarray(jx0))
    assert np.abs(np.asarray(jx1) - np.asarray(jx0)).max() > 1e-2
    np.testing.assert_allclose(x1_p.numpy(), np.asarray(jx1), atol=COUPLING_ATOL, rtol=0)

    lkey = jax.random.PRNGKey(4)
    want = float(jax_reflow.reflow_loss(jfn, jx0, jx1, jnp.asarray(past.numpy()), lkey))
    t = torch.from_numpy(np.array(jax.random.uniform(lkey, (BATCH,))))
    with torch.no_grad():
        got = float(port_reflow.reflow_loss(tr.model, x0_p, x1_p, past, t=t))
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    with pytest.raises(ValueError, match="generator"):
        port_reflow.reflow_loss(tr.model, x0_p, x1_p, past)
    with pytest.raises(ValueError, match="generator"):
        port_reflow.generate_coupling(tr.model, past, FSHAPE)


def test_one_round_matches_jax(jax_side, tmp_path):
    jtr, params, raw, ds = jax_side
    kw = dict(rounds=1, coupling_steps=4, epochs_per_round=2, lr=LR, seed=0)
    want = jax_distiller.reflow(jtr, ds, **kw)
    tr = port_trainer(tmp_path, params)
    pds = WindowDataset(torch.from_numpy(raw), past_len=5, future_len=3, stride=8)
    got = distiller.reflow(tr, pds, save_dir=str(tmp_path / "ckpts"), draws=jax_draws(0),
                           **kw)
    assert got["rounds"] == want["rounds"] == [1]
    np.testing.assert_allclose(got["loss"][1], want["loss"][1], rtol=ROUND_LOSS_RTOL)
    sd = state_dict_from_jax(jtr.state.params["params"])
    worst = 0.0
    for name, w in sd.items():
        for module in (tr.model, tr.ema_model):
            worst = max(worst, float((module.state_dict()[name] - w).abs().max()))
    print(f"reflow: parameters within {worst} of JAX's (bound {PARAM_SHARE * LR * STEPS})")
    assert worst <= PARAM_SHARE * LR * STEPS
    # The RF1 checkpoint, under the JAX package's name, samples in the port.
    name = ckpt.checkpoint_name(tr.cfg, ARCH, distiller.reflow_tag(1))
    assert name == jax_ckpt.checkpoint_name(jtr.cfg, ARCH, jax_distiller.reflow_tag(1))
    student = port_trainer(tmp_path / "rf1", params)
    meta = student.load(str(tmp_path / "ckpts" / name))
    assert (meta["reflow_round"], meta["coupling_steps"]) == (1, 4)
    for k, v in student.model.state_dict().items():
        torch.testing.assert_close(v, tr.model.state_dict()[k], rtol=0, atol=0)


def test_guards(jax_side, tmp_path):
    _, params, raw, _ = jax_side
    ds = WindowDataset(torch.from_numpy(raw), past_len=5, future_len=3, stride=8)
    cfg, _ = tiny_config(tmp_path)
    ddpm = Trainer(cfg, "DDPM-DiT", device="cpu", seed=SEED).setup()
    with pytest.raises(ValueError, match="FM family"):
        distiller.reflow(ddpm, ds)
    with pytest.raises(ValueError, match="no restored state"):
        distiller.reflow(Trainer(cfg, ARCH, device="cpu", seed=SEED), ds)
    tr = port_trainer(tmp_path, params)
    with pytest.raises(ValueError, match="rounds must be"):
        distiller.reflow(tr, ds, rounds=0)
    few = WindowDataset(torch.from_numpy(raw[:1]), past_len=5, future_len=3, stride=8)
    with pytest.raises(ValueError, match="no full batches"):
        distiller.reflow(tr, few)
    with pytest.raises(ValueError, match="CFG_SCALE"):
        distiller.reflow(port_trainer(tmp_path / "cfg", params, CFG_SCALE=2.0), ds)
