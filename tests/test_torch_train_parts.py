"""Port parity: the parts of the training slice below the trainer.

``window_indices``/``WindowDataset``, ``q_sample``, ``ddpm_loss``,
``drop_condition``, Adam and the plateau state machine, the EMA update and
``RunTracker`` against the JAX package's, with the JAX draws injected; and
the port's own contracts: dropout draws only from an explicit generator,
and ``TPU.REMAT`` (per-block ``torch.utils.checkpoint``) leaves the
gradients as they were, dropout masks included.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crowdmod_tpu.core import schedule as jax_schedule
from crowdmod_tpu.data.windows import WindowDataset as JaxWindowDataset
from crowdmod_tpu.data.windows import window_indices as jax_window_indices
from crowdmod_tpu.models.diffusion import ddpm as jax_ddpm
from crowdmod_tpu.models.guidance import drop_condition as jax_drop_condition
from crowdmod_tpu.train import optim as jax_optim
from crowdmod_tpu.train.state import TrainState as JaxTrainState
from crowdmod_tpu.utils.tracker import RunTracker as JaxRunTracker
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.core.schedule import linear_schedule, q_sample
from crowdmod_tpu_torch.data.windows import WindowDataset, window_indices
from crowdmod_tpu_torch.models import factory
from crowdmod_tpu_torch.models.backbones.dit import DiT4DFactorized
from crowdmod_tpu_torch.models.backbones.unet3d import UNet3D
from crowdmod_tpu_torch.models.diffusion import ddpm_loss
from crowdmod_tpu_torch.models.guidance import drop_condition
from crowdmod_tpu_torch.train import optim
from crowdmod_tpu_torch.train.state import TrainState, ema_decay_at, train_step
from crowdmod_tpu_torch.utils.tracker import RunTracker

SHAPE = (4, 3, 8, 12, 3)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("args", [(3, 16, 8, 8), (2, 70, 8, 3), (1, 8, 8, 1)])
def test_window_indices_match_jax(args):
    np.testing.assert_array_equal(window_indices(*args), jax_window_indices(*args))


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (False, False)])
def test_window_batches_match_jax(shuffle, drop_last):
    raw = _normal(0, (3, 20, 4, 6, 3))
    mine = WindowDataset(torch.from_numpy(raw), past_len=5, future_len=3, stride=4)
    ref = JaxWindowDataset(jnp.asarray(raw), past_len=5, future_len=3, stride=4)
    assert len(mine) == len(ref) == 12
    got = list(mine.batches(5, shuffle=shuffle, drop_last=drop_last, seed=7))
    want = list(ref.batches(5, shuffle=shuffle, drop_last=drop_last, seed=7))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for (p, f), (jp, jf) in zip(got, want):
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


def test_q_sample_matches_jax():
    x0 = _normal(1, SHAPE)
    t = np.array([0, 17, 499, 999], np.int32)
    key = jax.random.PRNGKey(2)
    want, eps = jax_schedule.q_sample(jax_schedule.linear_schedule(1000, 0.5),
                                      jnp.asarray(x0), jnp.asarray(t), key)
    got, eps_out = q_sample(linear_schedule(1000, 0.5), _t(x0), _t(t).long(), _t(eps))
    assert torch.equal(eps_out, _t(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="generator"):
        q_sample(linear_schedule(10), _t(x0), _t(t % 10).long())


@pytest.mark.parametrize("pred_type", ["eps", "v", "x0"])
def test_ddpm_loss_matches_jax_with_its_draws(pred_type):
    """The JAX loss's t and ε (kt, kq = split(key)) injected into the
    port's, with a denoiser that reads x, t and the past."""
    future, past = _normal(3, SHAPE), _normal(4, (4, 5, 8, 12, 3))
    T, key = 50, jax.random.PRNGKey(5)

    def denoise(x, t, c):
        return 0.5 * x + 0.01 * t.reshape(-1, 1, 1, 1, 1) + c[:, :3]

    want = jax_ddpm.ddpm_loss(denoise, jax_schedule.linear_schedule(T), jnp.asarray(future),
                              jnp.asarray(past), key, pred_type=pred_type)
    kt, kq = jax.random.split(key)
    t = jax.random.randint(kt, (4,), 0, T)
    eps = jax.random.normal(kq, SHAPE, jnp.float32)
    got = ddpm_loss(denoise, linear_schedule(T), _t(future), _t(past), t=_t(t).long(),
                    eps=_t(eps), pred_type=pred_type)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_ddpm_loss_draws_from_its_generator_only():
    sched, future = linear_schedule(20), _t(_normal(6, SHAPE))
    seen = []
    fn = lambda x, t, c: seen.append(t) or x  # noqa: E731
    loss = lambda seed: ddpm_loss(fn, sched, future, None,  # noqa: E731
                                  generator=torch.Generator().manual_seed(seed))
    assert float(loss(1)) == float(loss(1)) != float(loss(2))
    assert seen[0].shape == (4,) and int(seen[0].max()) < 20
    with pytest.raises(ValueError, match="generator"):
        ddpm_loss(fn, sched, future, None)


def test_drop_condition_matches_jax():
    past = _normal(7, (6, 5, 8, 12, 3))
    key = jax.random.PRNGKey(8)
    want = jax_drop_condition(jnp.asarray(past), key, 0.5)
    keep = jax.random.bernoulli(key, 0.5, (6,))
    got = drop_condition(_t(past), 0.5, keep=_t(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(np.asarray(keep).sum()) < 6
    x = _t(past)
    assert drop_condition(x, 0.0) is x
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        drop_condition(x, 1.0, keep=_t(keep))


def test_adam_matches_optax_chain():
    """torch Adam with L2-coupled decay = the JAX package's optax chain,
    bias correction and eps placement included; the LR set between steps
    reaches both."""
    shapes = {"w": (5, 7), "b": (7,)}
    params = {k: _normal(i, s) for i, (k, s) in enumerate(shapes.items())}
    tx = jax_optim.adam_with_plateau(1e-2, (0.5, 0.999), 3e-3)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = optim.adam(tp.values(), 1e-2, (0.5, 0.999), 3e-3)
    for step in range(4):
        grads = {k: _normal(10 + step * 2 + i, s) for i, (k, s) in enumerate(shapes.items())}
        if step == 2:
            st = jax_optim.set_learning_rate(st, 5e-3)
            optim.set_learning_rate(opt, 5e-3)
        updates, st = tx.update(jax.tree.map(jnp.asarray, grads), st, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = _t(grads[k])
        opt.step()
    assert optim.get_learning_rate(opt) == 5e-3
    assert jax_optim.get_learning_rate(st) == pytest.approx(5e-3, rel=1e-7)  # f32 there
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)


def test_plateau_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.9, 0.91, 0.9, 0.89, 0.8999, 0.7, 0.71, 0.72, 0.73]
    mine = optim.PlateauState(lr=1e-3, factor=0.5, patience=2, min_lr=3e-4)
    ref = jax_optim.PlateauState(lr=1e-3, factor=0.5, patience=2, min_lr=3e-4)
    for loss in losses:
        mine, ref = mine.step(loss), ref.step(loss)
        assert tuple(mine) == tuple(ref)
    assert mine.lr == 3e-4  # halved twice, floored


def test_ema_update_math():
    """ema = d·ema + (1 − d)·params with d = min(decay, (1 + t)/(10 + t)),
    t the step before its increment (the JAX package's test, ported)."""
    model = torch.nn.Linear(4, 1, bias=False)
    torch.nn.init.ones_(model.weight)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.5), ema_decay=0.75)
    loss = lambda batch: (model.weight * batch).sum()  # noqa: E731
    train_step(state, loss, torch.full((4,), 2.0))  # grad 2: w = 1 - 0.5·2 = 0
    torch.testing.assert_close(model.weight, torch.zeros(1, 4), rtol=0, atol=1e-7)
    torch.testing.assert_close(state.ema_model.weight, torch.full((1, 4), 0.1),
                               rtol=0, atol=1e-6)  # d = min(0.75, 1/10)
    ema = 0.1
    for t in range(1, 40):
        train_step(state, loss, torch.zeros(4))
        ema *= min(0.75, (1.0 + t) / (10.0 + t))
        assert ema_decay_at(0.75, t) == pytest.approx(min(0.75, (1.0 + t) / (10.0 + t)))
    assert state.step == 40
    np.testing.assert_allclose(state.ema_model.weight.detach().numpy(), ema, rtol=1e-5)
    assert not any(p.requires_grad for p in state.ema_model.parameters())
    assert TrainState(model, torch.optim.SGD(model.parameters(), lr=0.5)).ema_model is None


def test_ema_matches_jax_train_state():
    """Three EMA steps of the port against the JAX TrainState's, f32."""
    w0, grads = _normal(20, (6,)), [_normal(21 + i, (6,)) for i in range(3)]
    jstate = JaxTrainState.create({"w": jnp.asarray(w0)}, optax.sgd(0.1), ema_decay=0.999)
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(_t(w0))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1), ema_decay=0.999)
    for g in grads:
        jstate = jstate.apply_gradients({"w": jnp.asarray(g)})
        model.w.grad = _t(g)
        state.apply_gradients()
    np.testing.assert_allclose(state.ema_model.w.detach().numpy(),
                               np.asarray(jstate.ema_params["w"]), rtol=0, atol=1e-7)


def test_tracker_writes_the_jax_records(tmp_path):
    cfg = load_config("4test/ATC.yml")
    with RunTracker(tmp_path / "port", config=cfg) as mine:
        mine.log({"train_loss": np.float32(0.5), "lr": 1e-4}, step=1)
        mine.log({"val_loss": 0.25})
    ref = JaxRunTracker(tmp_path / "jax", config=cfg, use_wandb=False)
    ref.log({"train_loss": np.float32(0.5), "lr": 1e-4}, step=1)
    ref.log({"val_loss": 0.25})
    ref.finish()
    read = lambda d: [{k: v for k, v in json.loads(ln).items() if k != "time"}  # noqa: E731
                      for ln in (tmp_path / d / "events.jsonl").read_text().splitlines()]
    assert read("port") == read("jax") and len(read("port")) == 2
    assert (json.loads((tmp_path / "port" / "config.json").read_text())
            == json.loads((tmp_path / "jax" / "config.json").read_text()))


def _models(remat):
    cfg = load_config("4test/ATC.yml", overrides={
        "MACROPROPS": {"ROWS": 8, "COLS": 12}, "TPU": {"REMAT": remat},
        "MODEL": {"DDPM": {
            "UNET": {"BASE_CH": 8, "BASE_CH_MULT": [1, 2],
                     "APPLY_ATTENTION": [False, True], "DROPOUT_RATE": 0.3},
            "DIT": {"HIDDEN_SIZE": 32, "DEPTH": 2, "NUM_HEADS": 2, "DROPOUT_RATE": 0.3}}}})
    out = {}
    for arch in ("DDPM-UNet", "DDPM-DiT"):
        m = factory.build_backbone(cfg, arch)
        m.reset_parameters(torch.Generator().manual_seed(0))
        with torch.no_grad():  # AdaLN-Zero would zero most DiT gradients
            for p in m.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        out[arch] = m.train()
    return out


@pytest.mark.parametrize("arch", ["DDPM-UNet", "DDPM-DiT"])
def test_remat_keeps_the_gradients_with_dropout_on(arch):
    """Per-block checkpointing recomputes each block in the backward; the
    dropout masks are drawn before the block and passed in, so the
    recompute applies the same ones and the gradients agree."""
    future, past = _t(_normal(30, (2, 3, 8, 12, 3))), _t(_normal(31, (2, 5, 8, 12, 3)))
    t = torch.tensor([3, 700])
    grads = {}
    for remat in (False, True):
        model = _models(remat)[arch]
        assert model.remat is remat
        out = model(future, t, past, generator=torch.Generator().manual_seed(9))
        out.square().mean().backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=0, atol=1e-6, msg=name)
    assert max(float(g.abs().max()) for g in grads[False].values()) > 1e-3


@pytest.mark.parametrize("cls", [UNet3D, DiT4DFactorized])
def test_dropout_draws_from_the_generator_it_is_given(cls):
    """Same seed, same masks; another seed, others; training with dropout
    and no generator raises; eval mode draws nothing."""
    kw = (dict(base_channels=8, base_channels_multiples=(1, 2), apply_attention=(False, True))
          if cls is UNet3D else
          dict(grid_rows=8, grid_cols=12, hidden_size=32, depth=1, num_heads=2))
    model = cls(dropout_rate=0.5, **kw).train()
    future, past = _t(_normal(32, (2, 3, 8, 12, 3))), _t(_normal(33, (2, 5, 8, 12, 3)))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02)
        run = lambda seed: model(future, torch.tensor([1, 2]), past,  # noqa: E731
                                 generator=torch.Generator().manual_seed(seed))
        assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
        with pytest.raises(ValueError, match="generator"):
            model(future, torch.tensor([1, 2]), past)
        model.eval()
        assert torch.equal(model(future, torch.tensor([1, 2]), past), run(3))
