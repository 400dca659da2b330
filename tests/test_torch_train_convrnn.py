"""Port parity: ConvRNN training, sampling and scoring against the JAX
package's ``Trainer``, and its AMSGrad against optax.

The optimizer: the JAX package's ``adam_with_plateau(amsgrad=True)`` (optax's
``scale_by_amsgrad``) and the port's on one gradient sequence whose largest
second moment comes at step 1, where ``torch.optim.Adam(amsgrad=True)``
(the maximum of the uncorrected moment) moves the parameters elsewhere.

The trainer: a ConvRNN of 4–8 channels on an 8×12 grid with 3 past and 2
future frames, the JAX init perturbed and carried over by
``state_dict_from_jax``, 4-channel walker windows; the loss draws nothing,
so both sides see the same steps.  Tolerances: per-step losses and
``evaluate`` within 1e-5 (relative), parameters as the DDPM parity runs
(``torch_train_parity``), samples within 1e-4, metric arrays as
``tests/test_torch_metrics.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.data.synthetic import synthetic_walkers
from crowdmod_tpu.data.windows import WindowDataset as JaxWindowDataset
from crowdmod_tpu.train.optim import adam_with_plateau
from crowdmod_tpu.train.optim import get_learning_rate as jax_get_learning_rate
from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.data.windows import WindowDataset
from crowdmod_tpu_torch.train import checkpoint as ckpt
from crowdmod_tpu_torch.train.optim import AMSGrad, adam, get_learning_rate
from crowdmod_tpu_torch.train.trainer import ProtocolDraws, Trainer
from test_torch_metrics import _assert_outputs_match, _moved_rows
from torch_train_parity import LOSS_RTOL, _assert_params_close

SEED = 5
BATCH = 4
P, F, H, W = 3, 2, 8, 12
SAMPLE_ATOL = 1e-4
AMSGRAD_RTOL = 1e-5  # f32 pow and division order
ARCH = "ConvRNN"



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU convolutions of these small frames run ~50× slower on many
    threads than on one (thread start-up and contention dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_amsgrad_matches_optax_where_torch_amsgrad_does_not(weight_decay):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    # A large gradient at step 1, then small ones: the bias-corrected second
    # moment peaks at step 1, the uncorrected one later.
    grads = [4.0 * rng.normal(size=64)] + [0.1 * rng.normal(size=64) for _ in range(6)]
    grads = [g.astype(np.float32) for g in grads]
    lr, betas = 1e-2, (0.9, 0.999)

    tx = adam_with_plateau(lr, betas, weight_decay, amsgrad=True)
    p, state = jnp.asarray(p0), None
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, updates)
    want = np.asarray(p)

    def run(make):
        param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make([param])
        for g in grads:
            param.grad = torch.from_numpy(g)
            opt.step()
        return param.detach().numpy()

    port = run(lambda ps: adam(ps, lr, betas, weight_decay, amsgrad=True))
    np.testing.assert_allclose(port, want, rtol=AMSGRAD_RTOL, atol=1e-7)
    torch_ams = run(lambda ps: torch.optim.Adam(ps, lr=lr, betas=betas,
                                                weight_decay=weight_decay, amsgrad=True))
    err = np.abs(torch_ams - want).max()
    assert err > 100 * AMSGRAD_RTOL * np.abs(want).max(), err
    # The state survives a state_dict round trip (checkpoints carry it).
    param = torch.nn.Parameter(torch.zeros(3))
    opt = AMSGrad([param], lr=lr)
    param.grad = torch.ones(3)
    opt.step()
    again = AMSGrad([param], lr=lr)
    again.load_state_dict(opt.state_dict())
    assert again.state[param]["step"] == 1
    torch.testing.assert_close(again.state[param]["nu_max"], opt.state[param]["nu_max"])


def convrnn_config(root, loader):
    over = {
        "DATA_FS": {"SAVE_DIR": str(root / "ckpts"), "OUTPUT_DIR": str(root / "out")},
        "MACROPROPS": {"ROWS": H, "COLS": W},
        "DATASET": {"BATCH_SIZE": BATCH, "PAST_LEN": P, "FUTURE_LEN": F},
        "MODEL": {"CONVRNN": {
            "ENC_HIDDEN_CH": [4, 6, 6, 8, 8, 8], "FORC_HIDDEN_CH": [8, 8, 8, 8, 8, 6, 4],
            "CHECKPOINTS_TO_KEEP": 0, "TRAIN": {"EPOCHS": 1}}},
    }
    return loader("4test/ATC.yml", overrides=over)


def walker_raw4(n=6):
    """(n, 10, 8, 12, 4): walkers with a σ² channel, plus seeded noise (ρ
    and σ² kept positive); 12 windows of 5 frames at stride 5, three
    batches of 4."""
    raw = synthetic_walkers(n, H, W, 10)
    rng = np.random.default_rng(3)
    raw = np.concatenate([raw, np.zeros(raw.shape[:-1] + (1,), np.float32)], -1)
    noise = rng.normal(0, 0.1, raw.shape).astype(np.float32)
    noise[..., (0, 3)] = np.abs(noise[..., (0, 3)])
    return raw + noise


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX trainer: one epoch of ``fit`` (per-step losses), then
    ``evaluate``, ``sample`` and ``generate_metrics``."""
    root = tmp_path_factory.mktemp("jax")
    jcfg = convrnn_config(root, jax_load_config)
    jtr = JaxTrainer(jcfg, ARCH, run_dir=str(root / "run"), seed=SEED).setup()
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + np.random.default_rng(1).normal(0, 0.05, np.shape(a)).astype(np.float32),
        jtr.state.params)
    jtr.state = jtr.state.replace(params=params)
    raw = walker_raw4()
    ds = JaxWindowDataset(jnp.asarray(raw), past_len=P, future_len=F, stride=5)
    past = next(ds.batches(BATCH, shuffle=False))[0]
    sample = np.array(jtr.sample(past, jax.random.PRNGKey(0)))  # the initial weights
    losses, step = [], jtr._train_step

    def recording_step(state, batch, key):
        state, loss = step(state, batch, key)
        losses.append(float(loss))
        return state, loss

    jtr._train_step = recording_step
    history = jtr.fit(ds, epochs=1)
    return dict(cfg=jcfg, trainer=jtr, params=params["params"], raw=raw, ds=ds,
                losses=losses, history=history, trained=jtr.state.params["params"],
                lr=jax_get_learning_rate(jtr.state.opt_state), val=jtr.evaluate(ds),
                past=np.array(past), sample=sample)


def port_trainer(root, params):
    cfg = convrnn_config(root, load_config)
    tr = Trainer(cfg, ARCH, device="cpu", run_dir=str(root / "port_run"), seed=SEED).setup()
    tr.model.load_state_dict(state_dict_from_jax(params))
    return tr


def test_fit_and_evaluate_match_jax(jax_side, tmp_path):
    ref = jax_side
    tr = port_trainer(tmp_path, ref["params"])
    assert tr.mprops_count == 4 and tr.ema_model is None and tr.sched is None
    assert isinstance(tr.state.optimizer, AMSGrad)
    ds = WindowDataset(torch.from_numpy(ref["raw"]), past_len=P, future_len=F, stride=5)
    losses, step = [], tr._train_step

    def recording_step(batch, draws):
        loss = step(batch, draws)
        losses.append(float(loss))
        return loss

    tr._train_step = recording_step
    history = tr.fit(ds, epochs=1)
    assert len(losses) == 3
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(history["train_loss"], ref["history"]["train_loss"],
                               rtol=LOSS_RTOL)
    _assert_params_close(tr.params, ref["trained"], tr.plateau.lr, 3, "params")
    assert tr.state.step == 3
    assert get_learning_rate(tr.state.optimizer) == ref["lr"]
    np.testing.assert_allclose(tr.evaluate(ds), ref["val"], rtol=LOSS_RTOL)
    # The best-loss checkpoint under the JAX package's name ('GRU' tag).
    name = ckpt.checkpoint_name(tr.cfg, ARCH, "000")
    assert "GRU" in name and (tmp_path / "ckpts" / name).is_dir()


def test_sample_is_the_rollout_with_exp_channels(jax_side, tmp_path):
    ref = jax_side
    tr = port_trainer(tmp_path, ref["params"])
    past = torch.from_numpy(ref["past"])
    got = tr.sample(past).numpy()
    assert got.shape == (BATCH, F, H, W, 4)
    np.testing.assert_allclose(got, ref["sample"], atol=SAMPLE_ATOL, rtol=0)
    with torch.no_grad():
        raw = tr.model(past, future_len=F).numpy()
    np.testing.assert_array_equal(got[..., 1:3], raw[..., 1:3])
    np.testing.assert_allclose(got[..., (0, 3)], np.exp(raw[..., (0, 3)]), rtol=1e-6)
    assert (got[..., (0, 3)] > 0).all()


def test_generate_metrics_matches_jax(jax_side, tmp_path):
    """``generate_metrics`` on the same windows with the JAX permutation
    injected: the ConvRNN's 4-channel samples scored on channels 0–2, the
    same arrays and files."""
    ref = jax_side
    chunk, seed = 2, 42
    jtr = ref["trainer"]
    jtr.state = jtr.state.replace(params={"params": ref["params"]})
    want = jtr.generate_metrics(ref["ds"], chunk=chunk, seed=seed,
                                output_dir=str(tmp_path / "jax"))

    tr = port_trainer(tmp_path, ref["params"])
    ds = WindowDataset(torch.from_numpy(ref["raw"]), past_len=P, future_len=F, stride=5)
    nsamples = BATCH * chunk
    _, ksel, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    perm = torch.from_numpy(np.array(jax.random.permutation(ksel, min(len(ds), nsamples))))
    samples, selected = [], []
    sample = tr.sample
    tr.sample = lambda *a, **kw: samples.append(sample(*a, **kw)) or samples[-1]
    tr.select_past = lambda *a, **kw: selected.append(Trainer.select_past(*a, **kw)) \
        or selected[-1]
    got = tr.generate_metrics(ds, chunk=chunk, seed=seed, output_dir=str(tmp_path / "port"),
                              draws=lambda: ProtocolDraws(perm=perm))
    pred = samples[0].numpy()[..., :3]
    gt = selected[0][1][..., :3].numpy()
    assert samples[0].shape == (nsamples, F, H, W, 4)
    _assert_outputs_match(got, want, tmp_path / "port", tmp_path / "jax",
                          "ConvRNN generate_metrics", pred, gt, chunk, _moved_rows(pred)[0])
