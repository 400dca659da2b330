"""Shared by ``test_torch_train_{unet,dit,fm}.py``: the JAX package's
``Trainer.fit`` on a tiny config, and the port's, held against it.

Both trainers start from the same weights (the JAX init, perturbed with
seeded numpy noise, carried over by ``state_dict_from_jax``), train on the
same numpy walker windows in float32 on the CPU, and see the same draws:
the port's steps get the t, ε (DDPM) or x0 (FM) and CFG keep mask that JAX
``fit``'s key stream gives (``key, sub = split(key)`` a batch; ``_loss_fn``
splits ``sub`` into 2, or 3 with CFG; ``ddpm_loss`` splits again into kt,
kq, ``fm_loss`` into k0, kt).
Dropout is off (``DROPOUT_RATE`` 0): flax's dropout bits cannot be made in
PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.data.synthetic import synthetic_walkers
from crowdmod_tpu.data.windows import WindowDataset as JaxWindowDataset
from crowdmod_tpu.train.optim import get_learning_rate as jax_get_learning_rate
from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.data.windows import WindowDataset
from crowdmod_tpu_torch.train.optim import get_learning_rate
from crowdmod_tpu_torch.train.trainer import StepDraws, Trainer

SEED = 5
BATCH = 4
TIMESTEPS = 50
# Step 1's gradients: within GRAD_RTOL of the model's max|g|, and of the
# tensor's own max|g| where that is at least OWN_SCALE of the model's (the
# gradient of a per-channel shift ahead of a GroupNorm of one-channel groups
# is 0 up to float noise).
GRAD_RTOL = 1e-4
OWN_SCALE = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6  # params and EMA after 3 steps
# Adam's first step is sign-like where a gradient is within float noise of
# 0: at most this share of the elements may differ, each by at most
# 2·lr·steps.
MAX_SIGN_SHARE = 1e-4


def tiny_config(root, cfg_drop=0.0, **ddpm):
    backbones = {
        "UNET": {"BASE_CH": 8, "BASE_CH_MULT": [1, 2],
                 "APPLY_ATTENTION": [False, True], "DROPOUT_RATE": 0.0,
                 "TRAIN": {"EPOCHS": 1, "EMA_DECAY": 0.9}},
        "DIT": {"HIDDEN_SIZE": 64, "DEPTH": 2, "NUM_HEADS": 4,
                "DROPOUT_RATE": 0.0, "TRAIN": {"EPOCHS": 1, "EMA_DECAY": 0.9}},
    }
    over = {
        "DATA_FS": {"SAVE_DIR": str(root / "ckpts"), "OUTPUT_DIR": str(root / "out")},
        "MACROPROPS": {"ROWS": 8, "COLS": 12},
        "DATASET": {"BATCH_SIZE": BATCH},
        "MODEL": {
            "DDPM": {"TIMESTEPS": TIMESTEPS, "CHECKPOINTS_TO_KEEP": 0, "PRED_TYPE": "v",
                     "CFG_DROP_PROB": cfg_drop, **backbones, **ddpm},
            "FM": {"CHECKPOINTS_TO_KEEP": 0, "CFG_DROP_PROB": cfg_drop, **backbones},
        },
    }
    return load_config("4test/ATC.yml", overrides=over), jax_load_config(
        "4test/ATC.yml", overrides=over)


def perturbed(tree, seed, std=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0.0, std, np.shape(a)).astype(np.float32),
        tree,
    )


def walker_raw(n=6):
    """(n, 16, 8, 12, 3) walkers plus seeded noise, so rows differ: 12
    windows of 8 frames at stride 8, three batches of 4."""
    raw = synthetic_walkers(n, 8, 12, 16)
    return raw + np.random.default_rng(3).normal(0, 0.1, raw.shape).astype(np.float32)


def loss_draws(key, future_shape, cfg_drop=0.0, family="DDPM") -> StepDraws:
    """The draws of one JAX ``_loss_fn`` call on ``key``, as port tensors."""
    b = future_shape[0]
    keep = None
    if cfg_drop > 0.0:
        _, drop_key, step_key = jax.random.split(key, 3)
        keep = torch.from_numpy(np.array(
            jax.random.bernoulli(drop_key, 1.0 - cfg_drop, (b,))))
    else:
        _, step_key = jax.random.split(key)
    if family == "FM":
        k0, kt = jax.random.split(step_key)
        x0 = jax.random.normal(k0, future_shape, jnp.float32)
        t = jax.random.uniform(kt, (b,))
        return StepDraws(t=torch.from_numpy(np.array(t)),
                         x0=torch.from_numpy(np.array(x0)), keep=keep)
    kt, kq = jax.random.split(step_key)
    t = jax.random.randint(kt, (b,), 0, TIMESTEPS)
    eps = jax.random.normal(kq, future_shape, jnp.float32)
    return StepDraws(t=torch.from_numpy(np.array(t)).long(),
                     eps=torch.from_numpy(np.array(eps)), keep=keep)


def key_stream(seed, n, future_shape, cfg_drop=0.0, family="DDPM") -> list[StepDraws]:
    """The draws of n steps of a JAX ``fit`` (or, seed 0 without CFG, of
    ``evaluate``'s batches)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(loss_draws(sub, future_shape, cfg_drop, family))
    return out


def jax_reference(arch, root, cfg_drop=0.0) -> dict:
    """JAX side: step-1 gradients, one epoch of ``fit`` (per-step losses),
    then ``evaluate``."""
    _, jcfg = tiny_config(root, cfg_drop)
    jtr = JaxTrainer(jcfg, arch, run_dir=str(root / "jax_run"), seed=SEED).setup()
    params = perturbed(jtr.state.params, seed=1)
    jtr.state = jtr.state.replace(params=params,
                                  ema_params=jax.tree.map(jnp.asarray, params))
    raw = walker_raw()
    ds = JaxWindowDataset(jnp.asarray(raw), past_len=5, future_len=3, stride=8)
    first = next(ds.batches(BATCH, shuffle=True, seed=SEED + 1))
    _, sub = jax.random.split(jax.random.PRNGKey(SEED))
    grads = jax.grad(jtr._loss_fn())(jtr.state.params, first, sub)
    losses, step = [], jtr._train_step

    def recording_step(state, batch, key):
        state, loss = step(state, batch, key)
        losses.append(float(loss))
        return state, loss

    jtr._train_step = recording_step
    history = jtr.fit(ds, epochs=1)
    st = jtr.state
    return dict(
        arch=arch, cfg_drop=cfg_drop, raw=raw, params=params["params"],
        grads=grads["params"], losses=losses, history=history,
        trained=st.params["params"], ema=st.ema_params["params"], step=int(st.step),
        lr=jax_get_learning_rate(st.opt_state), plateau=jtr.plateau,
        val=jtr.evaluate(ds), n_val=len(ds) // BATCH,
    )


def _assert_params_close(got: dict, want_tree, lr, steps, label):
    want = state_dict_from_jax(want_tree)
    assert set(got) == set(want), label
    off = total = 0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        total += diff.numel()
        off += int((diff > PARAM_ATOL).sum())
        assert diff.max() <= 2 * lr * steps, (label, name, float(diff.max()))
    print(f"{label}: {off} of {total} elements beyond {PARAM_ATOL}")
    assert off <= MAX_SIGN_SHARE * total, (label, off, total)


def check_port_against(ref, root, conv_impl="im2col"):
    """Port side, from the same weights and draws; asserts each tolerance."""
    arch = ref["arch"]
    family = arch.split("-")[0]
    cfg, _ = tiny_config(root, ref["cfg_drop"])
    tr = Trainer(cfg, arch, device="cpu", run_dir=str(root / "port_run"), seed=SEED,
                 conv_impl=conv_impl).setup()
    sd = state_dict_from_jax(ref["params"])
    tr.model.load_state_dict(sd)
    tr.ema_model.load_state_dict(sd)
    ds = WindowDataset(torch.from_numpy(ref["raw"]), past_len=5, future_len=3, stride=8)
    fshape = (BATCH, 3, 8, 12, 3)
    draws = key_stream(SEED, len(ds) // BATCH, fshape, ref["cfg_drop"], family)

    # Step 1's gradient of every parameter.
    first = next(ds.batches(BATCH, shuffle=True, seed=SEED + 1))
    tr._loss_fn()(first, draws[0]).backward()
    want = state_dict_from_jax(ref["grads"])
    g_max = max(float(w.abs().max()) for w in want.values())
    for name, p in tr.model.named_parameters():
        assert p.grad is not None, f"{name} got no gradient"
        own = float(want[name].abs().max())
        err = float((p.grad - want[name]).abs().max())
        scale = own if own >= OWN_SCALE * g_max else g_max
        assert err <= GRAD_RTOL * scale, (name, err, own, g_max)
    tr.model.zero_grad(set_to_none=True)

    # One epoch of fit with JAX's draws.
    losses, step, it = [], tr._train_step, iter(draws)

    def recording_step(batch, d):
        loss = step(batch, d)
        losses.append(float(loss))
        return loss

    tr._train_step = recording_step
    history = tr.fit(ds, epochs=1, draws=lambda: next(it))
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(history["train_loss"], ref["history"]["train_loss"],
                               rtol=LOSS_RTOL)
    steps, lr = len(losses), tr.plateau.lr
    _assert_params_close(tr.params, ref["trained"], lr, steps, "params")
    _assert_params_close(tr.ema_params, ref["ema"], lr, steps, "ema")
    assert tr.state.step == ref["step"] == steps
    assert get_learning_rate(tr.state.optimizer) == ref["lr"] == history["lr"][-1]
    jp = ref["plateau"]
    assert (tr.plateau.lr, tr.plateau.num_bad) == (jp.lr, jp.num_bad)
    np.testing.assert_allclose(tr.plateau.best, jp.best, rtol=LOSS_RTOL)

    val = tr.evaluate(ds, draws=iter(key_stream(0, ref["n_val"], fshape,
                                                family=family)).__next__)
    np.testing.assert_allclose(val, ref["val"], rtol=LOSS_RTOL)
