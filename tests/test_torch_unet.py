"""Port parity: the DDPM-UNet slice — UNet3D forward (plain and with the
level-0 blocks fused), weight carry-over, two sampler chains, and the
Trainer/Predictor entry points.

The JAX package's UNet3D is the reference: its own init, perturbed with
seeded numpy noise, carried into the port by ``state_dict_from_jax``.  Both
sides run in float32 on the CPU.  The model is small (base 8 channels, two
levels, attention at level 1, an 8×12 grid) so each JAX compile stays short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from crowdmod_tpu.compat.torch_import import import_torch_checkpoint
from crowdmod_tpu.core import schedule as jax_schedule
from crowdmod_tpu.models.backbones import fused_apply as jax_fused_apply
from crowdmod_tpu.models.backbones.unet3d import UNet3D as JaxUNet3D
from crowdmod_tpu.models.diffusion import ddpm as jax_ddpm
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.core import schedule
from crowdmod_tpu_torch.models.backbones import fused_apply
from crowdmod_tpu_torch.models.backbones.unet3d import UNet3D
from crowdmod_tpu_torch.models.diffusion import ddpm
from crowdmod_tpu_torch.serving import load_predictor
from crowdmod_tpu_torch.train.trainer import Trainer

UNET = dict(out_channels=3, base_channels=8, base_channels_multiples=(1, 2),
            apply_attention=(False, True), dropout_rate=0.1)
SHAPE = (2, 3, 8, 12, 3)
PAST_SHAPE = (2, 5, 8, 12, 3)
FORWARD_ATOL = 1e-4
FUSED_RTOL = 3e-5  # of max|ref|, as tests/test_pallas_kernels.py:443-446
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
def models():
    jmodel = JaxUNet3D(**UNET)
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE), jnp.zeros((2,)), jnp.zeros(PAST_SHAPE)
    )
    params = perturbed(variables["params"], seed=1)
    tmodel = UNet3D(**UNET).eval()
    tmodel.load_state_dict(state_dict_from_jax(params))
    return jmodel, params, tmodel


def _inputs(seed):
    rng = np.random.default_rng(seed)
    future = rng.normal(size=SHAPE).astype(np.float32)
    past = rng.normal(size=PAST_SHAPE).astype(np.float32)
    return future, np.array([3, 917], np.int32), past


def _port(tmodel, future, t, past):
    with torch.no_grad():
        return tmodel(*(torch.from_numpy(a) for a in (future, t, past))).numpy()


def test_forward_matches_jax(models):
    jmodel, params, tmodel = models
    future, t, past = _inputs(2)
    want = np.asarray(jmodel.apply({"params": params}, future, t, past))
    got = _port(tmodel, future, t, past)
    assert got.shape == want.shape == SHAPE
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=0)


def test_fused_routing_matches_jax_fused_apply(models, monkeypatch):
    """With the volume gate lowered on both sides, the level-0 blocks
    (volume 8·8·12) route to the fused resblock: the port's twin against the
    JAX package's interceptor with the Pallas kernel in interpret mode."""
    jmodel, params, tmodel = models
    monkeypatch.setattr(jax_fused_apply, "MIN_FUSED_VOLUME", 512)
    monkeypatch.setattr(fused_apply, "MIN_FUSED_VOLUME", 512)
    routed = []
    real = fused_apply.fused_resblock
    monkeypatch.setattr(
        fused_apply, "fused_resblock",
        lambda x, *a, **k: routed.append(x.shape[-1]) or real(x, *a, **k),
    )
    future, t, past = _inputs(3)
    want = np.asarray(jax_fused_apply.fused_unet_apply(
        jmodel, {"params": params}, future, t, past, mode="interpret"))
    got = _port(tmodel, future, t, past)
    assert routed == [8, 24, 16]  # enc_0_0, dec_0_0, dec_0_1 (Cin)
    np.testing.assert_allclose(
        got, want, atol=FUSED_RTOL * np.abs(want).max(), rtol=0)


def test_state_dict_round_trips_through_torch_import(models, tmp_path):
    """The port's state_dict is a reference checkpoint: the JAX package's
    importer maps it back onto exactly the original flax tree."""
    _, params, tmodel = models
    assert not list(tmodel.buffers())
    path = tmp_path / "unet.pt"
    torch.save(tmodel.state_dict(), path)
    back = import_torch_checkpoint(str(path), "DDPM-UNet")["params"]
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for key, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[key]), leaf)


def _jax_noise(key, taus):
    k_init, k_loop = jax.random.split(key)
    draws = {None: jax.random.normal(k_init, SHAPE, jnp.float32)}
    for t in taus:
        draws[int(t)] = jax.random.normal(jax.random.fold_in(k_loop, t), SHAPE, jnp.float32)
    return lambda t: torch.from_numpy(np.array(draws[t]))


def _assert_chain_close(got, want):
    """Within CHAIN_ATOL, except rho values within float error of 0 that
    Sparsity pushed to the other sign: at most MAX_FLIP_SHARE of all."""
    assert np.isfinite(got).all()
    off = np.abs(got - want) > CHAIN_ATOL
    assert not off[..., 1:].any(), np.abs(got - want)[..., 1:].max()
    assert off.sum() <= MAX_FLIP_SHARE * off.size


@pytest.mark.parametrize("sampler", ["ddim_eta", "ddpm"])
def test_sampler_chain_matches_jax(models, sampler):
    jmodel, params, tmodel = models
    _, _, past = _inputs(4)
    jfn = lambda x, t, c: jmodel.apply({"params": params}, x, t, c)
    key = jax.random.PRNGKey(21)
    with torch.no_grad():
        if sampler == "ddim_eta":
            T = 50
            taus = schedule.respaced_taus(T, 3)
            want = jax_ddpm.ddim_eta_sample(
                jfn, jax_schedule.linear_schedule(T), past, key, SHAPE,
                jnp.asarray(taus), eta=1.0, guidance="Sparsity", lambda_guidance=0.6)
            got = ddpm.ddim_eta_sample(
                tmodel, schedule.linear_schedule(T), torch.from_numpy(past), SHAPE,
                taus, noise=_jax_noise(key, taus), eta=1.0, guidance="Sparsity",
                lambda_guidance=0.6)
        else:
            T = 4
            want = jax_ddpm.ddpm_sample(
                jfn, jax_schedule.linear_schedule(T), past, key, SHAPE,
                guidance="Sparsity", lambda_guidance=0.6)
            got = ddpm.ddpm_sample(
                tmodel, schedule.linear_schedule(T), torch.from_numpy(past), SHAPE,
                noise=_jax_noise(key, range(T)), guidance="Sparsity",
                lambda_guidance=0.6)
    _assert_chain_close(got.numpy(), np.asarray(want))


def test_trainer_and_predictor_build_ddpm_unet(tmp_path):
    over = {
        "MACROPROPS": {"ROWS": 8, "COLS": 12},
        "DATA_FS": {"SAVE_DIR": str(tmp_path / "ckpts")},
        "MODEL": {"DDPM": {
            "SAMPLER": "DDIM-eta", "TIMESTEPS": 50, "ETA_STEPS": 2,
            "GUIDANCE": "Sparsity", "LAMBDA_GUIDANCE": 0.6, "PRED_TYPE": "v",
            "UNET": {"BASE_CH": 8, "BASE_CH_MULT": [1, 2],
                     "APPLY_ATTENTION": [False, True],
                     "TRAIN": {"EMA_DECAY": 0.999}},
        }},
    }
    cfg = load_config("4test/ATC.yml", overrides=over)
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    trainer = Trainer(cfg, "DDPM-UNet", device="cpu", conv_impl="tapgemm")
    assert isinstance(trainer.model, UNet3D) and trainer.ema_decay == 0.999
    assert trainer.compute_dtype == torch.float32
    assert trainer.model.first.impl == "tapgemm"
    trainer.save(str(tmp_path / "ckpts"), "000")
    pred = load_predictor(str(cfg_path), "DDPM-UNet", device="cpu", batch_buckets=(1, 2))
    assert pred.input_spec == (5, 3, 8, 12, 3)
    out = pred.predict(np.zeros((2, 5, 8, 12, 3), np.float32), seed=0)
    assert out.shape == (2, 3, 8, 12, 3) and np.isfinite(out).all()
