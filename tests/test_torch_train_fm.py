"""Port parity: flow-matching training through ``Trainer.fit`` against the
JAX package's (``torch_train_parity`` says how), with FM's draws (x0 and
the uniform t) injected from the JAX key stream.

FM-DiT is DiT2D at depth 2, hidden 64, 4 heads, on an 8×12 grid (48
tokens; with dropout off its attention runs through the kernel wrapper's
autograd Function); FM-UNet is the base-8 two-level UNet, trained with
condition dropout 0.5 (the CFG keep mask from the JAX stream).
"""

import pytest

from torch_train_parity import check_port_against, jax_reference


@pytest.mark.parametrize("arch,cfg_drop", [("FM-DiT", 0.0), ("FM-UNet", 0.5)])
def test_fit_matches_jax(arch, cfg_drop, tmp_path):
    check_port_against(jax_reference(arch, tmp_path / "jax", cfg_drop=cfg_drop), tmp_path)


@pytest.mark.parametrize("arch,integrator,scale",
                         [("FM-DiT", "Heun", 2.0), ("FM-UNet", "Euler", 1.0)])
def test_sample_matches_jax(arch, integrator, scale, tmp_path):
    """``Trainer.sample`` takes ``INTEGRATORS[MODEL.FM.INTEGRATOR]`` at its
    ``INTEGRATOR_STEPS``, with CFG at ``MODEL.FM.CFG_SCALE`` and no eps
    adapter: the JAX trainer's chain on the same x0 and weights (the EMA
    module, as the JAX trainer samples its EMA params)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from crowdmod_tpu.train.trainer import Trainer as JaxTrainer
    from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
    from crowdmod_tpu_torch.train.trainer import Trainer
    from torch_train_parity import SEED, perturbed, tiny_config

    fm = {"MODEL": {"FM": {"INTEGRATOR": integrator, "CFG_SCALE": scale,
                           "INTEGRATOR_STEPS": {"EULER": 6, "HEUN": 3}}}}
    cfg, jcfg = (c.updated(fm) for c in tiny_config(tmp_path))
    jtr = JaxTrainer(jcfg, arch, run_dir=str(tmp_path / "jax"), seed=SEED).setup()
    params = perturbed(jtr.state.params, seed=2)
    jtr.state = jtr.state.replace(params=params, ema_params=params)
    past = np.random.default_rng(6).normal(size=(2, 5, 8, 12, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = np.asarray(jtr.sample(jnp.asarray(past), key))

    tr = Trainer(cfg, arch, device="cpu", seed=SEED).setup()
    tr.ema_model.load_state_dict(state_dict_from_jax(params["params"]))
    x0 = torch.from_numpy(np.array(jax.random.normal(key, want.shape, jnp.float32)))
    got = tr.sample(past, noise=lambda t: x0).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    bad = cfg.updated({"MODEL": {"FM": {"INTEGRATOR": "RK4"}}})
    with pytest.raises(ValueError, match=r"unknown integrator 'RK4'; expected \['Euler', 'Heun'\]"):
        Trainer(bad, arch, device="cpu").sample(past, torch.Generator().manual_seed(0))
