"""Port parity: DiT2D (FM-DiT), DiT4DJoint and DiT4DTube against the JAX
modules, and their weights through ``state_dict_from_jax`` and the JAX
package's own importer.

Weights are the JAX package's init plus seeded numpy noise (AdaLN-Zero and
the zero-init final layer make a fresh DiT output exactly zero).  Both sides
run in float32 with exact GELU on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.compat.torch_import import (
    detect_backbone,
    import_torch_checkpoint,
    load_torch_state_dict,
)
from crowdmod_tpu.models.backbones import dit as jax_dit
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.models.backbones import dit

# Grid 8x12, 5 past + 3 future frames, patch 4 (N_s = 6), hidden 64, depth 2.
P, F, H, W, C = 5, 3, 8, 12, 3
COMMON = dict(out_channels=C, grid_rows=H, grid_cols=W, patch_size=4,
              hidden_size=64, depth=2, num_heads=4, dropout_rate=0.0)
FORWARD_ATOL = 1e-4  # f32, two attention blocks deep

VARIANTS = {
    # backbone: (JAX module, port module, the reference arch that builds it)
    "dit2d": (lambda: jax_dit.DiT2D(past_len=P, future_len=F, **COMMON),
              lambda: dit.DiT2D(past_len=P, future_len=F, **COMMON), "FM-DiT"),
    "dit4d_joint": (
        lambda: jax_dit.DiT4DJoint(past_len=P, future_len=F, t_patch_size=4, **COMMON),
        lambda: dit.DiT4DJoint(past_len=P, future_len=F, t_patch_size=4, **COMMON), None),
    # t_max = T: one temporal slot, as the reference's V2 (the importer
    # gives that embedding's one row).
    "dit4d_tube": (lambda: jax_dit.DiT4DTube.make(past_len=P, future_len=F, t_max=P + F,
                                                  **COMMON),
                   lambda: dit.DiT4DTube.make(past_len=P, future_len=F, **COMMON), None),
}


def perturbed(tree, seed, std=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0.0, std, np.shape(a)).astype(np.float32),
        tree,
    )


def zero_tube_past_rows(params):
    """The JAX tube's final-layer rows of the past frames, zeroed: the form
    its importer makes and training keeps (they get no gradient)."""
    final = params["final"]["Dense_0"]
    cut = P * 4 * 4 * C
    final["kernel"][:, :cut] = 0.0
    final["bias"][:cut] = 0.0
    return params


def build(name):
    jmake, tmake, _ = VARIANTS[name]
    jmodel = jmake()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, F, H, W, C)),
                            jnp.zeros((2,)), jnp.zeros((2, P, H, W, C)))
    params = perturbed(variables["params"], seed=1)
    if name == "dit4d_tube":
        params = zero_tube_past_rows(params)
    tmodel = tmake().eval()
    tmodel.load_state_dict(state_dict_from_jax(params, name, future_len=F))
    return jmodel, params, tmodel


def inputs(seed, b=3):
    rng = np.random.default_rng(seed)
    future = rng.normal(size=(b, F, H, W, C)).astype(np.float32)
    past = rng.normal(size=(b, P, H, W, C)).astype(np.float32)
    return future, np.array([0, 417, 999][:b], np.int32), past


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_jax(name):
    jmodel, params, tmodel = build(name)
    future, t, past = inputs(2)
    want = np.asarray(jmodel.apply({"params": params}, future, t, past))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(future), torch.from_numpy(t),
                     torch.from_numpy(past)).numpy()
    assert got.shape == want.shape == (3, F, H, W, C)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_state_dict_round_trips_through_torch_import(name, tmp_path):
    """A saved port state_dict is a reference checkpoint: the JAX package's
    importer fingerprints the right backbone, takes every key, and gives the
    original tree back (the tube's temporal embedding comes back folded
    into the spatial one, its past-frame rows as zeros)."""
    jmodel, params, tmodel = build(name)
    path = tmp_path / "model.pt"
    torch.save(tmodel.state_dict(), path)
    assert detect_backbone(load_torch_state_dict(str(path))) == name
    back = import_torch_checkpoint(str(path), VARIANTS[name][2])["params"]
    want = params
    if name == "dit4d_tube":
        want = jax.tree.map(np.copy, params)
        want["spatial_pos_embed"] = (want["spatial_pos_embed"]
                                     + want["temporal_pos_embed"].reshape(1, 1, 1, -1))
        want["temporal_pos_embed"] = np.zeros_like(want["temporal_pos_embed"])
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path_, leaf in flat_want:
        np.testing.assert_allclose(np.asarray(flat_got[path_]), leaf, rtol=0, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path_))
    if name == "dit4d_tube":  # the folded tree is the same function
        future, t, past = inputs(3)
        np.testing.assert_allclose(
            np.asarray(jmodel.apply({"params": back}, future, t, past)),
            np.asarray(jmodel.apply({"params": params}, future, t, past)),
            atol=1e-5, rtol=0)


def test_tube_refuses_non_zero_past_rows():
    _, params, _ = build("dit4d_tube")
    params["final"]["Dense_0"]["kernel"][3, 0] = 1e-3  # frame 0: a past frame
    with pytest.raises(ValueError, match="past-frame rows are not zero"):
        state_dict_from_jax(params, "dit4d_tube", future_len=F)
    params = zero_tube_past_rows(params)
    params["final"]["Dense_0"]["bias"][5] = -1e-3
    with pytest.raises(ValueError, match="past-frame rows are not zero"):
        state_dict_from_jax(params, "dit4d_tube", future_len=F)
    with pytest.raises(ValueError, match="future_len"):
        state_dict_from_jax(zero_tube_past_rows(params), "dit4d_tube")


def test_backbone_is_read_from_the_tree_or_named():
    """DiT2D is recognised by its one-frame patch; the tube-patched joint
    variants must be named."""
    _, params, tmodel = build("dit2d")
    got = state_dict_from_jax(params)
    assert set(got) == set(tmodel.state_dict())
    _, params, _ = build("dit4d_joint")
    with pytest.raises(ValueError, match="dit4d_joint"):
        state_dict_from_jax(params)
    with pytest.raises(ValueError, match="unknown backbone"):
        state_dict_from_jax(params, "dit3d")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_dropout_and_remat_train_through_the_port(name):
    """Training mode with dropout draws every mask from the generator, before
    each block: a REMAT model and a plain one give the same loss and
    gradients for the same generator seed."""
    _, tmake, _ = VARIANTS[name]
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = tmake()
        model.reset_parameters(torch.Generator().manual_seed(3))
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(4)))
        for block in model.blocks:
            block.attn.dropout_rate = 0.1
            for i in (2, 4):
                block.mlp[i].p = 0.1
        model.remat = remat
        model.train()
        future, t, past = (torch.from_numpy(a) for a in inputs(5, b=2))
        out = model(future, t, past, generator=torch.Generator().manual_seed(9))
        out.square().mean().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        model(future, t, past)
