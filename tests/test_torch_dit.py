"""Port parity: DiT4DFactorized forward, weight carry-over and MHA.

The JAX package's modules are the reference.  Weights are made by the JAX
package's own init and then perturbed with seeded numpy noise: AdaLN-Zero and
the zero-init final layer make a freshly initialised DiT output exactly zero,
which would compare zeros and prove nothing.  Both sides run in float32 with
exact GELU on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.compat.torch_import import import_torch_checkpoint
from crowdmod_tpu.models.backbones import dit as jax_dit
from crowdmod_tpu.ops.attention import MultiHeadAttention as JaxMHA
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.models.backbones.dit import DiT4DFactorized
from crowdmod_tpu_torch.ops.attention import MultiHeadAttention

# Small DiT4DFactorized: grid 8x12, 5 past + 3 future frames, patch 4,
# t-patch 4 (T_p = 2 slots x N_s = 6 tokens), hidden 64, depth 2, 4 heads.
DIT = dict(
    out_channels=3, grid_rows=8, grid_cols=12, past_len=5, future_len=3,
    patch_size=4, t_patch_size=4, hidden_size=64, depth=2, num_heads=4,
)
FORWARD_ATOL = 1e-4  # f32, two attention stacks deep


def perturbed(tree, seed, std=0.02):
    """Every leaf plus N(0, std²) noise from a numpy seed."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0.0, std, np.shape(a)).astype(np.float32),
        tree,
    )


@pytest.fixture(scope="module")
def models():
    jmodel = jax_dit.DiT4DFactorized(dropout_rate=0.0, **DIT)
    x = jnp.zeros((2, 3, 8, 12, 3))
    past = jnp.zeros((2, 5, 8, 12, 3))
    variables = jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((2,)), past)
    params = perturbed(variables["params"], seed=1)
    tmodel = DiT4DFactorized(dropout_rate=0.0, **DIT).eval()
    tmodel.load_state_dict(state_dict_from_jax(params))
    return jmodel, params, tmodel


def test_forward_matches_jax(models):
    jmodel, params, tmodel = models
    rng = np.random.default_rng(2)
    future = rng.normal(size=(3, 3, 8, 12, 3)).astype(np.float32)
    past = rng.normal(size=(3, 5, 8, 12, 3)).astype(np.float32)
    t = np.array([0, 417, 999], np.int32)
    want = np.asarray(jmodel.apply({"params": params}, future, t, past))
    with torch.no_grad():
        got = tmodel(
            torch.from_numpy(future), torch.from_numpy(t), torch.from_numpy(past)
        ).numpy()
    assert got.shape == want.shape == (3, 3, 8, 12, 3)
    assert np.abs(want).max() > 1e-2  # perturbed weights: a real output
    np.testing.assert_allclose(got, want, atol=FORWARD_ATOL, rtol=0)


def test_state_dict_round_trips_through_torch_import(models, tmp_path):
    """The port's state_dict is a reference checkpoint: the JAX package's
    importer maps it back onto exactly the original flax tree, and rejects
    no key (so the port registers nothing beyond the reference layout)."""
    _, params, tmodel = models
    path = tmp_path / "model.pt"
    torch.save(tmodel.state_dict(), path)
    back = import_torch_checkpoint(str(path), "DDPM-DiT")["params"]
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for key, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[key]), leaf)


def test_state_dict_has_only_reference_keys(models):
    _, params, tmodel = models
    assert set(tmodel.state_dict()) == set(state_dict_from_jax(params))
    assert not list(tmodel.buffers())


@pytest.mark.parametrize("pallas", ["off", "interpret"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_mha_matches_jax(pallas, cross, monkeypatch):
    monkeypatch.setenv("CROWDMOD_PALLAS_ATTENTION", pallas)
    d, heads = 64, 2
    rng = np.random.default_rng(3)
    q_in = rng.normal(size=(2, 4, 5, d)).astype(np.float32)
    kv_in = rng.normal(size=(2, 4, 7, d)).astype(np.float32) if cross else None
    jmha = JaxMHA(num_heads=heads)
    args = (q_in,) if kv_in is None else (q_in, kv_in)
    params = perturbed(jmha.init(jax.random.PRNGKey(1), *args)["params"], 4)
    want = np.asarray(jmha.apply({"params": params}, *args))

    tmha = MultiHeadAttention(d, heads).eval()
    names = ("query", "key", "value")
    tmha.load_state_dict({
        "in_proj_weight": torch.from_numpy(np.concatenate(
            [params[n]["kernel"].T for n in names])),
        "in_proj_bias": torch.from_numpy(np.concatenate(
            [params[n]["bias"] for n in names])),
        "out_proj.weight": torch.from_numpy(params["out"]["kernel"].T.copy()),
        "out_proj.bias": torch.from_numpy(params["out"]["bias"]),
    })
    with torch.no_grad():
        got = tmha(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
