"""Port parity: the ConvRNN family (cells, encoder–forecaster, loss) against
the JAX package's ``models/convrnn``, and its weights through the JAX
package's own checkpoint importer.

Both sides take the same inputs (seeded numpy) and the same weights: the
JAX init, perturbed with seeded noise, carried into the port by
``state_dict_from_jax``.  Widths are small (4–8 channels) on the 12×36
grid, in float32 on the CPU; the forecasts take 3 past and 2 future frames
(the JAX side unrolls every frame of every step, and its compile time grows
with both).  Tolerances: a cell step or the loss within 1e-5, a forecast
within 1e-5 (teacher-forced) and 1e-4 (free rollout: each fed-back frame's
exp magnifies the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from crowdmod_tpu.compat.torch_import import import_torch_checkpoint
from crowdmod_tpu.models import convrnn as jax_convrnn
from crowdmod_tpu_torch.compat import jax_params
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.models import convrnn
from crowdmod_tpu_torch.models.convrnn.forecaster import UpConv

ENC = (4, 6, 6, 8, 8, 8)
FORC = (8, 8, 8, 8, 8, 6, 4)
H, W = 12, 36
CELL_ATOL = 1e-5
TF_ATOL = 1e-5
FREE_ATOL = 1e-4
LOSS_RTOL = 1e-5



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The CPU convolutions of these small frames run ~50× slower on many
    threads than on one (thread start-up and contention dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def perturbed(tree, seed, std=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + rng.normal(0.0, std, np.shape(a)).astype(np.float32), tree)


def frames(seed, shape):
    return np.abs(np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("cell", ["ConvGRUCell", "ConvLSTMCell"])
@pytest.mark.parametrize("bias", [False, True])
def test_cell_step_matches_jax(cell, bias):
    jcell = jax_convrnn.CELLS[cell](hidden_channels=8, kernel_size=3, use_bias=bias)
    x, h, c = frames(0, (2, H, W, 4)), frames(1, (2, H, W, 8)), frames(2, (2, H, W, 8))
    params = perturbed(jcell.init(jax.random.PRNGKey(0), x, (h, c))["params"], 3)
    jout, (jh, jc) = jcell.apply({"params": params}, x, (h, c))

    sd = {}
    jax_params._cell(params, "cell", sd)
    port = convrnn.CELLS[cell](4, 8, 3, use_bias=bias)
    port.load_state_dict({k[5:]: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()})
    with torch.no_grad():
        out, (ph, pc) = port(nchw(x), (nchw(h), nchw(c)))
    for got, want in ((out, jout), (ph, jh), (pc, jc)):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                                   atol=CELL_ATOL, rtol=0)


def models(cell, seed=0, bias=False):
    """The JAX forecaster with perturbed params, and the port's with the
    same weights."""
    jm = jax_convrnn.Forecaster(out_channels=4, enc_hidden_channels=ENC,
                                forc_hidden_channels=FORC,
                                cell=jax_convrnn.CELLS[cell], use_bias=bias)
    past, target = frames(10, (2, 3, H, W, 4)), frames(11, (2, 2, H, W, 4))
    params = jm.init(jax.random.PRNGKey(seed), past, target=target, teacher_forcing=True)
    params = perturbed(params["params"], seed + 1)
    pm = convrnn.Forecaster(4, ENC, FORC, cell=convrnn.CELLS[cell], use_bias=bias)
    pm.load_state_dict(state_dict_from_jax(params))
    return jm, params, pm.eval(), past, target


@pytest.mark.parametrize("cell,bias", [("ConvGRUCell", False), ("ConvLSTMCell", False),
                                       ("ConvGRUCell", True)])
@pytest.mark.parametrize("teacher_forcing", [True, False])
def test_forecaster_matches_jax(cell, bias, teacher_forcing):
    jm, params, pm, past, target = models(cell, bias=bias)
    apply = jax.jit(jm.apply, static_argnames="teacher_forcing")
    want = np.asarray(apply({"params": params}, past, target=target,
                            teacher_forcing=teacher_forcing))
    with torch.no_grad():
        got = pm(torch.from_numpy(past), target=torch.from_numpy(target),
                 teacher_forcing=teacher_forcing).numpy()
    assert got.shape == want.shape == (2, 2, H, W, 4)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=TF_ATOL if teacher_forcing else FREE_ATOL,
                               rtol=0)
    if not teacher_forcing:  # the horizon from future_len alone
        with torch.no_grad():
            again = pm(torch.from_numpy(past), future_len=2).numpy()
        np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_transpose_conv_has_flax_same_output(k):
    """The stride-2 transpose conv against flax's ``padding="SAME"`` one,
    with the kernel flipped as the JAX importer flips it."""
    x = frames(20, (2, 3, 9, 4))
    layer = fnn.ConvTranspose(5, kernel_size=(k, k), strides=(2, 2), padding="SAME")
    params = perturbed(layer.init(jax.random.PRNGKey(1), x)["params"], 21)
    want = np.asarray(layer.apply({"params": params}, x))
    sd = {}
    jax_params._conv_t2d(params, "up", sd)
    up = UpConv(4, 5, k, bias=True)
    up.load_state_dict({k[3:]: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in sd.items()})
    with torch.no_grad():
        got = up(nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 6, 18, 5)
    np.testing.assert_allclose(got, want, atol=CELL_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["random", "all_occupied", "all_empty", "clamped"])
def test_loss_matches_jax(case):
    rng = np.random.default_rng(30)
    pred = rng.normal(0, 1, (2, 3, H, W, 4)).astype(np.float32)
    target = np.abs(rng.normal(0, 1.5, (2, 3, H, W, 4))).astype(np.float32)
    if case == "all_occupied":
        target[..., 0] += 1.0
    elif case == "all_empty":
        target[..., 0] *= 0.5 / target[..., 0].max()
    elif case == "clamped":  # exp past 20 and ρ at 0: the clamps bite
        pred[..., (0, 3)] *= 4.0
        target[..., 0] *= rng.integers(0, 2, target[..., 0].shape)
    want = jax_convrnn.convrnn_loss(jnp.asarray(pred), jnp.asarray(target), 1e-6)
    got = convrnn.convrnn_loss(torch.from_numpy(pred), torch.from_numpy(target), 1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL, atol=1e-7)
    mu, var = pred[..., 1:3], np.exp(pred[..., 3:4])
    for name in ("kl_poisson_loss", "velocity_mse_loss", "kl_gaussian_loss"):
        args = ((np.exp(pred[..., 0]) + 0.1, target[..., 0] + 0.1)
                if name == "kl_poisson_loss" else (mu, var, target[..., 1:3], var + 0.5))
        np.testing.assert_allclose(
            getattr(convrnn, name)(*map(torch.from_numpy, args)).numpy(),
            np.asarray(getattr(jax_convrnn, name)(*map(jnp.asarray, args))),
            rtol=LOSS_RTOL, atol=1e-6)


def test_shared_slot_validation_message():
    want = ("shared state slots require ENC_HIDDEN_CH[1,3,5] == FORC_HIDDEN_CH[5,3,1]; "
            "got enc=[4, 6, 6, 8, 8, 8] forc=[8, 8, 8, 8, 8, 4, 4]")
    bad = (8, 8, 8, 8, 8, 4, 4)
    with pytest.raises(ValueError) as port_err:
        convrnn.Forecaster(4, ENC, bad)
    jm = jax_convrnn.Forecaster(out_channels=4, enc_hidden_channels=ENC,
                                forc_hidden_channels=bad)
    with pytest.raises(ValueError) as jax_err:
        jm.init(jax.random.PRNGKey(0), frames(0, (1, 5, H, W, 4)), future_len=1)
    assert str(port_err.value) == str(jax_err.value) == want
    with pytest.raises(ValueError, match="requires target"):
        convrnn.Forecaster(4, ENC, FORC)(torch.zeros(1, 5, H, W, 4), teacher_forcing=True)


@pytest.mark.parametrize("cell", ["ConvGRUCell", "ConvLSTMCell"])
def test_state_dict_round_trips_through_the_jax_importer(cell, tmp_path):
    """A port checkpoint in the reference layout loads through
    ``import_torch_checkpoint`` (``_import_convrnn``) into the JAX tree it
    came from, bit for bit."""
    jm, params, pm, past, _ = models(cell, seed=4, bias=True)
    path = tmp_path / "convrnn.pt"
    torch.save({"model": pm.state_dict()}, path)
    back = import_torch_checkpoint(str(path), arch="ConvRNN")["params"]
    flat, tree = jax.tree_util.tree_flatten_with_path(back), jax.tree_util.tree_flatten_with_path(params)
    assert [p for p, _ in flat[0]] == [p for p, _ in tree[0]]
    for (_, got), (_, want) in zip(flat[0], tree[0]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert jax_params._detect(params) == "convrnn"
