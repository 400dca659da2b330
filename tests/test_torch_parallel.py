"""The port's data-parallel paths (``crowdmod_tpu_torch.parallel``, the
trainer under a mesh) on the CPU over gloo, against the one-process port
and against the JAX package.

  * the sharding rules (``param_spec``, ``fsdp_spec``) against JAX's for
    every parameter of the tiny UNet and DiT, through the layout map, and
    FSDP's shard dims against the flax dims JAX shards;
  * 2-process DDP and FSDP runs of the tiny models (dropout and the CFG
    drop on) against the one-process run: step 1's gradients, a 3-step
    ``fit``, the weights and EMA, a ragged ``sample``, ``generate_metrics``;
    the FSDP checkpoint loaded by a plain ``Trainer``, by the JAX importer
    and back onto a sharded model;
  * the DDP step against the JAX package's step on a 2-device mesh, with
    the JAX draws injected, within the train-parity tolerances.

The worlds are spawned by ``test_torch_multiprocess.spawn_world`` (a
``file://`` rendezvous in the test's directory, a time limit a world).
"""

import jax
import numpy as np
import pytest
import torch
import yaml

from crowdmod_tpu.compat.torch_import import import_torch_checkpoint
from crowdmod_tpu.parallel import sharding as jax_sharding
from crowdmod_tpu.parallel.mesh import make_mesh as jax_make_mesh
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.models import factory
from crowdmod_tpu_torch.parallel import sharding
from crowdmod_tpu_torch.train.trainer import Trainer

from test_torch_multiprocess import dp_fit, spawn_world, tiny_config
from torch_train_parity import (
    BATCH,
    LOSS_RTOL,
    SEED,
    JaxTrainer,
    JaxWindowDataset,
    _assert_params_close,
    jax_get_learning_rate,
    key_stream,
    perturbed,
    walker_raw,
)
from torch_train_parity import tiny_config as parity_config

ARCHS = ("DDPM-UNet", "DDPM-DiT")
# 2 processes against 1: each process's backward sums over half the batch,
# then the all-reduce adds the halves, so float32 sums run in another order
# (measured up to ~1.1e-6 of max|g| on a conv weight of the tiny UNet).
GRAD_RTOL = 1e-5     # step 1's gradients, times the model's max|g|
PARAM_RTOL = 1e-6    # weights and EMA after 3 steps, times max|p|
LOSS_DP_RTOL = 1e-6
# Adam's first steps are sign-like where a gradient is float noise (the key
# bias of attention, a per-channel shift ahead of a GroupNorm of one-channel
# groups: their true gradient is 0): there the two runs' weights may part by
# up to 2·lr·steps.  An element counts as noise where step 1's gradient is
# under NOISE_SCALE times the model's max|g|.
NOISE_SCALE = 1e-6
SAMPLE_RTOL = 1e-5   # a 10-step chain on rows computed in batches of another size


# ---------------------------------------------------------------------------
# The sharding rules against JAX's
# ---------------------------------------------------------------------------

def _jax_tree(arch, root):
    _, jcfg = parity_config(root)
    return JaxTrainer(jcfg, arch, run_dir=str(root / "jax"), seed=SEED).setup() \
        .state.params["params"]


def _norm(spec, shape):
    """A spec without its entries at size-1 dims (the port drops some of
    the flax leaves' singleton dims)."""
    spec = tuple(spec) or (None,) * len(shape)
    return tuple(e for e, d in zip(spec, shape) if d != 1)


def _squeezed(shape):
    return tuple(d for d in shape if d != 1)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    return {arch: _jax_tree(arch, root) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("data,min_size", [(2, 64), (4, 64), (2, sharding.MIN_SIZE)])
def test_sharding_rules_match_jax(trees, arch, data, min_size, tmp_path):
    """Each port parameter's flax-layout shape is its JAX leaf's (up to
    singleton dims), ``fsdp_spec`` and ``param_spec`` answer as JAX's on it,
    and the torch dim FSDP shards is the one that holds the flax dim JAX
    shards (a tree whose sharded dims count 0, 1, 2, … carried over by
    ``state_dict_from_jax``)."""
    tree = trees[arch]
    cfg, _ = parity_config(tmp_path)
    model = factory.build_backbone(cfg, arch, 3)
    leaves, treedef = jax.tree.flatten(tree)
    ids = state_dict_from_jax(jax.tree.unflatten(treedef, [
        np.full(np.shape(a), k + 1.0, np.float32) for k, a in enumerate(leaves)]))
    jax_specs = [jax_sharding.fsdp_spec(a, data, min_size) for a in leaves]
    coords = []
    for a, spec in zip(leaves, jax_specs):
        c = np.zeros(np.shape(a), np.float32)
        if "data" in tuple(spec):
            j = tuple(spec).index("data")
            shape = [1] * c.ndim
            shape[j] = c.shape[j]
            c = c + np.arange(c.shape[j], dtype=np.float32).reshape(shape)
        coords.append(c)
    coord = state_dict_from_jax(jax.tree.unflatten(treedef, coords))
    layouts = sharding.flax_layouts(model)
    dims = sharding.placements(model, data, min_size)
    assert set(layouts) == set(model.state_dict()) == set(ids)
    for name, layout in layouts.items():
        src = sorted({int(v) - 1 for v in torch.unique(ids[name]).tolist()})
        for k in src:
            a = leaves[k]
            assert _squeezed(layout.shape) == _squeezed(np.shape(a)), name
            assert _norm(sharding.fsdp_spec(layout.shape, data, min_size), layout.shape) \
                == _norm(jax_specs[k], np.shape(a)), name
            assert _norm(sharding.param_spec(layout.shape, 2, min_size), layout.shape) \
                == _norm(jax_sharding.param_spec(a, 2, min_size), np.shape(a)), name
        t = coord[name]
        varying = [d for d in range(t.ndim) if t.shape[d] > 1
                   and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        assert varying == ([] if dims[name] is None else [dims[name]]), (name, varying)


# ---------------------------------------------------------------------------
# 2 processes against 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runs by (arch, mode), made when first asked for: mode None is the
    one-process run (in this process)."""
    cache = {}

    def get(arch, mode):
        if (arch, mode) not in cache:
            root = tmp_path_factory.mktemp(f"{arch}_{mode}")
            if mode is None:  # one thread, as each spawned process
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                try:
                    cache[arch, mode] = dp_fit(root, arch, "tp")
                finally:
                    torch.set_num_threads(threads)
            else:
                cache[arch, mode] = spawn_world(dp_fit, 2, root, arch, mode)
        return cache[arch, mode]

    return get


CASES = [(a, m) for a in ARCHS for m in ("tp", "fsdp")]


@pytest.mark.parametrize("arch,mode", CASES)
def test_two_processes_fit_as_one(runs, arch, mode):
    """Step 1's gradients, the per-step and epoch losses, the weights and
    the EMA after 3 steps (dropout 0.1 and the CFG drop on) equal the
    one-process run's within the tolerances above."""
    got, want = runs(arch, mode), runs(arch, None)
    g_max = max(float(g.abs().max()) for g in want["grads"].values())
    for name, g in want["grads"].items():
        err = float((got["grads"][name] - g).abs().max())
        assert err <= GRAD_RTOL * g_max, (name, err, g_max)
    np.testing.assert_allclose(got["history"]["step_loss"], want["history"]["step_loss"],
                               rtol=LOSS_DP_RTOL)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got["history"][key], want["history"][key],
                                   rtol=LOSS_DP_RTOL)
    assert got["step"] == want["step"] == 3 and got["lr"] == want["lr"]
    steps, lr = want["step"], want["lr"]
    for key in ("params", "ema"):
        p_max = max(float(p.abs().max()) for p in want[key].values())
        noise = 0
        for name, w in want[key].items():
            diff = (got[key][name] - w).abs()
            at_noise = want["grads"][name].abs() < NOISE_SCALE * g_max
            assert float(torch.where(at_noise, 0.0, diff).max()) <= PARAM_RTOL * p_max, \
                (key, name)
            assert float(diff.max()) <= 2 * lr * steps, (key, name)
            noise += int((diff[at_noise] > PARAM_RTOL * p_max).sum())
        print(f"{arch} {mode} {key}: {noise} float-noise elements beyond "
              f"{PARAM_RTOL}·max|p|")


@pytest.mark.parametrize("arch,mode", CASES)
def test_two_processes_sample_and_score_as_one(runs, arch, mode):
    """A ragged batch (5 rows over 2 processes) and the metric protocol's
    8 samples: each process samples its rows with its rows of the whole
    batch's draws, so the samples equal the one-process run's."""
    got, want = runs(arch, mode), runs(arch, None)
    ref = want["sample"]
    assert got["sample"].shape == ref.shape == (5, 3, 8, 12, 3)
    assert float((got["sample"] - ref).abs().max()) <= SAMPLE_RTOL * float(ref.abs().max())
    assert got["metrics"].keys() == want["metrics"].keys()
    for name, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][name], w, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_checkpoint_loads_plainly_into_jax_and_back(runs, arch, tmp_path):
    """The FSDP run's checkpoint (written by process 0 from the gathered
    state) loads into a plain ``Trainer`` with the run's weights, through
    the JAX package's importer (its weights in the reference's
    ``{"model": state_dict}`` file), and onto a sharded model in its shard
    layout with its Adam moments sharded."""
    got = runs(arch, "fsdp")
    cfg = tiny_config(arch, tmp_path)
    plain = Trainer(cfg, arch, device="cpu", seed=SEED + 2)
    plain.load(got["ckpt"])
    for name, w in got["params"].items():
        assert torch.equal(plain.params[name], w), name
    for name, w in got["ema"].items():
        assert torch.equal(plain.ema_params[name], w), name
    assert plain.state.step == 3
    payload = torch.load(got["ckpt"] + "/state.pt", weights_only=True)
    torch.save({"model": payload["params"]}, tmp_path / "reference.pt")  # its wrapper
    tree = import_torch_checkpoint(str(tmp_path / "reference.pt"), arch)["params"]
    back = state_dict_from_jax(jax.tree.map(np.asarray, tree))
    for name, w in back.items():
        torch.testing.assert_close(w, got["params"][name], rtol=0, atol=0)
    assert got["same_layout"] and got["moments_sharded"] and got["reloaded_step"] == 3
    for name, w in got["params"].items():
        assert torch.equal(got["reloaded"][name], w), name


# ---------------------------------------------------------------------------
# The DDP step against the JAX package's on a 2-device mesh
# ---------------------------------------------------------------------------

def dp_with_draws(tmp, arch, cfg_path, weights, draws):
    """A DDP fit of one epoch from ``weights`` with the JAX run's global
    draws injected (each process keeps its rows) → losses and state."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.parallel import multiprocess
    from crowdmod_tpu_torch.parallel.mesh import make_mesh
    from crowdmod_tpu_torch.train.optim import get_learning_rate

    cfg = load_config(cfg_path)
    rank = multiprocess.process_index()
    tr = Trainer(cfg, arch, device="cpu", seed=SEED, mesh=make_mesh(),
                 run_dir=str(tmp / f"run{rank}")).setup()
    tr.model.load_state_dict(weights)
    tr.ema_model.load_state_dict(weights)
    ds = WindowDataset(torch.from_numpy(walker_raw()), past_len=5, future_len=3, stride=8)
    it = iter(draws)
    history = tr.fit(ds, epochs=1, draws=lambda: next(it))
    return dict(history=history, params={k: v.clone() for k, v in tr.params.items()},
                ema={k: v.clone() for k, v in tr.ema_params.items()}, step=tr.state.step,
                lr=tr.plateau.lr, opt_lr=get_learning_rate(tr.state.optimizer))


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_step_matches_jax_mesh_step(arch, tmp_path):
    """The JAX trainer on a 2-device mesh (``make_mesh(data=2)``) against
    the port's DDP over 2 processes, from the same perturbed weights, with
    the JAX key stream's draws injected: per-step losses, weights and EMA
    within the train-parity tolerances (``torch_train_parity``)."""
    cfg, jcfg = parity_config(tmp_path)
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    jtr = JaxTrainer(jcfg, arch, run_dir=str(tmp_path / "jax"), seed=SEED, mesh=mesh).setup()
    start = perturbed(jtr.state.params, seed=1)  # numpy: the step donates its inputs
    weights = state_dict_from_jax(start["params"])
    params = jax_sharding.shard_params(jax.tree.map(jax.numpy.asarray, start), mesh)
    jtr.state = jtr.state.replace(params=params,
                                  ema_params=jax.tree.map(jax.numpy.copy, params))
    ds = JaxWindowDataset(jax.numpy.asarray(walker_raw()), past_len=5, future_len=3, stride=8)
    losses, step = [], jtr._train_step

    def recording_step(state, batch, key):
        state, loss = step(state, batch, key)
        losses.append(float(loss))
        return state, loss

    jtr._train_step = recording_step
    jtr.fit(ds, epochs=1)
    trained = jax.tree.map(np.asarray, jtr.state.params)["params"]
    ema = jax.tree.map(np.asarray, jtr.state.ema_params)["params"]

    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    family = arch.split("-")[0]
    draws = key_stream(SEED, len(losses), (BATCH, 3, 8, 12, 3), 0.0, family)
    (tmp_path / "world").mkdir()
    got = spawn_world(dp_with_draws, 2, tmp_path / "world", arch, str(cfg_path), weights,
                      draws)
    np.testing.assert_allclose(got["history"]["step_loss"][0], losses, rtol=LOSS_RTOL)
    steps, lr = got["step"], got["lr"]
    assert steps == len(losses) == 3
    assert got["opt_lr"] == jax_get_learning_rate(jtr.state.opt_state)
    _assert_params_close(got["params"], trained, lr, steps, f"{arch} DP params")
    _assert_params_close(got["ema"], ema, lr, steps, f"{arch} DP ema")
