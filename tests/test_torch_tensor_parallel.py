"""Tensor parallelism in the port (a "model" mesh axis:
``crowdmod_tpu_torch.parallel.tensor``, ``sharding.shard_params`` beyond
replication, the trainer and ``train --model-parallel``) on the CPU over
gloo, against the JAX package and against the port's plain run.

  * the parts: the four autograd rules at N = 2 against plain autograd
    (a gradient off by a factor of N shows), a column-parallel layer's
    gradients, ``mesh_from_config`` with ``TPU.MESH.MODEL`` and the
    override, ``shard_batch`` and ``replicate`` on a 2 × 2 mesh;
  * placement: every rank's slice of every parameter holds exactly the
    entries JAX's ``NamedSharding`` puts on its mesh position (model 2;
    data 2 × model 2 under FSDP), traced by giving each entry its own
    value and carrying the tree over through ``compat/jax_params.py``;
  * a step of a world of 2 (data 1 × model 2) against the JAX trainer on
    the same 1 × 2 mesh, with the JAX draws injected (DDPM-UNet, DDPM-DiT;
    ConvRNN, whose loss draws nothing, under AMSGrad, each rank holding no
    part of one GRU gate);
  * four ranks (data 2 × model 2), with and without FSDP, against the
    plain fit (DDPM-UNet, DDPM-DiT, FM-UNet, FM-DiT's DiT2D, ConvRNN):
    step 1's gradients, 3 steps' losses, weights and EMA, a ragged sample;
    replicated parameters bitwise equal across each model group; the TP
    checkpoint loaded by a plain ``Trainer`` and by JAX's importer; a plain
    checkpoint resumed under TP; the ConvRNN under FSDP over "data" alone
    saving whole weights;
  * ``train --data-parallel --model-parallel 2 [--fsdp] --device cpu`` as
    a command, its checkpoint against an in-process TP trainer's.

Worlds are spawned by ``test_torch_multiprocess.spawn_world``, one thread
a process.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from crowdmod_tpu.compat.torch_import import import_torch_checkpoint
from crowdmod_tpu.parallel import sharding as jax_sharding
from crowdmod_tpu.parallel.mesh import make_mesh as jax_make_mesh
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.models import factory
from crowdmod_tpu_torch.parallel import multiprocess, sharding, tensor
from crowdmod_tpu_torch.train.trainer import Trainer

from test_torch_multiprocess import (
    BATCH,
    SEED,
    _cli,
    _workspace,
    spawn_world,
    tiny_config,
    walker_windows,
)
from test_torch_train_convrnn import F as CONVRNN_F
from test_torch_train_convrnn import P as CONVRNN_P
from test_torch_train_convrnn import convrnn_config, walker_raw4
from torch_train_parity import (
    LOSS_RTOL,
    JaxTrainer,
    JaxWindowDataset,
    _assert_params_close,
    jax_get_learning_rate,
    key_stream,
    perturbed,
    walker_raw,
)
from torch_train_parity import BATCH as PARITY_BATCH
from torch_train_parity import SEED as PARITY_SEED
from torch_train_parity import tiny_config as parity_config

ARCHS = ("DDPM-UNet", "DDPM-DiT")
FIT_ARCHS = ("DDPM-UNet", "DDPM-DiT", "FM-UNet", "FM-DiT", "ConvRNN")
FIT_RTOL = 1e-5     # losses, weights, EMA, samples of a 4-rank run, times max|ref|
GRAD_RTOL = 1e-5    # step 1's gradients, times the model's max|g|
# Adam's first steps are sign-like where a gradient is float noise (see
# test_torch_parallel.NOISE_SCALE): there the weights may part by up to
# 2·lr·steps.
NOISE_SCALE = 1e-6
PLACE_MIN = 64      # min_size of the placement cases: every kind of layer cut


def _gather_all(obj):
    """Every rank's ``obj``, by rank (a collective)."""
    import torch.distributed as dist

    out = [None] * multiprocess.process_count()
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# The parts
# ---------------------------------------------------------------------------

def parts_world(tmp: Path) -> dict:
    """A world of 2 on a 1 × 2 mesh: each autograd rule and a
    column-parallel linear, with the gradients each rank ends with."""
    from crowdmod_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=1, model=2)
    r = mesh["model"].get_local_rank()
    shard = tensor.ModelShard(0, r, tensor.blocks(6, 2), mesh["model"].get_group())
    g = torch.Generator().manual_seed(0)
    full, c, cr = (torch.randn(6, 3, generator=g) for _ in range(3))
    c_rank = cr * (r + 1)  # a loss term that differs between the ranks
    out = {}

    local = tensor.local_slice(full, shard).requires_grad_()
    y = tensor.gather_features(local, shard, 0)
    (y * c).sum().backward()
    out["gather_features"] = (y.detach(), local.grad)

    x = full.clone().requires_grad_()
    (tensor.reduce_grad(x, shard) * c_rank).sum().backward()
    out["reduce_grad"] = x.grad

    w = tensor.local_slice(full, shard).requires_grad_()
    whole = tensor.gather_weight(w, shard)
    (whole * c).sum().backward()
    out["gather_weight"] = (whole.detach(), w.grad)

    b = full.clone().requires_grad_()
    part = tensor.split(b, shard)
    (part * tensor.local_slice(c_rank, shard)).sum().backward()
    out["split"] = (part.detach(), b.grad)

    cut = torch.nn.Linear(3, 3)
    cut.weight = torch.nn.Parameter(tensor.local_slice(full, shard))
    cut.bias = torch.nn.Parameter(c[:, 0].clone())  # replicated: 6 entries
    cut.model_shards = {"weight": shard}
    xin = cr[:4].clone().requires_grad_()
    yy = tensor.column(cut, xin, F.linear)
    (yy * torch.arange(24.0).reshape(4, 6)).sum().backward()
    out["column"] = dict(y=yy.detach(), dx=xin.grad, dw=cut.weight.grad, db=cut.bias.grad)
    return {"all": _gather_all(out)}


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    return spawn_world(parts_world, 2, tmp_path_factory.mktemp("parts"))


def test_autograd_rules_at_two_ranks(parts):
    """Each rule's forward and the gradient each rank ends with, against
    plain autograd of the sum of the ranks' losses: gather_features and
    gather_weight hand back the local slice (not N times it), reduce_grad
    and split sum the ranks' parts."""
    g = torch.Generator().manual_seed(0)
    full, c, cr = (torch.randn(6, 3, generator=g) for _ in range(3))
    ranks = parts["all"]
    for r, got in enumerate(ranks):
        rows = slice(3 * r, 3 * r + 3)
        y, dlocal = got["gather_features"]
        assert torch.equal(y, full) and torch.equal(dlocal, c[rows])
        whole, dw = got["gather_weight"]
        assert torch.equal(whole, full) and torch.equal(dw, c[rows])
        # Plain: d/dx of Σ_r Σ (x * cr·(r+1)) = 3·cr.
        torch.testing.assert_close(got["reduce_grad"], cr * 1 + cr * 2, rtol=0, atol=0)
        part, db = got["split"]
        assert torch.equal(part, full[rows])
        want = torch.cat([cr[:3] * 1, cr[3:] * 2])
        assert torch.equal(db, want)


def test_column_parallel_linear_gradients(parts):
    """A linear of 6 outputs cut 3 + 3: the output, the input's gradient
    (summed over the ranks), each rank's weight rows' gradient and the
    replicated bias's whole gradient equal plain autograd's."""
    g = torch.Generator().manual_seed(0)
    full, c, cr = (torch.randn(6, 3, generator=g) for _ in range(3))
    w = full.clone().requires_grad_()
    b = c[:, 0].clone().requires_grad_()
    x = cr[:4].clone().requires_grad_()
    y = F.linear(x, w, b)
    (y * torch.arange(24.0).reshape(4, 6)).sum().backward()
    for r, got in enumerate(parts["all"]):
        col = got["column"]
        torch.testing.assert_close(col["y"], y.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(col["dx"], x.grad, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(col["dw"], w.grad[3 * r:3 * r + 3], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(col["db"], b.grad, rtol=1e-6, atol=1e-6)


def test_mesh_from_config_reads_model_and_the_override(monkeypatch):
    """``mesh_shape`` answers as the JAX package's ``mesh_from_config``
    (``tests/test_cli.py``): MESH.MODEL, DATA × MODEL, the override
    winning; ``make_mesh`` lays "model" inner over a world of 8 (a
    rank's coordinates are (rank // M, rank % M))."""
    from crowdmod_tpu_torch.parallel import mesh as port_mesh

    cfg, _ = parity_config(Path("/nonexistent"))
    assert port_mesh.mesh_shape(cfg) == (None, 1)
    assert port_mesh.mesh_shape(cfg.updated({"TPU": {"MESH": {"MODEL": 2}}})) == (None, 2)
    assert port_mesh.mesh_shape(
        cfg.updated({"TPU": {"MESH": {"DATA": 2, "MODEL": 2}}})) == (2, 2)
    assert port_mesh.mesh_shape(
        cfg.updated({"TPU": {"MESH": {"MODEL": 2}}}), model_override=4) == (None, 4)
    seen = {}

    def fake_mesh(device_type, shape, mesh_dim_names):
        seen.update(shape=shape, names=mesh_dim_names)
        return torch.arange(8).reshape(shape)

    monkeypatch.setattr(multiprocess, "active", lambda: True)
    monkeypatch.setattr(multiprocess, "process_count", lambda: 8)
    monkeypatch.setattr("torch.distributed.device_mesh.init_device_mesh", fake_mesh)
    grid = port_mesh.mesh_from_config(cfg.updated({"TPU": {"MESH": {"MODEL": 2}}}),
                                      model_override=4, device_type="cpu")
    assert seen == {"shape": (2, 4), "names": ("data", "model")}
    assert grid[1].tolist() == [4, 5, 6, 7]  # data index 1's model group
    port_mesh.mesh_from_config(cfg.updated({"TPU": {"MESH": {"DATA": 2, "MODEL": 4}}}),
                               device_type="cpu")
    assert seen["shape"] == (2, 4)
    with pytest.raises(ValueError, match="does not divide"):
        port_mesh.make_mesh(model=3, device_type="cpu")


def test_a_mesh_that_misses_the_world_exits_2(capsys, monkeypatch):
    """The launch checks data × model against the world before any
    handshake: a manual launch of 2 processes asked for a model axis of 3,
    or a config's DATA 2 × MODEL 2 on a CPU world, exits 2 naming the
    mesh; ``--model-parallel`` still needs ``--data-parallel``."""
    from crowdmod_tpu_torch.cli import train
    from crowdmod_tpu_torch.parallel import launch

    monkeypatch.setenv("CROWDMOD_NUM_PROCESSES", "2")
    assert launch.run_ranks("crowdmod_tpu_torch.cli.train", [], "cpu", True,
                            data=None, model=3) == 2
    assert "does not cover the 2 processes" in capsys.readouterr().err
    assert launch.mesh_mismatch(4, 2, 2) is None and launch.mesh_mismatch(4, None, 2) is None
    assert launch.mesh_mismatch(6, 2, 2)
    with pytest.raises(SystemExit, match="require --data-parallel"):
        train.run(["--model-parallel", "2", "--device", "cpu"])
    assert train.run(["--data-parallel", "--model-parallel", "0", "--device", "cpu"]) == 2


# ---------------------------------------------------------------------------
# Placement against JAX
# ---------------------------------------------------------------------------

PLACE_ARCHS = ("DDPM-UNet", "DDPM-DiT", "FM-DiT", "ConvRNN")


def _id_tree(arch, root):
    """The JAX tree of ``arch`` at the parity widths, each entry its own
    value (1, 2, …, exact in float32), and its port state_dict."""
    _, jcfg = parity_config(root)
    if arch == "ConvRNN":
        jcfg = jcfg.updated(_CONVRNN_WIDTHS)
    jtr = JaxTrainer(jcfg, arch, run_dir=str(root / "jax"), seed=1)
    tree = jax.eval_shape(jtr.init_params)["params"]  # shapes only: no compile
    leaves, treedef = jax.tree.flatten(tree)
    start, ids = 1, []
    for a in leaves:
        n = int(np.prod(a.shape))
        ids.append(np.arange(start, start + n, dtype=np.float32).reshape(a.shape))
        start += n
    assert start < 1 << 24
    id_tree = jax.tree.unflatten(treedef, ids)
    return id_tree, {k: torch.from_numpy(np.asarray(v)).contiguous()
                     for k, v in state_dict_from_jax(id_tree).items()}


# GRU gates of 16 hidden: the fused gate conv (3, 3, 32, 32) is cut, and at
# two ranks each rank holds one whole gate.
_CONVRNN_WIDTHS = {"MODEL": {"CONVRNN": {"ENC_HIDDEN_CH": [8, 16, 16, 16, 16, 16],
                                         "FORC_HIDDEN_CH": [16, 16, 16, 16, 16, 16, 8]}}}


def _port_config(arch, root):
    cfg, _ = parity_config(root)
    return cfg.updated(_CONVRNN_WIDTHS) if arch == "ConvRNN" else cfg


def _jax_positions(id_tree, data, model, mode):
    """{mesh position: set of the entries JAX puts there} (all leaves) and
    the leaves' specs."""
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    placed = jax_sharding.shard_params(jax.tree.map(jax.numpy.asarray, id_tree), mesh,
                                       min_size=PLACE_MIN, mode=mode)
    grid = np.asarray(mesh.devices)
    pos = {dev: tuple(int(i) for i in np.argwhere(grid == dev)[0]) for dev in grid.flat}
    out, specs = {}, []
    for leaf in jax.tree.leaves(placed):
        specs.append(tuple(leaf.sharding.spec))
        for s in leaf.addressable_shards:
            out.setdefault(pos[s.device], set()).update(np.asarray(s.data).ravel().tolist())
    return out, specs


def _entries(tensors) -> set:
    return set(torch.cat([t.reshape(-1) for t in tensors]).tolist())


@pytest.fixture(scope="module")
def id_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("ids")
    return {arch: _id_tree(arch, root) for arch in PLACE_ARCHS}


@pytest.mark.parametrize("arch", PLACE_ARCHS)
def test_model_axis_placement_is_jax_s(id_trees, arch, tmp_path):
    """Model 2 and model 4 (data 1): rank m's cut of the model holds
    exactly the entries JAX's ``NamedSharding`` puts on mesh position
    (0, m), and none is cut twice."""
    id_tree, ids = id_trees[arch]
    for n in (2, 4):
        want, specs = _jax_positions(id_tree, 1, n, "tp")
        assert any("model" in s for s in specs)
        cut = [None] * n
        for r in range(n):
            model = factory.build_backbone(_port_config(arch, tmp_path), arch,
                                           4 if arch == "ConvRNN" else 3)
            model.load_state_dict(ids)
            sharding.cut_model(model, n, r, None, PLACE_MIN)
            cut[r] = _entries(model.state_dict().values())
            assert cut[r] == want[(0, r)], (arch, n, r, len(cut[r] ^ want[(0, r)]))
        shards = tensor.model_shards(model)
        assert shards and all(s.full == sum(len(i) for i in s.index) for s in shards.values())


def mesh_world(tmp: Path, ids: dict) -> list:
    """A 2 × 2 world → by rank: the mesh helpers' answers, and for each
    arch of ``ids`` its id model under ``shard_params(mode="fsdp")``: the
    local shards, and the parameters gathered over "data" (the model
    cut)."""
    from torch.distributed.tensor import DTensor

    from crowdmod_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

    mesh = make_mesh(data=2, model=2)
    rank = multiprocess.process_index()
    out = dict(
        coords=(mesh["data"].get_local_rank(), mesh["model"].get_local_rank()),
        rows=shard_batch(torch.arange(8.0), mesh),
        rank_rows=multiprocess.rank_rows(8, mesh),
        gathered=multiprocess.all_gather_rows(torch.full((1,), float(rank)), mesh),
        mean=multiprocess.mean_over_processes(torch.tensor([float(rank)]), mesh),
        replicated=replicate({"w": [torch.full((2,), rank + 1.0)]}, mesh)["w"][0],
    )
    for arch, sd in ids.items():
        model = factory.build_backbone(_port_config(arch, tmp), arch, 3)
        model.load_state_dict(sd)
        sharding.shard_params(model, mesh, "fsdp", PLACE_MIN)
        local, cut = {}, {}
        for name, p in model.named_parameters():
            dt = isinstance(p, DTensor)
            local[name] = p.to_local().detach().clone() if dt else p.detach()
            cut[name] = p.full_tensor().detach() if dt else p.detach()
        out[arch] = dict(local=local, cut=cut)
    return _gather_all(out)


@pytest.fixture(scope="module")
def mesh_ranks(id_trees, tmp_path_factory):
    ids = {arch: id_trees[arch][1] for arch in ("DDPM-UNet", "DDPM-DiT")}
    return spawn_world(mesh_world, 4, tmp_path_factory.mktemp("mesh"), ids)


@pytest.mark.parametrize("arch", ("DDPM-UNet", "DDPM-DiT"))
def test_fsdp_placement_with_a_model_axis_is_jax_s(id_trees, mesh_ranks, arch):
    """Data 2 × model 2 under FSDP: rank (d, m) holds exactly JAX's shard
    at (d, m) of every leaf JAX shards over "data"; of a leaf JAX keeps
    whole over "data" (small or indivisible: FSDP2 still cuts it, on dim
    0, the layout difference ``sharding.py`` names), and of the packed
    attention bias, its slices over "data" together make JAX's shard at
    (·, m)."""
    id_tree, ids = id_trees[arch]
    got = [rank[arch] for rank in mesh_ranks]
    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    placed = jax_sharding.shard_params(jax.tree.map(jax.numpy.asarray, id_tree), mesh,
                                       min_size=PLACE_MIN, mode="fsdp")
    grid = np.asarray(mesh.devices)
    names = {}  # entry → the port parameter that holds it
    for name, t in ids.items():
        for v in t.reshape(-1).tolist():
            names[v] = name
    on_data = on_model = 0
    for leaf in jax.tree.leaves(placed):
        spec = tuple(leaf.sharding.spec)
        at = {}
        for s in leaf.addressable_shards:
            d, m = (int(i) for i in np.argwhere(grid == s.device)[0])
            at[d, m] = set(np.asarray(s.data).ravel().tolist())
        for (d, m), want in at.items():
            owners = {names[v] for v in want}
            # FSDP2 cuts the packed attention bias (q, k, v end to end) in
            # contiguous halves over "data", not each of q, k, v: a layout
            # difference, so that one is held by its cut over "model".
            packed = any(n.endswith("in_proj_bias") for n in owners)
            kind = "local" if "data" in spec and not packed else "cut"
            if kind == "cut":  # JAX's slices at (·, m) together
                want = at[0, m] | at[1, m]
            held = _entries([got[2 * d + m][kind][n] for n in owners]) & set(
                np.asarray(leaf).ravel().tolist())
            assert held == want, (arch, owners, spec, (d, m))
            on_data += "data" in spec
            on_model += "model" in spec
    assert on_data and on_model


# ---------------------------------------------------------------------------
# A step against the JAX package's on a 1 × 2 mesh
# ---------------------------------------------------------------------------

def tp_with_draws(tmp, arch, cfg_path, weights, draws):
    """A TP fit (data 1 × model 2) of one epoch from ``weights`` with the
    JAX run's draws injected → losses and the gathered state."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.parallel.mesh import make_mesh
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.optim import get_learning_rate

    cfg = load_config(cfg_path)
    rank = multiprocess.process_index()
    tr = Trainer(cfg, arch, device="cpu", seed=PARITY_SEED,
                 mesh=make_mesh(data=1, model=2), run_dir=str(tmp / f"run{rank}")).setup()
    ckpt.load_full_state_dict(tr.model, weights)
    ckpt.load_full_state_dict(tr.ema_model, weights)
    ds = WindowDataset(torch.from_numpy(walker_raw()), past_len=5, future_len=3, stride=8)
    it = iter(draws)
    history = tr.fit(ds, epochs=1, draws=lambda: next(it))
    return dict(history=history, params={k: v.clone() for k, v in tr.params.items()},
                ema={k: v.clone() for k, v in tr.ema_params.items()}, step=tr.state.step,
                lr=tr.plateau.lr, opt_lr=get_learning_rate(tr.state.optimizer),
                cut=len(tensor.model_shards(tr.model)))


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_jax_mesh_step(arch, tmp_path):
    """The JAX trainer on a data 1 × model 2 mesh against the port's TP
    over 2 processes, from the same perturbed weights, with the JAX key
    stream's draws injected: per-step losses, weights and EMA within the
    train-parity tolerances (as ``test_dp_step_matches_jax_mesh_step``)."""
    import yaml

    cfg, jcfg = parity_config(tmp_path)
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    jtr = JaxTrainer(jcfg, arch, run_dir=str(tmp_path / "jax"), seed=PARITY_SEED,
                     mesh=mesh).setup()
    start = perturbed(jtr.state.params, seed=1)
    weights = {k: torch.from_numpy(np.asarray(v)) for k, v in
               state_dict_from_jax(start["params"]).items()}
    params = jax_sharding.shard_params(jax.tree.map(jax.numpy.asarray, start), mesh)
    assert any("model" in tuple(x.sharding.spec) for x in jax.tree.leaves(params))
    jtr.state = jtr.state.replace(params=params,
                                  ema_params=jax.tree.map(jax.numpy.copy, params))
    ds = JaxWindowDataset(jax.numpy.asarray(walker_raw()), past_len=5, future_len=3,
                          stride=8)
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
    draws = key_stream(PARITY_SEED, len(losses), (PARITY_BATCH, 3, 8, 12, 3), 0.0, family)
    (tmp_path / "world").mkdir()
    got = spawn_world(tp_with_draws, 2, tmp_path / "world", arch, str(cfg_path), weights,
                      draws)
    assert got["cut"] > 0
    np.testing.assert_allclose(got["history"]["step_loss"][0], losses, rtol=LOSS_RTOL)
    steps, lr = got["step"], got["lr"]
    assert steps == len(losses) == 3
    assert got["opt_lr"] == jax_get_learning_rate(jtr.state.opt_state)
    _assert_params_close(got["params"], trained, lr, steps, f"{arch} TP params")
    _assert_params_close(got["ema"], ema, lr, steps, f"{arch} TP ema")


def convrnn_tp_fit(tmp, cfg_path, weights):
    """A ConvRNN TP fit (data 1 × model 2) of one epoch from ``weights`` →
    losses, the gathered weights and the parameters this rank holds none
    of."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.windows import WindowDataset
    from crowdmod_tpu_torch.parallel.mesh import make_mesh
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.optim import get_learning_rate

    rank = multiprocess.process_index()
    tr = Trainer(load_config(cfg_path), "ConvRNN", device="cpu", seed=CONVRNN_SEED,
                 mesh=make_mesh(data=1, model=2), run_dir=str(tmp / f"run{rank}")).setup()
    ckpt.load_full_state_dict(tr.model, weights)
    ds = WindowDataset(torch.from_numpy(walker_raw4()), past_len=CONVRNN_P,
                       future_len=CONVRNN_F, stride=5)
    history = tr.fit(ds, epochs=1)
    return dict(history=history, params={k: v.clone() for k, v in tr.params.items()},
                step=tr.state.step, lr=tr.plateau.lr, opt_lr=get_learning_rate(tr.state.optimizer),
                cut=len(tensor.model_shards(tr.model)),
                empty=sorted(n for n, p in tr.model.named_parameters() if p.numel() == 0))


CONVRNN_SEED = 5


def test_convrnn_tp_step_matches_jax_mesh_step(tmp_path):
    """The JAX ConvRNN trainer (AMSGrad) on a data 1 × model 2 mesh against
    the port's TP over 2 processes, from the same perturbed weights, at
    widths whose GRU gate convs are cut (rank 0 holds the reset gates,
    rank 1 the update gates: each an empty parameter of the other):
    per-step losses and weights within the train-parity tolerances."""
    import yaml

    from crowdmod_tpu.config import load_config as jax_load_config

    from crowdmod_tpu_torch.config import load_config

    jcfg = convrnn_config(tmp_path, jax_load_config).updated(_CONVRNN_FIT)
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    jtr = JaxTrainer(jcfg, "ConvRNN", run_dir=str(tmp_path / "jax"), seed=CONVRNN_SEED,
                     mesh=mesh).setup()
    start = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + np.random.default_rng(1).normal(0, 0.05, np.shape(a)).astype(np.float32),
        jtr.state.params)
    weights = {k: torch.from_numpy(np.asarray(v)) for k, v in
               state_dict_from_jax(start["params"]).items()}
    params = jax_sharding.shard_params(jax.tree.map(jax.numpy.asarray, start), mesh)
    assert any("model" in tuple(x.sharding.spec) for x in jax.tree.leaves(params))
    jtr.state = jtr.state.replace(params=params)
    ds = JaxWindowDataset(jax.numpy.asarray(walker_raw4()), past_len=CONVRNN_P,
                          future_len=CONVRNN_F, stride=5)
    losses, step = [], jtr._train_step

    def recording_step(state, batch, key):
        state, loss = step(state, batch, key)
        losses.append(float(loss))
        return state, loss

    jtr._train_step = recording_step
    jtr.fit(ds, epochs=1)
    trained = jax.tree.map(np.asarray, jtr.state.params)["params"]

    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text(yaml.safe_dump(
        convrnn_config(tmp_path, load_config).updated(_CONVRNN_FIT).to_dict()))
    (tmp_path / "world").mkdir()
    got = spawn_world(convrnn_tp_fit, 2, tmp_path / "world", str(cfg_path), weights)
    assert got["cut"] > 0
    assert got["empty"] and all(n.endswith("update_gate.weight") for n in got["empty"])
    np.testing.assert_allclose(got["history"]["step_loss"][0], losses, rtol=LOSS_RTOL)
    assert got["step"] == len(losses) == 3
    assert got["opt_lr"] == jax_get_learning_rate(jtr.state.opt_state)
    _assert_params_close(got["params"], trained, got["lr"], 3, "ConvRNN TP params")


# ---------------------------------------------------------------------------
# Four ranks against the plain fit
# ---------------------------------------------------------------------------

# ConvRNN at widths whose GRU gate convs are cut: the fused gate conv of
# (3, 3, 24 or 32, 32) outputs at 2 ranks leaves each rank one whole gate
# and none of the other (an empty parameter under DDP, FSDP and AMSGrad).
_CONVRNN_FIT = {"MODEL": {"CONVRNN": {"ENC_HIDDEN_CH": [8, 16, 16, 16, 16, 16],
                                      "FORC_HIDDEN_CH": [16, 16, 16, 16, 16, 16, 8]}}}


_FM_FIT = {"MODEL": {"FM": {"INTEGRATOR_STEPS": {"EULER": 10}}}}


def _fit_config(arch: str, root: Path):
    if arch == "ConvRNN":
        from crowdmod_tpu_torch.config import load_config

        return convrnn_config(root, load_config).updated(_CONVRNN_FIT)
    cfg = tiny_config(arch, root)
    # FM samples at the DDPM runs' 10 steps, not the config's Euler 1000.
    return cfg.updated(_FM_FIT) if arch.startswith("FM") else cfg


def _fit_data(arch: str):
    """12 windows, three batches of 4: the walkers (4 channels, 3 + 2
    frames for the ConvRNN)."""
    from crowdmod_tpu_torch.data.windows import WindowDataset

    if arch == "ConvRNN":
        return WindowDataset(torch.from_numpy(walker_raw4()), past_len=CONVRNN_P,
                             future_len=CONVRNN_F, stride=5)
    return walker_windows()


def _fits(tmp: Path, arch: str, plain_ckpt: str) -> dict:
    """A data 2 × model 2 world's DDP run, then its FSDP run (:func:`_fit`
    each, in directories of their own) → {mode: rank 0's results}."""
    out = {}
    for mode in ("tp", "fsdp"):
        (tmp / mode).mkdir(exist_ok=True)
        out[mode] = _fit(tmp / mode, arch, mode, plain_ckpt)
    return out


def _fit(tmp: Path, arch: str, mode: str | None, plain_ckpt: str | None = None) -> dict:
    """One rank's part of a data 2 × model 2 run (``mode`` "tp" or
    "fsdp"), or with ``mode`` None the plain run: step 1's gradients
    (gathered whole), a 3-step ``fit`` with ``evaluate`` (its best
    checkpoint saved), the weights and EMA, a ragged sample.  Under a mesh
    also: the parameters no axis cuts, every rank's, for the bitwise check;
    the checkpoint loaded back under TP; ``plain_ckpt`` resumed under TP."""
    from torch.distributed.tensor import DTensor

    from crowdmod_tpu_torch.parallel.mesh import make_mesh
    from crowdmod_tpu_torch.train import checkpoint as ckpt
    from crowdmod_tpu_torch.train.trainer import StepDraws

    cfg = _fit_config(arch, tmp)
    mesh = None if mode is None else make_mesh(data=2, model=2)
    rank = multiprocess.process_index()
    tr = Trainer(cfg, arch, device="cpu", seed=SEED, mesh=mesh,
                 param_sharding=mode or "tp", run_dir=str(tmp / f"run{rank}")).setup()
    ds = _fit_data(arch)
    first = next(ds.batches(BATCH, shuffle=True, seed=SEED + 1))
    draws = StepDraws(generator=torch.Generator().manual_seed(11))
    tr._loss_fn()(*tr._rank_args(first, draws)).backward()
    shards = tensor.model_shards(tr.model)
    whole = lambda g: g.full_tensor() if isinstance(g, DTensor) else g  # noqa: E731
    grads = {}
    for n, p in tr.model.named_parameters():
        g = whole(p.grad)
        grads[n] = (tensor.gather_weight(g, shards[n]) if n in shards else g).clone()
    tr.model.zero_grad(set_to_none=True)

    hist = tr.fit(ds, ds, epochs=1)
    out = dict(history=hist, grads=grads, lr=tr.plateau.lr, step=tr.state.step,
               params={k: v.clone() for k, v in tr.params.items()},
               ema={k: v.clone() for k, v in (tr.ema_params or {}).items()},
               empty=sorted(n for n, p in tr.model.named_parameters() if p.numel() == 0))
    past = ds.gather(np.arange(5))[0]  # 5 rows: ragged over 2 data indices
    out["sample"] = tr.sample(past, torch.Generator().manual_seed(7))
    out["ckpt"] = str(Path(cfg.DATA_FS.SAVE_DIR) / ckpt.checkpoint_name(cfg, arch, "000"))
    if mesh is None:
        return out
    local = lambda p: p.to_local() if isinstance(p, DTensor) else p  # noqa: E731
    uncut = {n: local(p).detach().clone() for n, p in tr.model.named_parameters()
             if n not in shards}
    out["uncut"] = _gather_all(uncut)
    out["cut"] = sorted(shards)
    again = Trainer(cfg, arch, device="cpu", seed=SEED + 1, mesh=mesh, param_sharding=mode,
                    run_dir=str(tmp / f"again{rank}"))
    again.load(out["ckpt"])
    out["reloaded"] = {k: v.clone() for k, v in again.params.items()}
    out["reloaded_step"] = again.state.step
    if plain_ckpt:
        own = cfg.updated({"DATA_FS": {"SAVE_DIR": str(tmp / "resumed_ckpts")}})
        resumed = Trainer(own, arch, device="cpu", seed=SEED + 2, mesh=mesh,
                          param_sharding=mode, run_dir=str(tmp / f"resumed{rank}"))
        resumed.load(plain_ckpt)
        out["resumed"] = {k: v.clone() for k, v in resumed.params.items()}
        out["resumed_ema"] = {k: v.clone() for k, v in (resumed.ema_params or {}).items()}
        out["resumed_step"] = resumed.state.step
        resumed.fit(ds, epochs=1)  # a step on the re-cut Adam state
        out["resumed_fit"] = resumed.state.step
    return out


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The runs by (arch, mode), made when first asked for: mode None is the
    plain run (in this process, one thread)."""
    cache = {}

    def get(arch, mode):
        if (arch, mode) not in cache:
            root = tmp_path_factory.mktemp(f"{arch}_{mode}")
            if mode is None:
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                try:
                    cache[arch, mode] = _fit(root, arch, None)
                finally:
                    torch.set_num_threads(threads)
            else:
                plain = get(arch, None)["ckpt"]
                both = spawn_world(_fits, 4, root, arch, plain)
                cache.update({(arch, m): run for m, run in both.items()})
        return cache[arch, mode]

    return get


CASES = [(a, m) for a in FIT_ARCHS for m in ("tp", "fsdp")]


def _close(got: dict, want: dict, rtol: float, label: str, noise=None, bound=None):
    top = max(float(v.abs().max()) for v in want.values())
    for name, w in want.items():
        diff = (got[name] - w).abs()
        if noise is not None:
            assert float(diff.max()) <= bound, (label, name)
            diff = torch.where(noise[name], 0.0, diff)
        assert float(diff.max()) <= rtol * top, (label, name, float(diff.max()), top)


@pytest.mark.parametrize("arch,mode", CASES)
def test_four_ranks_fit_as_the_plain_fit(fits, arch, mode):
    """Data 2 × model 2 (dropout 0.1 and the CFG drop on), DDP or FSDP
    over "data": step 1's gradients, the per-step, epoch and eval losses,
    the weights and EMA after 3 steps and a ragged 5-row sample equal the
    plain run's within 1e-5 of max|ref|; the same parameters are cut.  The
    ConvRNN's rank 0 holds none of each cut GRU's update gate."""
    got, want = fits(arch, mode), fits(arch, None)
    assert got["cut"]
    if arch == "ConvRNN":
        assert got["empty"] and all(n.endswith("update_gate.weight") for n in got["empty"])
        assert not want["ema"]
    _close(got["grads"], want["grads"], GRAD_RTOL, "grads")
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got["history"][key], want["history"][key], rtol=FIT_RTOL)
    np.testing.assert_allclose(got["history"]["step_loss"], want["history"]["step_loss"],
                               rtol=FIT_RTOL)
    assert got["step"] == want["step"] == 3 and got["lr"] == want["lr"]
    g_max = max(float(g.abs().max()) for g in want["grads"].values())
    noise = {n: g.abs() < NOISE_SCALE * g_max for n, g in want["grads"].items()}
    bound = 2 * want["lr"] * want["step"]
    for key in ("params", "ema") if want["ema"] else ("params",):
        _close(got[key], want[key], FIT_RTOL, key, noise, bound)
    ref = want["sample"]
    assert got["sample"].shape == ref.shape == (
        (5, CONVRNN_F, 8, 12, 4) if arch == "ConvRNN" else (5, 3, 8, 12, 3))
    assert float((got["sample"] - ref).abs().max()) <= FIT_RTOL * float(ref.abs().max())


@pytest.mark.parametrize("arch,mode", CASES)
def test_uncut_parameters_stay_equal_across_each_model_group(fits, arch, mode):
    """After 3 steps every parameter that the model axis leaves whole is
    bitwise the same on the two ranks of each model group (ranks 0, 1 and
    2, 3), under DDP and under FSDP (its local shards)."""
    ranks = fits(arch, mode)["uncut"]
    assert len(ranks) == 4 and ranks[0]
    for a, b in ((0, 1), (2, 3)):
        for name, t in ranks[a].items():
            assert torch.equal(t, ranks[b][name]), (a, b, name)


@pytest.mark.parametrize("arch,mode", CASES)
def test_tp_checkpoint_loads_plainly_into_jax_and_back(fits, arch, mode, tmp_path):
    """The TP run's checkpoint (gathered over both axes, written once)
    loads into a plain ``Trainer`` with the run's weights and step, through
    the JAX package's importer, and back under TP; a plain checkpoint
    resumes under TP (weights, EMA, step, the re-cut Adam state steps)."""
    got = fits(arch, mode)
    cfg = _fit_config(arch, tmp_path)
    plain = Trainer(cfg, arch, device="cpu", seed=SEED + 3)
    plain.load(got["ckpt"])
    for name, w in got["params"].items():
        assert torch.equal(plain.params[name], w), name
    for name, w in got["ema"].items():
        assert torch.equal(plain.ema_params[name], w), name
    assert plain.state.step == 3
    payload = torch.load(got["ckpt"] + "/state.pt", weights_only=True)
    torch.save({"model": payload["params"]}, tmp_path / "reference.pt")
    tree = import_torch_checkpoint(str(tmp_path / "reference.pt"), arch)["params"]
    back = state_dict_from_jax(jax.tree.map(np.asarray, tree))
    for name, w in back.items():
        assert torch.equal(torch.as_tensor(np.asarray(w)), got["params"][name]), name
    assert got["reloaded_step"] == 3
    for name, w in got["params"].items():
        assert torch.equal(got["reloaded"][name], w), name
    want = torch.load(fits(arch, None)["ckpt"] + "/state.pt", weights_only=True)
    assert got["resumed_step"] == want["step"] == 3 and got["resumed_fit"] == 6
    for name, w in want["params"].items():
        assert torch.equal(got["resumed"][name], w), name
    for name, w in want.get("ema_params", {}).items():
        assert torch.equal(got["resumed_ema"][name], w), name


def convrnn_data_fsdp(tmp: Path) -> dict:
    """A ConvRNN fit (with ``evaluate``) under FSDP over "data" alone, data
    2 → each saved weight's type and shape."""
    from crowdmod_tpu_torch.parallel.mesh import make_mesh
    from crowdmod_tpu_torch.train import checkpoint as ckpt

    cfg = _fit_config("ConvRNN", tmp)
    rank = multiprocess.process_index()
    tr = Trainer(cfg, "ConvRNN", device="cpu", seed=SEED, mesh=make_mesh(data=2),
                 param_sharding="fsdp", run_dir=str(tmp / f"run{rank}")).setup()
    ds = _fit_data("ConvRNN")
    tr.fit(ds, ds, epochs=1)
    path = Path(cfg.DATA_FS.SAVE_DIR) / ckpt.checkpoint_name(cfg, "ConvRNN", "000")
    payload = torch.load(path / "state.pt", weights_only=False)
    return {k: (type(v).__name__, tuple(v.shape)) for k, v in payload["params"].items()}


def test_fsdp_over_data_alone_saves_whole_convrnn_weights(fits, tmp_path):
    """The ConvRNN under FSDP with no model axis is all one root unit,
    which keeps its parameters gathered (plain tensors) after
    ``evaluate``'s forward while its state_dict still gives the shards:
    the checkpoint must hold whole plain tensors, the plain fit's shapes."""
    got = spawn_world(convrnn_data_fsdp, 2, tmp_path)
    want = torch.load(fits("ConvRNN", None)["ckpt"] + "/state.pt", weights_only=True)["params"]
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name] == ("Tensor", tuple(w.shape)), (name, got[name])


def test_shard_batch_and_replicate_act_on_the_data_axis(mesh_ranks):
    """On a 2 × 2 mesh ("model" inner: rank = 2·d + m) the rows, the gather
    and the mean go by the data index — both ranks of a model group take
    the same rows — and ``replicate`` broadcasts over "data" only: rank
    (1, m) gets (0, m)'s tensor, the model shards do not mix."""
    for rank, g in enumerate(mesh_ranks):
        d, m = divmod(rank, 2)
        assert g["coords"] == (d, m)
        assert torch.equal(g["rows"], torch.arange(4.0) + 4 * d)
        assert g["rank_rows"] == slice(4 * d, 4 * d + 4)
        assert torch.equal(g["gathered"], torch.tensor([float(m), 2.0 + m]))
        assert torch.equal(g["mean"], torch.tensor([1.0 + m]))
        assert torch.equal(g["replicated"], torch.full((2,), float(m) + 1.0))


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------

def cli_twin(tmp: Path, cfg_path: str, list_path: str) -> dict:
    """The command's run in process: a ``Trainer`` on a data 1 × model 2
    mesh over the workspace's training set, DDP then FSDP → each one's
    gathered weights."""
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.data.ingest import get_training_dataset
    from crowdmod_tpu_torch.parallel.mesh import mesh_from_config

    cfg = load_config(cfg_path, list_path)
    out = {}
    for mode in ("tp", "fsdp"):
        run = cfg.updated({"DATA_FS": {"SAVE_DIR": str(tmp / mode)}})
        tr = Trainer(run, "DDPM-UNet", device="cpu", seed=42,
                     mesh=mesh_from_config(run, 2), param_sharding=mode,
                     run_dir=str(tmp / f"{mode}_run{multiprocess.process_index()}"))
        train_ds, val_ds = get_training_dataset(run, 3, seed=42, device=tr.device)
        tr.fit(train_ds, val_ds)
        out[mode] = {k: v.clone() for k, v in tr.params.items()}
    return out


def test_train_model_parallel_command_on_the_cpu(tmp_path):
    """``train --data-parallel --model-parallel 2 [--fsdp] --device cpu``
    spawns a world of 2 (one process a model rank on the CPU), logs the
    mesh, trains and finds the uncut parameters equal across the model
    group; each checkpoint's weights equal an in-process TP trainer's on
    the same data and seed, bit for bit."""
    from crowdmod_tpu_torch.train import checkpoint as ckpt

    cfg_path, list_path = _workspace(tmp_path)
    procs = {}
    for mode, flags in (("tp", []), ("fsdp", ["--fsdp"])):
        save = tmp_path / f"cli_{mode}"
        import yaml

        run_cfg = tmp_path / f"cfg_{mode}.yml"
        data = yaml.safe_load(Path(cfg_path).read_text())
        data["DATA_FS"]["SAVE_DIR"] = str(save)
        data["DATA_FS"]["OUTPUT_DIR"] = str(tmp_path / f"out_{mode}")
        run_cfg.write_text(yaml.safe_dump(data))
        procs[mode] = (save, _cli("train", "--config-yml-file", str(run_cfg),
                                  "--configList-yml-file", list_path, "--arch", "DDPM-UNet",
                                  "--device", "cpu", "--data-parallel",
                                  "--model-parallel", "2", *flags))
    (tmp_path / "twin").mkdir()
    twin = spawn_world(cli_twin, 2, tmp_path / "twin", cfg_path, list_path)
    for mode, (save, p) in procs.items():
        out = p.communicate(timeout=300)[0]
        assert p.returncode == 0, out
        assert "mesh: {'data': 1, 'model': 2}" in out, out
        assert '"uncut_equal": true' in out, out
        assert ("FSDP" if mode == "fsdp" else "DDP") in out
        state = save / "DDPM-UNet_ATC4TEST_TE1_PL5_FL3_CE000_NA"
        payload, _ = ckpt.load_checkpoint(state)
        assert set(payload["params"]) == set(twin[mode])
        for name, w in twin[mode].items():
            assert torch.equal(payload["params"][name], w), (mode, name)
