"""The port's bench tools (``bench_torch.py``, ``tools/bench_*_torch.py``,
``tools/profile_sampler_torch.py``) against the JAX repo's: the same
workloads (``CASES``, the conv shapes, ``GEOMETRY_CONFIGS``, ``SECTIONS``
and the suite's metrics, read from the JAX sources with ``ast`` where they
live inside a function), the same models (parameter counts against
``jax.eval_shape`` of the JAX models' ``init``, built from ``bench.py``'s
own constructor calls), the same flags and defaults plus ``--device`` (the
dropped ones named), the same report keys plus each twin's declared
additions, and every twin raising under ``--device cuda`` on a host
without a card.  The cheap twins also run on the CPU at a narrow size, and
their reports carry exactly the declared keys.
"""

import ast
import contextlib
import importlib
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import bench_torch

REPO = Path(__file__).resolve().parents[1]
# twin module → (the JAX file, the JAX flags it drops, its own internal flags)
TWINS = {
    "bench_torch": ("bench.py", (), ()),
    "tools.bench_suite_torch": ("tools/bench_suite.py", (), ()),
    "tools.bench_serving_torch": ("tools/bench_serving.py", (), ()),
    "tools.bench_batch_scaling_torch": ("tools/bench_batch_scaling.py", (), ()),
    "tools.bench_geometries_torch": ("tools/bench_geometries.py", (), ()),
    "tools.bench_conv_kernel_torch": ("tools/bench_conv_kernel.py", (), ()),
    "tools.bench_resblock_torch": ("tools/bench_resblock.py", (), ()),
    "tools.bench_unet_sampler_torch": ("tools/bench_unet_sampler.py", (), ()),
    "tools.profile_sampler_torch": ("tools/profile_sampler.py", ("--pallas", "--unroll"), ()),
    "tools.bench_multichip_torch": ("tools/bench_multichip.py", (), ("--mesh", "--rows-file")),
}
# Defaults that name a JAX lowering, mapped to the port's conv kernels; the
# serving twin's fixed work directory, a new one a run (no run serves
# another's checkpoint).
MAPPED_DEFAULTS = {("tools.bench_unet_sampler_torch", "--impls"): (
    ["direct", "pallas"], ["im2col", "tapgemm"]),
    ("tools.bench_serving_torch", "--workdir"): ("/tmp/bench_serving", None)}
# Arguments that keep a twin's call from writing outside the test's directory.
ARGS = {"tools.bench_serving_torch": ["--workdir", "{tmp}"]}


def _tree(path) -> ast.Module:
    return ast.parse((REPO / path).read_text())


def _assigned(tree, name):
    """The literal assigned to ``name`` anywhere in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def _flags(path) -> dict:
    """``--flag`` → its literal default (None where not a literal)."""
    flags = {}
    for node in ast.walk(_tree(path)):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            default = next((k.value for k in node.keywords if k.arg == "default"), None)
            try:
                flags[node.args[0].value] = ast.literal_eval(default) if default else None
            except ValueError:
                flags[node.args[0].value] = None
    return flags


def _dict_keys(tree, where=lambda node: True) -> list[set]:
    """The key sets of the dict literals in ``tree`` that ``where`` takes."""
    return [{k.value for k in node.keys if isinstance(k, ast.Constant)}
            for node in ast.walk(tree) if isinstance(node, ast.Dict) and where(node)]


def _path_of(module: str) -> str:
    return module.replace(".", "/") + ".py"


def test_workloads_match_the_jax_tools():
    from tools import (bench_conv_kernel_torch, bench_geometries_torch,
                       bench_resblock_torch, bench_suite_torch,
                       bench_unet_sampler_torch)

    assert bench_resblock_torch.CASES == [tuple(c) for c in _assigned(
        _tree("tools/bench_resblock.py"), "CASES")]
    assert bench_resblock_torch.B == _assigned(_tree("tools/bench_resblock.py"), "B")
    conv = _tree("tools/bench_conv_kernel.py")
    assert bench_conv_kernel_torch.SHAPES == [tuple(s) for s in _assigned(conv, "shapes")]
    b, t, h, w = (bench_conv_kernel_torch.B, bench_conv_kernel_torch.T,
                  bench_conv_kernel_torch.H, bench_conv_kernel_torch.W)
    assert (b, t, h, w) == (64, 3, 12, 36)
    for node in ast.walk(conv):  # `b, t, h, w = 64, 3, 12, 36` inside main()
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple) and \
                [e.id for e in node.targets[0].elts] == ["b", "t", "h", "w"]:
            assert ast.literal_eval(node.value) == (b, t, h, w)
    assert bench_geometries_torch.GEOMETRY_CONFIGS == _assigned(
        _tree("tools/bench_geometries.py"), "GEOMETRY_CONFIGS")
    suite = _tree("tools/bench_suite.py")
    assert bench_suite_torch.SECTIONS == _assigned(suite, "SECTIONS")
    metrics = [node.args[0].value for node in ast.walk(suite)
               if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "report"
               and isinstance(node.args[0], ast.Constant)]
    assert bench_suite_torch.METRICS == tuple(metrics)
    cases = _assigned(_tree("tools/bench_unet_sampler.py"), "cases")
    assert bench_unet_sampler_torch.CONV_CASES == [tuple(c) for c in cases]


def _jax_bench_models() -> dict:
    """``bench.py``'s two constructor calls, evaluated with its names."""
    from crowdmod_tpu.models.backbones.dit import DiT4DFactorized
    from crowdmod_tpu.models.backbones.unet3d import UNet3D

    names = {"c": 3, "h": 12, "w": 36, "p": 5, "f": 3, "compute_dtype": jnp.float32}
    ctors = {"DiT4DFactorized": DiT4DFactorized, "UNet3D": UNet3D}
    models = {}
    for node in ast.walk(_tree("bench.py")):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") in ctors:
            kw = {k.arg: (names[k.value.id] if isinstance(k.value, ast.Name)
                          else ast.literal_eval(k.value)) for k in node.keywords}
            models[node.func.id] = ctors[node.func.id](**kw)
    assert set(models) == set(ctors)
    return models


def test_bench_models_have_the_jax_models_parameter_counts():
    """11.7M and 7.2M: the port's models built from ``bench_config`` against
    ``jax.eval_shape`` of the JAX models' ``init`` (nothing compiled)."""
    b, p, f, h, w, c = bench_torch.B, bench_torch.P, bench_torch.F, bench_torch.H, \
        bench_torch.W, bench_torch.C
    assert (b, p, f, h, w, c) == (64, 5, 3, 12, 36, 3)
    cfg = bench_torch.bench_config(10)
    for name, model in _jax_bench_models().items():
        shapes = jax.eval_shape(
            model.init, jax.random.PRNGKey(0), jnp.zeros((b, f, h, w, c)),
            jnp.zeros((b,)), jnp.zeros((b, p, h, w, c)))
        want = sum(int(jnp.prod(jnp.array(x.shape))) for x in jax.tree.leaves(shapes))
        arch = {"DiT4DFactorized": "DDPM-DiT", "UNet3D": "DDPM-UNet"}[name]
        tr = bench_torch.bench_trainer(cfg, arch, "cpu")
        assert sum(p.numel() for p in tr.model.parameters()) == want, name
    assert cfg.MODEL.DDPM.SAMPLER == "DDPM" and cfg.MODEL.DDPM.SCALE == 0.5
    assert cfg.MODEL.DDPM.GUIDANCE == "None" and cfg.TPU.COMPUTE_DTYPE == "bfloat16"


@pytest.mark.parametrize("module", sorted(TWINS))
def test_flags_are_the_jax_tools_plus_device(module):
    jax_file, dropped, internal = TWINS[module]
    want, got = _flags(jax_file), _flags(_path_of(module))
    assert set(got) == (set(want) - set(dropped)) | {"--device"} | set(internal)
    assert got["--device"] == "cuda"
    for flag in set(want) & set(got):
        jax_default, port_default = MAPPED_DEFAULTS.get((module, flag),
                                                        (want[flag], want[flag]))
        assert jax_default == want[flag] and got[flag] == port_default, flag


def test_report_keys_match_the_jax_tools():
    from tools import (bench_batch_scaling_torch, bench_conv_kernel_torch,
                       bench_geometries_torch, bench_multichip_torch,
                       bench_serving_torch, bench_suite_torch,
                       bench_unet_sampler_torch)

    record = _tree("bench.py")
    keys = set().union(*_dict_keys(record))
    keys |= {node.slice.value for node in ast.walk(record) if isinstance(node, ast.Subscript)
             and getattr(node.value, "id", "") == "record" and isinstance(node.ctx, ast.Store)}
    assert keys == set(bench_torch.REPORT_KEYS)
    assert set(bench_suite_torch.REPORT_KEYS) in _dict_keys(_tree("tools/bench_suite.py"))
    serving = _dict_keys(_tree("tools/bench_serving.py"))
    for twin_keys in (bench_serving_torch.REPORT_KEYS, bench_serving_torch.SAMPLER_KEYS,
                      bench_serving_torch.BUCKET_KEYS):
        assert set(twin_keys) in serving
    for module, path in ((bench_batch_scaling_torch, "tools/bench_batch_scaling.py"),
                         (bench_geometries_torch, "tools/bench_geometries.py")):
        assert set(module.REPORT_KEYS) in _dict_keys(_tree(path))
    multichip = [k for k in _dict_keys(_tree("tools/bench_multichip.py")) if "mesh" in k
                 or "rows" in k]
    for twin_keys in (bench_multichip_torch.REPORT_KEYS, bench_multichip_torch.ROW_KEYS,
                      bench_multichip_torch.VIRTUAL_ROW_KEYS):
        assert set(twin_keys) in multichip
    conv = _tree("tools/bench_conv_kernel.py")
    jax_columns = {node.slice.value for node in ast.walk(conv) if isinstance(node, ast.Subscript)
                   and getattr(node.value, "id", "") == "res" and isinstance(node.ctx, ast.Store)}
    assert jax_columns == set(bench_conv_kernel_torch.COLUMNS)
    variants = _dict_keys(_tree("tools/bench_unet_sampler.py"),
                          lambda node: any(getattr(k, "value", "") == "xla32"
                                           for k in node.keys))
    assert variants == [set(bench_unet_sampler_torch.COLUMNS)]


@pytest.mark.parametrize("module", sorted(TWINS))
def test_twins_raise_without_a_card(module, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.format(tmp=tmp_path / "out") for a in ARGS.get(module, [])]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        importlib.import_module(module).main([*argv, "--device", "cuda"])
    assert not (tmp_path / "out").exists()


def test_conv_shapes_have_kernel_plans():
    """Every shape of the conv table, Cin = 3 at T = 3 too, has a plan of
    the im2col kernel in both dtypes that fits a block (the wrapper's
    ``_check`` takes any channel count; bf16 Cin = 3 comes by element loads
    in the packed 8-channel stages)."""
    from crowdmod_tpu_torch.ops.kernels.conv3d import SMEM_LIMIT, im2col_plan
    from tools.bench_conv_kernel_torch import B, SHAPES, volume

    for cin, cout in SHAPES:
        shape = (B, *volume(cin, cout), cin)
        assert im2col_plan(shape, cout, torch.float32).route == "simt"
        plan = im2col_plan(shape, cout, torch.bfloat16)
        assert plan.route == "halo" and plan.smem_bytes <= SMEM_LIMIT
        assert plan.tma_x == (cin % 8 == 0) and (cin != 3 or plan.kc == 8)


def test_calibration_peak_is_the_cards_own():
    from tools.bench_unet_sampler_torch import card_peak

    assert card_peak("NVIDIA H100 80GB HBM3, 700.00 W") == 989.4
    with pytest.raises(SystemExit, match="no published bf16 peak"):
        card_peak("Some Other Card, 300.00 W")


def _run(module: str, argv: list, monkeypatch, **small) -> list:
    """``module``'s main on the CPU with ``small`` module constants → the
    JSON objects it printed."""
    mod = importlib.import_module(module)
    for name, value in small.items():
        monkeypatch.setattr(mod, name, value)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main([*argv, "--device", "cpu"]) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]


def test_cheap_twins_report_their_declared_keys(monkeypatch):
    """The conv and resblock tables at batch 2 (every shape, every case:
    the kernels' CPU twins against themselves), ``bench_torch.py`` at the
    narrow widths: each report has exactly the declared keys."""
    from tools import bench_conv_kernel_torch as conv
    from tools import bench_resblock_torch as res

    (rec,) = _run("tools.bench_conv_kernel_torch", [], monkeypatch, B=2, ITERS=1)
    assert set(rec) == set(conv.REPORT_KEYS) and len(rec["rows"]) == len(conv.SHAPES)
    assert all(set(r) == set(conv.ROW_KEYS) and set(r["us"]) == set(conv.COLUMNS.values())
               for r in rec["rows"])
    (rec,) = _run("tools.bench_resblock_torch", [], monkeypatch, B=2, ITERS=1)
    assert set(rec) == set(res.REPORT_KEYS) and len(rec["rows"]) == len(res.CASES)
    assert [r["fused_us"] is None for r in rec["rows"]] == [
        t * h * w < 128 for _, _, _, t, h, w in res.CASES]
    assert all(set(r) == set(res.ROW_KEYS) for r in rec["rows"])

    narrow = bench_torch.bench_config

    def config(timesteps, **kw):
        return narrow(timesteps, overrides={"MODEL": {"DDPM": {
            "DIT": {"HIDDEN_SIZE": 32, "DEPTH": 1},
            "UNET": {"BASE_CH": 8, "BASE_CH_MULT": [1, 2],
                     "APPLY_ATTENTION": [False, True]}}}})

    monkeypatch.setattr(bench_torch, "bench_config", config)
    monkeypatch.setattr(bench_torch.measure, "__defaults__", (2, 1))
    (rec,) = _run("bench_torch", [], monkeypatch)
    assert set(rec) == set(bench_torch.REPORT_KEYS) | set(bench_torch.ADDED_KEYS)
    assert rec["vs_baseline"] is None and rec["backend"] == "cpu"
    assert rec["value"] > 0 and rec["unet_steps_per_sec"] > 0


@pytest.mark.parametrize("warmup", [True, False])
def test_time_calls_counts_its_calls(warmup):
    """On the CPU: the warm-up call (unless the caller made one), then
    ``reps`` × ``iters`` timed calls; no busy share without a card."""
    from crowdmod_tpu_torch.utils.profiling import time_calls

    calls = []
    t = time_calls(lambda: calls.append(1), reps=3, iters=2, device="cpu", warmup=warmup)
    assert len(calls) == warmup + 3 * 2 and len(t["reps_s"]) == 3
    assert t["seconds"] == min(t["reps_s"]) and t["busy_share"] is None
    assert t["kernel_s"] is None and (t["first_s"] is not None) == warmup


def test_serving_workdir_is_new_each_run(monkeypatch, tmp_path):
    """Without ``--workdir`` each run trains into a directory of its own
    under the temporary directory: no run serves another's checkpoint."""
    import tempfile

    import tools.soak_http_torch as soak
    from tools import bench_serving_torch

    seen = []

    def stop(cfg, arch, workdir, epochs, device):
        seen.append(Path(workdir))
        raise KeyboardInterrupt

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(soak, "ensure_checkpoint", stop)
    for _ in range(2):
        with pytest.raises(KeyboardInterrupt):
            bench_serving_torch.main(["--device", "cpu"])
    assert len(set(seen)) == 2 and all(p.parent == tmp_path for p in seen)
