"""Shared by ``tests/test_torch_geometries*.py`` (not collected): each
bundled dataset config at a narrow width, a denoiser of it built by both
packages with the same weights, the port's kernel call sites recorded
during a forward, and the JAX package's fused-block decisions.

The grids are those of ``tools/sample_all_datasets.sh``'s configs (each
"-OBST" config shares its base config's grid and widths) and ATC_medium's.
Narrow: UNet ``BASE_CH`` 8, DiT hidden 64 and depth 2, batch 2; every other
setting (frames, grid, channel multiples, attention levels, heads, patches)
the config's own.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from crowdmod_tpu.config import load_config as jax_load_config
from crowdmod_tpu.models.backbones import fused_apply as jax_fused_apply
from crowdmod_tpu.models.factory import build_backbone as jax_build_backbone
from crowdmod_tpu_torch.compat.jax_params import state_dict_from_jax
from crowdmod_tpu_torch.config import load_config
from crowdmod_tpu_torch.models.factory import build_backbone

GRIDS = ("ATC", "ETHUCY", "HERMES-BO", "HERMES-BN", "HERMES-CR-90", "HERMES-CR-120",
         "ATC_medium")
ARCHS = ("DDPM-UNet", "DDPM-DiT", "FM-DiT", "FM-UNet")
NARROW = {"MODEL": {
    "DDPM": {"UNET": {"BASE_CH": 8}, "DIT": {"HIDDEN_SIZE": 64, "DEPTH": 2}},
    "FM": {"UNET": {"BASE_CH": 8}, "DIT": {"HIDDEN_SIZE": 64, "DEPTH": 2}}}}
BATCH = 2
FORWARD_ATOL = 1e-4  # as tests/test_torch_unet.py


def configs(name: str):
    """``configs/<name>.yml`` at the narrow width, as each package loads it."""
    return (jax_load_config(f"{name}.yml").updated(NARROW),
            load_config(f"{name}.yml").updated(NARROW))


def inputs(cfg, seed: int):
    """A future, t and a past at batch 2 of ``cfg``'s grid (numpy).  t is
    float32 for every arch (whole numbers, DDPM steps too: both packages'
    time embeddings take floats), so the two UNets of a narrow config are
    one JAX program, compiled once."""
    rng = np.random.default_rng(seed)
    p, f = cfg.DATASET.PAST_LEN, cfg.DATASET.FUTURE_LEN
    h, w = cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS
    future = rng.normal(size=(BATCH, f, h, w, 3)).astype(np.float32)
    past = rng.normal(size=(BATCH, p, h, w, 3)).astype(np.float32)
    return future, np.array([3.0, 617.0], np.float32), past


def random_params(model, args, seed: int):
    """Weights for the JAX ``model`` from its shapes alone (no init
    compile): GroupNorm/LayerNorm scales 1 + N(0, 0.1²), biases N(0, 0.1²),
    kernels N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *(jnp.asarray(a) for a in args))["params"]

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1])) or 1
        return (rng.normal(size=s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@contextlib.contextmanager
def recording():
    """Every call the port's models make to a kernel wrapper, by call site:
    ``{"attention": [(problems, heads, Sq, Sk, Dh)], "gn": [(x shape,
    silu)], "conv": [(x shape, out shape)], "resblock": [(x shape, out
    shape)]}``; the wrappers run as they would (their twins, on the CPU)."""
    import crowdmod_tpu_torch.models.backbones.fused_apply as fused_mod
    import crowdmod_tpu_torch.ops.attention as attn_mod
    import crowdmod_tpu_torch.ops.conv3d as conv_mod
    import crowdmod_tpu_torch.ops.norm as norm_mod

    calls = {"attention": [], "gn": [], "conv": [], "resblock": []}
    sites = [(attn_mod, "fused_attention", "attention"), (norm_mod, "fused_group_norm", "gn"),
             (conv_mod, "conv3d_same", "conv"), (fused_mod, "fused_resblock", "resblock")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]

    def wrap(fn, kind):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            x = args[0]
            if kind == "attention":  # (B·…, H, Sq, Sk, Dh)
                calls[kind].append((*x.shape[:3], args[1].shape[2], x.shape[3]))
            elif kind == "gn":
                calls[kind].append((tuple(x.shape), bool(kwargs["silu"])))
            else:
                calls[kind].append((tuple(x.shape), tuple(out.shape)))
            return out
        return call

    try:
        for mod, name, kind in sites:
            setattr(mod, name, wrap(getattr(mod, name), kind))
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def unet_calls(calls, levels) -> dict:
    """Recorded UNet calls in :func:`chip_smoke.unet_shape_tables`' terms:
    conv and gn keyed by level, the fused blocks in order, attention by
    (tokens, heads, Dh)."""
    level_of = {tuple(g): lv for lv, g in levels.items()}
    volume_of = {int(np.prod(g)): lv for lv, g in levels.items()}
    out = {"conv": {}, "gn": {}, "attention": {}}
    for x, y in calls["conv"]:
        key = (level_of[x[1:4]], x[-1], y[-1])
        out["conv"][key] = out["conv"].get(key, 0) + 1
    for x, silu in calls["gn"]:
        key = (volume_of[int(np.prod(x[1:-1]))], x[-1], silu)
        out["gn"][key] = out["gn"].get(key, 0) + 1
    for b, h, s, sk, dh in calls["attention"]:
        key = (s, h, dh)
        out["attention"][key] = out["attention"].get(key, 0) + 1
    out["resblock"] = [(x[-1], y[-1]) for x, y in calls["resblock"]]
    return out


def jax_fused_blocks(model, params, args) -> list:
    """(Cin, Cout) of every ResnetBlock3D the JAX package's
    ``fused_unet_apply`` routes to its kernel (``_eligible``), in call
    order, from an abstract trace (nothing compiled or run)."""
    chosen = []
    eligible = jax_fused_apply._eligible

    def spy(mod, x, deterministic):
        ok = eligible(mod, x, deterministic)
        if ok:
            chosen.append((int(x.shape[-1]), int(mod.out_channels)))
        return ok

    jax_fused_apply._eligible = spy
    try:
        jax.eval_shape(lambda p, *a: jax_fused_apply.fused_unet_apply(
            model, {"params": p}, *a), params, *(jnp.asarray(a) for a in args))
    finally:
        jax_fused_apply._eligible = eligible
    return chosen


def check_forward(name: str, arch: str) -> dict:
    """One f32 CPU forward of ``arch`` at ``name``'s grid by both packages
    (the JAX weights carried by ``state_dict_from_jax``): the outputs within
    :data:`FORWARD_ATOL`; the port's kernel calls equal to
    :func:`chip_smoke.unet_shape_tables` (UNet; and its fused blocks to the
    JAX ``_eligible``'s) or :func:`chip_smoke.dit_attention_shapes` (DiT)
    → the port's recorded calls."""
    jcfg, cfg = configs(name)
    args = inputs(cfg, seed=len(name))
    jmodel = jax_build_backbone(jcfg, arch)
    params = random_params(jmodel, args, seed=len(name) + len(arch))
    want = np.asarray(jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))(params, *args))
    model = build_backbone(cfg, arch).eval()
    model.load_state_dict(state_dict_from_jax(params))
    with recording() as calls, torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == want.shape == (BATCH, cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS,
                                       cfg.MACROPROPS.COLS, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)
    if arch.endswith("UNet"):
        tables = chip_smoke.unet_shape_tables(cfg, arch)
        got_tables = unet_calls(calls, tables["levels"])
        for kind in ("conv", "gn", "attention", "resblock"):
            assert got_tables[kind] == tables[kind], kind
        assert jax_fused_blocks(jmodel, params, args) == tables["resblock"]
    else:
        shapes = chip_smoke.dit_attention_shapes(cfg, arch, BATCH)
        counted = {}
        for key in calls["attention"]:
            counted[key] = counted.get(key, 0) + 1
        assert counted == shapes
        assert not (calls["gn"] or calls["conv"] or calls["resblock"])
    return calls
