"""Port parity of the bench tools' workloads: ``bench_torch.py``'s timed
callable (``chain``: ``Trainer.sample`` as a request runs it) against the
JAX package's ``ddpm_sample`` over the same weights and draws, and
``tools/bench_multichip_torch.py --virtual 2`` on gloo.

The bench models are cut to a narrow width (DiT hidden 32, depth 1; UNet
base 8, two levels, attention at level 1) at ``bench.py``'s ATC grid, T =
10, batch 2, float32 on the CPU.  The port's weights (seeded, perturbed so
the zero-initialised DiT outputs are not 0) cross into the JAX tree through
the JAX package's own importer (``import_torch_checkpoint``); the JAX draws
(x_T from ``split(key)[0]``, step t's from ``fold_in(split(key)[1], t)``)
are injected into the port's chain.  The JAX UNet's level-0 blocks take its
fused-resblock path as its own CPU tests run it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from crowdmod_tpu.compat.torch_import import import_torch_checkpoint
from crowdmod_tpu.core import schedule as jax_schedule
from crowdmod_tpu.models.backbones.dit import DiT4DFactorized as JaxDiT
from crowdmod_tpu.models.backbones.unet3d import UNet3D as JaxUNet
from crowdmod_tpu.models.diffusion import ddpm as jax_ddpm

REPO = Path(__file__).resolve().parents[1]
T, BATCH = 10, 2
SHAPE = (BATCH, bench_torch.F, bench_torch.H, bench_torch.W, bench_torch.C)
CHAIN_ATOL = 1e-4
NARROW = {"MODEL": {"DDPM": {
    "DIT": {"HIDDEN_SIZE": 32, "DEPTH": 1},
    "UNET": {"BASE_CH": 8, "BASE_CH_MULT": [1, 2], "APPLY_ATTENTION": [False, True]}}}}
JAX_MODELS = {
    "DDPM-DiT": lambda: JaxDiT(
        out_channels=3, grid_rows=12, grid_cols=36, patch_size=4, hidden_size=32,
        depth=1, num_heads=4, mlp_ratio=4.0, dropout_rate=0.1, time_multiple=4,
        past_len=5, future_len=3, t_patch_size=4),
    "DDPM-UNet": lambda: JaxUNet(
        out_channels=3, base_channels=8, base_channels_multiples=(1, 2),
        apply_attention=(False, True), dropout_rate=0.1),
}


def jax_noise(key):
    """The JAX sampler's draws as the port's ``noise`` callable."""
    k_init, k_loop = jax.random.split(key)
    draws = {None: jax.random.normal(k_init, SHAPE, jnp.float32)}
    for t in range(T):
        draws[t] = jax.random.normal(jax.random.fold_in(k_loop, t), SHAPE, jnp.float32)
    return lambda t: torch.from_numpy(np.array(draws[t]))


@pytest.mark.parametrize("arch", sorted(JAX_MODELS))
def test_bench_chain_matches_jax_ddpm_sample(arch, tmp_path):
    cfg = bench_torch.bench_config(T, overrides=NARROW)
    trainer = bench_torch.bench_trainer(cfg, arch, "cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    path = tmp_path / "model.pt"
    torch.save(trainer.model.state_dict(), path)
    params = import_torch_checkpoint(str(path), arch)["params"]

    key = jax.random.PRNGKey(7)
    got = bench_torch.chain(trainer, BATCH, noise=jax_noise(key))().numpy()
    jmodel = JAX_MODELS[arch]()
    past = jnp.zeros((BATCH, 5, 12, 36, 3), jnp.float32)
    want = np.asarray(jax_ddpm.ddpm_sample(
        lambda x, t, c: jmodel.apply({"params": params}, x, t, c),
        jax_schedule.linear_schedule(T, scale=0.5), past, key, SHAPE))
    assert got.shape == want.shape == SHAPE
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=CHAIN_ATOL, rtol=0)


def test_bench_multichip_virtual_2_on_gloo():
    """Meshes of 1 and 2 gloo processes: each process holds batch/N rows,
    finite samples and losses, and at N = 2 FSDP2's all-gather and
    reduce-scatter and DDP's all-reduce ran (the tool asserts all of it);
    its report keeps the JAX tool's keys plus the twin's declared ones."""
    import tools.bench_multichip_torch as mc

    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    out = subprocess.run(
        [sys.executable, "tools/bench_multichip_torch.py", "--virtual", "2",
         "--batch-per-chip", "2"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(report) == set(mc.REPORT_KEYS) | set(mc.ADDED_KEYS)
    assert [r["mesh"] for r in report["rows"]] == [1, 2]
    for row in report["rows"]:
        assert set(row) == set(mc.VIRTUAL_ROW_KEYS) | {"train_ddp_samples_per_sec",
                                                        "ddp_collectives"}
        assert row["ok"] is True
    two = report["rows"][1]
    assert two["collectives"]["all-gather"] > 0 and two["collectives"]["reduce-scatter"] > 0
    assert two["ddp_collectives"]["all-reduce"] > 0
