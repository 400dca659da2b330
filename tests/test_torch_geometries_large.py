"""Every bundled dataset's geometry on the port, held on the CPU: the
grids HERMES-CR-90, HERMES-CR-120 and ATC_medium (the rest, with the
tables and the plans, in ``tests/test_torch_geometries.py``), and torch
replays of the kernels' arithmetic at the shapes these configs give them:

  * each arch's f32 forward at batch 2 and a narrow width on each grid
    against the JAX package's, within 1e-4, the kernel wrappers' calls a
    forward equal to ``chip_smoke.unet_shape_tables`` and the JAX
    ``_eligible``'s (the UNets) or ``dit_attention_shapes`` (the DiTs);
  * the wgmma attention's tiles and sums at FM-DiT's 120, 144 and 224 keys
    (a last 64-row query tile partly live at each; one warpgroup, keys
    padded to 128, 160 and 224) and the UNet's level-2 84 keys at Dh 32
    and 108 at Dh 64, against the twin and the JAX Pallas kernel in
    interpret mode;
  * the fused resblock's halo tiles, chunks, taps and GN partials at
    Cout 64 (ATC_medium's 64→64 and 192→64: N = 64, two 32-column atoms),
    against the twin and the JAX Pallas kernel in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from crowdmod_tpu.ops.pallas.resblock import fused_resblock as jax_fused_resblock
from crowdmod_tpu_torch.ops.kernels import attention_reference, resblock_reference
from crowdmod_tpu_torch.ops.kernels.attention import attention_plan
from crowdmod_tpu_torch.ops.kernels.resblock import resblock_plan
from tests import torch_geometries as geo
from tests.test_torch_attention_plan import _wgmma_replay
from tests.test_torch_resblock_plan import _resblock_replay

GRIDS = ("HERMES-CR-90", "HERMES-CR-120", "ATC_medium")
CASES = [(g, a) for g in GRIDS for a in geo.ARCHS]
# (keys = queries, Dh, warpgroups splitting the keys, NK a warpgroup)
WGMMA = {"fm_dit_s120": (120, 64, 1, 128), "fm_dit_s144": (144, 64, 1, 160),
         "fm_dit_s224": (224, 64, 1, 224), "unet_s84_dh32": (84, 32, 1, 128),
         "unet_s108_dh64": (108, 64, 1, 128)}


@pytest.mark.parametrize("name,arch", CASES, ids=[f"{g}-{a}" for g, a in CASES])
def test_forward_and_kernel_calls_match_jax(name, arch):
    geo.check_forward(name, arch)


@pytest.mark.parametrize("case", WGMMA)
def test_wgmma_replay_at_the_configs_tokens(case):
    """2 problems of 4 heads at each token count: the plan (wgmma, one
    warpgroup, the keys padded to its NK, a last query tile partly live),
    and its replay equal to the twin and the JAX Pallas kernel, bf16 in
    and out, within two bf16 ulps of the output's scale."""
    sk, dh, split, nk = WGMMA[case]
    rng = np.random.default_rng(sk * dh)
    q, k, v = (rng.normal(size=(2, 4, sk, dh)).astype(np.float32) for _ in range(3))
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    plan = attention_plan(2, 4, sk, sk, dh, torch.bfloat16)
    assert (plan.route, plan.key_split, plan.key_block) == ("wgmma", split, nk)
    assert sk % plan.query_tile and nk >= sk
    scale = dh ** -0.5
    got = _wgmma_replay(qb, kb, vb, scale, plan)
    twin = attention_reference(qb, kb, vb, scale).float()
    jax_out = jax_fused_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                  scale=scale, mode="interpret")
    jax_out = np.array(jax_out.astype(jnp.float32))
    tol = 2 * 2.0 ** -8 * float(twin.abs().max())
    np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=0, atol=tol)


@pytest.mark.parametrize("cin", [64, 192])
def test_resblock_replay_at_cout_64(cin):
    """ATC_medium's level-0 blocks at Cout 64, 64→64 (the identity skip)
    and 192→64 (the 1×1 skip as extra K; ``resblock_plan``'s N = 64
    block) on a small volume (2 samples of 4 × 6 × 8, two tiles each):
    the replay equals the f32 twin and the JAX Pallas kernel in interpret
    mode within 1e-5 of max|ref|."""
    cout = 64
    rng = np.random.default_rng(cin)
    n = lambda shape, sc: (rng.normal(size=shape) * sc).astype(np.float32)  # noqa: E731
    w = {"gn1_scale": 1 + n((cin,), 0.1), "gn1_bias": n((cin,), 0.1),
         "w1": n((3, 3, 3, cin, cout), (27 * cin) ** -0.5), "b1": n((cout,), 0.1),
         "gn2_scale": 1 + n((cout,), 0.1), "gn2_bias": n((cout,), 0.1),
         "w2": n((3, 3, 3, cout, cout), (27 * cout) ** -0.5), "b2": n((cout,), 0.1)}
    if cin != cout:
        w["w_skip"] = n((1, 1, 1, cin, cout), cin ** -0.5)
        w["b_skip"] = n((cout,), 0.1)
    x, temb = n((2, 4, 6, 8, cin), 1.0), n((2, cout), 1.0)
    plan = resblock_plan(2, 4, 6, 8, cin, cout, 8, torch.bfloat16, mt=1)
    full = resblock_plan(64, 16, 12, 36, cin, cout, 8, torch.bfloat16)
    assert plan.bn == full.bn == 64 and plan.n_tiles == 1 and plan.m_tiles == 4
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = _resblock_replay(torch.from_numpy(x), torch.from_numpy(temb), tw, plan)
    ref = resblock_reference(torch.from_numpy(x), torch.from_numpy(temb), tw)
    jax_out = np.asarray(jax_fused_resblock(x, temb, {k: jnp.asarray(v) for k, v in w.items()},
                                            mode="interpret"))
    scale = float(ref.abs().max())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), jax_out, rtol=0, atol=1e-5 * scale)
