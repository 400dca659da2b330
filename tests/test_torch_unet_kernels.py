"""Port parity: the UNet kernels' twins against the JAX package's kernels.

GroupNorm, the two Conv3D lowerings and the fused ResnetBlock.  The JAX side
runs its oracles and its Pallas kernels in interpret mode, as the JAX
package's own kernel tests do on the CPU.  The port's public wrappers, given
CPU tensors, run their twins and launch nothing; the CUDA kernels are held
against the twins on the card by ``chip_smoke.py``.  Inputs are numpy-seeded
and float32 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crowdmod_tpu.ops.conv3d import conv3d_same as jax_conv3d_same
from crowdmod_tpu.ops.pallas.conv3d import (
    conv3d_same_im2col as jax_conv3d_im2col,
    conv3d_same_tapgemm as jax_conv3d_tapgemm,
)
from crowdmod_tpu.ops.pallas.groupnorm import (
    fused_group_norm as jax_fused_group_norm,
    group_norm_reference as jax_group_norm_reference,
)
from crowdmod_tpu.ops.pallas.resblock import (
    fused_resblock as jax_fused_resblock,
    resblock_reference as jax_resblock_reference,
)
from crowdmod_tpu_torch.ops.kernels import (
    conv3d_same_im2col,
    conv3d_same_reference,
    conv3d_same_tapgemm,
    fused_group_norm,
    fused_resblock,
    group_norm_reference,
    reset_launch_counts,
    resblock_reference,
)
from crowdmod_tpu_torch.ops.kernels.conv3d import (
    pack_im2col,
    pack_tapgemm,
    unpack_im2col,
    unpack_tapgemm,
)
from crowdmod_tpu_torch.ops.kernels.resblock import pack_resblock

GN_ATOL = 1e-5  # f32 moments and affine; only summation order differs
CONV_RTOL = 1e-5  # of max|ref|: K up to 27·96 terms summed in another order
RESBLOCK_RTOL = 2e-5  # of max|ref|, as tests/test_pallas_kernels.py:326-346


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("silu", [False, True], ids=["plain", "silu"])
@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 32), (3, 54, 96), (2, 2, 3, 9, 192)])
def test_group_norm_twin_matches_jax(shape, silu):
    c = shape[-1]
    x = _normal(0, shape, 2.0) + 0.5
    gamma, beta = _normal(1, (c,), 0.1) + 1.0, _normal(2, (c,), 0.1)
    got = group_norm_reference(_t(x), _t(gamma), _t(beta), 8, 1e-5, silu).numpy()
    want_oracle = np.asarray(jax_group_norm_reference(x, gamma, beta, 8, 1e-5, silu))
    want_kernel = np.asarray(jax_fused_group_norm(
        x, gamma, beta, num_groups=8, eps=1e-5, silu=silu, mode="interpret"))
    np.testing.assert_allclose(got, want_oracle, atol=GN_ATOL, rtol=0)
    np.testing.assert_allclose(got, want_kernel, atol=GN_ATOL, rtol=0)


def test_group_norm_raises_on_indivisible_channels():
    x = torch.zeros(2, 5, 12)
    with pytest.raises(ValueError, match="divisible"):
        fused_group_norm(x, torch.ones(12), torch.zeros(12), num_groups=8)


@pytest.mark.parametrize(
    "shape,cout",
    [((2, 4, 6, 8, 3), 8),     # Cin = 3, the first conv
     ((2, 4, 6, 8, 16), 3),    # Cout = 3, the final conv
     ((1, 2, 3, 9, 24), 16),   # the smallest UNet level
     ((2, 4, 6, 8, 16), 16)],
    ids=["cin3", "cout3", "level2", "square"],
)
def test_conv3d_twin_matches_jax(shape, cout):
    cin = shape[-1]
    x = _normal(3, shape)
    kernel = _normal(4, (3, 3, 3, cin, cout), 0.1)
    bias = _normal(5, (cout,), 0.1)
    got = conv3d_same_reference(_t(x), _t(kernel), _t(bias)).numpy()
    wants = {
        "direct": jax_conv3d_same(x, kernel, "direct"),
        "im2col": jax_conv3d_im2col(x, kernel, interpret=True),
        "tapgemm": jax_conv3d_tapgemm(x, kernel, interpret=True),
    }
    for name, want in wants.items():
        want = np.asarray(want) + bias
        np.testing.assert_allclose(
            got, want, atol=CONV_RTOL * np.abs(want).max(), rtol=0, err_msg=name)
    # Both packings hold the same kernel, and each wrapper's CPU route is
    # the twin on it.
    kt = _t(kernel)
    torch.testing.assert_close(unpack_im2col(pack_im2col(kt)), kt, rtol=0, atol=0)
    torch.testing.assert_close(unpack_tapgemm(pack_tapgemm(kt)), kt, rtol=0, atol=0)
    for conv, pack in ((conv3d_same_im2col, pack_im2col),
                       (conv3d_same_tapgemm, pack_tapgemm)):
        out = conv(_t(x), pack(kt), _t(bias)).numpy()
        np.testing.assert_allclose(out, got, atol=0, rtol=0)


def _resblock_weights(seed, cin, cout):
    rng = np.random.default_rng(seed)
    n = lambda shape, sc: (rng.normal(size=shape) * sc).astype(np.float32)
    w = {
        "gn1_scale": n((cin,), 0.1) + 1.0, "gn1_bias": n((cin,), 0.1),
        "w1": n((3, 3, 3, cin, cout), 0.05), "b1": n((cout,), 0.1),
        "gn2_scale": n((cout,), 0.1) + 1.0, "gn2_bias": n((cout,), 0.1),
        "w2": n((3, 3, 3, cout, cout), 0.05), "b2": n((cout,), 0.1),
    }
    if cin != cout:
        w["w_skip"] = n((1, 1, 1, cin, cout), 0.1)
        w["b_skip"] = n((cout,), 0.1)
    return w


@pytest.mark.parametrize(
    "cin,cout,vol",
    [(32, 32, (4, 6, 8)), (96, 32, (4, 6, 8)), (64, 32, (2, 3, 9)), (32, 64, (4, 6, 8))],
    ids=["identity", "decoder_skip", "smallest", "widening"],
)
def test_resblock_twin_matches_jax(cin, cout, vol):
    x = _normal(cin + cout, (2, *vol, cin))
    temb = _normal(1, (2, cout))
    w = _resblock_weights(2, cin, cout)
    got = resblock_reference(
        _t(x), _t(temb), {k: _t(v) for k, v in w.items()}).numpy()
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    for name, want in (
        ("oracle", jax_resblock_reference(x, temb, jw)),
        ("interpret", jax_fused_resblock(x, temb, jw, mode="interpret")),
    ):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got, want, atol=RESBLOCK_RTOL * np.abs(want).max(), rtol=0,
            err_msg=name)


def test_pack_resblock_folds_the_skip_into_conv2():
    w = {k: _t(v) for k, v in _resblock_weights(3, 16, 8).items()}
    p = pack_resblock(w, torch.bfloat16)
    assert p["w1"].shape == (27 * 16, 8) and p["w1"].dtype == torch.bfloat16
    assert p["w2"].shape == (27 * 8 + 16, 8) and p["has_skip"]
    torch.testing.assert_close(
        p["w2"][27 * 8:].float(), w["w_skip"].reshape(16, 8).bfloat16().float())
    torch.testing.assert_close(p["bias2"], w["b2"] + w["b_skip"])
    assert not pack_resblock(
        {k: _t(v) for k, v in _resblock_weights(3, 8, 8).items()}, torch.float32
    )["has_skip"]


def test_cpu_wrappers_run_the_twins_and_launch_nothing():
    reset_launch_counts()
    x = _t(_normal(6, (2, 4, 6, 8, 16)))
    gamma, beta = torch.ones(16), torch.zeros(16)
    torch.testing.assert_close(
        fused_group_norm(x, gamma, beta, silu=True),
        group_norm_reference(x, gamma, beta, 8, 1e-5, True), rtol=0, atol=0)
    kernel = _t(_normal(7, (3, 3, 3, 16, 8), 0.1))
    ref = conv3d_same_reference(x, kernel)
    torch.testing.assert_close(conv3d_same_im2col(x, pack_im2col(kernel)), ref,
                               rtol=0, atol=0)
    torch.testing.assert_close(conv3d_same_tapgemm(x, pack_tapgemm(kernel)), ref,
                               rtol=0, atol=0)
    w = {k: _t(v) for k, v in _resblock_weights(8, 16, 8).items()}
    temb = torch.zeros(2, 8)
    torch.testing.assert_close(fused_resblock(x, temb, w),
                               resblock_reference(x, temb, w), rtol=0, atol=0)
    for fn in (fused_group_norm, conv3d_same_im2col, conv3d_same_tapgemm,
               fused_resblock):
        assert fn.launches == 0, fn.__name__
