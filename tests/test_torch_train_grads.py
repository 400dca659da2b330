"""Port parity: the gradients through the kernels.

Each kernel wrapper (attention, GroupNorm(+SiLU), the conv through either
kernel, the fused resblock) runs as a ``torch.autograd.Function`` whose
backward is the VJP of the plain math, written in PyTorch ops (the fused
resblock's: autograd through its twin, recomputed, as the JAX package's
``custom_vjp`` differentiates its reference).  On CPU tensors the
forward is the twin and the backward the same code the card runs.  Each
backward is held against ``jax.vjp`` of the JAX package's function, with the
Pallas kernel in interpret mode so its ``custom_vjp`` runs, and against
PyTorch autograd through the twin.  Inputs are numpy-seeded, float32, and
the tolerance is ``1e-5·max|ref|``.

Also the regression test of a fault the training path had: the conv
weight got no gradient on the CPU (its pack was made under ``no_grad`` and
used in its place); and the fused resblock's eligibility held to the JAX
package's ``_eligible`` case by case.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crowdmod_tpu.ops.pallas.conv3d as jax_pallas_conv3d
from crowdmod_tpu.models.backbones import fused_apply as jax_fused_apply
from crowdmod_tpu.models.backbones.unet3d import ResnetBlock3D as JaxResnetBlock3D
from crowdmod_tpu.ops.conv3d import conv3d_same as jax_conv3d_same
from crowdmod_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from crowdmod_tpu.ops.pallas.groupnorm import fused_group_norm as jax_fused_group_norm
from crowdmod_tpu.ops.pallas.resblock import fused_resblock as jax_fused_resblock
from crowdmod_tpu_torch.models.backbones import fused_apply
from crowdmod_tpu_torch.models.backbones.unet3d import ResnetBlock3D
from crowdmod_tpu_torch.ops.conv3d import Conv3DSame, conv3d_same, jax_kernel
from crowdmod_tpu_torch.ops.kernels import (
    attention_reference,
    conv3d_same_reference,
    fused_attention,
    fused_group_norm,
    fused_resblock,
    group_norm_reference,
    reset_launch_counts,
    resblock_reference,
)
from crowdmod_tpu_torch.ops.kernels.attention import FusedAttention
from crowdmod_tpu_torch.ops.kernels.conv3d import pack_im2col, pack_tapgemm
from crowdmod_tpu_torch.ops.kernels.groupnorm import FusedGroupNorm
from crowdmod_tpu_torch.ops.kernels.resblock import FusedResblock, pack_resblock

GRAD_RTOL = 1e-5  # of max|ref|, f32


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _close(got, want, label):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, label
    assert np.abs(want).max() > 0, label
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_RTOL * np.abs(want).max(),
                               err_msg=label)


def _port_grads(fn, inputs, g):
    """Gradients of ``sum(fn(*inputs) * g)`` with respect to ``inputs``."""
    leaves = [_leaf(a) for a in inputs]
    out = fn(*leaves)
    out.backward(torch.from_numpy(g))
    return out, [t.grad for t in leaves]


@pytest.mark.parametrize("b, h, sq, sk, dh", [(2, 4, 1, 2, 64), (2, 4, 6, 9, 32)],
                         ids=["temporal_1x2", "cross_6x9"])
def test_attention_backward(b, h, sq, sk, dh):
    q, k, v = (_normal(i, (b, h, s, dh)) for i, s in enumerate((sq, sk, sk)))
    g = _normal(3, (b, h, sq, dh))
    scale = 1.0 / dh**0.5
    out, got = _port_grads(lambda *a: fused_attention(*a), (q, k, v), g)
    assert out.grad_fn is not None and "FusedAttention" in type(out.grad_fn).__name__
    _, vjp = jax.vjp(
        lambda *a: jax_fused_attention(*a, scale=scale, mode="interpret"), q, k, v)
    _, twin = _port_grads(lambda *a: attention_reference(*a, scale), (q, k, v), g)
    for name, a, w, t in zip("qkv", got, vjp(jnp.asarray(g)), twin):
        _close(a, w, f"d{name} vs jax.vjp")
        _close(a, t, f"d{name} vs autograd through the twin")


@pytest.mark.parametrize("silu", [False, True], ids=["plain", "silu"])
def test_group_norm_backward(silu):
    x = _normal(4, (2, 4, 6, 8, 16), 2.0) + 0.5
    gamma, beta = 1.0 + _normal(5, (16,), 0.2), _normal(6, (16,), 0.2)
    g = _normal(7, x.shape)
    kw = dict(num_groups=8, eps=1e-5, silu=silu)
    out, got = _port_grads(lambda *a: fused_group_norm(*a, **kw), (x, gamma, beta), g)
    assert "FusedGroupNorm" in type(out.grad_fn).__name__
    _, vjp = jax.vjp(
        lambda *a: jax_fused_group_norm(*a, **kw, mode="interpret"), x, gamma, beta)
    _, twin = _port_grads(lambda *a: group_norm_reference(*a, 8, 1e-5, silu),
                          (x, gamma, beta), g)
    for name, a, w, t in zip(("x", "gamma", "beta"), got, vjp(jnp.asarray(g)), twin):
        _close(a, w, f"d{name} vs jax.vjp")
        _close(a, t, f"d{name} vs autograd through the twin")


@pytest.mark.parametrize("impl", ["im2col", "tapgemm"])
def test_conv3d_backward(impl, monkeypatch):
    """The JAX side's custom VJP differentiates its direct conv; its forward
    runs the Pallas kernel in interpret mode."""
    name = "conv3d_same_im2col" if impl == "im2col" else "conv3d_same_tapgemm"
    monkeypatch.setattr(jax_pallas_conv3d, name,
                        functools.partial(getattr(jax_pallas_conv3d, name), interpret=True))
    cin, cout = 8, 16
    x = _normal(8, (2, 4, 6, 8, cin))
    weight = _normal(9, (cout, cin, 3, 3, 3), 0.1)  # reference (O, I, kh, kw, kl)
    bias = _normal(10, (cout,), 0.1)
    g = _normal(11, (2, 4, 6, 8, cout))
    pack = pack_im2col if impl == "im2col" else pack_tapgemm
    packed = pack(jax_kernel(torch.from_numpy(weight)))
    out, got = _port_grads(lambda x, w, b: conv3d_same(x, w, b, packed, impl),
                           (x, weight, bias), g)
    assert "Conv3DSameFunction" in type(out.grad_fn).__name__
    kernel = np.ascontiguousarray(weight.transpose(4, 2, 3, 1, 0))  # (kl, kh, kw, I, O)
    variant = "pallas" if impl == "im2col" else "pallas_tap"
    _, vjp = jax.vjp(lambda x, k, b: jax_conv3d_same(x, k, variant) + b, x, kernel, bias)
    dx, dk, db = vjp(jnp.asarray(g))
    _, twin = _port_grads(
        lambda x, w, b: conv3d_same_reference(x, jax_kernel(w), b), (x, weight, bias), g)
    _close(got[0], dx, "dx vs jax.vjp")
    _close(jax_kernel(got[1]), dk, "dweight vs jax.vjp")
    _close(got[2], db, "dbias vs jax.vjp")
    for name, a, t in zip(("x", "weight", "bias"), got, twin):
        _close(a, t, f"d{name} vs autograd through the twin")


def test_backward_functions_keep_the_input_dtypes():
    """Gradients come out in each input's dtype, as JAX's do: bf16 inputs
    get bf16 gradients, the float32 GroupNorm affine float32 ones."""
    x = _leaf(_normal(12, (2, 6, 16))).detach().bfloat16().requires_grad_(True)
    gamma, beta = torch.ones(16, requires_grad=True), torch.zeros(16, requires_grad=True)
    FusedGroupNorm.apply(x, gamma, beta, 8, 1e-5, True).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and gamma.grad.dtype == torch.float32
    q = torch.randn(1, 2, 4, 32, generator=torch.Generator().manual_seed(0))
    q = q.bfloat16().requires_grad_(True)
    FusedAttention.apply(q, q, q, 0.1).float().sum().backward()
    assert q.grad.dtype == torch.bfloat16 and torch.isfinite(q.grad.float()).all()


@pytest.mark.parametrize("impl", ["im2col", "tapgemm"])
def test_conv_weight_gets_a_gradient_and_repacks_after_a_step(impl):
    """Every Conv3DSame parameter gets a gradient, and the cached kernel pack
    (keyed on the weight's in-place version) is rebuilt after the
    optimizer's in-place step."""
    conv = Conv3DSame(8, 8, impl=impl)
    x = torch.randn(2, 3, 4, 5, 8, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    conv(x).square().sum().backward()
    assert conv.weight.grad is not None and conv.weight.grad.abs().max() > 0
    assert conv.bias.grad is not None and x.grad is not None
    before = conv.packed_weight()
    torch.optim.Adam(conv.parameters(), lr=0.1).step()
    after = conv.packed_weight()
    pack = pack_im2col if impl == "im2col" else pack_tapgemm
    assert after is not before and not torch.equal(after, before)
    torch.testing.assert_close(after, pack(jax_kernel(conv.weight.detach())),
                               rtol=0, atol=0)


def _resblock_weights(cin, cout, seed):
    """The fused block's weight dict (the JAX layout) as numpy arrays."""
    shapes = {"gn1_scale": (cin,), "gn1_bias": (cin,), "w1": (3, 3, 3, cin, cout),
              "b1": (cout,), "gn2_scale": (cout,), "gn2_bias": (cout,),
              "w2": (3, 3, 3, cout, cout), "b2": (cout,)}
    if cin != cout:
        shapes.update(w_skip=(1, 1, 1, cin, cout), b_skip=(cout,))
    w = {k: _normal(seed + i, shape, 0.2) for i, (k, shape) in enumerate(shapes.items())}
    for k in ("gn1_scale", "gn2_scale"):
        w[k] = w[k] + 1.0
    return w


@pytest.mark.parametrize("cin, cout", [(8, 16), (16, 16)], ids=["skip_8_16", "same_16"])
def test_fused_resblock_backward(cin, cout):
    """x, temb_proj and every weight of the block (the skip's included):
    FusedResblock's backward vs ``jax.vjp`` of the JAX package's
    ``fused_resblock`` (its ``custom_vjp``, the Pallas kernel in interpret
    mode forward) and vs autograd through the twin.  Two channels a group
    after conv1: with one, GroupNorm cancels temb_proj and b1 exactly and
    their gradients are rounding noise."""
    x = _normal(20, (2, 4, 4, 8, cin), 2.0) + 0.5
    temb = _normal(21, (2, cout))
    w = _resblock_weights(cin, cout, 30)
    g = _normal(22, (2, 4, 4, 8, cout))
    keys = list(w)

    def port(x, temb, *ws):
        return fused_resblock(x, temb, dict(zip(keys, ws)))

    out, got = _port_grads(port, (x, temb, *w.values()), g)
    assert "FusedResblock" in type(out.grad_fn).__name__
    _, vjp = jax.vjp(lambda x, t, ww: jax_fused_resblock(x, t, ww, mode="interpret"),
                     jnp.asarray(x), jnp.asarray(temb),
                     {k: jnp.asarray(v) for k, v in w.items()})
    dx, dtemb, dw = vjp(jnp.asarray(g))
    _, twin = _port_grads(lambda x, t, *ws: resblock_reference(x, t, dict(zip(keys, ws))),
                          (x, temb, *w.values()), g)
    for name, a, want, t in zip(["x", "temb_proj", *keys], got,
                                [dx, dtemb, *(dw[k] for k in keys)], twin):
        _close(a, want, f"d{name} vs jax.vjp")
        _close(a, t, f"d{name} vs autograd through the twin")


@pytest.mark.parametrize("cin, cout, grid, training, attention", [
    (8, 8, (8, 12, 36), False, False), (96, 32, (8, 12, 36), False, False),
    (8, 8, (8, 12, 36), True, False), (8, 8, (8, 12, 36), False, True),
    (8, 12, (8, 12, 36), False, False), (12, 8, (8, 12, 36), False, False),
    (8, 8, (4, 6, 18), False, False), (8, 8, (8, 8, 16), False, False),
    (64, 64, (8, 8, 16), False, False), (8, 8, (4, 16, 16), False, False),
], ids=lambda v: str(v))
def test_fused_resblock_eligibility_is_jaxs(cin, cout, grid, training, attention):
    """``fused_apply.eligible`` equals the JAX package's ``_eligible`` on
    each case, with and without a gradient wanted: deterministic, no
    attention, channels multiples of 8, volume ≥ 1024."""
    block = ResnetBlock3D(cin, cout, 32, apply_attention=attention)
    block.train(training)
    x = torch.zeros(1, *grid, cin)
    want = jax_fused_apply._eligible(
        JaxResnetBlock3D(out_channels=cout, apply_attention=attention),
        jnp.zeros((1, *grid, cin)), not training)
    assert fused_apply.eligible(block, x, block.training) == want
    with torch.no_grad():
        assert fused_apply.eligible(block, x, block.training) == want


def test_fused_resblock_is_not_eligible_for_a_gradient(monkeypatch):
    """Eligibility does not depend on a gradient, as JAX's does not: a
    block whose parameters require grad routes to the kernel with grad
    enabled as under no_grad, and its forward there is FusedResblock's,
    with every block parameter in the graph."""
    monkeypatch.setattr(fused_apply, "MIN_FUSED_VOLUME", 64)
    block = ResnetBlock3D(8, 16, 32).eval()
    x = torch.randn(1, 4, 4, 4, 8, generator=torch.Generator().manual_seed(2))
    assert fused_apply.eligible(block, x, block.training)
    with torch.no_grad():
        assert fused_apply.eligible(block, x, block.training)
    block.requires_grad_(False)
    assert fused_apply.eligible(block, x, block.training)
    block.requires_grad_(True)
    temb = torch.randn(1, 32, generator=torch.Generator().manual_seed(3))
    out = block(x, temb)
    assert "FusedResblock" in type(out.grad_fn).__name__
    out.square().sum().backward()
    for name, p in block.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name


def test_fused_resblock_refuses_an_input_that_needs_grad():
    """Off the CPU an input that needs grad no longer raises: the wrapper
    builds a graph through FusedResblock, the operator's fake kernel on
    ``meta`` tensors, and launches nothing."""
    reset_launch_counts()
    gen = torch.Generator().manual_seed(4)
    w = {k: torch.from_numpy(v) for k, v in _resblock_weights(16, 8, 40).items()}
    w = {k: v.to("meta").requires_grad_(True) for k, v in w.items()}
    x = torch.empty(1, 8, 4, 4, 16, device="meta", requires_grad=True)
    temb = torch.randn(1, 8, generator=gen).to("meta")
    out = fused_resblock(x, temb, w, packed=pack_resblock(w, torch.float32))
    assert out.shape == (1, 8, 4, 4, 8) and out.device.type == "meta"
    assert type(out.grad_fn).__name__ == "FusedResblockBackward"
    assert issubclass(out.grad_fn._forward_cls, FusedResblock)
    assert fused_resblock.launches == 0
