"""Stride-1 SAME 3×3×3 convolution module (port of the JAX package's
``ops/conv3d.py``).

:class:`Conv3DSame` holds the reference ``nn.Conv3d`` parameters —
``weight (O, I, kh, kw, kl)`` with time last, ``bias (O,)`` — and runs one
of the two hand-written kernels over channels-last ``(B, T, H, W, C)``:
``impl="im2col"`` (the default) or ``impl="tapgemm"``.  The JAX package
chooses its lowering from an environment variable; here the choice is a
constructor argument that ``UNet3D(conv_impl=...)`` passes down.  The JAX
package's XLA lowerings (``direct``, ``split_t``, ``fold_t``) compute the
same function and are not carried over.

The kernel's weight layout is packed once per weight load (in the compute
dtype), not per call: the pack is cached and rebuilt only when the weight
tensor changes (a new tensor, or an in-place write such as
``load_state_dict`` or an optimizer step).  The pack is made without
autograd: the kernels are forward only.  Under a trace (``torch.export``, a
scan body) a weight has no storage to key the cache on, so the pack is made
in the traced program and not kept, unless :meth:`Conv3DSame.pin_pack` has
fixed it beforehand (an exported sampler's frozen copy).  :func:`conv3d_same` gives the
conv its gradient (:class:`Conv3DSameFunction`): the kernel forward on the
pack, and the VJP of the plain conv (:func:`conv3d_same_vjp`, the library's
convolution backward) with respect to the input, the reference-layout
weight and the bias, as the JAX package's ``custom_vjp`` differentiates
its direct conv.

Under tensor parallelism (:mod:`crowdmod_tpu_torch.parallel.tensor`) the
module's weight holds this rank's output channels: the kernel runs on
those O/N channels, its pack made from the local slice (the pack cache is
keyed on the local tensor), and the channels are gathered.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.grad import conv3d_input, conv3d_weight

from crowdmod_tpu_torch.ops.kernels import conv3d_same_im2col, conv3d_same_tapgemm
from crowdmod_tpu_torch.ops.kernels.conv3d import pack_im2col, pack_tapgemm
from crowdmod_tpu_torch.parallel import tensor

IMPLS = ("im2col", "tapgemm")


def weights_key(*tensors: torch.Tensor) -> tuple:
    """Identity of the tensors' current values: storage, device and
    in-place version, so a cache keyed on it is dropped on any write."""
    return tuple((t.data_ptr(), t.device, t._version) for t in tensors)


def jax_kernel(weight: torch.Tensor) -> torch.Tensor:
    """Reference Conv3d ``(O, I, kh, kw, kl)`` → the JAX package's kernel
    ``(kl, kh, kw, I, O)`` (time first), as a view."""
    return weight.permute(4, 2, 3, 1, 0)


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> None:
    """flax's default ``lecun_normal``: truncated normal (±2σ) scaled so the
    variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


def conv3d_same_vjp(x, weight, bias, g, needs=(True, True, True)):
    """``(dx, dweight, dbias)`` of the stride-1 SAME conv of ``x (B, T, H,
    W, Cin)`` with the reference-layout ``weight (O, I, kh, kw, kl)`` cast to
    x's dtype, for the output cotangent ``g``: the library's convolution
    backward on the ``(B, C, T, H, W)`` views, in x's dtype; each gradient
    comes out in its input's dtype, None where ``needs`` says so."""
    w = weight.to(x.dtype).permute(0, 1, 4, 2, 3)  # (O, I, kl, kh, kw)
    x5, g5 = x.permute(0, 4, 1, 2, 3), g.to(x.dtype).permute(0, 4, 1, 2, 3)
    dx = dw = db = None
    if needs[0]:
        dx = conv3d_input(x5.shape, w, g5, padding=1).permute(0, 2, 3, 4, 1)
    if needs[1]:
        dw = conv3d_weight(x5, w.shape, g5, padding=1).permute(0, 1, 3, 4, 2)
        dw = dw.to(weight.dtype)
    if needs[2] and bias is not None:
        db = g.float().sum(dim=(0, 1, 2, 3)).to(bias.dtype)
    return dx, dw, db


class Conv3DSameFunction(torch.autograd.Function):
    """The conv with a gradient: the ``impl`` kernel on the packed weight
    forward (the twin on the CPU), :func:`conv3d_same_vjp` backward on
    either device.  Inputs: ``x`` in the compute dtype, the reference-layout
    ``weight`` and ``bias`` (float32), ``packed`` (the kernel's layout of
    ``weight``, made without autograd) and ``impl``."""

    @staticmethod
    def forward(ctx, x, weight, bias, packed, impl):
        ctx.save_for_backward(x, weight, bias)
        conv = conv3d_same_im2col if impl == "im2col" else conv3d_same_tapgemm
        return conv(x, packed, bias)

    @staticmethod
    def backward(ctx, g):
        return (*conv3d_same_vjp(*ctx.saved_tensors, g, ctx.needs_input_grad[:3]),
                None, None)


def conv3d_same(x, weight, bias, packed, impl: str) -> torch.Tensor:
    """Stride-1 SAME 3×3×3 conv of channels-last ``x`` through the ``impl``
    kernel on ``packed``; differentiable in ``x``, ``weight`` and ``bias``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return Conv3DSameFunction.apply(x, weight, bias, packed, impl)
    conv = conv3d_same_im2col if impl == "im2col" else conv3d_same_tapgemm
    return conv(x, packed, bias)


class Conv3DSame(nn.Module):
    """Stride-1 SAME 3×3×3 conv, computed in ``dtype`` with f32
    accumulation; parameter-compatible with the reference ``Conv3d``.
    ``cache_packs`` False (set by FSDP sharding) packs the weight every
    forward instead of caching it on the weight's storage and version."""

    cache_packs = True

    def __init__(self, in_channels: int, out_channels: int, *,
                 dtype: torch.dtype = torch.float32, impl: str = "im2col"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown conv3d impl {impl!r}; expected {IMPLS}")
        self.dtype, self.impl = dtype, impl
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self._packed = (None, None)
        self.register_buffer("pinned", None, persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        lecun_normal_(self.weight, 27 * self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def _pack(self) -> torch.Tensor:
        pack = pack_im2col if self.impl == "im2col" else pack_tapgemm
        return pack(jax_kernel(self.weight)).to(self.dtype)

    @torch.no_grad()
    def pin_pack(self) -> None:
        """Pack the weight now and use that pack from here on, under a trace
        too: for a copy whose weights no longer change.  The pack is a
        (non-persistent) buffer, so a trace reads it as the module's own."""
        self.pinned = self._pack()

    @torch.no_grad()
    def packed_weight(self) -> torch.Tensor:
        """The kernel's weight layout in ``dtype``, rebuilt only when the
        weight changed (made in the traced program under a trace)."""
        if self.pinned is not None:
            return self.pinned
        if torch.compiler.is_compiling() or not self.cache_packs:
            return self._pack()
        key = weights_key(self.weight) + (self.dtype, self.impl)
        if self._packed[0] != key:
            self._packed = (key, self._pack())
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def op(x, w, b):
            return conv3d_same(x.to(self.dtype).contiguous(), w, b, self.packed_weight(),
                               self.impl)

        return tensor.column(self, x, op)
