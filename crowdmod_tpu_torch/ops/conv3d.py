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
``load_state_dict``).  The pack is made without autograd: the kernels are
forward only.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from crowdmod_tpu_torch.ops.kernels import conv3d_same_im2col, conv3d_same_tapgemm
from crowdmod_tpu_torch.ops.kernels.conv3d import pack_im2col, pack_tapgemm

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


class Conv3DSame(nn.Module):
    """Stride-1 SAME 3×3×3 conv, computed in ``dtype`` with f32
    accumulation; parameter-compatible with the reference ``Conv3d``."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 dtype: torch.dtype = torch.float32, impl: str = "im2col"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown conv3d impl {impl!r}; expected {IMPLS}")
        self.dtype, self.impl = dtype, impl
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self._packed = (None, None)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        lecun_normal_(self.weight, 27 * self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    @torch.no_grad()
    def packed_weight(self) -> torch.Tensor:
        """The kernel's weight layout in ``dtype``, rebuilt only when the
        weight changed."""
        key = weights_key(self.weight) + (self.dtype, self.impl)
        if self._packed[0] != key:
            pack = pack_im2col if self.impl == "im2col" else pack_tapgemm
            self._packed = (key, pack(jax_kernel(self.weight)).to(self.dtype))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = conv3d_same_im2col if self.impl == "im2col" else conv3d_same_tapgemm
        return conv(x.to(self.dtype).contiguous(), self.packed_weight(), self.bias)
