"""Convolutional recurrent cells (port of the JAX package's
``models/convrnn/cells.py``), on ``(B, C, H, W)`` frames.

The state is a uniform ``(h, c)`` pair for both cell types (the GRU carries
a zero ``c`` it never reads, see :func:`init_state`), so the encoder and
forecaster code is cell-agnostic.

The modules keep the reference's state_dict layout, which the JAX package's
checkpoint importer reads: the GRU's ``reset_gate``, ``update_gate`` and
``conv_cand`` convolutions (the JAX package fuses the first two into one
``gates`` convolution whose output channels are ``[reset | update]``), and
the LSTM's one ``conv`` producing the gates in the order ``i, f, o, g``.
Each convolution pads ``k // 2`` on every side and runs in the cell's
compute ``dtype`` on float32 parameters.

Under tensor parallelism each convolution whose weight is cut over "model"
runs column-parallel (:func:`conv2d`); the GRU's reset and update gates
are then cut as the halves of JAX's one fused gate conv, and run as that
conv over this rank's block of its ``[reset | update]`` outputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from crowdmod_tpu_torch.ops.conv3d import lecun_normal_
from crowdmod_tpu_torch.parallel import tensor


def init_state(batch: int, h: int, w: int, hidden: int, dtype=torch.float32,
               device=None):
    """Zero ``(h, c)`` state of ``(batch, hidden, h, w)``; ``c`` is carried
    for both cell types."""
    z = torch.zeros((batch, hidden, h, w), dtype=dtype, device=device)
    return (z, z)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` of ``x`` with the weights cast to ``dtype`` (the parameters
    stay float32, as flax keeps them); column-parallel over the channels
    where the weight is cut over "model"."""
    def op(x, w, b):
        return F.conv2d(x.to(dtype), w.to(dtype), None if b is None else b.to(dtype),
                        stride=conv.stride, padding=conv.padding)

    return tensor.column(conv, x, op, dim=1)


def make_conv(cin: int, cout: int, k: int, *, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    """A ``k × k`` convolution padded ``k // 2`` on every side, with flax's
    initialisation (:func:`reset_conv`)."""
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)
    reset_conv(conv)
    return conv


def reset_conv(conv: nn.Module, generator: torch.Generator | None = None) -> None:
    """flax's default initialisation: lecun-normal kernel (fan-in ``kh·kw·I``),
    zero bias.  Works for ``Conv2d (O, I, kh, kw)`` and ``ConvTranspose2d
    (I, O, kh, kw)`` weights alike."""
    w = conv.weight
    fan_in = w[0].numel() if isinstance(conv, nn.Conv2d) else w.shape[0] * w[0, 0].numel()
    lecun_normal_(w, fan_in, generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


class ConvGRUCell(nn.Module):
    def __init__(self, input_channels: int, hidden_channels: int, kernel_size: int = 3,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = input_channels + hidden_channels
        self.reset_gate = make_conv(cin, hidden_channels, kernel_size, bias=use_bias)
        self.update_gate = make_conv(cin, hidden_channels, kernel_size, bias=use_bias)
        self.conv_cand = make_conv(cin, hidden_channels, kernel_size, bias=use_bias)

    def forward(self, x: torch.Tensor, state):
        h_prev, c_prev = state
        dt = self.dtype
        combined = torch.cat([x.to(dt), h_prev.to(dt)], dim=1)
        gates = tensor.shard_of(self, "gates")
        if gates is None:
            reset = torch.sigmoid(conv2d(self.reset_gate, combined, dt))
            update = torch.sigmoid(conv2d(self.update_gate, combined, dt))
        else:  # this rank's block of the fused [reset | update] conv
            r, u = self.reset_gate, self.update_gate
            both = tensor.column(
                r, combined, lambda x, w, b: F.conv2d(
                    x, w.to(dt), None if b is None else b.to(dt), padding=r.padding),
                dim=1, shard=gates, weight=torch.cat([r.weight, u.weight]),
                bias=None if r.bias is None else torch.cat([r.bias, u.bias]))
            reset, update = torch.sigmoid(both).chunk(2, dim=1)
        cand_in = torch.cat([x.to(dt), reset * h_prev], dim=1)
        candidate = torch.tanh(conv2d(self.conv_cand, cand_in, dt))
        h_next = (1.0 - update) * candidate + update * h_prev
        return h_next, (h_next, c_prev)


class ConvLSTMCell(nn.Module):
    def __init__(self, input_channels: int, hidden_channels: int, kernel_size: int = 3,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = make_conv(input_channels + hidden_channels, 4 * hidden_channels,
                              kernel_size, bias=use_bias)

    def forward(self, x: torch.Tensor, state):
        h_prev, c_prev = state
        dt = self.dtype
        gates = conv2d(self.conv, torch.cat([x.to(dt), h_prev.to(dt)], dim=1), dt)
        i, f, o, g = torch.chunk(gates, 4, dim=1)
        c_next = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h_next = torch.sigmoid(o) * torch.tanh(c_next)
        return h_next, (h_next, c_next)


CELLS = {"ConvGRUCell": ConvGRUCell, "ConvLSTMCell": ConvLSTMCell}
