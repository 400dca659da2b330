"""ConvRNN encoder–forecaster (port of the JAX package's
``models/convrnn/forecaster.py``), ``(B, T, H, W, C)`` at the boundary and
``(B, C, H, W)`` frames inside.

Per forecast step the whole sliding observation window is re-encoded
through three resolutions (conv → cell → strided conv → cell → strided conv
→ cell), then decoded (cell → transpose conv ×2 → cell → transpose conv ×2
→ cell → conv → conv head), with LeakyReLU(0.2) after every conv but the
head.

The three recurrent state slots are shared between the encoder and the
forecaster: slot 0 at H/4 (encoder rnn3, forecaster rnn1), slot 1 at H/2
(rnn2 of both), slot 2 at H (encoder rnn1, forecaster rnn3).  That
coupling needs ``ENC_HIDDEN_CH[1,3,5] == FORC_HIDDEN_CH[5,3,1]``, checked at
construction.

The modules keep the reference's state_dict keys:
``encoder.encoder_cell_list.{0..5}`` (conv1, rnn1, down1, rnn2, down2,
rnn3) and ``forecaster_cell_list.{0..6}`` (rnn1, up1, rnn2, up2, rnn3,
conv4, head); the transpose convolutions are ``ConvTranspose2d (I, O, k,
k)``, stride 2, which the JAX package holds spatially flipped.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from crowdmod_tpu_torch.models.convrnn.cells import (
    ConvGRUCell,
    conv2d,
    init_state,
    make_conv,
    reset_conv,
)
from crowdmod_tpu_torch.parallel import tensor


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def exp_log_channels(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``x`` with density (channel 0) and variance (channel 3) of axis
    ``dim`` exp'd: the forecaster predicts both in log space."""
    out = x.clone()
    for ch in (0, 3):
        if ch < x.shape[dim]:
            out.select(dim, ch).copy_(torch.exp(x.select(dim, ch)))
    return out


def _transpose_crop(k: int, stride: int = 2) -> tuple[int, int]:
    """Rows (and columns) to drop at the start and at the end of the full
    stride-``stride`` transpose convolution to get flax's ``padding="SAME"``
    output of ``stride·H``: flax pads the dilated input ``(a, b)`` where the
    full convolution pads ``(k-1, k-1)``."""
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    lo, hi = k - 1 - pad_a, k - 1 - (pad_len - pad_a)
    if min(lo, hi) < 0:
        raise ValueError(f"transpose conv kernel {k} with stride {stride} is not supported")
    return lo, hi


class UpConv(nn.ConvTranspose2d):
    """Stride-2 transpose convolution with flax's ``SAME`` output size, in a
    compute dtype (float32 parameters)."""

    def __init__(self, cin: int, cout: int, k: int, *, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        lo, hi = _transpose_crop(k)
        super().__init__(cin, cout, k, stride=2, padding=min(lo, hi), bias=bias)
        self.extra = (lo - min(lo, hi), hi - min(lo, hi))
        self.dtype = dtype
        reset_conv(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Column-parallel where the weight ``(I, O, k, k)`` is cut over
        "model" on its output dim (torch dim 1)."""
        dt = self.dtype
        lo, hi = self.extra

        def op(x, w, b):
            out = F.conv_transpose2d(x.to(dt), w.to(dt), None if b is None else b.to(dt),
                                     stride=2, padding=self.padding)
            h, w = out.shape[-2:]
            return out[..., lo:h - hi, lo:w - hi]

        return tensor.column(self, x, op, dim=1)


class Encoder(nn.Module):
    """Three-scale recurrent encoder over an observation window.

    ``forward(window (B, T, C, H, W), state)`` → the top (H/4) hidden
    features of the last frame and the updated ``[quarter, half, full]``
    slots."""

    def __init__(self, input_channels: int, hidden_channels: Sequence[int],
                 kernels: Sequence[int], cell=ConvGRUCell, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hc, kz = list(hidden_channels), list(kernels)
        self.dtype = dtype

        def rnn(cin, hidden, k):
            return cell(cin, hidden, k, use_bias=use_bias, dtype=dtype)

        self.encoder_cell_list = nn.ModuleList([
            make_conv(input_channels, hc[0], kz[0], bias=use_bias),
            rnn(hc[0], hc[1], kz[1]),
            make_conv(hc[1], hc[2], kz[2], stride=2, bias=use_bias),
            rnn(hc[2], hc[3], kz[3]),
            make_conv(hc[3], hc[4], kz[4], stride=2, bias=use_bias),
            rnn(hc[4], hc[5], kz[5]),
        ])

    def forward(self, window: torch.Tensor, state: list):
        conv1, rnn1, down1, rnn2, down2, rnn3 = self.encoder_cell_list
        dt = self.dtype
        s_full, s_half, s_quarter = state[2], state[1], state[0]
        top = None
        for t in range(window.shape[1]):
            h = _lrelu(conv2d(conv1, window[:, t], dt))
            h, s_full = rnn1(h, s_full)
            h = _lrelu(conv2d(down1, h, dt))
            h, s_half = rnn2(h, s_half)
            h = _lrelu(conv2d(down2, h, dt))
            top, s_quarter = rnn3(h, s_quarter)
        return top, [s_quarter, s_half, s_full]


class Forecaster(nn.Module):
    """Autoregressive multi-scale forecaster, ``(past, target) → future``;
    its widths are ``MODEL.CONVRNN``'s."""

    def __init__(
        self,
        out_channels: int = 4,
        enc_hidden_channels: Sequence[int] = (16, 64, 64, 96, 96, 96),
        forc_hidden_channels: Sequence[int] = (96, 96, 96, 96, 96, 64, 16),
        enc_kernels: Sequence[int] = (3, 3, 3, 3, 3, 3),
        forc_kernels: Sequence[int] = (3, 4, 3, 4, 3, 3, 3),
        cell=ConvGRUCell,
        use_bias: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        e, f = list(enc_hidden_channels), list(forc_hidden_channels)
        if not (e[1] == f[5] and e[3] == f[3] and e[5] == f[1]):
            raise ValueError(
                "shared state slots require ENC_HIDDEN_CH[1,3,5] == "
                f"FORC_HIDDEN_CH[5,3,1]; got enc={e} forc={f}"
            )
        self.dtype = dtype
        self.forc_hidden_channels = f
        fk = list(forc_kernels)
        self.encoder = Encoder(out_channels, e, enc_kernels, cell, use_bias, dtype)

        def rnn(cin, hidden, k):
            return cell(cin, hidden, k, use_bias=use_bias, dtype=dtype)

        self.forecaster_cell_list = nn.ModuleList([
            rnn(e[5], f[1], fk[0]),
            UpConv(f[1], f[2], fk[1], bias=use_bias, dtype=dtype),
            rnn(f[2], f[3], fk[2]),
            UpConv(f[3], f[4], fk[3], bias=use_bias, dtype=dtype),
            rnn(f[4], f[5], fk[4]),
            make_conv(f[5], f[6], fk[5], bias=use_bias),
            make_conv(f[6], out_channels, fk[6], bias=use_bias),
        ])

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initialisation: lecun-normal kernels, zero biases."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                reset_conv(m, generator)

    def forward(
        self,
        past: torch.Tensor,
        future_len: int | None = None,
        target: torch.Tensor | None = None,
        *,
        teacher_forcing: bool = False,
    ) -> torch.Tensor:
        """``past (B, P, H, W, C)`` → ``(B, F, H, W, C)`` float32 frames,
        density and variance in log space.  With ``teacher_forcing`` the
        window advances by ``target``'s frames, else by the prediction with
        channels 0 and 3 exp'd."""
        if teacher_forcing and target is None:
            raise ValueError("teacher_forcing=True requires target frames")
        if future_len is None:
            if target is None:
                raise ValueError("need future_len or target to set horizon")
            future_len = target.shape[1]
        rnn1, up1, rnn2, up2, rnn3, conv4, head = self.forecaster_cell_list
        dt, fc = self.dtype, self.forc_hidden_channels
        b, _, h, w, _ = past.shape
        dev = past.device
        state = [
            init_state(b, h // 4, w // 4, fc[1], dt, dev),
            init_state(b, h // 2, w // 2, fc[3], dt, dev),
            init_state(b, h, w, fc[5], dt, dev),
        ]
        window = past.permute(0, 1, 4, 2, 3)  # (B, T, C, H, W)
        if teacher_forcing:
            target = target.permute(0, 1, 4, 2, 3)
        frames = []
        for t in range(future_len):
            top, state = self.encoder(window, state)
            x, state[0] = rnn1(top, state[0])
            x = _lrelu(up1(x))
            x, state[1] = rnn2(x, state[1])
            x = _lrelu(up2(x))
            x, state[2] = rnn3(x, state[2])
            x = _lrelu(conv2d(conv4, x, dt))
            frame = conv2d(head, x, dt).float()  # log-space rho and sigma2
            frames.append(frame)
            next_frame = target[:, t] if teacher_forcing else exp_log_channels(frame, 1)
            window = torch.cat([window[:, 1:], next_frame[:, None].to(window.dtype)], dim=1)
        return torch.stack(frames, dim=1).permute(0, 1, 3, 4, 2)
