"""Stride-1 SAME 3×3×3 convolution: two Hopper kernels and their plain twin.

Replaces ``crowdmod_tpu/ops/pallas/conv3d.py``: :func:`conv3d_same_im2col`
(kernel ``_kernel``) and :func:`conv3d_same_tapgemm` (kernel
``_tap_kernel``), both in ``csrc/conv3d.cu``, whose note says what bounds
them on the H100 (operations) and how each design answers that.

Layout: ``x (B, T, H, W, Cin) → (B, T, H, W, Cout)``, channels-last as in
the JAX package.  The canonical weight is the JAX package's ``kernel
(3, 3, 3, Cin, Cout)`` with time first (the reference Conv3d weight
``(O, I, kh, kw, kl)`` permuted ``(4, 2, 3, 1, 0)``).  Each kernel takes it
packed once, by the caller, in the input dtype: :func:`pack_im2col` folds it
to ``(27·Cin, Cout)``, :func:`pack_tapgemm` to ``(9, Cin, 3·Cout)`` with
the three kw taps side by side.  The bias is float32 and is added in f32
before the output's one rounding to the input dtype.

:func:`conv3d_same_reference` is the twin for both: the im2col GEMM
written out in torch (27 shifted slices of the zero-padded input, one
matmul with f32 accumulation), independent of cuDNN and of TF32.  On CPU
tensors each wrapper runs it; on CUDA tensors it launches its kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from crowdmod_tpu_torch.ops.kernels import build

# The tap-GEMM kernel's block holds R rows of W + 2 padded columns in a
# 160-row GEMM tile (csrc/conv3d.cu, kTapM).
TAPGEMM_MAX_WIDTH = 158
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]
_SIGNATURES = {
    "crowdmod_conv3d_im2col": (ctypes.c_int, _ARGTYPES),
    "crowdmod_conv3d_tapgemm": (ctypes.c_int, _ARGTYPES),
}


def pack_im2col(kernel: torch.Tensor) -> torch.Tensor:
    """``(3, 3, 3, Cin, Cout) → (27·Cin, Cout)``, rows (kd, kh, kw, ci)."""
    return kernel.reshape(-1, kernel.shape[-1]).contiguous()


def pack_tapgemm(kernel: torch.Tensor) -> torch.Tensor:
    """``(3, 3, 3, Cin, Cout) → (9, Cin, 3·Cout)``: slab kd·3 + kh, column
    kw·Cout + co."""
    _, _, _, cin, cout = kernel.shape
    return kernel.permute(0, 1, 3, 2, 4).reshape(9, cin, 3 * cout).contiguous()


def unpack_im2col(w_mat: torch.Tensor) -> torch.Tensor:
    return w_mat.reshape(3, 3, 3, -1, w_mat.shape[-1])


def unpack_tapgemm(w_taps: torch.Tensor) -> torch.Tensor:
    cin, cout = w_taps.shape[1], w_taps.shape[2] // 3
    return w_taps.reshape(3, 3, cin, 3, cout).permute(0, 1, 3, 2, 4)


def conv3d_same_reference(x, kernel, bias=None) -> torch.Tensor:
    """Plain twin: pad once, gather the 27 shifted slices in (kd, kh, kw, ci)
    order, one f32 matmul with the folded kernel, + bias, cast to x's
    dtype."""
    b, t, h, w, cin = x.shape
    cout = kernel.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    patches = torch.cat([
        xp[:, kd:kd + t, kh:kh + h, kw:kw + w]
        for kd in range(3) for kh in range(3) for kw in range(3)
    ], dim=-1)
    out = torch.matmul(
        patches.reshape(-1, 27 * cin), kernel.float().reshape(27 * cin, cout)
    )
    if bias is not None:
        out = out + bias.float()
    return out.reshape(b, t, h, w, cout).to(x.dtype)


def _check(name, x, w, bias, w_shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x is on {x.device}, not a CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"{name}: dtype {x.dtype}; the kernel takes one of {list(_DTYPE_CODES)}"
        )
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError(
            f"{name}: x must be a contiguous (B, T, H, W, Cin) tensor, got "
            f"shape {tuple(x.shape)}, strides {x.stride()}"
        )
    if (w.device != x.device or w.dtype != x.dtype or tuple(w.shape) != w_shape
            or not w.is_contiguous()):
        raise ValueError(
            f"{name}: the packed weight must be a contiguous {x.dtype} "
            f"{w_shape} tensor on {x.device}, got {w.dtype} {tuple(w.shape)} "
            f"on {w.device}"
        )
    cout = w_shape[-1] if len(w_shape) == 2 else w_shape[-1] // 3
    if bias is not None and (
        bias.device != x.device or bias.dtype != torch.float32
        or tuple(bias.shape) != (cout,) or not bias.is_contiguous()
    ):
        raise ValueError(
            f"{name}: bias must be a contiguous float32 ({cout},) tensor on "
            f"{x.device}, got {bias.dtype} {tuple(bias.shape)} on {bias.device}"
        )


def _launch(fn_name, x, w, bias, cout):
    b, t, h, wd, cin = x.shape
    out = torch.empty((b, t, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("conv3d", _SIGNATURES)
    err = getattr(lib, fn_name)(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        b, t, h, wd, cin, cout, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")
    return out


def conv3d_same_im2col(x, w_mat, bias=None) -> torch.Tensor:
    """Stride-1 SAME 3×3×3 conv with the folded ``(27·Cin, Cout)`` weight.
    CPU tensors take the plain twin; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return conv3d_same_reference(x, unpack_im2col(w_mat), bias)
    cin = x.shape[-1]
    _check("conv3d_same_im2col", x, w_mat, bias, (27 * cin, w_mat.shape[-1]))
    out = _launch("crowdmod_conv3d_im2col", x, w_mat, bias, w_mat.shape[-1])
    conv3d_same_im2col.launches += 1
    return out


def conv3d_same_tapgemm(x, w_taps, bias=None) -> torch.Tensor:
    """Stride-1 SAME 3×3×3 conv with the tap-packed ``(9, Cin, 3·Cout)``
    weight.  CPU tensors take the plain twin; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return conv3d_same_reference(x, unpack_tapgemm(w_taps), bias)
    cin = x.shape[-1]
    _check("conv3d_same_tapgemm", x, w_taps, bias, (9, cin, w_taps.shape[-1]))
    if w_taps.shape[-1] % 3:
        raise ValueError(
            f"conv3d_same_tapgemm: weight width {w_taps.shape[-1]} is not 3·Cout"
        )
    if x.shape[3] > TAPGEMM_MAX_WIDTH:
        raise ValueError(
            f"conv3d_same_tapgemm: width {x.shape[3]} > {TAPGEMM_MAX_WIDTH}, "
            "the most one kernel block takes"
        )
    out = _launch("crowdmod_conv3d_tapgemm", x, w_taps, bias,
                  w_taps.shape[-1] // 3)
    conv3d_same_tapgemm.launches += 1
    return out


conv3d_same_im2col.launches = 0
conv3d_same_tapgemm.launches = 0
