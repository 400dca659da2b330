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

:func:`im2col_plan` and :func:`tapgemm_plan` cut each call into blocks
(tile widths, K chunk, split-K) from its shape and dtype; the wrapper passes
the plan to the kernel, so the plan is testable without a card.  A split-K
call is two launches (the splits, then their sum) and counts as one launch
of the wrapper.  The kernels are the ``crowdmod::conv3d_im2col`` and
``crowdmod::conv3d_tapgemm`` operators (:mod:`.library`).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from crowdmod_tpu_torch.ops.kernels import build, library
from crowdmod_tpu_torch.ops.kernels.build import SMS, sm_count

SIMT_BK = 16  # csrc/common.cuh, kBK: the f32 kernels' K chunk
NARROW_WEIGHTS = 6144  # csrc/conv3d.cu, kNarrowWeights: f32 weight floats in shared memory
# A bf16 tap-GEMM block holds R whole rows of W + 2 padded columns in its
# 128 GEMM rows (csrc/conv3d.cu; the f32 block has 160).
TAPGEMM_MAX_WIDTH = 126
_TAP_BLOCK = {torch.bfloat16: (128, 32), torch.float32: (160, 16)}  # rows, channels
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "crowdmod_conv3d_im2col": (ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 5
                               + [ctypes.c_int] * 11 + [ctypes.c_void_p]),
    "crowdmod_conv3d_tapgemm": (ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 4
                                + [ctypes.c_int] * 8 + [ctypes.c_void_p]),
    "crowdmod_conv3d_smem_bytes": (ctypes.c_int, [ctypes.c_int] * 4),
}


@dataclass(frozen=True)
class ConvPlan:
    """How one conv call is cut into blocks (the kernels' tile plan).

    ``bm``/``bn``: a block's GEMM rows and columns (f32 im2col: ``bn == 4``
    is the narrow kernel, a thread per position); ``bk``: the depth of a K
    chunk; ``kc``: the channels of one tap a K chunk takes (0: the flat K,
    or element loads); ``splits``: the 27 taps split over that many blocks
    (im2col only), summed by a second launch; ``blocks``: blocks of the main
    launch.  Shared memory and pipeline stages are the C tile table's
    (``crowdmod_conv3d_smem_bytes``)."""

    bm: int
    bn: int
    bk: int
    kc: int
    splits: int
    blocks: int

    def split_taps(self) -> list[tuple[int, int]]:
        """The taps ``[lo, hi)`` of each split, as the kernel cuts them."""
        s = self.splits
        return [(i * 27 // s, (i + 1) * 27 // s) for i in range(s)]

    def workspace_elems(self, positions: int, cout: int) -> int:
        """float32 elements of the split-K workspace: one partial output a
        split."""
        return self.splits * positions * cout if self.splits > 1 else 0


# The bf16 tiles (BM, BN, BK) csrc/conv3d.cu is built with: its
# CROWDMOD_IM2COL_TILES table and TapTile.
IM2COL_TILES = frozenset({(128, 32, 32), (128, 64, 32), (128, 64, 64), (128, 128, 64),
                          (256, 64, 64)})
TAPGEMM_TILES = frozenset({(128, 96, 32), (128, 96, 64)})


def _tap_chunk(cin: int, bk: int) -> int:
    """Channels of one tap a bf16 K chunk of depth ``bk`` takes: the widest
    of 64 (up to bk), 32, 16, 8 dividing Cin; 0 where Cin % 8 ≠ 0 (no
    16-byte rows)."""
    return next((kc for kc in (64, 32, 16, 8) if kc <= bk and cin % kc == 0), 0)


def mma_plan(tile, cin: int, splits: int, blocks: int) -> ConvPlan:
    """A bf16 plan on ``tile`` = (BM, BN, BK) of :data:`IM2COL_TILES` or
    :data:`TAPGEMM_TILES`."""
    bm, bn, bk = tile
    return ConvPlan(bm, bn, bk, _tap_chunk(cin, bk), splits, blocks)


def smem_bytes(impl: str, plan: ConvPlan) -> int:
    """Dynamic shared memory of a bf16 block of ``plan`` (``impl``:
    ``"im2col"`` or ``"tapgemm"``), from the built library's tile table."""
    lib = build.load("conv3d", _SIGNATURES)
    return lib.crowdmod_conv3d_smem_bytes(
        ("im2col", "tapgemm").index(impl), plan.bm, plan.bn, plan.bk)


@functools.lru_cache(maxsize=256)
def im2col_plan(x_shape, cout: int, dtype, sms: int = SMS) -> ConvPlan:
    """The tile plan of :func:`conv3d_same_im2col` for ``x_shape`` → Cout.

    bf16: 64-deep K chunks where a tap's channels fill them (Cin % 64 == 0),
    with a 128- or 64-channel tile; otherwise 32-deep chunks and a 64- or
    32-channel tile.  Blocks take 128 positions, or 256 for a 64-channel
    tile of 64-deep chunks where that still makes two waves (level 0).
    Where the tiles are under one wave of ``sms`` blocks (level 2), the 27
    taps split in 9.  ``chip_smoke.py --conv-tiles`` times every tile at
    every path shape: the data behind these rules.

    f32: the CUDA-core loop's 64-, 32- or 16-channel tile, or the narrow
    kernel for Cout ≤ 4."""
    b, t, h, w, cin = x_shape
    positions = b * t * h * w
    blocks = lambda bm, bn: -(-positions // bm) * -(-cout // bn)  # noqa: E731
    if dtype == torch.float32:
        if cout <= 4 and cin % 4 == 0 and cin * 4 <= NARROW_WEIGHTS:
            return ConvPlan(256, 4, SIMT_BK, 0, 1, -(-positions // 256))
        bn = (64 if cout >= 64 and blocks(128, 64) >= 2 * sms
              else 32 if cout >= 32 else 16)
        return ConvPlan(128, bn, SIMT_BK, 0, 1, blocks(128, bn))
    deep = cin % 64 == 0
    bn = 128 if cout > 64 and deep else 64 if cout > 32 else 32
    bk = 64 if deep and bn >= 64 else 32
    bm = 256 if (bn, bk) == (64, 64) and blocks(256, 64) >= 2 * sms else 128
    tiles = blocks(bm, bn)
    splits = 9 if cin % 8 == 0 and tiles < sms else 1
    return mma_plan((bm, bn, bk), cin, splits, tiles * splits)


@functools.lru_cache(maxsize=256)
def tapgemm_plan(x_shape, cout: int, dtype) -> ConvPlan:
    """The tile plan of :func:`conv3d_same_tapgemm`: whole rows of W + 2
    padded columns a block, 32 (bf16) or 16 (f32) output channels × 3 kw
    taps in N; bf16 K chunks 64 deep where Cin % 64 == 0, else 32."""
    b, t, h, w, cin = x_shape
    bm, cb = _TAP_BLOCK[dtype]
    if w + 2 > bm:
        raise ValueError(f"tap-GEMM: width {w} does not fit a {bm}-row block")
    blocks = -(-(b * t * h) // (bm // (w + 2))) * -(-cout // cb)
    if dtype == torch.float32:
        return ConvPlan(bm, 3 * cb, SIMT_BK, 0, 1, blocks)
    return mma_plan((bm, 3 * cb, 64 if cin % 64 == 0 else 32), cin, 1, blocks)


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
    """Plain twin: pad once, gather the 27 shifted windows in (kd, kh, kw,
    ci) order (three unfolds: a handful of views, quick to trace), one f32
    matmul with the folded kernel, + bias, cast to x's dtype."""
    b, t, h, w, cin = x.shape
    cout = kernel.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    # (b, t, h, w, ci, kd, kh, kw) → (…, kd, kh, kw, ci)
    patches = xp.unfold(1, 3, 1).unfold(2, 3, 1).unfold(3, 3, 1).permute(
        0, 1, 2, 3, 5, 6, 7, 4)
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


def _launch(fn_name, x, w, bias, cout, plan_args, workspace=()):
    """Launch ``fn_name`` on x's stream: the pointers, then ``workspace``
    (im2col: its split-K buffer or None), the shape, then ``plan_args``."""
    b, t, h, wd, cin = x.shape
    out = torch.empty((b, t, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load("conv3d", _SIGNATURES)
    err = getattr(lib, fn_name)(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), *workspace,
        b, t, h, wd, cin, cout, *plan_args,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")
    return out


def conv3d_same_im2col(x, w_mat, bias=None) -> torch.Tensor:
    """Stride-1 SAME 3×3×3 conv with the folded ``(27·Cin, Cout)`` weight.
    CPU tensors take the plain twin; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return conv3d_same_reference(x, unpack_im2col(w_mat), bias)
    return torch.ops.crowdmod.conv3d_im2col(x, w_mat, bias)


def _im2col_cuda(x, w_mat, bias):
    """``crowdmod::conv3d_im2col`` on CUDA tensors: check, plan, launch."""
    cin = x.shape[-1]
    _check("conv3d_same_im2col", x, w_mat, bias, (27 * cin, w_mat.shape[-1]))
    cout = w_mat.shape[-1]
    plan = im2col_plan(tuple(x.shape), cout, x.dtype, sm_count(x.device))
    ws = None
    if plan.splits > 1:  # freed on return: the allocator orders reuse on the stream
        ws = torch.empty(plan.workspace_elems(x.numel() // cin, cout),
                         dtype=torch.float32, device=x.device)
    out = _launch("crowdmod_conv3d_im2col", x, w_mat, bias, cout,
                  (plan.bm, plan.bn, plan.bk, plan.kc, plan.splits),
                  (None if ws is None else ws.data_ptr(),))
    conv3d_same_im2col.launches += 1
    return out


def conv3d_same_tapgemm(x, w_taps, bias=None) -> torch.Tensor:
    """Stride-1 SAME 3×3×3 conv with the tap-packed ``(9, Cin, 3·Cout)``
    weight.  CPU tensors take the plain twin; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return conv3d_same_reference(x, unpack_tapgemm(w_taps), bias)
    return torch.ops.crowdmod.conv3d_tapgemm(x, w_taps, bias)


def _tapgemm_cuda(x, w_taps, bias):
    """``crowdmod::conv3d_tapgemm`` on CUDA tensors: check, plan, launch."""
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
    cout = w_taps.shape[-1] // 3
    plan = tapgemm_plan(tuple(x.shape), cout, x.dtype)
    out = _launch("crowdmod_conv3d_tapgemm", x, w_taps, bias, cout, (plan.bk, plan.kc))
    conv3d_same_tapgemm.launches += 1
    return out


def _conv_fake(x, w, bias):
    cout = w.shape[-1] if w.dim() == 2 else w.shape[-1] // 3
    return x.new_empty((*x.shape[:-1], cout))


library.define("conv3d_im2col(Tensor x, Tensor w, Tensor? bias) -> Tensor",
               _im2col_cuda, _conv_fake)
library.define("conv3d_tapgemm(Tensor x, Tensor w, Tensor? bias) -> Tensor",
               _tapgemm_cuda, _conv_fake)
conv3d_same_im2col.launches = 0
conv3d_same_tapgemm.launches = 0
