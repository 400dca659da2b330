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
from its shape and dtype: in bf16 the output tile of whole rows a block
owns, the halo box it loads by TMA once a channel chunk, the GEMM tiles,
the chunk depth, the stages in flight, split-K and shared memory; the
wrapper passes the plan to the kernel, so the plan is testable without a
card.  A split-K
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

SIMT_BK = 16  # csrc/common.cuh, kBK: the f32 SIMT loops' K chunk
SMEM_LIMIT = 232448  # dynamic shared memory a block may use (csrc/conv3d.cu kSmemLimit)
MAX_STAGES = 4  # csrc/conv3d.cu kMaxStages: weight chunks in flight, at most
# A bf16 block takes whole rows of W + 2 padded columns: tap-GEMM's 128 GEMM
# rows, im2col's 256 (or 128 for thin grids, where W + 2 <= 128).
TAPGEMM_MAX_WIDTH = 126
IM2COL_MAX_WIDTH = 254
# The bf16 halo kernels csrc/conv3d.cu is built with (CROWDMOD_HALO_TILES):
# (impl, bm, bn, kc) — bm = 128 * (64-row tiles a warpgroup), bn = 64 *
# (64-column atoms; tap-GEMM's 3 are the kw taps of 64 channels, its 1 or 2
# the compact form over the weight's 3·Cout columns, for 3·Cout <= 128).
HALO_TILES = frozenset(
    {("im2col", bm, 64, kc) for bm in (128, 256) for kc in (64, 32, 16, 8)}
    | {("tapgemm", 128, bn, kc) for bn in (64, 128, 192) for kc in (64, 32, 16, 8)})
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCH = (ctypes.c_int, [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15
           + [ctypes.c_void_p])
_SIGNATURES = {
    "crowdmod_conv3d_im2col": _LAUNCH,
    "crowdmod_conv3d_tapgemm": _LAUNCH,
    "crowdmod_conv3d_smem_bytes": (ctypes.c_int, [ctypes.c_int] * 12),
}


@dataclass(frozen=True)
class ConvPlan:
    """How one conv call is cut into blocks (the kernels' tile plan).

    ``route``: ``"halo"`` (bf16: TMA halo box, wgmma), ``"narrow"`` (f32,
    Cout ≤ 4: the staged f32 halo, a thread an output position) or
    ``"simt"`` (the other f32 calls).  ``bm``/``bn``: a block's GEMM rows
    and columns (halo: 2 warpgroups × 64-row tiles, 64-column atoms; narrow:
    bn 4); ``kc``: the channels of a K chunk, the halo box's depth (simt:
    its K chunk, 16).  ``tile``: the (samples, t slices, h rows) of output a
    block owns, all of W; ``box``: the halo box (samples, t, h, w) it loads
    a chunk, ``tile`` + 2 in t and h, W + 2; ``rows``: the tile's live GEMM
    rows (W + 2 a row: the pad columns are computed and dropped).
    ``stages``: weight chunks in flight; ``nbox``: halo boxes in flight;
    ``splits``: the taps (27, or 9 slabs) split in that many runs over as
    many work items, summed by a second launch; ``blocks``: the work items
    (tiles × channel tiles × splits; the halo kernel walks them with one
    persistent block a multiprocessor; simt and narrow: blocks of the
    launch); ``smem_bytes``: dynamic shared memory a block;
    ``tma_x``/``tma_w``: the box / the weight stages come by TMA (16-byte
    rows: Cin % 8 == 0 / Cout % 8 == 0), else by the producer's element
    loads.  The halo fields are 0 on the simt route.
    """

    route: str
    bm: int
    bn: int
    kc: int
    tile: tuple
    box: tuple
    rows: int
    stages: int
    nbox: int
    splits: int
    blocks: int
    smem_bytes: int
    tma_x: bool
    tma_w: bool

    def args(self) -> tuple:
        """The plan's integers in the C interface's order."""
        return (self.bm, self.bn, self.kc, *self.tile, self.stages, self.nbox, self.splits)

    def split_taps(self, taps: int = 27) -> list[tuple[int, int]]:
        """The taps (im2col: 27; tap-GEMM: 9 slabs) ``[lo, hi)`` of each
        split, as the kernel cuts them."""
        s = self.splits
        return [(i * taps // s, (i + 1) * taps // s) for i in range(s)]

    def workspace_elems(self, positions: int, cout: int) -> int:
        """float32 elements of the split-K workspace: one partial output a
        split."""
        return self.splits * positions * cout if self.splits > 1 else 0


def halo_smem_bytes(tap: bool, bm: int, bn: int, kc: int, box_positions: int,
                    stages: int, nbox: int) -> int:
    """Dynamic shared memory of a halo block (csrc/conv3d.cu
    ``halo_smem_bytes``): ``nbox`` boxes (each rounded up to 1024 bytes),
    ``stages`` weight chunks of bn / 64 atoms × :func:`stage_rows` × 128
    bytes, tap-GEMM's f32 Z tile (bm × (bn + 4)), 12 barriers and 1024
    bytes of alignment."""
    box = -(-box_positions * kc * 2 // 1024) * 1024
    main = (nbox * box + stages * (bn // 64) * stage_rows(kc) * 128
            + (bm * (bn + 4) * 4 if tap else 0))
    return 1024 + main + 8 * (4 + 2 * MAX_STAGES)


def narrow_smem_bytes(cin: int, tb: int, hb: int, w: int) -> int:
    """Shared memory of a narrow f32 block: the weight as a float4 a (tap,
    ci) and the halo box of all Cin channels, float4 chunks with a pad slot
    every 8 positions."""
    npos = (tb + 2) * (hb + 2) * (w + 2)
    return (27 * cin + cin // 4 * (npos + npos // 8 + 1)) * 16


def _halo_kc(cin: int) -> int:
    """Channels a chunk: 64 where Cin takes them, else 32, or 16 or 8 for a
    narrow Cin (8: the packed stages, four taps of 8 channels each)."""
    return 64 if cin % 64 == 0 else 32 if cin > 16 else 16 if cin > 8 else 8


def stage_rows(kc: int) -> int:
    """Weight rows of a stage: one tap's kc, or the packed stage's 4 × 8."""
    return 32 if kc == 8 else kc


def _halo_tile(x_shape, tap: bool, bm: int, bn: int, kc: int):
    """The (samples, t, h) box of whole rows that computes the fewest GEMM
    rows in all (bm a tile, padding included), then loads the fewest halo
    positions; samples share a tile only whole.  → (tile, box positions,
    tiles), or None where no tile fits."""
    b, t, h, w, _ = x_shape
    pw = w + 2
    best = None
    for tb in range(1, t + 1):
        for hb in range(1, h + 1):
            for bb in range(1, b + 1 if (tb, hb) == (t, h) else 2):
                if bb * tb * hb * pw > bm:
                    break
                npos = bb * (tb + 2) * (hb + 2) * pw
                if halo_smem_bytes(tap, bm, bn, kc, npos, 2, 1) > SMEM_LIMIT:
                    break
                mtiles = -(-b // bb) * -(-t // tb) * -(-h // hb)
                key = (mtiles * bm, mtiles * npos)
                if best is None or key < best[0]:
                    best = (key, (bb, tb, hb), npos, mtiles)
    return None if best is None else best[1:]


def halo_plan(impl: str, x_shape, cout: int, sms: int = SMS, block=None,
              splits=None) -> ConvPlan:
    """A bf16 plan.  The block (bm, bn) is tap-GEMM's (128, 192) — three kw
    taps of 64 channels — or, where 3·Cout <= 128, (128, 64 or 128) over
    the weight's own 3·Cout columns; im2col's is (256, 64), or (128, 64)
    where the 256-row tiles make under a quarter of ``sms`` work items
    (the serving buckets of 1 and 8: ``--conv-tiles`` timed the 128-row
    block 10–15% faster at batch 1, slower at batch 64; a 128 × 128 im2col
    block was no faster at level 1, slower at level 2); ``block`` forces
    one of :data:`HALO_TILES` (``--conv-tiles``).  The tile is
    :func:`_halo_tile`'s.  Two boxes where Cin takes several chunks and
    they fit (the next chunk's box loads while this one computes; with one
    chunk a second box was 5% slower at level 0, ``chip_smoke.py
    --conv-ab``), then as many weight stages as fit (at most 4); where the
    work items fill under 90% of ``sms`` (level 2; every level at batch 1)
    the taps split over 2, 3 or 9 items, the most that still run in one
    wave (``--conv-tiles`` at batch 64 and 1: a second wave costs more than
    the split saves) (``splits`` forces 1, 2, 3 or 9)."""
    b, t, h, w, cin = x_shape
    tap = impl == "tapgemm"
    pw = w + 2
    if tap:
        bm, bn = 128, 192 if 3 * cout > 128 else 64 * -(-3 * cout // 64)
        if w > TAPGEMM_MAX_WIDTH:
            raise ValueError(f"tap-GEMM: width {w} does not fit a {bm}-row block")
    else:
        bm, bn = 256, 64
        if w > IM2COL_MAX_WIDTH:
            raise ValueError(f"im2col: width {w} does not fit a 256-row block")
    if block is not None:
        bm, bn = block
        if tap and bn < 192 and 3 * cout > bn:
            raise ValueError(f"tap-GEMM: 3·Cout = {3 * cout} columns do not fit bn {bn}")
    kc = _halo_kc(cin)
    ntiles = 1 if tap and bn < 192 else -(-cout // 64)
    found = _halo_tile(x_shape, tap, bm, bn, kc)
    if found is None:
        raise ValueError(f"{impl}: no halo tile of {x_shape} fits a block")
    if not tap and block is None and pw <= 128 and found[2] * ntiles < sms / 4:
        bm = 128
        found = _halo_tile(x_shape, tap, bm, bn, kc)
    tile, npos, mtiles = found
    nbox, stages = next(
        (nb, s) for nb in ((2, 1) if cin > kc else (1,)) for s in (4, 3, 2)
        if halo_smem_bytes(tap, bm, bn, kc, npos, s, nb) <= SMEM_LIMIT)
    if kc == 8:  # the packed stages walk all taps in one block
        splits = 1
    elif splits is None:
        items = mtiles * ntiles
        splits = 1 if items >= 0.9 * sms else max(
            k for k in (1, 2, 3, 9) if k == 1 or items * k <= sms)
    bb, tb, hb = tile
    return ConvPlan("halo", bm, bn, kc, tile, (bb, tb + 2, hb + 2, pw), bb * tb * hb * pw,
                    stages, nbox, splits, mtiles * ntiles * splits,
                    halo_smem_bytes(tap, bm, bn, kc, npos, stages, nbox),
                    cin % 8 == 0, cout % 8 == 0)


def _narrow_plan(x_shape, sms: int) -> ConvPlan | None:
    """The narrow f32 plan, or None where no tile fits: the (t, h) tile of
    one sample (all of W, a thread an output position) with the fewest
    blocks, then the least shared memory, among those that leave room for
    two blocks a multiprocessor (else any that fits)."""
    b, t, h, w, cin = x_shape
    if cin % 4:
        return None
    cands = []
    for tb in range(1, t + 1):
        for hb in range(1, h + 1):
            smem = narrow_smem_bytes(cin, tb, hb, w)
            if smem > SMEM_LIMIT:
                break
            blocks = b * -(-t // tb) * -(-h // hb)
            cands.append((smem > SMEM_LIMIT // 2, blocks, smem, (tb, hb)))
    if not cands:
        return None
    _, blocks, smem, (tb, hb) = min(cands)
    return ConvPlan("narrow", tb * hb * w, 4, 4, (1, tb, hb), (1, tb + 2, hb + 2, w + 2),
                    tb * hb * w, 1, 1, 1, blocks, smem, False, False)


def _simt(bm: int, bn: int, blocks: int) -> ConvPlan:
    return ConvPlan("simt", bm, bn, SIMT_BK, (0, 0, 0), (0, 0, 0, 0), 0, 0, 0, 1, blocks, 0,
                    False, False)


def smem_bytes(impl: str, plan: ConvPlan, x_shape) -> int:
    """Dynamic shared memory of a block of ``plan`` for an input of
    ``x_shape`` (``impl``: ``"im2col"`` or ``"tapgemm"``), as the built
    library computes it (``crowdmod_conv3d_smem_bytes``)."""
    lib = build.load("conv3d", _SIGNATURES)
    w, cin = x_shape[3], x_shape[4]
    return lib.crowdmod_conv3d_smem_bytes(
        ("im2col", "tapgemm").index(impl), int(plan.route == "halo"), w, cin,
        plan.bm, plan.bn, plan.kc, *plan.tile, plan.stages, plan.nbox)


@functools.lru_cache(maxsize=256)
def im2col_plan(x_shape, cout: int, dtype, sms: int = SMS) -> ConvPlan:
    """The plan of :func:`conv3d_same_im2col` for ``x_shape`` → Cout.

    bf16: the halo kernel, 256 rows × 64 columns a block (128 for the
    thin grids of the small serving buckets) (:func:`halo_plan`).  f32: the narrow kernel for Cout ≤ 4
    (the final conv), else the SIMT loop's 64-, 32- or 16-channel tile."""
    b, t, h, w, cin = x_shape
    if dtype == torch.float32:
        if cout <= 4:
            plan = _narrow_plan(x_shape, sms)
            if plan is not None:
                return plan
        positions = b * t * h * w
        blocks = lambda bn: -(-positions // 128) * -(-cout // bn)  # noqa: E731
        bn = 64 if cout >= 64 and blocks(64) >= 2 * sms else 32 if cout >= 32 else 16
        return _simt(128, bn, blocks(bn))
    return halo_plan("im2col", x_shape, cout, sms)


@functools.lru_cache(maxsize=256)
def tapgemm_plan(x_shape, cout: int, dtype, sms: int = SMS) -> ConvPlan:
    """The plan of :func:`conv3d_same_tapgemm`: bf16, the halo kernel with
    128 rows a block and 64 output channels × 3 kw taps in N (all 3·Cout
    columns where they are 128 or fewer); f32, the SIMT block of 160 rows
    of W + 2 padded columns × 16 channels × 3 taps."""
    b, t, h, w, cin = x_shape
    if dtype == torch.float32:
        if w + 2 > 160:
            raise ValueError(f"tap-GEMM: width {w} does not fit a 160-row block")
        return _simt(160, 48, -(-(b * t * h) // (160 // (w + 2))) * -(-cout // 16))
    return halo_plan("tapgemm", x_shape, cout, sms)


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


def _launch(fn_name, x, w, bias, cout, plan):
    """Launch ``fn_name`` with ``plan`` on x's stream (a split plan with its
    f32 workspace, freed on return: the allocator orders its reuse on the
    stream)."""
    b, t, h, wd, cin = x.shape
    out = torch.empty((b, t, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    ws = None
    if plan.splits > 1:
        ws = torch.empty(plan.workspace_elems(b * t * h * wd, cout), dtype=torch.float32,
                         device=x.device)
    lib = build.load("conv3d", _SIGNATURES)
    err = getattr(lib, fn_name)(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), b, t, h, wd, cin, cout, *plan.args(),
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
    out = _launch("crowdmod_conv3d_im2col", x, w_mat, bias, cout, plan)
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
    plan = tapgemm_plan(tuple(x.shape), cout, x.dtype, sm_count(x.device))
    out = _launch("crowdmod_conv3d_tapgemm", x, w_taps, bias, cout, plan)
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
