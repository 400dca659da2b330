#!/usr/bin/env python3
"""Drive the PyTorch port (``crowdmod_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, on a machine with CUDA

Phases, one line of numbers each; any failure raises and the script exits
non-zero without a result line:

  1. device: the card's name and power limit (nvidia-smi), kernel build time;
  2. kernels: each CUDA kernel against its plain twin on the card, at the
     serving paths' shapes, in f32 and bf16, with device times (CUDA
     events), the host's time to issue a call, bounds and the library
     yardstick;
  3. DiT serving: ``configs/serving/ATC.yml`` with DDPM-DiT (hidden 256,
     depth 6, DDIM-eta 25 steps + Sparsity) and seeded random weights,
     through ``load_predictor``/``warmup``/``BatchingQueue``, with p50
     latency per bucket and a ``torch.profiler`` trace of one batch-64
     request (device busy time, kernel launches, the top kernels);
  4. DiT ancestral: the same model with ``SAMPLER: DDPM`` (T = 1000);
  5. DiT end to end against the twins: one f32 denoiser forward and one
     25-step DDIM-eta chain, with the kernels and with the twins, on the card;
  6. UNet serving: phase 3 with DDPM-UNet (base 32, mults 1-2-4, attention
     at level 2), whose forward runs the GroupNorm, conv (im2col), fused
     ResnetBlock and attention kernels;
  7. UNet ancestral: phase 4 with DDPM-UNet;
  8. UNet end to end in f32: kernels with ``conv_impl="im2col"``, kernels
     with ``conv_impl="tapgemm"`` (the tap-GEMM kernel's path) and twins.

Each path is driven with the launch counts set to 0 just before it and read
just after: phases 3-4 (DiT), phases 6-7 (UNet) and the tap-GEMM run of
phase 8; the counts are held to the launches each forward makes.  The last
two lines are a JSON object with every kernel's numbers and
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

DEVICE = "cuda"
SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {"attention_f32": 1e-5, "attention_bf16": 2e-2, "step": 1e-6,
       "forward_f32": 1e-4, "chain": 1e-3, "max_flip_share": 1e-3,
       # GroupNorm: absolute; conv and resblock: times max|ref| (K up to
       # 27·256 terms summed in another order); bf16: any kernel's bf16
       # output against the f32 twin on the same bf16 inputs, times max|ref|.
       "gn_f32": 1e-5, "conv_f32": 1e-4, "resblock_f32": 1e-4, "bf16": 2e-2}
REPLACES = {
    "fused_attention": "crowdmod_tpu/ops/pallas/attention.py:53",
    "fused_ancestral_update": "crowdmod_tpu/ops/pallas/fused_step.py:59",
    "fused_group_norm": "crowdmod_tpu/ops/pallas/groupnorm.py:81",
    "conv3d_same_im2col": "crowdmod_tpu/ops/pallas/conv3d.py:158",
    "conv3d_same_tapgemm": "crowdmod_tpu/ops/pallas/conv3d.py:99",
    "fused_resblock": "crowdmod_tpu/ops/pallas/resblock.py:253",
}
SOURCES = {
    "fused_attention": "crowdmod_tpu_torch/csrc/attention.cu",
    "fused_ancestral_update": "crowdmod_tpu_torch/csrc/fused_step.cu",
    "fused_group_norm": "crowdmod_tpu_torch/csrc/groupnorm.cu",
    "conv3d_same_im2col": "crowdmod_tpu_torch/csrc/conv3d.cu",
    "conv3d_same_tapgemm": "crowdmod_tpu_torch/csrc/conv3d.cu",
    "fused_resblock": "crowdmod_tpu_torch/csrc/resblock.cu",
}
# Kernel launches of one denoiser forward at the serving config's width:
# the DiT's two attentions a block; the UNet's fused level-0 blocks, its
# standalone convs and GroupNorms (the shape tables below) and 4 attentions
# (level 2 and the bottleneck).
PER_FORWARD = {
    "DDPM-DiT": lambda cfg: {"fused_attention": 2 * cfg.MODEL.DDPM.DIT.DEPTH},
    "DDPM-UNet": lambda cfg: {
        "fused_resblock": len(RESBLOCK_SHAPES),
        "conv3d_same_im2col": sum(CONV_SHAPES.values()),
        "fused_group_norm": sum(GN_SHAPES.values()),
        "fused_attention": 4,
    },
}


def log(phase: str, **numbers) -> None:
    print(f"[{phase}] " + json.dumps(numbers), flush=True)


def cuda_ms(fn, *, iters: int = 20, reps: int = 15) -> tuple[float, float]:
    """Device time of one call of ``fn``, from CUDA events, and the host's
    time to issue it.

    Each repetition first queues a ~5 ms spin kernel, so the host has issued
    all ``iters`` calls before the card reaches them: the events then time
    the calls back to back on the card, not the host's launch rate.  Returns
    the medians over ``reps`` of (device ms per call, host ms per call)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    device, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host.append(1e3 * (time.perf_counter() - t0) / iters)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / iters)
    return statistics.median(device), statistics.median(host)


def cuda_ms_budget(fn, budget_ms: float = 40.0) -> tuple[float, float]:
    """:func:`cuda_ms` over 5 repetitions of about ``budget_ms`` of device
    time each: at least one call a repetition, at most 20."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = 1e3 * (time.perf_counter() - t0)
    iters = max(1, min(20, int(budget_ms / max(once, 1e-3))))
    return cuda_ms(fn, iters=iters, reps=5)


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate vs operations
    over the type's peak; → (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------

def phase_device() -> dict:
    from crowdmod_tpu_torch.ops.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    seconds = build.build_all()
    regs = {
        n: [ln.strip() for ln in build.library_path(n).with_suffix(".log")
            .read_text().splitlines() if "registers" in ln]
        for n in build.SOURCES
    }
    log("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        build_s=round(seconds, 3), ptxas=regs)
    return {"kind": name, "smi": smi}


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------

def _randn(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check_attention(label, b, h, sq, sk, dh, dtype, gen, *, packed=False):
    """Kernel vs twin at one shape; times kernel, twin and SDPA."""
    import torch.nn.functional as F

    from crowdmod_tpu_torch.ops.kernels import attention_reference, fused_attention

    if packed:  # strided views of one (B, S, 3, H, Dh) buffer, as MHA gives
        qkv = _randn((b, sq, 3, h, dh), gen, dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q = _randn((b, h, sq, dh), gen, dtype)
        k, v = _randn((b, h, sk, dh), gen, dtype), _randn((b, h, sk, dh), gen, dtype)
    scale = 1.0 / dh**0.5
    out = fused_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    ref = attention_reference(q.float(), k.float(), v.float(), scale)
    err = (out.float() - ref).abs().max().item()
    tol = TOL["attention_f32" if dtype == torch.float32 else "attention_bf16"]
    if not err <= tol:
        raise AssertionError(f"attention {label}: max abs err {err} > {tol}")
    elsize = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * elsize
    b_ms, b_by = bound(nbytes, 4 * b * h * sq * sk * dh, dtype)
    ms, host_ms = cuda_ms(lambda: fused_attention(q, k, v, scale=scale))
    res = dict(
        shape=[b, h, sq, sk, dh], dtype=str(dtype).split(".")[1],
        max_abs_err=err, tolerance=tol, ms=ms, host_ms=host_ms,
        plain_ms=cuda_ms(lambda: attention_reference(q, k, v, scale))[0],
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
        )[0],
    )
    log(f"kernel attention {label}", **res)
    return res


def check_step(label, shape, sparsity, gen):
    from crowdmod_tpu_torch.ops.kernels import (
        ancestral_update_reference,
        fused_ancestral_update,
    )

    x, eps, z = (_randn(shape, gen) for _ in range(3))
    # Coefficients of step t = 500 of the ATC schedule (T = 1000, scale 0.5).
    from crowdmod_tpu_torch.core.schedule import linear_schedule

    s = linear_schedule(1000, scale=0.5)
    kw = dict(
        inv_sqrt_alpha=float(s.one_by_sqrt_alpha[500]),
        beta_over_somab=float(s.beta[500] / s.sqrt_one_minus_alpha_bar[500]),
        sigma=float(np.sqrt(s.beta[500])), lambda_guidance=0.6,
        sparsity=sparsity,
    )
    out = fused_ancestral_update(x, eps, z, **kw)
    torch.cuda.synchronize()
    err = (out - ancestral_update_reference(x, eps, z, **kw)).abs().max().item()
    if not err <= TOL["step"]:
        raise AssertionError(f"ancestral step {label}: max abs err {err}")
    n = x.numel()
    b_ms, b_by = bound(16 * n, (7 if sparsity else 5) * n, torch.float32)
    ms, host_ms = cuda_ms(lambda: fused_ancestral_update(x, eps, z, **kw))
    res = dict(
        shape=list(shape), dtype="float32", sparsity=sparsity,
        max_abs_err=err, tolerance=TOL["step"], ms=ms, host_ms=host_ms,
        plain_ms=cuda_ms(lambda: ancestral_update_reference(x, eps, z, **kw))[0],
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    log(f"kernel ancestral_update {label}", **res)
    return res


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    attn = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for batch in (64, 256):
            n_sp, n_tm = batch * 2, batch * 27  # B·T_p, B·N_s problems
            attn[f"spatial_b{batch}_{dn}"] = check_attention(
                f"spatial b{batch} {dn}", n_sp, 4, 27, 27, 64, dtype, gen)
            attn[f"temporal_b{batch}_{dn}"] = check_attention(
                f"temporal b{batch} {dn}", n_tm, 4, 1, 2, 64, dtype, gen)
        attn[f"spatial_b64_packed_{dn}"] = check_attention(
            f"spatial b64 packed {dn}", 128, 4, 27, 27, 64, dtype, gen,
            packed=True)
        attn[f"edge_s216_{dn}"] = check_attention(
            f"edge S216 Dh32 {dn}", 16, 4, 216, 216, 32, dtype, gen)
        # The UNet's level-2 attention: 54 positions, 4 heads of 32.
        attn[f"unet_b64_{dn}"] = check_attention(
            f"unet level-2 b64 {dn}", 64, 4, 54, 54, 32, dtype, gen, packed=True)
    step = {
        f"b64_{'sparsity' if sp else 'none'}": check_step(
            f"b64 {'sparsity' if sp else 'none'}", (64, 3, 12, 36, 3), sp, gen)
        for sp in (False, True)
    }
    return {"attention": attn, "step": step}


# ---------------------------------------------------------------------------
# Phase 2, the UNet kernels
# ---------------------------------------------------------------------------

UNET_BATCH = 64
LEVELS = {0: (8, 12, 36), 1: (4, 6, 18), 2: (2, 3, 9)}
# (level, Cin, Cout) of the standalone convs of one UNet forward → how many
# run at that shape: first, up_1 and final_conv at level 0; up_2 and the
# level-1 blocks' convs; the level-2 and bottleneck blocks' convs.
CONV_SHAPES = {(0, 3, 32): 1, (0, 64, 64): 1, (0, 32, 3): 1, (1, 32, 64): 1,
               (1, 64, 64): 3, (1, 192, 64): 1, (1, 96, 64): 1,
               (1, 128, 128): 1, (2, 64, 128): 1, (2, 128, 128): 7,
               (2, 256, 128): 1, (2, 192, 128): 1}
# (level, C, silu) of the standalone GroupNorms → count: the unfused blocks'
# GN1 and GN2, the 4 attention pre-norms (no SiLU), the final norm.
GN_SHAPES = {(0, 32, True): 1, (1, 32, True): 1, (1, 64, True): 3,
             (1, 192, True): 1, (1, 96, True): 1, (2, 64, True): 1,
             (2, 128, True): 7, (2, 128, False): 4, (2, 256, True): 1,
             (2, 192, True): 1}
# (Cin, Cout) of the fused level-0 blocks: enc_0_0, dec_0_0, dec_0_1.
RESBLOCK_SHAPES = [(32, 32), (96, 32), (64, 32)]


def _dn(dtype) -> str:
    return str(dtype).split(".")[1]


def _rel_check(label, out, ref, tol) -> float:
    """max |out − ref|, held to tol·max|ref|; raises beyond it."""
    scale = ref.abs().max().item()
    err = (out.float() - ref).abs().max().item()
    if not (scale > 0 and err <= tol * scale):
        raise AssertionError(f"{label}: max abs err {err} > {tol} x {scale}")
    return err


def _timings(res, kernel, plain, library, nbytes, flops, dtype):
    b_ms, b_by = bound(nbytes, flops, dtype)
    ms, host_ms = cuda_ms_budget(kernel)
    res.update(ms=ms, host_ms=host_ms, plain_ms=cuda_ms_budget(plain)[0],
               bound_ms=b_ms, bound_by=b_by,
               library_ms=None if library is None else cuda_ms_budget(library)[0])


def check_group_norm(level, c, act, dtype, gen, timing):
    import torch.nn.functional as F

    from crowdmod_tpu_torch.ops.kernels import fused_group_norm, group_norm_reference

    t, h, w = LEVELS[level]
    x = _randn((UNET_BATCH, t, h, w, c), gen, dtype)
    gamma = 1.0 + 0.1 * _randn((c,), gen)
    beta = 0.1 * _randn((c,), gen)
    out = fused_group_norm(x, gamma, beta, silu=act)
    torch.cuda.synchronize()
    ref = group_norm_reference(x.float(), gamma, beta, 8, 1e-5, act)
    err = (out.float() - ref).abs().max().item()
    if dtype == torch.float32:
        tol = TOL["gn_f32"]
        if not err <= tol:
            raise AssertionError(f"group norm {level} {c}: max abs err {err}")
    else:
        tol = TOL["bf16"]
        _rel_check(f"group norm {level} {c} bf16", out, ref, tol)
    res = dict(shape=[UNET_BATCH, t * h * w, c], silu=act, dtype=_dn(dtype),
               max_abs_err=err, tolerance=tol)
    if timing:
        # F.group_norm over the (B, C, S) view of the same memory, no SiLU.
        xs = x.reshape(UNET_BATCH, t * h * w, c).transpose(1, 2)
        g_lib, b_lib = gamma.to(dtype), beta.to(dtype)
        _timings(
            res, lambda: fused_group_norm(x, gamma, beta, silu=act),
            lambda: group_norm_reference(x, gamma, beta, 8, 1e-5, act),
            lambda: F.group_norm(xs, 8, g_lib, b_lib),
            2 * x.numel() * x.element_size() + 8 * c,
            x.numel() * (11 if act else 7), dtype)
    log(f"kernel group_norm L{level} C{c}{' silu' if act else ''} {_dn(dtype)}", **res)
    return res


def check_conv(level, cin, cout, impl, dtype, gen, timing):
    import torch.nn.functional as F

    from crowdmod_tpu_torch.ops.kernels import (
        conv3d_same_im2col,
        conv3d_same_reference,
        conv3d_same_tapgemm,
    )
    from crowdmod_tpu_torch.ops.kernels.conv3d import pack_im2col, pack_tapgemm

    t, h, w = LEVELS[level]
    x = _randn((UNET_BATCH, t, h, w, cin), gen, dtype)
    kernel = (_randn((3, 3, 3, cin, cout), gen) / (27 * cin) ** 0.5).to(dtype)
    bias = 0.1 * _randn((cout,), gen)
    conv, pack = ((conv3d_same_im2col, pack_im2col) if impl == "im2col"
                  else (conv3d_same_tapgemm, pack_tapgemm))
    wp = pack(kernel)
    out = conv(x, wp, bias)
    torch.cuda.synchronize()
    ref = conv3d_same_reference(x.float(), kernel.float(), bias)
    tol = TOL["conv_f32" if dtype == torch.float32 else "bf16"]
    err = _rel_check(f"conv {impl} L{level} {cin}->{cout} {_dn(dtype)}", out, ref, tol)
    res = dict(shape=[UNET_BATCH, t, h, w, cin, cout], impl=impl,
               dtype=_dn(dtype), max_abs_err=err, tolerance=f"{tol} x max|ref|")
    if timing:
        # F.conv3d over the same channels-last memory (NDHWC, cuDNN).
        xc = x.permute(0, 4, 1, 2, 3)
        wc = kernel.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        bc = bias.to(dtype)
        flops = 2 * UNET_BATCH * t * h * w * 27 * cin * cout
        nbytes = (x.numel() + kernel.numel() + UNET_BATCH * t * h * w * cout) \
            * x.element_size() + 4 * cout
        _timings(res, lambda: conv(x, wp, bias),
                 lambda: conv3d_same_reference(x, kernel, bias),
                 lambda: F.conv3d(xc, wc, bc, padding=1), nbytes, flops, dtype)
    log(f"kernel conv3d {impl} L{level} {cin}->{cout} {_dn(dtype)}", **res)
    return res


def _resblock_weights(cin, cout, gen, dtype):
    """A weight dict of the fused kernel's contract, conv weights rounded to
    ``dtype`` (so kernel and f32 twin see the same values)."""
    n = lambda shape, sc: sc * _randn(shape, gen)
    w = {"gn1_scale": 1 + n((cin,), 0.1), "gn1_bias": n((cin,), 0.1),
         "w1": n((3, 3, 3, cin, cout), (27 * cin) ** -0.5), "b1": n((cout,), 0.1),
         "gn2_scale": 1 + n((cout,), 0.1), "gn2_bias": n((cout,), 0.1),
         "w2": n((3, 3, 3, cout, cout), (27 * cout) ** -0.5), "b2": n((cout,), 0.1)}
    if cin != cout:
        w["w_skip"] = n((1, 1, 1, cin, cout), cin ** -0.5)
        w["b_skip"] = n((cout,), 0.1)
    for k in ("w1", "w2", "w_skip"):
        if k in w:
            w[k] = w[k].to(dtype).float()
    return w


def check_resblock(cin, cout, dtype, gen, timing):
    from crowdmod_tpu_torch.ops.kernels import fused_resblock, resblock_reference
    from crowdmod_tpu_torch.ops.kernels.resblock import pack_resblock

    t, h, wd = LEVELS[0]
    x = _randn((UNET_BATCH, t, h, wd, cin), gen, dtype)
    temb = _randn((UNET_BATCH, cout), gen, dtype)
    w = _resblock_weights(cin, cout, gen, dtype)
    packed = pack_resblock(w, dtype)
    out = fused_resblock(x, temb, w, packed=packed)
    torch.cuda.synchronize()
    ref = resblock_reference(x.float(), temb.float(), w)
    tol = TOL["resblock_f32" if dtype == torch.float32 else "bf16"]
    err = _rel_check(f"resblock {cin}->{cout} {_dn(dtype)}", out, ref, tol)
    res = dict(shape=[UNET_BATCH, t, h, wd, cin, cout], dtype=_dn(dtype),
               max_abs_err=err, tolerance=f"{tol} x max|ref|", launches_per_call=3)
    if timing:
        pos = UNET_BATCH * t * h * wd
        flops = 2 * pos * (27 * cin * cout + 27 * cout * cout
                           + (cin * cout if cin != cout else 0))
        nbytes = (x.numel() + pos * cout + packed["w1"].numel()
                  + packed["w2"].numel()) * x.element_size() \
            + 4 * (temb.numel() + 2 * cin + 4 * cout)
        _timings(res, lambda: fused_resblock(x, temb, w, packed=packed),
                 lambda: resblock_reference(x, temb, w), None, nbytes, flops, dtype)
    log(f"kernel resblock {cin}->{cout} {_dn(dtype)}", **res)
    return res


def phase_unet_kernels(timing: bool = True) -> dict:
    """Every UNet kernel against its twin at every shape of the path, batch
    64, f32 and bf16, with TF32 off; times where ``timing``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    res = {"gn": {}, "conv": {}, "resblock": {}}
    for dtype in (torch.float32, torch.bfloat16):
        dn = _dn(dtype)
        for level, c, act in GN_SHAPES:
            res["gn"][f"L{level}_C{c}_{act}_{dn}"] = check_group_norm(
                level, c, act, dtype, gen, timing)
        for impl in ("im2col", "tapgemm"):
            for level, cin, cout in CONV_SHAPES:
                res["conv"][f"{impl}_L{level}_{cin}_{cout}_{dn}"] = check_conv(
                    level, cin, cout, impl, dtype, gen, timing)
        for cin, cout in RESBLOCK_SHAPES:
            res["resblock"][f"{cin}_{cout}_{dn}"] = check_resblock(
                cin, cout, dtype, gen, timing)
    if timing:
        # Device ms of the kernels of one bf16 forward at batch 64 (the
        # served dtype; the final conv counted in f32, as it runs).
        per_fwd = {
            "group_norm": sum(res["gn"][f"L{l}_C{c}_{a}_bfloat16"]["ms"] * n
                              for (l, c, a), n in GN_SHAPES.items()),
            "conv3d_im2col": sum(
                res["conv"][f"im2col_L{l}_{i}_{o}_{'float32' if o == 3 else 'bfloat16'}"]["ms"]
                * n for (l, i, o), n in CONV_SHAPES.items()),
            "resblock": sum(res["resblock"][f"{i}_{o}_bfloat16"]["ms"]
                            for i, o in RESBLOCK_SHAPES),
        }
        log("UNet kernels per bf16 forward at batch 64 (device ms)", **per_fwd)
    return res



# ---------------------------------------------------------------------------
# Phases 3-8
# ---------------------------------------------------------------------------

def write_checkpoint(cfg, arch: str, workdir: Path) -> tuple[Path, str]:
    """The serving config with SAVE_DIR in ``workdir``, and a checkpoint of
    ``arch`` with seeded random weights, every parameter perturbed by
    N(0, 0.02²) (the zero-init AdaLN and final layer would otherwise make
    the DiT output 0)."""
    import yaml

    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg = cfg.updated({"DATA_FS": {"SAVE_DIR": str(workdir / "ckpts")}})
    cfg_path = workdir / "ATC.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    trainer = Trainer(cfg, arch, device=DEVICE, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    for sd in (trainer.params, trainer.ema_params):
        for v in sd.values():
            v.add_(0.02 * torch.randn(v.shape, generator=gen).to(v.device))
    return cfg_path, trainer.save(str(workdir / "ckpts"), "000")


def launch_counts() -> dict:
    from crowdmod_tpu_torch.ops.kernels import KERNELS

    return {fn.__name__: fn.launches for fn in KERNELS}


def check_launches(label, before, per_forward, forwards, extra=None) -> dict:
    """The launches since ``before`` against ``per_forward`` × ``forwards``
    (+ ``extra``), every kernel; raises on any difference."""
    after = launch_counts()
    got = {k: after[k] - before[k] for k in after}
    want = {k: v * forwards for k, v in per_forward.items()}
    want.update(extra or {})
    bad = {k: [got[k], want.get(k, 0)] for k in got if got[k] != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{label}: launches [got, expected] {bad}")
    return got


def profile_request(pred, past, arch) -> dict:
    """Device busy share of one serving request, from a torch.profiler trace
    (kernel time on the card over the request's wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pred.predict(past)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(past)
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    res = dict(wall_ms_profiled=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
               busy_share=busy_us / wall_us, kernel_launches=len(kernels),
               top_kernels_ms=[[n[:80], t / 1e3] for n, t in top])
    log(f"profile serving {arch} b64", **res)
    return res


def phase_serving(cfg_path: Path, arch: str, f_shape, per_forward) -> dict:
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.serving import BatchingQueue, load_predictor

    before = launch_counts()
    pred = load_predictor(str(cfg_path), arch, device=DEVICE)
    t0 = time.perf_counter()
    pred.warmup()
    warmup_s = time.perf_counter() - t0
    p, f, h, w, c = pred.input_spec
    walkers = synthetic_walkers(256, h, w, p + f)[:, :p]

    queue = BatchingQueue(pred, max_delay_ms=5.0)
    results, errors = [], []
    rng = np.random.default_rng(SEED)
    sizes = [[int(n) for n in rng.integers(1, 9, size=4)] for _ in range(4)]

    def client(ns):
        try:
            for n in ns:
                results.append((n, queue.predict(walkers[:n], timeout=600)))
        except Exception as e:  # re-raised below, after the threads end
            errors.append(e)

    threads = [threading.Thread(target=client, args=(ns,)) for ns in sizes]
    for t in threads:
        t.start()
    big = queue.predict(walkers[:64], timeout=600)
    for t in threads:
        t.join(timeout=900)
    queue.close()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"BatchingQueue clients failed: {errors}")
    results.append((64, big))
    if len(results) != 17:
        raise AssertionError(f"{len(results)} of 17 requests answered")
    for n, out in results:
        if out.shape != (n,) + f_shape or not np.isfinite(out).all():
            raise AssertionError(f"bad output {out.shape} for a batch of {n}")

    p50 = {}
    for b in pred.batch_buckets:
        lat = []
        for _ in range(5 if b < 256 else 3):
            t0 = time.perf_counter()
            pred.predict(walkers[:b])
            lat.append(1e3 * (time.perf_counter() - t0))
        p50[b] = statistics.median(lat)
    profile = profile_request(pred, walkers[:64], arch)
    steps = pred.cfg.MODEL.DDPM.ETA_STEPS
    launches = check_launches(f"{arch} serving", before, per_forward,
                              steps * pred.stats.requests)
    res = dict(arch=arch, requests=len(results), dispatches=queue.dispatches,
               coalesced=queue.coalesced_requests, buckets=pred.batch_buckets,
               warmup_s=warmup_s, predictions=pred.stats.requests,
               p50_ms_per_bucket={str(k): v for k, v in p50.items()},
               out_abs_mean=float(np.abs(big).mean()), launches=launches)
    log(f"serving {arch} DDIM-eta {steps} + Sparsity", **res)
    return {**res, "profile": profile}


def phase_ancestral(cfg, arch: str, ckpt_path: str, f_shape, per_forward,
                    batch: int = 64) -> dict:
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.serving import Predictor

    cfg = cfg.updated({"MODEL": {"DDPM": {"SAMPLER": "DDPM"}}})
    node = cfg.MODEL.DDPM
    pred = Predictor(cfg, arch, ckpt_path, device=DEVICE, batch_buckets=(batch,))
    p, f, h, w, c = pred.input_spec
    past = synthetic_walkers(batch, h, w, p + f)[:, :p]
    before = launch_counts()
    t0 = time.perf_counter()
    out = pred.predict(past)
    latency = time.perf_counter() - t0
    T = node.TIMESTEPS
    launches = check_launches(f"{arch} ancestral", before, per_forward, T,
                              {"fused_ancestral_update": T})
    if out.shape != (batch,) + f_shape or not np.isfinite(out).all():
        raise AssertionError(f"bad ancestral output {out.shape}")
    res = dict(arch=arch, batch=batch, timesteps=T, guidance=node.GUIDANCE,
               lambda_guidance=node.LAMBDA_GUIDANCE, latency_s=latency,
               launches=launches)
    log(f"ancestral {arch} DDPM-{T} b{batch}", **res)
    return res


@contextlib.contextmanager
def twins_on_the_card():
    """Route every kernel call site of the models to the plain twins (this
    script's comparison only; the port itself never does this).  The
    DDIM-eta chains compared below run no ancestral step."""
    import crowdmod_tpu_torch.models.backbones.fused_apply as fused_mod
    import crowdmod_tpu_torch.ops.attention as attn_mod
    import crowdmod_tpu_torch.ops.conv3d as conv_mod
    import crowdmod_tpu_torch.ops.norm as norm_mod
    from crowdmod_tpu_torch.ops.kernels import (
        attention_reference,
        conv3d_same_reference,
        group_norm_reference,
        resblock_reference,
    )
    from crowdmod_tpu_torch.ops.kernels.conv3d import unpack_im2col, unpack_tapgemm

    twins = [
        (attn_mod, "fused_attention",
         lambda q, k, v, *, scale: attention_reference(q, k, v, scale)),
        (norm_mod, "fused_group_norm",
         lambda x, g, b, *, num_groups, eps, silu: group_norm_reference(
             x, g, b, num_groups, eps, silu)),
        (conv_mod, "conv3d_same_im2col",
         lambda x, w, b=None: conv3d_same_reference(x, unpack_im2col(w), b)),
        (conv_mod, "conv3d_same_tapgemm",
         lambda x, w, b=None: conv3d_same_reference(x, unpack_tapgemm(w), b)),
        (fused_mod, "fused_resblock",
         lambda x, temb, w, *, num_groups, eps, packed=None: resblock_reference(
             x, temb, w, num_groups=num_groups, eps=eps)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in twins]
    try:
        for mod, name, fn in twins:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_end_to_end(cfg, arch: str, ckpt_path: str) -> dict:
    """One f32 batch-64 forward and one DDIM-eta chain, with the kernels
    (each conv kernel, for the UNet) and with the twins, on the card; the
    tap-GEMM run is that kernel's path and its launches are returned."""
    from crowdmod_tpu_torch.core import layout
    from crowdmod_tpu_torch.core.schedule import respaced_taus
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.models.diffusion import ddim_eta_sample
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts
    from crowdmod_tpu_torch.train.trainer import Trainer

    # f32 end to end, and no TF32 anywhere, so the routes differ only by the
    # kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    node = cfg.MODEL.DDPM
    p, f, h, w = (cfg.DATASET.PAST_LEN, cfg.DATASET.FUTURE_LEN,
                  cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    past = torch.from_numpy(synthetic_walkers(64, h, w, p + f)[:, :p]).to(DEVICE)
    x = torch.randn((64, f, h, w, 3), generator=gen, device=DEVICE)
    t = torch.randint(0, node.TIMESTEPS, (64,), generator=gen, device=DEVICE)
    taus = respaced_taus(node.TIMESTEPS, node.ETA_STEPS)
    draws = {None: x}
    draws.update({int(s): torch.randn(x.shape, generator=gen, device=DEVICE)
                  for s in taus})

    def run(conv_impl):
        trainer = Trainer(cfg, arch, device=DEVICE, compute_dtype=torch.float32,
                          conv_impl=conv_impl)
        trainer.load(ckpt_path)
        denoise = trainer._denoise_fn()  # binds the checkpoint's EMA weights
        with torch.no_grad():
            fwd = trainer.model(x, t, past)
            chain = ddim_eta_sample(
                denoise, trainer.sched, past, tuple(x.shape),
                taus, noise=draws.__getitem__, eta=node.ETA,
                guidance=node.GUIDANCE, lambda_guidance=node.LAMBDA_GUIDANCE,
            )
        torch.cuda.synchronize()
        return fwd, chain

    with twins_on_the_card():
        fwd_t, chain_t = run("im2col")
    impls = ("im2col", "tapgemm") if arch == "DDPM-UNet" else ("im2col",)
    res, tap_launches = {"arch": arch}, None
    for impl in impls:
        if impl == "tapgemm":
            reset_launch_counts()  # the tap-GEMM kernel's path
        fwd_k, chain_k = run(impl)
        if impl == "tapgemm":
            tap_launches = launch_counts()["conv3d_same_tapgemm"]
            want = PER_FORWARD[arch](cfg)["conv3d_same_im2col"] * (1 + len(taus))
            if tap_launches != want or launch_counts()["conv3d_same_im2col"]:
                raise AssertionError(
                    f"tap-GEMM path launched {tap_launches} tap-GEMM convs "
                    f"(expected {want}) and "
                    f"{launch_counts()['conv3d_same_im2col']} im2col convs")
        fwd_err = (fwd_k - fwd_t).abs().max().item()
        if not fwd_k.abs().max().item() > 1e-3:
            raise AssertionError(f"{arch}: the denoiser output is all but zero")
        if not fwd_err <= TOL["forward_f32"]:
            raise AssertionError(f"{arch} {impl} forward kernels vs twins: {fwd_err}")
        if not torch.isfinite(chain_k).all():
            raise AssertionError("chain output is not finite")
        off = (chain_k - chain_t).abs() > TOL["chain"]
        flips = int(off[..., layout.RHO].sum())
        off_other = int(off.sum()) - flips
        if off_other or flips > TOL["max_flip_share"] * off.numel():
            raise AssertionError(
                f"{arch} {impl} chain kernels vs twins: {off_other} non-rho "
                f"elements and {flips} rho flips beyond {TOL['chain']}"
            )
        res[impl] = dict(forward_max_abs_diff=fwd_err,
                         forward_abs_max=fwd_k.abs().max().item(),
                         chain_max_abs_diff=(chain_k - chain_t).abs().max().item(),
                         chain_rho_flips=flips, chain_elements=off.numel())
    res["tapgemm_path_launches"] = tap_launches
    log(f"end to end {arch} kernels vs twins (f32)", **res)
    return res


def kernel_entry(name, route, measured, launches) -> dict:
    return dict(name=name, route=route, source=SOURCES[name],
                replaces=REPLACES[name], launches=launches,
                **{k: measured[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "host_ms", "shape", "dtype")})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.ops.kernels import reset_launch_counts

    t_start = time.perf_counter()
    device = phase_device()
    kernels = phase_kernels()
    unet = phase_unet_kernels()

    cfg = load_config("serving/ATC.yml")
    f_shape = (cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    paths = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for arch in ("DDPM-DiT", "DDPM-UNet"):
            cfg_path, ckpt_path = write_checkpoint(cfg, arch, Path(tmp))
            per_forward = PER_FORWARD[arch](cfg)
            reset_launch_counts()  # this arch's main path: serving + ancestral
            phase_serving(cfg_path, arch, f_shape, per_forward)
            phase_ancestral(cfg, arch, ckpt_path, f_shape, per_forward)
            paths[arch] = launch_counts()
            log("main path launches", arch=arch, **paths[arch])
            e2e = phase_end_to_end(cfg, arch, ckpt_path)
    dit, unet_path = paths["DDPM-DiT"], paths["DDPM-UNet"]
    launches = {
        "fused_attention": dit["fused_attention"] + unet_path["fused_attention"],
        "fused_ancestral_update": dit["fused_ancestral_update"]
        + unet_path["fused_ancestral_update"],
        "fused_group_norm": unet_path["fused_group_norm"],
        "conv3d_same_im2col": unet_path["conv3d_same_im2col"],
        "conv3d_same_tapgemm": e2e["tapgemm_path_launches"],
        "fused_resblock": unet_path["fused_resblock"],
    }
    log("launches on the paths", **launches)
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")

    # The serving paths compute in bf16 on the card (TPU.COMPUTE_DTYPE), so
    # each kernel is reported at a batch-64 shape in bf16: the DiT's spatial
    # attention, the UNet's final norm, its level-0 64->64 conv and its
    # widest fused block (dec_0_0, 96->32).
    measured = {
        "fused_attention": kernels["attention"]["spatial_b64_bfloat16"],
        "fused_ancestral_update": kernels["step"]["b64_sparsity"],
        "fused_group_norm": unet["gn"]["L0_C32_True_bfloat16"],
        "conv3d_same_im2col": unet["conv"]["im2col_L0_64_64_bfloat16"],
        "conv3d_same_tapgemm": unet["conv"]["tapgemm_L0_64_64_bfloat16"],
        "fused_resblock": unet["resblock"]["96_32_bfloat16"],
    }
    line = {"kernels": [kernel_entry(n, "cuda", measured[n], launches[n])
                        for n in measured]}
    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
