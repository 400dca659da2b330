#!/usr/bin/env python3
"""Drive the PyTorch port (``crowdmod_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, on a machine with CUDA

Phases, one line of numbers each; any failure raises and the script exits
non-zero without a result line:

  1. device: the card's name and power limit (nvidia-smi), kernel build time;
  2. kernels: each CUDA kernel against its plain twin on the card, at the
     serving path's shapes, with device times (CUDA events), the host's time
     to issue a call, bounds and the library yardstick;
  3. serving: ``configs/serving/ATC.yml`` (DDPM-DiT, hidden 256, depth 6,
     DDIM-eta 25 steps + Sparsity) with seeded random weights, through
     ``load_predictor``/``warmup``/``BatchingQueue``, with p50 latency per
     bucket and a ``torch.profiler`` trace of one batch-64 request (device
     busy time, kernel launches, the top kernels);
  4. the ancestral path: the same model with ``SAMPLER: DDPM`` (T = 1000);
  5. end to end against the attention twin: one f32 denoiser forward and
     one 25-step DDIM-eta chain, with the kernel and with the twin, on the
     card.

Phases 3 and 4 are the main path: the kernels' launch counts are set to 0
just before phase 3 and read just after phase 4.  The last two lines are a
JSON object with every kernel's numbers and ``{"ok": true, "device": ...}``.
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

ARCH = "DDPM-DiT"
DEVICE = "cuda"
SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {"attention_f32": 1e-5, "attention_bf16": 2e-2, "step": 1e-6,
       "forward_f32": 1e-4, "chain": 1e-3, "max_flip_share": 1e-3}
REPLACES = {
    "fused_attention": "crowdmod_tpu/ops/pallas/attention.py:53",
    "fused_ancestral_update": "crowdmod_tpu/ops/pallas/fused_step.py:59",
}
SOURCES = {
    "fused_attention": "crowdmod_tpu_torch/csrc/attention.cu",
    "fused_ancestral_update": "crowdmod_tpu_torch/csrc/fused_step.cu",
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
    step = {
        f"b64_{'sparsity' if sp else 'none'}": check_step(
            f"b64 {'sparsity' if sp else 'none'}", (64, 3, 12, 36, 3), sp, gen)
        for sp in (False, True)
    }
    return {"attention": attn, "step": step}


# ---------------------------------------------------------------------------
# Phases 3-5
# ---------------------------------------------------------------------------

def write_checkpoint(cfg, workdir: Path) -> tuple[Path, str]:
    """The serving config with SAVE_DIR in ``workdir``, and a checkpoint of
    seeded random weights, every parameter perturbed by N(0, 0.02²) (the
    zero-init AdaLN and final layer would otherwise make the DiT output 0)."""
    import yaml

    from crowdmod_tpu_torch.train.trainer import Trainer

    cfg = cfg.updated({"DATA_FS": {"SAVE_DIR": str(workdir / "ckpts")}})
    cfg_path = workdir / "ATC.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    trainer = Trainer(cfg, ARCH, device=DEVICE, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 1)
    for sd in (trainer.params, trainer.ema_params):
        for v in sd.values():
            v.add_(0.02 * torch.randn(v.shape, generator=gen).to(v.device))
    return cfg_path, trainer.save(str(workdir / "ckpts"), "000")


def profile_request(pred, past) -> None:
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log("profile serving b64", wall_ms_profiled=wall_us / 1e3,
        device_busy_ms=busy_us / 1e3, busy_share=busy_us / wall_us,
        kernel_launches=len(kernels),
        top_kernels_ms=[[n[:80], t / 1e3] for n, t in top])


def phase_serving(cfg_path: Path, f_shape) -> dict:
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.serving import BatchingQueue, load_predictor

    pred = load_predictor(str(cfg_path), ARCH, device=DEVICE)
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
    profile_request(pred, walkers[:64])
    res = dict(requests=len(results), dispatches=queue.dispatches,
               coalesced=queue.coalesced_requests, buckets=pred.batch_buckets,
               warmup_s=warmup_s,
               p50_ms_per_bucket={str(k): v for k, v in p50.items()},
               out_abs_mean=float(np.abs(big).mean()))
    log("serving DDIM-eta 25 + Sparsity", **res)
    return res


def phase_ancestral(cfg, ckpt_path: str, f_shape) -> dict:
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.ops.kernels import fused_ancestral_update, fused_attention
    from crowdmod_tpu_torch.serving import Predictor

    cfg = cfg.updated({"MODEL": {"DDPM": {"SAMPLER": "DDPM"}}})
    node = cfg.MODEL.DDPM
    pred = Predictor(cfg, ARCH, ckpt_path, device=DEVICE, batch_buckets=(64,))
    p, f, h, w, c = pred.input_spec
    past = synthetic_walkers(64, h, w, p + f)[:, :p]
    a0, s0 = fused_attention.launches, fused_ancestral_update.launches
    t0 = time.perf_counter()
    out = pred.predict(past)
    latency = time.perf_counter() - t0
    d_attn = fused_attention.launches - a0
    d_step = fused_ancestral_update.launches - s0
    T, depth = node.TIMESTEPS, node.DIT.DEPTH
    if d_step != T or d_attn != 2 * depth * T:
        raise AssertionError(
            f"ancestral request launched {d_step} steps and {d_attn} "
            f"attentions; expected {T} and {2 * depth * T}"
        )
    if out.shape != (64,) + f_shape or not np.isfinite(out).all():
        raise AssertionError(f"bad ancestral output {out.shape}")
    res = dict(timesteps=T, guidance=node.GUIDANCE,
               lambda_guidance=node.LAMBDA_GUIDANCE, latency_s=latency,
               step_launches=d_step, attention_launches=d_attn)
    log("ancestral DDPM-1000 b64", **res)
    return res


@contextlib.contextmanager
def attention_twin_on_the_card():
    """Route the model's attention call site to the plain twin (this
    script's comparison only; the port itself never does this).  The
    DDIM-eta chain compared below runs no ancestral step."""
    import crowdmod_tpu_torch.ops.attention as attn_mod
    from crowdmod_tpu_torch.ops.kernels import attention_reference

    saved = attn_mod.fused_attention
    attn_mod.fused_attention = lambda q, k, v, *, scale: attention_reference(
        q, k, v, scale)
    try:
        yield
    finally:
        attn_mod.fused_attention = saved


def phase_end_to_end(cfg, ckpt_path: str) -> dict:
    from crowdmod_tpu_torch.core import layout
    from crowdmod_tpu_torch.core.schedule import respaced_taus
    from crowdmod_tpu_torch.data.synthetic import synthetic_walkers
    from crowdmod_tpu_torch.models.diffusion import ddim_eta_sample
    from crowdmod_tpu_torch.train.trainer import Trainer

    # f32 end to end, and no TF32 anywhere, so the two routes differ only
    # by the kernels.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainer = Trainer(cfg, ARCH, device=DEVICE, compute_dtype=torch.float32)
    trainer.load(ckpt_path)
    node = cfg.MODEL.DDPM
    p, f, h, w = trainer._grid_shapes()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    past = torch.from_numpy(synthetic_walkers(64, h, w, p + f)[:, :p]).to(DEVICE)
    x = torch.randn((64, f, h, w, 3), generator=gen, device=DEVICE)
    t = torch.randint(0, node.TIMESTEPS, (64,), generator=gen, device=DEVICE)
    taus = respaced_taus(node.TIMESTEPS, node.ETA_STEPS)
    draws = {None: x}
    draws.update({int(s): torch.randn(x.shape, generator=gen, device=DEVICE)
                  for s in taus})
    denoise = trainer._denoise_fn()  # binds the checkpoint's EMA weights

    def run():
        with torch.no_grad():
            fwd = trainer.model(x, t, past)
            chain = ddim_eta_sample(
                denoise, trainer.sched, past, tuple(x.shape),
                taus, noise=draws.__getitem__, eta=node.ETA,
                guidance=node.GUIDANCE, lambda_guidance=node.LAMBDA_GUIDANCE,
            )
        torch.cuda.synchronize()
        return fwd, chain

    fwd_k, chain_k = run()
    with attention_twin_on_the_card():
        fwd_t, chain_t = run()
    fwd_err = (fwd_k - fwd_t).abs().max().item()
    if not fwd_k.abs().max().item() > 1e-3:
        raise AssertionError("the DiT output is all but zero")
    if not fwd_err <= TOL["forward_f32"]:
        raise AssertionError(f"forward kernels vs twins: {fwd_err}")
    if not torch.isfinite(chain_k).all():
        raise AssertionError("chain output is not finite")
    off = (chain_k - chain_t).abs() > TOL["chain"]
    flips = int(off[..., layout.RHO].sum())
    off_other = int(off.sum()) - flips
    if off_other or flips > TOL["max_flip_share"] * off.numel():
        raise AssertionError(
            f"chain kernels vs twins: {off_other} non-rho elements and "
            f"{flips} rho flips beyond {TOL['chain']}"
        )
    res = dict(forward_max_abs_diff=fwd_err,
               forward_abs_max=fwd_k.abs().max().item(),
               chain_max_abs_diff=(chain_k - chain_t).abs().max().item(),
               chain_rho_flips=flips, chain_elements=off.numel())
    log("end to end kernels vs twins (f32)", **res)
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
    from crowdmod_tpu_torch.ops.kernels import (
        fused_ancestral_update,
        fused_attention,
        reset_launch_counts,
    )

    t_start = time.perf_counter()
    device = phase_device()
    kernels = phase_kernels()

    cfg = load_config("serving/ATC.yml")
    f_shape = (cfg.DATASET.FUTURE_LEN, cfg.MACROPROPS.ROWS, cfg.MACROPROPS.COLS, 3)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path, ckpt_path = write_checkpoint(cfg, Path(tmp))

        reset_launch_counts()  # the main path: phases 3 and 4
        phase_serving(cfg_path, f_shape)
        served_attn = fused_attention.launches
        if served_attn == 0:
            raise AssertionError("serving launched no attention kernel")
        phase_ancestral(cfg, ckpt_path, f_shape)
        launches = {"fused_attention": fused_attention.launches,
                    "fused_ancestral_update": fused_ancestral_update.launches}
        log("main path launches", serving_attention=served_attn, **launches)
        if not all(launches.values()):
            raise AssertionError(f"a kernel was not launched: {launches}")

        phase_end_to_end(cfg, ckpt_path)

    # The serving path computes in bf16 on the card (TPU.COMPUTE_DTYPE), so
    # attention is reported at its batch-64 spatial shape in bf16.
    line = {"kernels": [
        kernel_entry("fused_attention", "cuda",
                     kernels["attention"]["spatial_b64_bfloat16"],
                     launches["fused_attention"]),
        kernel_entry("fused_ancestral_update", "cuda",
                     kernels["step"]["b64_sparsity"],
                     launches["fused_ancestral_update"]),
    ]}
    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
