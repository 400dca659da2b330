"""``doctor``: a deployment environment self-check (port of the JAX
package's ``cli/doctor.py``).

One command that checks the whole stack before a long run takes a card.
Checks, in order, each printed as ``[ok]``, ``[warn]`` or ``[FAIL]``:

  1. device: CUDA visible, the card's name and power limit (nvidia-smi),
     compute capability 9.0 (the kernels are built for ``sm_90a``);
  2. kernels: every CUDA library built from ``csrc/`` (or found in the
     source-hash cache, ``crowdmod_tpu_torch/_build/``), then each of the
     six kernels launched once at a small shape and held against its
     plain PyTorch twin on the card;
  3. native runtime: the g++ build of the host library and a transpose
     parity probe against numpy;
  4. shipped configs: every ``configs/**/*.yml`` through the port's schema
     validation;
  5. checkpoint IO: a ``state.pt`` + ``metadata.json`` round trip;
  6. mesh (unless ``--skip-mesh``): a 2-process gloo world on the CPU
     running a data-parallel reduction and FSDP placement through the
     port's ``parallel/mesh.py`` and ``parallel/sharding.py``.

With ``--device cpu`` the device and kernel checks report ``warn`` (not
built: CPU); the default ``--device cuda`` fails them on a host without a
GPU and carries on with the host checks.  The JAX command's
``--compile-cache`` and ``--no-compile-cache`` have no counterpart: the
kernel libraries are always cached by the hash of their sources, so
argparse refuses both (exit 2).  Exit status 0 when no check failed
(warnings allowed), 1 otherwise.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

OK, WARN, FAIL = "ok", "warn", "FAIL"

# Kernel vs twin tolerances (those of chip_smoke.py's phase 2): bf16 outputs
# within 2e-2 of max|ref| (attention: absolute, its outputs are O(1)), the
# f32 ancestral step within 1e-6.
BF16_TOL = 2e-2
STEP_TOL = 1e-6


def _result(name: str, status: str, detail: str, results: list) -> None:
    results.append((name, status, detail))
    pad = max(1, 28 - len(name))
    print(f"  {name}{' ' * pad}[{status}] {detail}", flush=True)


def _nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi gives them, or why
    not."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e!r})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"nvidia-smi exit {out.returncode}"


def check_device(results, device: str) -> bool:
    """→ whether the card is there for the kernel check."""
    import torch

    if device == "cpu":
        _result("device", WARN, "not built: CPU (--device cpu; the kernels run "
                "on the card only)", results)
        return False
    try:
        if not torch.cuda.is_available():
            _result("device", FAIL, "CUDA is not available (--device cuda)", results)
            return False
        cap = torch.cuda.get_device_capability(0)
        detail = (f"{torch.cuda.device_count()} CUDA device(s): {_nvidia_smi()}, "
                  f"compute capability {cap[0]}.{cap[1]}, torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}")
        if cap != (9, 0):
            _result("device", FAIL, detail + "; the kernels are built for sm_90a "
                    "(compute capability 9.0)", results)
            return False
        _result("device", OK, detail, results)
        return True
    except Exception as e:  # noqa: BLE001 — report, don't crash the doctor
        _result("device", FAIL, repr(e), results)
        return False


def _resblock_weights(cin: int, cout: int, gen, device) -> dict:
    import torch

    def n(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=device)

    w = {"gn1_scale": 1 + n((cin,), 0.1), "gn1_bias": n((cin,), 0.1),
         "w1": n((3, 3, 3, cin, cout), (27 * cin) ** -0.5), "b1": n((cout,), 0.1),
         "gn2_scale": 1 + n((cout,), 0.1), "gn2_bias": n((cout,), 0.1),
         "w2": n((3, 3, 3, cout, cout), (27 * cout) ** -0.5), "b2": n((cout,), 0.1)}
    for k in ("w1", "w2"):  # bf16 values, so kernel and f32 twin see the same
        w[k] = w[k].to(torch.bfloat16).float()
    return w


def kernel_probes(device="cuda") -> dict:
    """Each of the six kernels launched once at a small shape on ``device``
    against its twin in f32 on the same inputs → {kernel: (error,
    tolerance)}; the error of bf16 outputs is relative to max|ref|."""
    import numpy as np
    import torch

    from crowdmod_tpu_torch.core.schedule import linear_schedule
    from crowdmod_tpu_torch.ops import kernels as K
    from crowdmod_tpu_torch.ops.kernels.conv3d import pack_im2col, pack_tapgemm
    from crowdmod_tpu_torch.ops.kernels.resblock import pack_resblock

    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def rel(out, ref):
        return float((out.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))

    res = {}
    q, k, v = (randn(2, 2, 27, 64, dtype=bf16) for _ in range(3))
    out = K.fused_attention(q, k, v, scale=0.125)
    ref = K.attention_reference(q.float(), k.float(), v.float(), 0.125)
    res["fused_attention"] = (float((out.float() - ref).abs().max()), BF16_TOL)

    x, eps, z = (randn(2, 3, 12, 36, 3) for _ in range(3))
    s = linear_schedule(1000, scale=0.5)
    c = (s.one_by_sqrt_alpha[500], s.beta[500] / s.sqrt_one_minus_alpha_bar[500],
         np.sqrt(s.beta[500]))
    coeffs = K.step_coefficients(*c, device)
    kw = dict(lambda_guidance=0.6, sparsity=True, rho_channel=0)
    out = K.fused_ancestral_update(x, eps, z, coeffs, **kw)
    ref = K.ancestral_update_reference(x, eps, z, inv_sqrt_alpha=coeffs[0],
                                       beta_over_somab=coeffs[1], sigma=coeffs[2], **kw)
    res["fused_ancestral_update"] = (float((out - ref).abs().max()), STEP_TOL)

    x = randn(2, 216, 32, dtype=bf16)
    gamma, beta = 1 + 0.1 * randn(32), 0.1 * randn(32)
    out = K.fused_group_norm(x, gamma, beta, silu=True)
    ref = K.group_norm_reference(x.float(), gamma, beta, 8, 1e-5, True)
    res["fused_group_norm"] = (rel(out, ref), BF16_TOL)

    x = randn(1, 4, 6, 18, 32, dtype=bf16)
    kernel = (randn(3, 3, 3, 32, 32) / (27 * 32) ** 0.5).to(bf16)
    bias = 0.1 * randn(32)
    ref = K.conv3d_same_reference(x.float(), kernel.float(), bias)
    res["conv3d_same_im2col"] = (rel(K.conv3d_same_im2col(x, pack_im2col(kernel), bias),
                                     ref), BF16_TOL)
    res["conv3d_same_tapgemm"] = (rel(K.conv3d_same_tapgemm(x, pack_tapgemm(kernel), bias),
                                      ref), BF16_TOL)

    x = randn(1, 8, 12, 36, 32, dtype=bf16)
    temb = randn(1, 32, dtype=bf16)
    w = _resblock_weights(32, 32, gen, device)
    out = K.fused_resblock(x, temb, w, packed=pack_resblock(w, bf16))
    res["fused_resblock"] = (rel(out, K.resblock_reference(x.float(), temb.float(), w)),
                             BF16_TOL)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return res


def check_kernels(results, on_card: bool, device: str) -> None:
    if not on_card:
        if device == "cpu":
            _result("kernels", WARN, "not built: CPU", results)
        else:
            _result("kernels", FAIL, "not built: no usable card", results)
        return
    from crowdmod_tpu_torch.ops.kernels import KERNELS, build

    try:
        t0 = time.perf_counter()
        built = build.build_all()
        cache = (f"{len(build.SOURCES) - len(built)}/{len(build.SOURCES)} libraries "
                 f"from the source-hash cache, {len(built)} built in "
                 f"{time.perf_counter() - t0:.1f}s ({build.BUILD_DIR})")
        probes = kernel_probes("cuda")
        launches = json.dumps({fn.__name__: fn.launches for fn in KERNELS})
        bad = {n: e for n, (e, tol) in probes.items() if not e <= tol}
        worst = max(e / tol for e, tol in probes.values())
        if bad:
            _result("kernels", FAIL, f"{cache}; kernel vs twin over tolerance: {bad}",
                    results)
        else:
            _result("kernels", OK, f"{cache}; {len(probes)} kernels launched, each "
                    f"within {worst:.2g} of its tolerance of the twin; launches "
                    f"{launches}", results)
    except Exception as e:  # noqa: BLE001
        _result("kernels", FAIL, repr(e)[-300:], results)


def check_native(results):
    import numpy as np

    from crowdmod_tpu_torch import native

    try:
        a = np.arange(2 * 3 * 4 * 5 * 6, dtype=np.float32).reshape(2, 3, 4, 5, 6)
        out = native.transpose_to_native(a)
        if not np.array_equal(out, np.transpose(a, (0, 4, 2, 3, 1))):
            _result("native runtime", FAIL, "transpose parity mismatch", results)
        else:
            _result("native runtime", OK, "C++ library built (g++), parity probe passes",
                    results)
    except Exception as e:  # noqa: BLE001 — the port has no numpy fallback
        _result("native runtime", FAIL, repr(e)[-300:], results)


def check_configs(results):
    from crowdmod_tpu_torch.config import load_config
    from crowdmod_tpu_torch.config.loader import config_dir, is_datafile_list
    from crowdmod_tpu_torch.config.validate import validate_config

    bad = []
    n = 0
    for yml in sorted(config_dir().rglob("*.yml")):
        # Companion files, not dataset configs: datafile lists (told by
        # their content) and the HTML viewer's models list.
        if yml.name == "models_list.yml" or is_datafile_list(yml):
            continue
        n += 1
        # One unparseable config reports FAIL, not a crash before the
        # remaining checks and the summary.
        try:
            problems = validate_config(load_config(yml))
        except Exception as e:  # noqa: BLE001
            problems = [repr(e)]
        if problems:
            bad.append(f"{yml.name}: {problems[0]}")
    if not n:
        _result("shipped configs", WARN, "no configs/ directory found", results)
    elif bad:
        _result("shipped configs", FAIL, "; ".join(bad[:3]), results)
    else:
        _result("shipped configs", OK, f"{n} configs validate", results)


def check_checkpoint_io(results):
    import torch

    from crowdmod_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    try:
        with tempfile.TemporaryDirectory() as d:
            target = os.path.join(d, "doctor_probe")
            params = {"w": torch.arange(4.0)}
            save_checkpoint(target, {"params": params}, metadata={"probe": True})
            back, meta = load_checkpoint(target)
            ok = torch.equal(back["params"]["w"], params["w"]) and bool(
                (meta or {}).get("probe"))
            _result("checkpoint io", OK if ok else FAIL,
                    "state.pt + metadata.json save/restore round trip", results)
    except Exception as e:  # noqa: BLE001
        _result("checkpoint io", FAIL, repr(e), results)


def _mesh_probe(init_method: str, world: int, rank: int) -> None:
    """One rank of :func:`check_mesh`'s world (a spawned process)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from crowdmod_tpu_torch.parallel import multiprocess
    from crowdmod_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from crowdmod_tpu_torch.parallel.sharding import shard_params

    torch.set_num_threads(1)
    multiprocess.initialize(num_processes=world, process_id=rank, device_type="cpu",
                            init_method=init_method, timeout_s=120)
    try:
        mesh = make_mesh()
        x = shard_batch(torch.ones(8, 4), mesh)  # this process's rows
        total = x.sum()
        dist.all_reduce(total)
        assert x.shape == (8 // world, 4) and float(total) == 32.0, (x.shape, total)
        # FSDP: a parameter sharded over the data axis, gathered at use.
        model = torch.nn.Linear(4, 16, bias=False)
        torch.nn.init.ones_(model.weight)
        model = shard_params(model, mesh, mode="fsdp", min_size=1)
        w = model.weight
        assert isinstance(w, DTensor) and isinstance(w.placements[0], Shard), w
        assert w.to_local().numel() == 64 // world, w.to_local().shape
        with torch.no_grad():
            y = model(x)
        assert y.shape == (8 // world, 16) and float(y.sum()) == 8 // world * 16 * 4
    finally:
        multiprocess.shutdown()


def check_mesh(results, world: int = 2, timeout_s: float = 300.0):
    """A ``world``-process gloo world on the CPU (spawned processes meeting
    at a ``file://`` rendezvous)."""
    import multiprocessing

    try:
        with tempfile.TemporaryDirectory(prefix="crowdmod_doctor_") as tmp:
            init = "file://" + os.path.join(tmp, "rendezvous")
            ctx = multiprocessing.get_context("spawn")
            procs = [ctx.Process(target=_mesh_probe, args=(init, world, r))
                     for r in range(world)]
            t0 = time.time()
            for p in procs:
                p.start()
            for p in procs:
                p.join(max(1.0, timeout_s - (time.time() - t0)))
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
            codes = [p.exitcode for p in procs]
        if codes == [0] * world:
            _result(f"mesh ({world} processes)", OK,
                    f"gloo: DP reduction + FSDP placement in {time.time() - t0:.1f}s",
                    results)
        else:
            _result(f"mesh ({world} processes)", FAIL, f"exit codes {codes}", results)
    except Exception as e:  # noqa: BLE001
        _result(f"mesh ({world} processes)", FAIL, repr(e), results)


def build_parser():
    from crowdmod_tpu_torch.cli import common_parser

    p = common_parser("Environment self-check for crowdmod deployments.")
    p.add_argument("--skip-mesh", action="store_true",
                   help="Skip the 2-process gloo mesh check (fastest).")
    return p


def run(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    print("crowdmod doctor", flush=True)
    results: list = []
    on_card = check_device(results, args.device)
    check_kernels(results, on_card, args.device)
    check_native(results)
    check_configs(results)
    check_checkpoint_io(results)
    if not args.skip_mesh:
        check_mesh(results)

    failed = [r for r in results if r[1] == FAIL]
    warned = [r for r in results if r[1] == WARN]
    print(f"{len(results) - len(failed) - len(warned)} ok, "
          f"{len(warned)} warnings, {len(failed)} failures")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(run())
