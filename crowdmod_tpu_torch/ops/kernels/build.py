"""Build and load the port's CUDA kernels.

Each ``crowdmod_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
under ``crowdmod_tpu_torch/_build/`` (git-ignored), and loaded with
``ctypes``.  The library's file name carries a hash of its source and flags,
so an edited source rebuilds and an unchanged one loads at once.  A build
takes seconds: no source includes PyTorch's headers.

Builds run at first use, from the repo's sources only; :func:`build_all`
compiles every source at once, one ``nvcc`` process each.  Nothing here runs
at import time, so the package imports on a machine without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SMS = 132  # streaming multiprocessors of an H100 SXM, the plans' default card
PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("attention", "fused_step", "groupnorm", "conv3d", "resblock")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: building the port's CUDA kernels needs the CUDA "
        "toolkit (nvcc on PATH or under /usr/local/cuda)"
    )


def library_path(name: str) -> Path:
    """Where the built library of ``csrc/<name>.cu`` lives (the hash covers
    the source, the shared headers and the flags)."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: tuple[str, ...] = SOURCES) -> tuple[str, ...]:
    """Compile every source in ``names`` whose library is missing, all in
    parallel; returns the names it compiled (none when every library was in
    the source-hash cache).  The compiler's resource report (``-Xptxas -v``)
    goes to a ``.log`` beside each library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return tuple(name for name, *_ in jobs)


def load(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    ``argtypes``/``restype`` set from ``signatures`` ({fn: (restype,
    argtypes)})."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libraries[name] = lib
        return lib


@functools.lru_cache(maxsize=16)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the kernel plans' input)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
