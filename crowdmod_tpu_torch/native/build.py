"""Build the port's native host library (``src/crowdmod_native.cpp``).

``libcrowdmod_native-<hash>.so`` is compiled with the system ``g++`` at
first use into ``crowdmod_tpu_torch/_build/`` (git-ignored), the hash taken
over the source and the flags, so an edited source rebuilds and an
unchanged one loads at once.  A failed build raises with the compiler's
message: nothing falls back to numpy.  Plain C ABI + ctypes, no pybind11.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src" / "crowdmod_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-funroll-loops")


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libcrowdmod_native-{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """The library's path, compiling it first if it is missing; raises
    ``RuntimeError`` with the compiler's output when it cannot be built."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's native library "
                           f"({SRC.name}) is built with the system g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # A per-process temporary renamed into place: two processes building
    # into one directory never load a half-written library.
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib
