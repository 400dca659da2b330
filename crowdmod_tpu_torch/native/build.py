"""Build the port's native host library (``src/crowdmod_native.cpp``).

``libcrowdmod_native-<hash>.so`` is compiled with the system ``g++`` at
first use into ``crowdmod_tpu_torch/_build/`` (git-ignored), the hash taken
over the source and the flags, so an edited source rebuilds and an
unchanged one loads at once.  A failed build raises with the compiler's
message: nothing falls back to numpy.  Plain C ABI + ctypes, no pybind11.

``CROWDMOD_NATIVE_SANITIZE=thread|address`` builds the library under
ThreadSanitizer or AddressSanitizer + UndefinedBehaviorSanitizer (``-O1
-g``, its own file: the flags are in the hash), as the JAX package's build
does, so that the native tests run as race and memory checks (with the
sanitizer's runtime in ``LD_PRELOAD``).  :mod:`.sanitize` compiles its
harness with the same :func:`flags` and runs every entry point under both
in a bare process.
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
SANITIZERS = {
    "thread": ("-fsanitize=thread",),
    "address": ("-fsanitize=address,undefined", "-fno-sanitize-recover=all"),
}


def flags(sanitizer: str | None = None) -> tuple[str, ...]:
    """The compiler flags, with ``sanitizer``'s (default
    ``CROWDMOD_NATIVE_SANITIZE``; thread or address) and ``-O1 -g`` in
    place of ``-O3`` when it names one of :data:`SANITIZERS`."""
    san = os.environ.get("CROWDMOD_NATIVE_SANITIZE") if sanitizer is None else sanitizer
    if san not in SANITIZERS:
        return FLAGS
    return ("-O1", "-g", *SANITIZERS[san], *(f for f in FLAGS if f != "-O3"))


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(flags()).encode())
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
    proc = subprocess.run([cxx, *flags(), str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib
