"""Race and memory checks of the port's native runtime.

Builds ``src/sanitize_harness.cpp`` with ``src/crowdmod_native.cpp``
under ThreadSanitizer and under AddressSanitizer + UndefinedBehavior-
Sanitizer, with the library's own sanitized flags (:func:`.build.flags`,
as an executable), and runs each in a bare process: every C entry point,
the threaded loops above and below the thread count, and the ``.cmb``
files' error paths.  Exit status 0 when every sanitizer run passes.

    python -m crowdmod_tpu_torch.native.sanitize            # both
    python -m crowdmod_tpu_torch.native.sanitize thread     # TSan only
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from crowdmod_tpu_torch.native import build

SRC = Path(__file__).resolve().parent / "src"


def harness_command(cxx: str, name: str, exe: str) -> list[str]:
    """The g++ command that builds the harness under sanitizer ``name``:
    the library's flags for that sanitizer, linked as an executable."""
    return [cxx, *(f for f in build.flags(name) if f not in ("-shared", "-fPIC")),
            str(build.SRC), str(SRC / "sanitize_harness.cpp"), "-o", exe]


def run_one(name: str, workdir: str) -> bool:
    """Build the harness under sanitizer ``name`` and run it (3 repeats in
    ``workdir``); → whether it built and exited 0."""
    cxx = shutil.which("g++")
    if cxx is None:
        print(f"[{name}] FAIL: g++ not found")
        return False
    exe = os.path.join(workdir, f"harness_{name}")
    cmd = harness_command(cxx, name, exe)
    print(f"[{name}] {' '.join(cmd)}", flush=True)
    if subprocess.run(cmd).returncode:
        print(f"[{name}] FAIL: the build failed")
        return False
    env = dict(os.environ)
    env.setdefault("TSAN_OPTIONS", "halt_on_error=1")
    env.setdefault("ASAN_OPTIONS", "detect_leaks=1")
    rc = subprocess.run([exe, workdir, "3"], env=env).returncode
    print(f"[{name}] {'PASS' if rc == 0 else f'FAIL rc={rc}'}", flush=True)
    return rc == 0


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(build.SANITIZERS)
    unknown = [n for n in names if n not in build.SANITIZERS]
    if unknown:
        print(f"unknown sanitizer(s) {unknown}; expected {list(build.SANITIZERS)}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="crowdmod_sanitize_") as workdir:
        results = [run_one(n, workdir) for n in names]
    return 0 if all(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
