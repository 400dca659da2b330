#!/usr/bin/env python
"""Race/memory validation of the port's native host runtime
(``crowdmod_tpu_torch/native``): a front end to ``python -m
crowdmod_tpu_torch.native.sanitize``.

Builds the sanitizer harness together with the library source under
ThreadSanitizer and AddressSanitizer+UBSan and runs it in a bare process,
outside Python.  The JAX tool's arguments (sanitizer names, both by
default) and exit status, plus ``--device``: the harness runs on the host,
but the tool asks for the card as every tool of the port does.

    python tools/native_sanitize_torch.py            # both sanitizers
    python tools/native_sanitize_torch.py thread     # just TSan
    python tools/native_sanitize_torch.py --device cpu ...   # no GPU
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("names", nargs="*", help="thread, address (default: both)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    from crowdmod_tpu_torch.native import sanitize
    from crowdmod_tpu_torch.train.trainer import resolve_device

    resolve_device(args.device)
    return sanitize.main(args.names)


if __name__ == "__main__":
    raise SystemExit(main())
