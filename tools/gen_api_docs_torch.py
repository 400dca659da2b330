#!/usr/bin/env python
"""Generate docs/API_torch.md — the PyTorch port's per-module API reference
from live introspection.

Walks every module under ``crowdmod_tpu_torch``, collects public classes and
functions actually defined there (not re-exports), and renders signatures +
docstring summaries, as ``tools/gen_api_docs.py`` does for the JAX package
(``docs/API.md``).  The JAX tool's output format, plus ``--device``: the
walk runs on the host and builds no kernel, but the tool asks for the card
as every tool of the port does.  Regenerate after API changes:

    python tools/gen_api_docs_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import pkgutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import crowdmod_tpu_torch  # noqa: E402

# Build-system internals: the native library's and the kernels' build modules.
SKIP_MODULES = {"crowdmod_tpu_torch.native.build", "crowdmod_tpu_torch.ops.kernels.build"}


def iter_modules():
    yield "crowdmod_tpu_torch", crowdmod_tpu_torch
    for info in pkgutil.walk_packages(
        crowdmod_tpu_torch.__path__, prefix="crowdmod_tpu_torch."
    ):
        if info.name in SKIP_MODULES or "._" in info.name:
            continue
        try:
            yield info.name, importlib.import_module(info.name)
        except Exception as e:  # pragma: no cover
            print(f"!! could not import {info.name}: {e}", file=sys.stderr)


def first_paragraph(doc: str | None) -> str:
    import re

    if not doc:
        return ""
    lines = []
    for line in inspect.cleandoc(doc).splitlines():
        if not line.strip():
            break
        lines.append(line.strip())
    out = " ".join(lines)
    # Dataclass-generated docstrings repeat the signature, reprs with
    # addresses included; drop those.
    out = re.sub(r"<[^<>]* object at 0x[0-9a-f]+>", "<default>", out)
    out = re.sub(r"<class '([\w.]+)'>", r"\1", out)
    return out


def signature_of(obj) -> str:
    import re

    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # Defaults whose reprs embed memory addresses are dropped for stable,
    # readable docs.
    sig = re.sub(r"<[^<>]* object at 0x[0-9a-f]+>", "<default>", sig)
    sig = re.sub(r"<class '([\w.]+)'>", r"\1", sig)
    return sig if len(sig) <= 120 else "(...)"


def public_members(name: str, mod):
    classes, functions = [], []
    for attr, obj in sorted(vars(mod).items()):
        if attr.startswith("_"):
            continue
        if getattr(obj, "__module__", None) != name:
            continue  # re-export; documented where defined
        if inspect.isclass(obj):
            classes.append((attr, obj))
        elif inspect.isfunction(obj):
            functions.append((attr, obj))
    return classes, functions


def class_methods(cls):
    out = []
    for attr, obj in sorted(vars(cls).items()):
        if attr.startswith("_") or not inspect.isfunction(obj):
            continue
        out.append((attr, obj))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    from crowdmod_tpu_torch.train.trainer import resolve_device

    resolve_device(args.device)
    out = [
        "# crowdmod-tpu PyTorch port API reference",
        "",
        "Generated by `tools/gen_api_docs_torch.py` — do not edit by hand.",
        "The JAX package's reference: `docs/API.md`; the port's runbook:",
        "`docs/SCALING_torch.md`.",
        "",
    ]
    for name, mod in iter_modules():
        classes, functions = public_members(name, mod)
        summary = first_paragraph(mod.__doc__)
        if not (classes or functions or summary):
            continue
        out.append(f"## `{name}`")
        out.append("")
        if summary:
            out.append(summary)
            out.append("")
        for attr, cls in classes:
            out.append(f"### class `{attr}{signature_of(cls)}`")
            doc = first_paragraph(cls.__doc__)
            if doc:
                out.append("")
                out.append(doc)
            methods = class_methods(cls)
            if methods:
                out.append("")
                for mname, mobj in methods:
                    mdoc = first_paragraph(mobj.__doc__)
                    line = f"- `.{mname}{signature_of(mobj)}`"
                    if mdoc:
                        line += f" — {mdoc}"
                    out.append(line)
            out.append("")
        for attr, fn in functions:
            doc = first_paragraph(fn.__doc__)
            out.append(f"### `{attr}{signature_of(fn)}`")
            if doc:
                out.append("")
                out.append(doc)
            out.append("")
    path = os.path.join(REPO, "docs", "API_torch.md")
    with open(path, "w") as f:
        f.write("\n".join(out).rstrip() + "\n")
    n_sections = sum(1 for line in out if line.startswith("## "))
    print(f"wrote {path}: {n_sections} modules")


if __name__ == "__main__":
    main()
