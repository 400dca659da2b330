"""Static HTML comparison viewers with synchronized GIF frame stepping
(port of the JAX package's ``viz/html_viewer.py``; the ``view`` command).

The reference's two standalone viewers (``gif_comparison_viewer.py``, a
cross-model grid, and ``lambda_comparison_viewer.py``, a guidance-λ
ablation grid) as one engine with two directory-layout scanners.  Each GIF
is split into PNG frames (PIL, imported when a GIF is read) in a cache
dir; the page drives every cell from one play/pause/step/slider control,
so all sequences stay frame-locked.  Host only; no device.

    python -m crowdmod_tpu_torch.cli view out/samples/DDPM-UNet \
        out/samples/FM-UNet --output viewer.html
    python -m crowdmod_tpu_torch.cli view out/lambda_sweep --mode lambda
"""

from __future__ import annotations

import argparse
import base64
import html
import io
import os
import re


def extract_frames(gif_path: str, cache_dir: str | None = None,
                   embed: bool = False) -> list[str]:
    """GIF → per-frame PNGs; returns file paths, or data URIs if ``embed``."""
    from PIL import Image

    out = []
    with Image.open(gif_path) as im:
        n = getattr(im, "n_frames", 1)
        stem = os.path.splitext(os.path.basename(gif_path))[0]
        for i in range(n):
            im.seek(i)
            frame = im.convert("RGB")
            if embed:
                buf = io.BytesIO()
                frame.save(buf, format="PNG", optimize=True)
                out.append(
                    "data:image/png;base64,"
                    + base64.b64encode(buf.getvalue()).decode()
                )
            else:
                assert cache_dir is not None
                os.makedirs(cache_dir, exist_ok=True)
                p = os.path.join(cache_dir, f"{stem}_f{i:03d}.png")
                frame.save(p, format="PNG")
                out.append(p)
    return out


def scan_model_dirs(dirs: list[str]) -> dict[str, dict[str, str]]:
    """rows = model dirs, cols = GIF basenames
    (gif_comparison_viewer layout, :20-46)."""
    grid: dict[str, dict[str, str]] = {}
    for d in dirs:
        label = os.path.basename(os.path.normpath(d)) or d
        row = {}
        for f in sorted(os.listdir(d)):
            if f.endswith(".gif"):
                row[os.path.splitext(f)[0]] = os.path.join(d, f)
        if row:
            grid[label] = row
    return grid


def scan_lambda_dirs(parent: str) -> dict[str, dict[str, str]]:
    """rows = λ-tagged subdirectories of ``parent``
    (lambda_comparison_viewer layout, :6-92): subdirs named ``*lambda<val>*``
    sorted numerically."""
    entries = []
    for name in os.listdir(parent):
        full = os.path.join(parent, name)
        if not os.path.isdir(full):
            continue
        m = re.search(r"lambda[_-]?([0-9.eE+-]+)", name)
        if m:
            try:
                entries.append((float(m.group(1)), name, full))
            except ValueError:
                continue
    entries.sort()
    return scan_model_dirs([full for _, _, full in entries])


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; background: #fafafa; margin: 16px; }}
 table {{ border-collapse: collapse; }}
 th, td {{ padding: 6px 10px; text-align: center; vertical-align: top; }}
 th {{ background: #eee; position: sticky; top: 0; }}
 td img {{ max-width: 340px; border: 1px solid #ccc; }}
 .rowlabel {{ font-weight: bold; text-align: right; white-space: nowrap; }}
 #controls {{ margin: 12px 0; display: flex; gap: 8px; align-items: center; }}
 button {{ padding: 4px 12px; }}
</style></head><body>
<h2>{title}</h2>
<div id="controls">
 <button onclick="togglePlay()" id="playbtn">Pause</button>
 <button onclick="step(-1)">&#9664;</button>
 <button onclick="step(1)">&#9654;</button>
 <input type="range" id="slider" min="0" max="{max_frame}" value="0"
        oninput="seek(this.value)">
 <span id="framelabel">frame 1/{n_frames}</span>
</div>
<table>{table}</table>
<script>
const FRAMES = {frames_js};
const N = {n_frames};
let cur = 0, playing = true;
function render() {{
  for (const [id, frames] of Object.entries(FRAMES)) {{
    const img = document.getElementById(id);
    if (img) img.src = frames[Math.min(cur, frames.length - 1)];
  }}
  document.getElementById('slider').value = cur;
  document.getElementById('framelabel').textContent =
    `frame ${{cur + 1}}/${{N}}`;
}}
function step(d) {{ cur = (cur + d + N) % N; render(); }}
function seek(v) {{ cur = parseInt(v); render(); }}
function togglePlay() {{
  playing = !playing;
  document.getElementById('playbtn').textContent = playing ? 'Pause' : 'Play';
}}
setInterval(() => {{ if (playing) step(1); }}, 500);
render();
</script></body></html>
"""


def generate_html(
    grid: dict[str, dict[str, str]],
    output_html: str,
    *,
    title: str = "crowdmod comparison",
    embed: bool = True,
) -> str:
    """Render the synchronized comparison page for ``grid[row][col] =
    gif_path``."""
    out_dir = os.path.dirname(os.path.abspath(output_html))
    cache = os.path.join(out_dir, "frames_cache")
    cols = sorted({c for row in grid.values() for c in row})
    frames_js: dict[str, list[str]] = {}
    n_frames = 1

    body = ["<tr><th></th>"]
    body += [f"<th>{html.escape(c)}</th>" for c in cols]
    body.append("</tr>")
    for r, row in grid.items():
        body.append(f'<tr><td class="rowlabel">{html.escape(r)}</td>')
        for c in cols:
            gif = row.get(c)
            if gif is None:
                body.append("<td>—</td>")
                continue
            cell_id = re.sub(r"\W+", "_", f"{r}_{c}")
            # Per-cell cache subdir: every model row ships GIFs with the
            # same basenames (mprops_seq_N.gif), so a flat cache would have
            # later rows overwrite earlier rows' frames.
            frames = extract_frames(
                gif, os.path.join(cache, cell_id), embed=embed
            )
            if not embed:
                frames = [os.path.relpath(f, out_dir) for f in frames]
            frames_js[cell_id] = frames
            n_frames = max(n_frames, len(frames))
            body.append(f'<td><img id="{cell_id}"></td>')
        body.append("</tr>")

    import json as _json

    page = _PAGE.format(
        title=html.escape(title),
        table="".join(body),
        frames_js=_json.dumps(frames_js),
        n_frames=n_frames,
        max_frame=n_frames - 1,
    )
    os.makedirs(out_dir, exist_ok=True)
    with open(output_html, "w") as f:
        f.write(page)
    return output_html


def load_models_file(path: str, main_dir: str | None = None) -> list[str]:
    """Resolve a ``MODELS:`` YAML list (reference ``config/models_list.yml``,
    used by gif_comparison_viewer.py:847's ``--models-file`` flag) to model
    sample dirs, optionally prefixed with ``main_dir``."""
    import yaml

    with open(path) as f:
        tree = yaml.safe_load(f) or {}
    names = tree.get("MODELS", tree if isinstance(tree, list) else [])
    if not isinstance(names, list):
        raise ValueError(f"{path}: expected a MODELS list")
    base = main_dir or "."
    return [os.path.join(base, str(n)) for n in names]


def list_model_dirs(parent: str) -> list[str]:
    """Names of ``parent``'s subdirs that contain GIFs — the reference
    viewer's ``--list-models`` helper for authoring a models_list.yml."""
    names = []
    for name in sorted(os.listdir(parent)):
        full = os.path.join(parent, name)
        if os.path.isdir(full) and any(
            f.endswith(".gif") for f in os.listdir(full)
        ):
            names.append(name)
    return names


def run(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Synchronized HTML GIF comparison viewer."
    )
    p.add_argument("dirs", nargs="*",
                   help="Model sample dirs (models mode) or one parent dir "
                        "of lambda-tagged subdirs (lambda mode).")
    p.add_argument("--mode", choices=("models", "lambda"), default="models")
    p.add_argument("--output", default="comparison.html")
    p.add_argument("--title", default=None)
    p.add_argument("--no-embed", action="store_true",
                   help="Reference cached PNGs instead of base64-embedding.")
    p.add_argument("--models-file", default=None,
                   help="YAML with a MODELS list of model dir names "
                        "(reference config/models_list.yml), displayed "
                        "in file order.")
    p.add_argument("--main-models-dir", default=None,
                   help="Parent dir that --models-file names resolve under.")
    p.add_argument("--list-models", action="store_true",
                   help="Print the GIF-bearing subdirs of --main-models-dir "
                        "(or the one positional dir) and exit.")
    args = p.parse_args(argv)
    if args.list_models:
        parent = args.main_models_dir or (args.dirs[0] if args.dirs else ".")
        for name in list_model_dirs(parent):
            print(name)
        return 0
    if args.models_file:
        args.dirs = list(args.dirs) + load_models_file(
            args.models_file, args.main_models_dir
        )
    if not args.dirs:
        p.error("no model dirs given (positional dirs or --models-file)")
    if args.mode == "lambda":
        grid = scan_lambda_dirs(args.dirs[0])
        title = args.title or f"guidance-λ comparison: {args.dirs[0]}"
    else:
        grid = scan_model_dirs(args.dirs)
        title = args.title or "model comparison"
    if not grid:
        print("no GIFs found")
        return 1
    out = generate_html(
        grid, args.output, title=title, embed=not args.no_embed
    )
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
