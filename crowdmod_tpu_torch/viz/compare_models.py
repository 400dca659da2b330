"""Cross-model metric comparison figures (port of the JAX package's
``viz/compare_models.py``; the ``compare`` command).

Each model's metric directory carries a ``metrics_files.json`` manifest
(written by :meth:`crowdmod_tpu_torch.metrics.generator.MetricsEngine.save`,
under the JAX package's names, so either package's directories load); this
module loads any number of them, aligns metrics by name, and draws
side-by-side boxplot and Bhattacharyya comparison figures plus a summary
table CSV (the reference's ``comparison_models_plot.py``).  numpy and
matplotlib on the host; no device.

    python -m crowdmod_tpu_torch.cli compare out/metrics/DDPM-UNet \
        out/metrics/FM-UNet --output-dir out/comparison
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from crowdmod_tpu_torch.viz.plot_crowd import ddim_sort_key, make_short_name
from crowdmod_tpu_torch.viz.plot_metrics import labeled_boxplot


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_manifest(model_dir: str) -> dict[str, np.ndarray]:
    """→ {metric_name: (N, cols) array} from one model's metric dir."""
    path = os.path.join(model_dir, "metrics_files.json")
    with open(path) as f:
        manifest = json.load(f)
    out = {}
    for name, csv_path in manifest.items():
        if name == "title":
            continue
        if not os.path.isabs(csv_path):
            csv_path = os.path.join(model_dir, os.path.basename(csv_path))
        if os.path.exists(csv_path):
            out[name] = np.genfromtxt(
                csv_path, delimiter=",", skip_header=1, ndmin=2
            )
    return out


def _csv_header(model_dir: str, name: str) -> list[str]:
    with open(os.path.join(model_dir, "metrics_files.json")) as f:
        manifest = json.load(f)
    csv_path = manifest[name]
    if not os.path.isabs(csv_path):
        csv_path = os.path.join(model_dir, os.path.basename(csv_path))
    with open(csv_path) as f:
        return f.readline().strip().split(",")


def compare_metric(
    models: dict[str, dict[str, np.ndarray]],
    metric: str,
    save_path: str,
    *,
    column: int = 0,
    column_label: str = "",
) -> str | None:
    """One figure: ``metric[column]`` boxplot per model, models side by side
    (reference comparison_models_plot figures)."""
    plt = _plt()
    labels, values = [], []
    for name in sorted(models, key=ddim_sort_key):
        data = models[name].get(metric)
        if data is None or data.shape[1] <= column:
            continue
        col = data[:, column]
        col = col[np.isfinite(col)]
        if len(col):
            labels.append(make_short_name(name))
            values.append(col)
    if not values:
        return None
    fig, ax = plt.subplots(figsize=(max(6, 1.4 * len(values)), 5))
    labeled_boxplot(ax, values, labels)
    ax.set_title(f"{metric}{f' ({column_label})' if column_label else ''}")
    ax.grid(True, alpha=0.3)
    ax.tick_params(axis="x", rotation=30)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def compare_bhatt(
    models: dict[str, dict[str, np.ndarray]], save_path: str
) -> str | None:
    """Paired Bhattacharyya coef/dist comparison across models (reference
    Bhatt figures)."""
    plt = _plt()
    names = sorted(models, key=ddim_sort_key)
    have = [
        n for n in names
        if "MF_BHATT_COEF" in models[n] and "MF_BHATT_DIST" in models[n]
    ]
    if not have:
        return None
    fig, axes = plt.subplots(1, 2, figsize=(6 + 1.2 * len(have), 5))
    for ax, metric in zip(axes, ("MF_BHATT_COEF", "MF_BHATT_DIST")):
        vals = [models[n][metric][:, 0] for n in have]
        labeled_boxplot(ax, vals, [make_short_name(n) for n in have])
        ax.set_title(f"{metric} (hist2D)")
        ax.grid(True, alpha=0.3)
        ax.tick_params(axis="x", rotation=30)
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def summary_table(
    models: dict[str, dict[str, np.ndarray]], save_path: str
) -> str:
    """Mean-per-metric CSV across models for quick ranking."""
    metrics = sorted({m for d in models.values() for m in d})
    names = sorted(models, key=ddim_sort_key)
    with open(save_path, "w") as f:
        f.write("model," + ",".join(metrics) + "\n")
        for n in names:
            row = [make_short_name(n)]
            for m in metrics:
                data = models[n].get(m)
                row.append(
                    f"{np.nanmean(data):.4f}" if data is not None else ""
                )
            f.write(",".join(row) + "\n")
    return save_path


def compare_models(
    model_dirs: list[str], output_dir: str,
    metrics: list[str] | None = None,
) -> dict[str, str]:
    """Full comparison suite over N model metric directories."""
    os.makedirs(output_dir, exist_ok=True)
    models = {
        os.path.basename(os.path.normpath(d)) or d: load_manifest(d)
        for d in model_dirs
    }
    if metrics is None:
        metrics = sorted({m for d in models.values() for m in d})
    artifacts = {}
    for m in metrics:
        if m.startswith("MF_BHATT"):
            continue
        p = compare_metric(
            models, m, os.path.join(output_dir, f"compare_{m}.png")
        )
        if p:
            artifacts[m] = p
    p = compare_bhatt(models, os.path.join(output_dir, "compare_BHATT.png"))
    if p:
        artifacts["BHATT"] = p
    artifacts["summary"] = summary_table(
        models, os.path.join(output_dir, "summary.csv")
    )
    return artifacts


def run(argv=None) -> int:
    p = argparse.ArgumentParser(description="Compare model metric suites.")
    p.add_argument("model_dirs", nargs="+",
                   help="Metric dirs each containing metrics_files.json")
    p.add_argument("--output-dir", default="comparison")
    p.add_argument("--metrics", nargs="*", default=None)
    args = p.parse_args(argv)
    artifacts = compare_models(args.model_dirs, args.output_dir, args.metrics)
    for k, v in artifacts.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(run())
