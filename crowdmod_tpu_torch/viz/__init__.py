"""Plots of the port (the JAX package's ``viz``): sample grids and GIFs,
crowd frames, loss curves, metric boxplots, the cross-model comparison
figures and the HTML GIF viewer.

The numbers behind a plot are computed in PyTorch on the caller's device
(the GIFs' overlay metrics in one batched call, :func:`.plot_samples.
overlay_metrics`); only the drawing runs on the host, in numpy and
matplotlib (Agg), imported when a plot is drawn.  A host without
matplotlib still trains and scores: :func:`plotting_unavailable` says why
the plots are skipped there.
"""

from __future__ import annotations


def plotting_unavailable() -> str | None:
    """Why this host cannot draw the plots (matplotlib missing), or None."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        return f"matplotlib is not installed ({e})"
    return None
