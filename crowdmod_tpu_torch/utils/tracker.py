"""Run tracking (port of the JAX package's ``utils/tracker.py``).

:class:`RunTracker` always writes a local JSONL event stream
(``events.jsonl``) and a config snapshot (``config.json``) under the run
directory, with the JAX package's records, and records artifacts (the plots
and GIFs of ``generate-samples``) in the same stream.  It mirrors both to
Weights & Biases when the ``wandb`` package imports and ``WANDB_MODE`` is
not ``disabled`` or ``offline`` (``use_wandb=None``); without ``wandb`` it
tracks locally only, as the JAX package does.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Mapping


class RunTracker:
    """Local-first experiment tracker with optional wandb mirroring."""

    def __init__(
        self,
        run_dir: str | os.PathLike,
        config: Mapping | None = None,
        project: str = "crowdmod-tpu",
        use_wandb: bool | None = None,
    ):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._events = open(self.run_dir / "events.jsonl", "a")
        self._t0 = time.time()
        self.step = 0

        if config is not None:
            snap = dict(config.to_dict() if hasattr(config, "to_dict") else config)
            with open(self.run_dir / "config.json", "w") as f:
                json.dump(snap, f, indent=2, default=str)

        self._wandb = None
        if use_wandb is None:
            use_wandb = os.environ.get("WANDB_MODE", "") not in ("disabled", "offline")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=project,
                    config=dict(config or {}),
                    dir=str(self.run_dir),
                )
            except Exception:
                logging.info("wandb unavailable; local JSONL tracking only")

    def log(self, metrics: Mapping[str, Any], step: int | None = None):
        step = self.step if step is None else step
        record = {
            "step": step,
            "time": round(time.time() - self._t0, 3),
            **{k: float(v) if hasattr(v, "__float__") else v
               for k, v in metrics.items()},
        }
        self._events.write(json.dumps(record) + "\n")
        self._events.flush()
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)
        self.step = step + 1

    def log_artifact(self, path: str | os.PathLike, kind: str = "file"):
        """Record an artifact path (GIF/plot/checkpoint) in the event stream
        and mirror media to wandb when available (reference crowd.py:145
        logs GIFs as ``wandb.Video``)."""
        record = {
            "artifact": str(path),
            "kind": kind,
            "time": round(time.time() - self._t0, 3),
        }
        self._events.write(json.dumps(record) + "\n")
        self._events.flush()
        if self._wandb is not None:
            try:
                import wandb

                if str(path).endswith(".gif"):
                    self._wandb.log({kind: wandb.Video(str(path))})
                elif str(path).endswith((".png", ".svg", ".jpg")):
                    self._wandb.log({kind: wandb.Image(str(path))})
            except Exception:
                logging.info("wandb artifact mirror failed for %s", path)

    def finish(self):
        self._events.close()
        if self._wandb is not None:
            self._wandb.finish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
