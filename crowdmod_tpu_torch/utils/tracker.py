"""Run tracking, local part (port of the JAX package's ``utils/tracker.py``).

:class:`RunTracker` writes a JSONL event stream (``events.jsonl``) and a
config snapshot (``config.json``) under the run directory, with the JAX
package's records.  Its Weights & Biases mirror and its artifact records
(for the plots and GIFs of ``viz``) are not ported yet.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Mapping


class RunTracker:
    """Local experiment tracker: events and config under ``run_dir``."""

    def __init__(self, run_dir: str | os.PathLike, config: Mapping | None = None):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self._events = open(self.run_dir / "events.jsonl", "a")
        self._t0 = time.time()
        self.step = 0
        if config is not None:
            snap = dict(config.to_dict() if hasattr(config, "to_dict") else config)
            with open(self.run_dir / "config.json", "w") as f:
                json.dump(snap, f, indent=2, default=str)

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
        self.step = step + 1

    def finish(self):
        self._events.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
