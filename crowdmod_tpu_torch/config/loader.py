"""YAML config loading with the reference's two-file merge convention.

The port's copy of ``crowdmod_tpu.config.loader``: a model/dataset config
file plus an optional datafile-list file are merged (later file wins per
top-level key) and returned as an immutable :class:`FrozenConfig`.  Bare
names resolve against the repo's ``configs/`` directory, the same files the
JAX package reads.
"""

from __future__ import annotations

import os
from pathlib import Path

import yaml

from crowdmod_tpu_torch.config.frozen import FrozenConfig


def config_dir() -> Path:
    """Directory holding the bundled dataset configs.

    Defaults to ``configs/`` at the repo root (checkouts and editable
    installs).  Non-editable wheel installs don't carry the repo layout —
    point ``CROWDMOD_CONFIG_DIR`` at a configs directory there.
    """
    env = os.environ.get("CROWDMOD_CONFIG_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "configs"


def _load_yaml(path: str | os.PathLike) -> dict:
    p = Path(path)
    if not p.exists():
        # Fall back to the bundled configs directory for bare names.
        candidate = config_dir() / p
        if candidate.exists():
            p = candidate
        else:
            raise FileNotFoundError(f"config file not found: {path}")
    with open(p, "r") as f:
        data = yaml.safe_load(f)
    return data or {}


def is_datafile_list(path: str | os.PathLike) -> bool:
    """True if ``path`` is a datafile-list YAML, judged by *content*.

    The reference ships two shapes of companion file (not dataset configs):
    ``DATA_LIST`` mappings of ``[pkl, n_samples]`` pairs or bare filenames
    (``configs/ATC_datafiles.yml``, ``configs/ATC_DSlist4test_one.yml``) and
    plain top-level filename lists.  Filename suffixes are a convention, not a
    contract — classify by structure so new companion files (whatever they
    are named) are never schema-validated as dataset configs.
    """
    try:
        data = _load_yaml(path)
    except Exception:
        return False
    if isinstance(data, list):
        return True
    if isinstance(data, dict) and data:
        return set(data) <= {"DATA_LIST"}
    return False


def load_config(
    config_yml_file: str | os.PathLike,
    datafiles_yml_file: str | os.PathLike | None = None,
    overrides: dict | None = None,
) -> FrozenConfig:
    """Load and merge config YAMLs into a FrozenConfig.

    Args:
      config_yml_file: dataset/model hyperparameter tree (e.g. ``ATC.yml``).
      datafiles_yml_file: optional ``DATA_LIST`` file of ``[pkl, n_samples]``
        pairs, merged on top (reference myparser.py:32-33 semantics).
      overrides: optional final dict deep-merged on top (sweeps, tests).
    """
    merged = _load_yaml(config_yml_file)
    cfg = FrozenConfig(merged)
    if datafiles_yml_file is not None:
        cfg = cfg.updated(_load_yaml(datafiles_yml_file))
    if overrides:
        cfg = cfg.updated(overrides)
    # Fill schema defaults so optional keys are real attributes everywhere
    # (validate.with_defaults is a no-op for configs with schema problems).
    from crowdmod_tpu_torch.config.validate import with_defaults

    return with_defaults(cfg)
