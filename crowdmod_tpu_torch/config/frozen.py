"""Immutable, hashable configuration trees.

The port's copy of ``crowdmod_tpu.config.frozen`` (the port imports nothing of
the JAX package).  The merged YAML is frozen into a ``FrozenConfig``: a nested
mapping with attribute access, where lists become tuples and dicts become
nested ``FrozenConfig`` instances, so configs hash and compare by value.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Iterator


def _freeze_value(v: Any) -> Any:
    if isinstance(v, Mapping):
        return FrozenConfig(v)
    if isinstance(v, (list, tuple)):
        return tuple(_freeze_value(x) for x in v)
    return v


def _thaw_value(v: Any) -> Any:
    if isinstance(v, FrozenConfig):
        return v.to_dict()
    if isinstance(v, tuple):
        return [_thaw_value(x) for x in v]
    return v


class FrozenConfig(Mapping):
    """Nested immutable mapping with attribute access (``cfg.DATASET.NAME``).

    Hashable, so it can be closed over or passed as a static jit argument.
    """

    __slots__ = ("_data", "_hash")

    def __init__(self, data: Mapping | None = None, **kwargs: Any):
        merged: dict = {}
        if data is not None:
            merged.update(data)
        merged.update(kwargs)
        object.__setattr__(
            self, "_data", {k: _freeze_value(v) for k, v in merged.items()}
        )
        object.__setattr__(self, "_hash", None)

    # Mapping protocol -----------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    # Attribute access -----------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self._data[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        raise AttributeError("FrozenConfig is immutable")

    # Hash / eq ------------------------------------------------------------
    def _hashable_items(self):
        return tuple(sorted(self._data.items(), key=lambda kv: kv[0]))

    def __hash__(self) -> int:
        h = object.__getattribute__(self, "_hash")
        if h is None:
            h = hash(self._hashable_items())
            object.__setattr__(self, "_hash", h)
        return h

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, FrozenConfig):
            return NotImplemented
        return self._data == other._data

    def __repr__(self) -> str:
        return f"FrozenConfig({self._data!r})"

    # Conversions / functional update --------------------------------------
    def to_dict(self) -> dict:
        return {k: _thaw_value(v) for k, v in self._data.items()}

    def updated(self, other: Mapping) -> "FrozenConfig":
        """Deep-merge ``other`` on top of self, returning a new FrozenConfig."""
        base = self.to_dict()
        _deep_update(base, other)
        return FrozenConfig(base)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        """Look up ``"MODEL.DDPM.TIMESTEPS"``-style dotted paths."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node


def _deep_update(base: dict, other: Mapping) -> dict:
    for k, v in other.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), Mapping):
            sub = dict(base[k]) if not isinstance(base[k], dict) else base[k]
            base[k] = _deep_update(sub, v)
        else:
            base[k] = _thaw_value(v) if isinstance(v, (FrozenConfig, tuple)) else v
    return base
