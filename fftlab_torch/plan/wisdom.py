"""Wisdom: measured plan choices, kept per process and in a JSON file
(counterpart of fftlab/plan/wisdom.py).

A table keyed by (kind, n, precision) holds the measured-best algorithm
or route and its time. The file is `FFTLAB_WISDOM_PATH`, resolved at
each call, else `~/.cache/fftlab_torch/wisdom.json`: never the JAX
package's file. No factory wisdom ships with the port, since
fftlab/plan/factory_wisdom.json holds TPU measurements only.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

_LOCK = threading.Lock()
_WISDOM: dict[str, dict[str, Any]] = {}


def _default_path() -> str:
    return os.environ.get(
        "FFTLAB_WISDOM_PATH",
        os.path.expanduser("~/.cache/fftlab_torch/wisdom.json"))


DEFAULT_PATH = _default_path()  # informational: each call resolves the path anew


def _key(n: int, precision: str, kind: str = "c2c") -> str:
    return f"{kind}:{n}:{precision}"


def record(n: int, precision: str, algorithm: str, time_ms: float, kind: str = "c2c",
           extra: dict | None = None) -> None:
    with _LOCK:
        _WISDOM[_key(n, precision, kind)] = {
            "algorithm": algorithm,
            "time_ms": float(time_ms),
            **(extra or {}),
        }


def lookup(n: int, precision: str, kind: str = "c2c") -> dict[str, Any] | None:
    with _LOCK:
        return _WISDOM.get(_key(n, precision, kind))


def forget() -> None:
    with _LOCK:
        _WISDOM.clear()


def export_wisdom(path: str | None = None) -> str:
    """Write the table as JSON; returns the path."""
    path = path or _default_path()
    with _LOCK:
        blob = json.dumps(_WISDOM, indent=2, sort_keys=True)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(blob)
    return path


def import_wisdom(path: str | None = None, overwrite: bool = True) -> int:
    """Load a JSON wisdom file; returns the number of entries in it.
    `overwrite=False` keeps the entries already in memory."""
    path = path or _default_path()
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"malformed wisdom file {path}")
    with _LOCK:
        if overwrite:
            _WISDOM.update(data)
        else:
            for k, v in data.items():
                _WISDOM.setdefault(k, v)
        return len(data)


def snapshot() -> dict[str, dict[str, Any]]:
    with _LOCK:
        return dict(_WISDOM)
