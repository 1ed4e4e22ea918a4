"""Running-average metric tracking + YAML result files (counterpart of
``esr_tpu/utils/trackers.py``).

:class:`YamlLogger` writes YAML itself, without ``pyyaml``: reports are
nested dicts of numbers, strings, booleans, ``None`` and short lists, which
a small block-style emitter covers exactly.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List

import numpy as np


class MetricTracker:
    """Totals / counts / running averages per key (unknown keys are created
    on first update). ``writer`` (a ``utils.writer.MetricWriter``) receives
    ``add_scalar(key, value)`` on every update, as the reference's does."""

    def __init__(self, keys: Iterable[str] = (), writer=None):
        self.writer = writer
        self._total: Dict[str, float] = {k: 0.0 for k in keys}
        self._count: Dict[str, int] = {k: 0 for k in self._total}

    def reset(self) -> None:
        for k in self._total:
            self._total[k] = 0.0
            self._count[k] = 0

    def update(self, key: str, value: float, n: int = 1) -> None:
        if self.writer is not None:
            self.writer.add_scalar(key, value)
        self._total[key] = self._total.get(key, 0.0) + float(value) * n
        self._count[key] = self._count.get(key, 0) + n

    def avg(self, key: str) -> float:
        c = self._count.get(key, 0)
        return self._total.get(key, 0.0) / c if c else 0.0

    def result(self) -> Dict[str, float]:
        """{key: running average}; keys never updated report 0.0."""
        return {k: self.avg(k) for k in self._total}


def _scalar(v) -> str:
    if isinstance(v, (np.generic, np.ndarray)) and np.ndim(v) == 0:
        v = v.item()
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v)
        # YAML 1.1 reads a float only with a '.' in the mantissa
        if "e" in s and "." not in s.split("e")[0]:
            m, e = s.split("e")
            s = f"{m}.0e{e}"
        return s
    if isinstance(v, str):
        return json.dumps(v)  # a JSON string is a YAML double-quoted scalar
    raise TypeError(f"cannot write {type(v).__name__} to YAML")


def _flow(v) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar(str(k))}: {_flow(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple, np.ndarray)) and np.ndim(v) > 0:
        return "[" + ", ".join(_flow(x) for x in list(v)) + "]"
    return _scalar(v)


def _emit(obj: Dict, indent: int, lines: List[str]) -> None:
    pad = "  " * indent
    for k, v in obj.items():
        key = _scalar(str(k))
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{key}:")
            _emit(v, indent + 1, lines)
        else:
            lines.append(f"{pad}{key}: {_flow(v)}")


def to_yaml(obj: Dict) -> str:
    """Block-style YAML of a nested dict."""
    lines: List[str] = []
    _emit(obj, 0, lines)
    return "\n".join(lines) + "\n"


class YamlLogger:
    """Structured YAML result file: ``log_info`` appends to an ``info``
    list, ``log_dict`` stores a named mapping; written on ``close()`` (or
    context exit)."""

    def __init__(self, path: str):
        self.path = path
        self._info: Dict = {}
        self._closed = False

    def log_info(self, info: str) -> None:
        self._info.setdefault("info", []).append(info)

    def log_dict(self, payload: Dict, name: str) -> None:
        self._info[name] = payload

    def close(self) -> None:
        if self._closed:
            return
        with open(self.path, "w") as f:
            f.write(to_yaml(self._info))
        self._closed = True

    def __enter__(self) -> "YamlLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
