"""The percentile of the serving summaries (a copy of
``esr_tpu/obs/report.py:percentile`` and ``percentile_ms``)."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0..100), linear interpolation between order
    statistics (``numpy.percentile``'s default); None for no values."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    rank = (q / 100.0) * (len(vals) - 1)
    lo = int(math.floor(rank))
    hi = int(math.ceil(rank))
    if lo == hi:
        return vals[lo]
    frac = rank - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def percentile_ms(values_s: Sequence[float], q: float, ndigits: int = 3) -> Optional[float]:
    """:func:`percentile` of seconds, in milliseconds rounded to ``ndigits``."""
    p = percentile(values_s, q)
    return None if p is None else round(p * 1e3, ndigits)
