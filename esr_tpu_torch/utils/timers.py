"""Wall-clock timers with a process-wide summary (counterpart of
``esr_tpu/utils/timers.py``): a :class:`Timer` context appends its seconds
to :data:`timing_stats`, and :func:`print_timing_info` (registered with
``atexit`` when the first timer starts) reports each name's mean. Device
work is asynchronous: synchronize the device inside the timed block
(``esr_tpu_torch.device.synchronize``) to time it.
"""

from __future__ import annotations

import atexit
import time
from collections import defaultdict
from typing import Dict, List

timing_stats: Dict[str, List[float]] = defaultdict(list)
_atexit_registered = False


class Timer:
    """``with Timer("name"): ...``: seconds appended to ``timing_stats``;
    with a ``logger`` the single measurement is also logged at exit."""

    def __init__(self, name: str, logger=None):
        self.name = name
        self.logger = logger

    def __enter__(self) -> "Timer":
        global _atexit_registered
        if not _atexit_registered:
            atexit.register(print_timing_info)
            _atexit_registered = True
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.interval = time.perf_counter() - self._t0
        timing_stats[self.name].append(self.interval)
        if self.logger is not None:
            self.logger.info(f"{self.name}: {self.interval:.4f} s")


def print_timing_info(logger=None) -> None:
    """Mean wall-clock seconds per timer name."""
    emit = logger.info if logger is not None else print
    if not timing_stats:
        return
    emit("== Timing statistics ==")
    for name, samples in timing_stats.items():
        mean = sum(samples) / len(samples)
        emit(f"{name}: {mean:.4f} s ({len(samples)} samples)")
