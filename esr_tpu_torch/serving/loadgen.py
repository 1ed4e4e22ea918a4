"""Seeded synthetic traffic for the serving tier: streams and Poisson
arrivals (counterpart of ``esr_tpu/serving/loadgen.py``).

- :func:`make_stream_corpus`: ``n`` synthetic recordings of seeded,
  unequal lengths, optionally bursty; the same seeds give the streams the
  reference's corpus writes, kept in memory here (no HDF5 round trip).
- :func:`poisson_schedule`: exponential inter-arrival gaps at ``rate_hz``
  and request classes dealt round robin, for ``ServingEngine.run``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from esr_tpu_torch.data.records import MemoryRecording
from esr_tpu_torch.data.synthetic import make_synthetic_recording

__all__ = ["Arrival", "make_stream_corpus", "poisson_schedule"]


@dataclass(frozen=True)
class Arrival:
    """One scheduled stream arrival, ``t`` seconds after traffic starts;
    ``path`` is a recording path or an in-memory recording."""

    t: float
    path: object
    request_class: Optional[str] = None
    request_id: Optional[str] = None


def make_stream_corpus(
    n: int = 8,
    seed: int = 0,
    sensor_resolution: Tuple[int, int] = (64, 64),
    base_events: Tuple[int, int] = (1024, 4096),
    num_frames: int = 6,
    events_schedule: Optional[Sequence[int]] = None,
    burst_schedule: Optional[Sequence[float]] = None,
    rungs: Sequence[str] = ("ori", "down2", "down4", "down8", "down16"),
) -> List[MemoryRecording]:
    """``n`` recordings ``stream000``... with deliberately unequal lengths:
    the event count is drawn from ``base_events`` (or cycled from
    ``events_schedule``), recording ``i`` seeded ``seed * 1000 + i``, its
    ``burst_frac`` cycled from ``burst_schedule`` (1.0: uniform)."""
    rng = np.random.default_rng(seed)
    lo, hi = base_events
    out = []
    for i in range(n):
        ev = (int(events_schedule[i % len(events_schedule)]) if events_schedule
              else int(rng.integers(lo, hi + 1)))
        out.append(make_synthetic_recording(
            sensor_resolution, base_events=ev, num_frames=num_frames, rungs=rungs,
            seed=seed * 1000 + i,
            burst_frac=(float(burst_schedule[i % len(burst_schedule)])
                        if burst_schedule else 1.0),
            name=f"stream{i:03d}",
        ))
    return out


def poisson_schedule(paths: Sequence, rate_hz: float, seed: int = 0,
                     classes: Sequence[Optional[str]] = (None,)) -> List[Arrival]:
    """Seeded Poisson arrivals over ``paths`` in order: iid exponential gaps
    of mean ``1 / rate_hz``, the first at t = 0; classes dealt round robin;
    request ids ``lg-0000``..."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i, path in enumerate(paths):
        out.append(Arrival(t=round(t, 6), path=path, request_class=classes[i % len(classes)],
                           request_id=f"lg-{i:04d}"))
        t += float(rng.exponential(1.0 / rate_hz))
    return out
