"""Seeded traffic for the serving tier: streams and Poisson arrivals
(counterpart of ``esr_tpu/serving/loadgen.py``).

- :func:`make_stream_corpus`: ``n`` recordings of seeded, unequal lengths,
  kept in memory (no HDF5 round trip). ``kind="synthetic"`` is the fast
  random-walk generator (``data/synthetic.py``); ``kind="simulate"``
  renders procedurally textured scenes and runs them through the ESIM
  contrast-threshold simulator (``tools/simulate.py``) for natural event
  statistics, with no cv2 and no h5py. The same seeds give the streams the
  reference's corpus writes.
- :func:`poisson_schedule`: exponential inter-arrival gaps at ``rate_hz``
  and request classes dealt round robin, for ``ServingEngine.run``.
- :func:`fleet_traffic`: a corpus and an aggregate rate scaled with the
  replica count; :func:`cohorts`: a schedule grouped into fixed-size
  arrival cohorts (the restart-the-batch baseline).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from esr_tpu_torch.data.records import MemoryRecording
from esr_tpu_torch.data.synthetic import make_synthetic_recording

__all__ = ["Arrival", "make_stream_corpus", "poisson_schedule", "cohorts", "fleet_traffic"]


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
    kind: str = "synthetic",
    sensor_resolution: Tuple[int, int] = (64, 64),
    base_events: Tuple[int, int] = (1024, 4096),
    num_frames: int = 6,
    events_schedule: Optional[Sequence[int]] = None,
    burst_schedule: Optional[Sequence[float]] = None,
    rungs: Sequence[str] = ("ori", "down2", "down4", "down8", "down16"),
) -> List[MemoryRecording]:
    """``n`` recordings ``stream000``... with deliberately unequal lengths,
    recording ``i`` seeded ``seed * 1000 + i``.

    ``kind="synthetic"``: the event count drawn from ``base_events`` (or
    cycled from ``events_schedule``), ``burst_frac`` cycled from
    ``burst_schedule`` (1.0: uniform). ``kind="simulate"``: a scene of
    ``rng.integers(num_frames, 2 * num_frames)`` frames rendered at 8x
    ``sensor_resolution`` (the ladder's rungs downscale it back), its disc
    radii scaled by ``max(8h, 8w) / 720 + 0.2``, simulated with that seed;
    its length knob is that draw, so ``events_schedule`` or
    ``burst_schedule`` with it raises ``ValueError``."""
    if kind == "simulate" and (events_schedule or burst_schedule):
        raise ValueError(
            "events_schedule/burst_schedule apply only to kind='synthetic'; simulate "
            "recordings vary via the seeded num_frames draw (got events_schedule="
            f"{list(events_schedule) if events_schedule else None!r}, burst_schedule="
            f"{list(burst_schedule) if burst_schedule else None!r})")
    if kind not in ("synthetic", "simulate"):
        raise ValueError(f"unknown corpus kind {kind!r}")
    rng = np.random.default_rng(seed)
    lo, hi = base_events
    out = []
    for i in range(n):
        name = f"stream{i:03d}"
        if kind == "synthetic":
            ev = (int(events_schedule[i % len(events_schedule)]) if events_schedule
                  else int(rng.integers(lo, hi + 1)))
            out.append(make_synthetic_recording(
                sensor_resolution, base_events=ev, num_frames=num_frames, rungs=rungs,
                seed=seed * 1000 + i,
                burst_frac=(float(burst_schedule[i % len(burst_schedule)])
                            if burst_schedule else 1.0),
                name=name,
            ))
            continue
        from esr_tpu_torch.tools.simulate import render_scene_frames, simulate_memory_recording

        h, w = sensor_resolution
        frames, ts = render_scene_frames(
            seed=seed * 1000 + i, num_frames=int(rng.integers(num_frames, num_frames * 2)),
            h=h * 8, w=w * 8, disc_radius_scale=max(h * 8, w * 8) / 720 + 0.2)
        recording, _ = simulate_memory_recording(frames, ts, rungs=rungs, seed=seed * 1000 + i,
                                                 name=name)
        out.append(recording)
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


def fleet_traffic(n_replicas: int, streams_per_replica: int = 4,
                  rate_hz_per_replica: float = 2.0, seed: int = 0,
                  classes: Sequence[Optional[str]] = (None,), **corpus_kw
                  ) -> Tuple[List[MemoryRecording], List[Arrival]]:
    """The fleet's loadgen: ``n_replicas * streams_per_replica`` streams at
    an aggregate rate of ``rate_hz_per_replica * n_replicas``, so the same
    knobs give the same per-replica pressure at any fleet size. Returns
    ``(recordings, schedule)`` for ``FleetRouter.run(arrivals=...)``;
    ``corpus_kw`` passes through to :func:`make_stream_corpus`."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    recordings = make_stream_corpus(n=int(n_replicas) * int(streams_per_replica), seed=seed,
                                    **corpus_kw)
    schedule = poisson_schedule(recordings, rate_hz=float(rate_hz_per_replica) * int(n_replicas),
                                seed=seed, classes=classes)
    return recordings, schedule


def cohorts(schedule: Sequence[Arrival], size: int) -> List[Tuple[float, List[Arrival]]]:
    """The schedule in arrival order, grouped into cohorts of ``size``; a
    cohort is ready when its last member has arrived (the wait continuous
    batching does not pay)."""
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    ordered = sorted(schedule, key=lambda a: a.t)
    out = []
    for i in range(0, len(ordered), size):
        group = ordered[i:i + size]
        out.append((max(a.t for a in group), group))
    return out
