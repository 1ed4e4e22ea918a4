"""Synthetic multi-resolution recordings (counterpart of
``esr_tpu/data/synthetic.py``): moving point sources emit events; each
ladder rung sees the same scene quantized to its grid, with the event count
scaled by the area ratio so scale^2*N GT windowing holds. Seeded by numpy,
so the same seed gives the same recording as the reference's generator."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from esr_tpu_torch.data.records import LADDER, MemoryRecording


def synthesize_streams(
    sensor_resolution: Tuple[int, int],
    base_events: int,
    duration: float = 1.0,
    rungs: Sequence[str] = ("ori", "down2", "down4", "down8", "down16"),
    num_sources: int = 6,
    rng: Optional[np.random.Generator] = None,
    burst_frac: float = 1.0,
    burst_events_frac: float = 0.98,
) -> Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Event streams per rung: ``base_events`` at the coarsest rung, scaled
    by factor^2 at finer rungs. ``burst_frac < 1`` makes the scene bursty:
    ``burst_events_frac`` of the events fall in the first ``burst_frac`` of
    the duration and the rest trail out to its end, so time-mode windows see
    an active head and a near-idle tail."""
    if not 0.0 < burst_frac <= 1.0:
        raise ValueError(f"burst_frac must be in (0, 1], got {burst_frac}")
    rng = rng or np.random.default_rng(0)
    H, W = sensor_resolution
    fmax = max(LADDER[r] for r in rungs)
    # shared latent trajectory: sources moving with constant velocity
    src_xy = rng.random((num_sources, 2))
    src_v = rng.normal(0, 0.3, (num_sources, 2))
    streams = {}
    for rung in rungs:
        f = LADDER[rung]
        h, w = round(H / f), round(W / f)
        n = int(base_events * (fmax / f) ** 2)
        u = rng.random(n)
        if burst_frac < 1.0:
            n_burst = int(n * burst_events_frac)
            u[:n_burst] *= burst_frac
            u[n_burst:] = burst_frac + u[n_burst:] * (1.0 - burst_frac)
        ts = np.sort(u) * duration
        which = rng.integers(0, num_sources, n)
        pos = src_xy[which] + src_v[which] * (ts / duration)[:, None]
        pos += rng.normal(0, 0.02, (n, 2))  # sensor jitter
        pos %= 1.0
        xs = np.floor(pos[:, 0] * w).astype(np.int32).clip(0, w - 1)
        ys = np.floor(pos[:, 1] * h).astype(np.int32).clip(0, h - 1)
        ps = rng.choice(np.array([-1, 1], np.int8), n)
        streams[rung] = (xs, ys, ts, ps)
    return streams


def make_synthetic_recording(
    sensor_resolution: Tuple[int, int] = (64, 64),
    base_events: int = 4096,
    num_frames: int = 8,
    duration: float = 1.0,
    rungs: Sequence[str] = ("ori", "down2", "down4", "down8", "down16"),
    seed: int = 0,
    burst_frac: float = 1.0,
    burst_events_frac: float = 0.995,
    name: Optional[str] = None,
) -> MemoryRecording:
    """The recording the reference's ``write_synthetic_h5`` writes for the
    same arguments (its streams and frames), kept in memory."""
    rng = np.random.default_rng(seed)
    streams = synthesize_streams(sensor_resolution, base_events, duration, rungs, rng=rng,
                                 burst_frac=burst_frac,
                                 burst_events_frac=burst_events_frac)
    H, W = sensor_resolution
    frames = [(rng.random((H, W)) * 255).astype(np.uint8) for _ in range(num_frames)]
    return MemoryRecording(sensor_resolution, streams, frames,
                           np.linspace(0, duration, num_frames),
                           name=name or f"synthetic_seed{seed}")
