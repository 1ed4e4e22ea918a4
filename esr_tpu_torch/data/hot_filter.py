"""Hot-pixel filtering: a stateful event-rate tracker and its keep-mask
(counterpart of ``esr_tpu/data/hot_filter.py``).

Each window observed marks the pixels that fired at least once; the marks
accumulate into a per-pixel rate (marks / windows seen). Once more than
``min_obvs`` windows have been seen, up to ``max_px`` of the pixels whose
rate exceeds ``max_rate`` (the highest first) are masked, and the events
landing on them are dropped before rasterization. The state lives in the
dataset, so windows must reach it in one order: the loader refuses the
filter with worker processes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def hot_mask_from_rate(event_rate: np.ndarray, idx: int, max_px: int = 100,
                       min_obvs: int = 5, max_rate: float = 0.8) -> np.ndarray:
    """Binary keep-mask ``[H, W]``: zero at the (at most ``max_px``)
    highest-rate pixels above ``max_rate``, once ``idx > min_obvs``."""
    mask = np.ones_like(event_rate, np.float32)
    if idx <= min_obvs:
        return mask
    flat = event_rate.reshape(-1)
    n_over = int((flat > max_rate).sum())
    if n_over == 0:
        return mask
    candidates = np.argsort(flat)[::-1][:min(max_px, n_over)]
    candidates = candidates[flat[candidates] > max_rate]
    mask.reshape(-1)[candidates] = 0.0
    return mask


class HotPixelFilter:
    """Per-recording hot-pixel tracker (``config``: ``max_px``,
    ``min_obvs``, ``max_rate``)."""

    def __init__(self, resolution: Tuple[int, int], config: Dict):
        self.resolution = tuple(resolution)
        self.max_px = int(config.get("max_px", 100))
        self.min_obvs = int(config.get("min_obvs", 5))
        self.max_rate = float(config.get("max_rate", 0.8))
        self.hot_events = np.zeros(self.resolution, np.float64)
        self.hot_idx = 0

    def update_and_mask(self, events: np.ndarray) -> np.ndarray:
        """Observe one window ``[4, N]`` (x, y, t, p) and return the
        keep-mask after it."""
        h, w = self.resolution
        obs = np.zeros((h, w), np.float64)
        if events.shape[1]:
            xs = events[0].astype(np.int64)
            ys = events[1].astype(np.int64)
            ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
            obs[ys[ok], xs[ok]] = 1.0
        self.hot_events += obs
        self.hot_idx += 1
        return hot_mask_from_rate(self.hot_events / self.hot_idx, self.hot_idx,
                                  self.max_px, self.min_obvs, self.max_rate)

    def filter_events(self, events: np.ndarray) -> np.ndarray:
        """Update the statistics with ``events``, then drop those on hot
        pixels."""
        mask = self.update_and_mask(events)
        if events.shape[1] == 0:
            return events
        h, w = self.resolution
        xs = events[0].astype(np.int64).clip(0, w - 1)
        ys = events[1].astype(np.int64).clip(0, h - 1)
        return events[:, mask[ys, xs] > 0]
