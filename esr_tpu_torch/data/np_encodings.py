"""Host-side event rasterization, resize and tile activity (counterpart
of ``esr_tpu/data/np_encodings.py``).

``events_to_channels_np`` and ``events_to_stack_np`` call the native host
kernel (``esr_tpu_torch.native``) first and take their numpy twins only
when it is unavailable, as the reference does; the two routes give the
same bits. :data:`ROUTES` counts the calls each route took.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np

from esr_tpu_torch import native
from esr_tpu_torch.ops.resize import _interp_matrix


class RouteCounts:
    """Calls that took the native kernel and calls that took numpy (the
    loader's prefetch threads count concurrently)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts = {"native": 0, "numpy": 0}

    def add(self, route: str) -> None:
        with self._lock:
            self._counts[route] += 1

    def reset(self) -> None:
        with self._lock:
            self._counts = {"native": 0, "numpy": 0}

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


ROUTES = RouteCounts()


def events_to_image_np(
    xs: np.ndarray, ys: np.ndarray, ps: np.ndarray, sensor_size: Tuple[int, int]
) -> np.ndarray:
    """Scatter-add events into ``[H, W]``; out-of-range events dropped.
    Weights are counts / +-1, so the f64 accumulate is exact."""
    h, w = sensor_size
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    flat = ys[inb].astype(np.int64) * w + xs[inb].astype(np.int64)
    img = np.bincount(flat, weights=ps[inb], minlength=h * w)
    return img.astype(np.float32).reshape(h, w)


def events_to_channels_np(
    xs: np.ndarray, ys: np.ndarray, ps: np.ndarray, sensor_size: Tuple[int, int]
) -> np.ndarray:
    """Two-channel count image ``[H, W, 2]`` (positive, negative): the
    native kernel when available, else :func:`channels_numpy`."""
    out = native.rasterize_counts(xs, ys, ps, sensor_size)
    if out is not None:
        ROUTES.add("native")
        return out
    ROUTES.add("numpy")
    return channels_numpy(xs, ys, ps, sensor_size)


def channels_numpy(xs, ys, ps, sensor_size: Tuple[int, int]) -> np.ndarray:
    """The numpy twin of :func:`events_to_channels_np`."""
    pos = events_to_image_np(xs, ys, (ps > 0).astype(np.float32), sensor_size)
    neg = events_to_image_np(xs, ys, (ps < 0).astype(np.float32), sensor_size)
    return np.stack([pos, neg], axis=-1)


def events_to_stack_np(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, ps: np.ndarray,
                       num_bins: int, sensor_size: Tuple[int, int],
                       binning: str = "half_open") -> np.ndarray:
    """Signed time-binned stack ``[H, W, B]``.

    ``half_open`` (the default): bins ``floor((t - t0) / (t1 - t0 + 1e-6) *
    B)``, each event in one bin; the native kernel when available, else
    :func:`stack_numpy`. ``inclusive``: the original closed intervals, an
    event on a bin edge counted in both bins, and a window of <= 3 events
    or all-zero timestamps an all-zero stack; numpy on both routes. ``ts``
    must ascend (true for stream windows)."""
    if xs.size == 0:
        return np.zeros((*sensor_size, num_bins), np.float32)
    if binning == "inclusive":
        ROUTES.add("numpy")
        return stack_inclusive(xs, ys, ts, ps, num_bins, sensor_size)
    if binning != "half_open":
        raise ValueError(f"unknown stack binning {binning!r}")
    out = native.rasterize_stack(xs, ys, ts, ps, num_bins, sensor_size)
    if out is not None:
        ROUTES.add("native")
        return out
    ROUTES.add("numpy")
    return stack_numpy(xs, ys, ts, ps, num_bins, sensor_size)


def stack_numpy(xs, ys, ts, ps, num_bins: int, sensor_size: Tuple[int, int]) -> np.ndarray:
    """The numpy twin of :func:`events_to_stack_np`."""
    h, w = sensor_size
    if xs.size == 0:
        return np.zeros((h, w, num_bins), np.float32)
    t0 = ts.min()
    dt = ts.max() - t0 + 1e-6
    b = np.clip(np.floor((ts - t0) / dt * num_bins).astype(np.int64), 0, num_bins - 1)
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    flat = (ys[inb].astype(np.int64) * w + xs[inb].astype(np.int64)) * num_bins + b[inb]
    binned = np.bincount(flat, weights=ps[inb], minlength=h * w * num_bins)
    return binned.astype(np.float32).reshape(h, w, num_bins)


def stack_inclusive(xs, ys, ts, ps, num_bins: int, sensor_size: Tuple[int, int]) -> np.ndarray:
    """The ``inclusive`` binning of :func:`events_to_stack_np`: bin ``b``
    holds the events in ``[t0 + delta * b, t0 + delta * b + delta]``,
    ``delta = (t1 - t0 + 1e-6) / B``, found by binary search."""
    h, w = sensor_size
    out = np.zeros((h, w, num_bins), np.float32)
    if ts.sum() == 0 or len(ts) <= 3:
        return out
    t0 = ts[0]
    delta = (ts[-1] - t0 + 1e-6) / num_bins
    for bi in range(num_bins):
        # tstart + delta, not t0 + delta * (bi + 1): float addition is not
        # associative, and an edge one ulp off moves a boundary event
        tstart = t0 + delta * bi
        beg = int(np.searchsorted(ts, tstart, side="left"))
        end = int(np.searchsorted(ts, tstart + delta, side="right"))
        out[:, :, bi] = events_to_image_np(xs[beg:end], ys[beg:end], ps[beg:end], sensor_size)
    return out


def events_to_voxel_np(xs: np.ndarray, ys: np.ndarray, ts: np.ndarray, ps: np.ndarray,
                       num_bins: int, sensor_size: Tuple[int, int]) -> np.ndarray:
    """Voxel grid ``[H, W, B]``: each event's polarity split between its
    two nearest bins by temporal bilinear weights; ``ts`` normalized to
    [0, 1]."""
    tnorm = ts.astype(np.float32) * (num_bins - 1)
    bins = []
    for b in range(num_bins):
        wgt = np.maximum(0.0, 1.0 - np.abs(tnorm - b))
        bins.append(events_to_image_np(xs, ys, ps.astype(np.float32) * wgt, sensor_size))
    return np.stack(bins, axis=-1)


def interpolate_np(x: np.ndarray, size: Tuple[int, int], mode: str) -> np.ndarray:
    """Resize ``[H, W, C]`` with ``align_corners=False`` semantics."""
    h_in, w_in = x.shape[0], x.shape[1]
    if (h_in, w_in) == tuple(size):
        return x.astype(np.float32)
    mh = _interp_matrix(h_in, size[0], mode)
    mw = _interp_matrix(w_in, size[1], mode)
    out = np.einsum("oh,hwc->owc", mh, x.astype(np.float32))
    return np.einsum("ow,hwc->hoc", mw, out)


def tile_activity_np(counts: np.ndarray, tile: int = 8) -> np.ndarray:
    """Per-tile activity sums of a ``[H, W, ...]`` count image ->
    ``[ceil(H/tile), ceil(W/tile)]`` f32; a tile is active iff its sum is
    ``> 0``."""
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    h, w = counts.shape[0], counts.shape[1]
    c = counts.reshape(h, w, -1).sum(axis=-1)
    ht = -(-h // tile)
    wt = -(-w // tile)
    c = np.pad(c, ((0, ht * tile - h), (0, wt * tile - w)))
    return c.reshape(ht, tile, wt, tile).sum(axis=(1, 3)).astype(np.float32)


def activity_fraction_np(act: np.ndarray) -> float:
    """Fraction of active tiles of a :func:`tile_activity_np` map (the
    statistic ``RequestClass.min_activity`` compares against)."""
    act = np.asarray(act)
    return float((act > 0).mean()) if act.size else 0.0


def events_to_channels_activity_np(xs: np.ndarray, ys: np.ndarray, ps: np.ndarray,
                                   sensor_size: Tuple[int, int],
                                   tile: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """The count image and its per-tile activity map in one pass: the
    activity is a reduction of the counts just summed, never a second scan
    of the events."""
    cnt = events_to_channels_np(xs, ys, ps, sensor_size)
    return cnt, tile_activity_np(cnt, tile)
