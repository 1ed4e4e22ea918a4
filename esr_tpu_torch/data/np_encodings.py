"""Host-side (numpy) event rasterization, resize and tile activity
(counterpart of ``esr_tpu/data/np_encodings.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from esr_tpu_torch.ops.resize import _interp_matrix


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
    """Two-channel count image ``[H, W, 2]`` (positive, negative)."""
    pos = events_to_image_np(xs, ys, (ps > 0).astype(np.float32), sensor_size)
    neg = events_to_image_np(xs, ys, (ps < 0).astype(np.float32), sensor_size)
    return np.stack([pos, neg], axis=-1)


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
