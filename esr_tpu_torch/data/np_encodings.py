"""Host-side (numpy) event rasterization and resize (counterpart of
``esr_tpu/data/np_encodings.py``)."""

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
