"""Views of the self-supervised flow / reconstruction pipeline: the flow
colour wheel, robust min-max normalization, and per-sequence PNG stores
(counterpart of ``esr_tpu/utils/pipeline_vis.py``).

- :func:`flow_to_image`: hue the flow's angle (``atan2`` moved to [0, 1]),
  saturation 1, value the min-max-normalized magnitude, converted to RGB
  with the formula of ``matplotlib.colors.hsv_to_rgb`` written out in numpy
  (:func:`hsv_to_rgb`), so the images are the reference's bit for bit and the
  module needs no matplotlib;
- :func:`minmax_norm`: the P1..P99 normalization, clipped to [0, 1];
- :class:`PipelineVisualizer`: ``render`` gives the uint8 views by name
  (``events``, ``frames``, ``flow``, ``iwe``, ``brightness``), ``store``
  writes them as ``<store_dir>/<sequence>/<kind>/%09d.png`` with
  ``timestamps.txt`` beside, through :func:`esr_tpu_torch.utils.vis_events
  .save_image` (the port's own PNG writer: no OpenCV).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from esr_tpu_torch.utils.vis_events import render_event_cnt, save_image


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``[..., 3]`` HSV in [0, 1] -> RGB in [0, 1]: the arithmetic of
    ``matplotlib.colors.hsv_to_rgb``, operation for operation (integers
    widen to at least f32, as there)."""
    hsv = np.asarray(hsv)
    if hsv.shape[-1] != 3:
        raise ValueError(f"the last dimension must be 3; shape {hsv.shape} was found")
    in_shape = hsv.shape
    hsv = np.array(hsv, dtype=np.promote_types(hsv.dtype, np.float32), ndmin=2)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    # the sextants in matplotlib's order; hue 1.0 (i = 6) is sextant 0
    for idx, (rr, gg, bb) in ((i % 6 == 0, (v, t, p)), (i == 1, (q, v, p)),
                              (i == 2, (p, v, t)), (i == 3, (p, q, v)),
                              (i == 4, (t, p, v)), (i == 5, (v, p, q)),
                              (s == 0, (v, v, v))):
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    return np.stack([r, g, b], axis=-1).reshape(in_shape)


def flow_to_image(flow_x: np.ndarray, flow_y: np.ndarray) -> np.ndarray:
    """``[H, W]`` flow components -> ``[H, W, 3]`` uint8 on the colour wheel
    (module docstring); a flow of one magnitude everywhere is black."""
    flow_x = np.asarray(flow_x, np.float64)
    flow_y = np.asarray(flow_y, np.float64)
    mag = np.sqrt(flow_x**2 + flow_y**2)
    min_mag = mag.min()
    mag_range = mag.max() - min_mag
    ang = (np.arctan2(flow_y, flow_x) + np.pi) / (2.0 * np.pi)
    hsv = np.zeros(flow_x.shape + (3,))
    hsv[:, :, 0] = ang
    hsv[:, :, 1] = 1.0
    hsv[:, :, 2] = mag - min_mag
    if mag_range != 0.0:
        hsv[:, :, 2] /= mag_range
    return (255 * hsv_to_rgb(hsv)).astype(np.uint8)


def minmax_norm(x: np.ndarray) -> np.ndarray:
    """``x`` mapped from its P1..P99 range to [0, 1] and clipped (left as it
    is before the clip when the two percentiles are equal)."""
    lo = np.percentile(x, 1)
    den = np.percentile(x, 99) - lo
    if den != 0:
        x = (x - lo) / den
    return np.clip(x, 0, 1)


def _hwc(arr: np.ndarray, channels: int) -> np.ndarray:
    """``[B, C, H, W]``, ``[B, H, W, C]``, ``[C, H, W]``, ``[H, W, C]`` or
    ``[H, W]`` -> ``[H, W, C]`` (a batch gives its first item)."""
    a = np.asarray(arr)
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 2:
        a = a[..., None]
    if a.shape[0] == channels and a.shape[-1] != channels:
        a = np.transpose(a, (1, 2, 0))
    return a


class PipelineVisualizer:
    """Renders and stores the pipeline's views (module docstring). A
    sequence visited again resumes its frame index and appends to its
    ``timestamps.txt``."""

    KINDS = ("events", "flow", "frames", "iwe", "brightness")

    def __init__(self, store_dir: Optional[str] = None,
                 color_scheme: str = "green_red") -> None:
        self.store_dir = store_dir
        self.color_scheme = color_scheme
        self.img_idx = 0
        self._sequence: Optional[str] = None
        self._ts_file = None
        self._seq_idx: Dict[str, int] = {}

    def render(self, inputs: Optional[Dict[str, np.ndarray]] = None,
               flow: Optional[np.ndarray] = None, iwe: Optional[np.ndarray] = None,
               brightness: Optional[np.ndarray] = None,
               frames_pair: bool = True) -> Dict[str, np.ndarray]:
        """The uint8 view of each input given: ``events`` (``inp_cnt`` or
        ``e_cnt``), ``frames`` (``inp_frames``: the previous and current
        frame side by side, or with ``frames_pair=False`` the current one),
        ``flow``, ``iwe`` and ``brightness``."""
        out: Dict[str, np.ndarray] = {}
        inputs = inputs or {}
        ev = inputs.get("inp_cnt", inputs.get("e_cnt"))
        if ev is not None:
            out["events"] = render_event_cnt(_hwc(ev, 2), color_scheme=self.color_scheme)
        frames = inputs.get("inp_frames")
        if frames is not None:
            f = _hwc(frames, 2)
            img = np.concatenate([f[:, :, 0], f[:, :, 1]], axis=1) if frames_pair else f[:, :, 1]
            out["frames"] = np.clip(img, 0, 255).astype(np.uint8)
        if flow is not None:
            f = _hwc(flow, 2)
            out["flow"] = flow_to_image(f[:, :, 0], f[:, :, 1])
        if iwe is not None:
            out["iwe"] = render_event_cnt(_hwc(iwe, 2), color_scheme=self.color_scheme)
        if brightness is not None:
            out["brightness"] = (minmax_norm(_hwc(brightness, 1)[:, :, 0]) * 255).astype(np.uint8)
        return out

    def store(self, inputs: Optional[Dict[str, np.ndarray]], flow: Optional[np.ndarray],
              iwe: Optional[np.ndarray], brightness: Optional[np.ndarray], sequence: str,
              ts: Optional[float] = None) -> Dict[str, str]:
        """Write the views (``frames_pair=False``) under
        ``store_dir/sequence/<kind>/%09d.png`` and ``ts`` to the sequence's
        ``timestamps.txt``; returns the paths written by kind."""
        if self.store_dir is None:
            raise ValueError("PipelineVisualizer.store needs a store_dir")
        root = os.path.join(self.store_dir, sequence)
        if sequence != self._sequence:
            fresh = sequence not in self._seq_idx
            for kind in self.KINDS:
                os.makedirs(os.path.join(root, kind), exist_ok=True)
            if self._ts_file is not None:
                self._ts_file.close()
            self._ts_file = open(os.path.join(root, "timestamps.txt"), "w" if fresh else "a")
            self._sequence = sequence
            self.img_idx = self._seq_idx.get(sequence, 0)
        written: Dict[str, str] = {}
        for kind, img in self.render(inputs, flow, iwe, brightness, frames_pair=False).items():
            path = os.path.join(root, kind, "%09d.png" % self.img_idx)
            save_image(path, img)
            written[kind] = path
        if ts is not None:
            self._ts_file.write(str(ts) + "\n")
            self._ts_file.flush()
        self.img_idx += 1
        self._seq_idx[sequence] = self.img_idx
        return written

    def close(self) -> None:
        if self._ts_file is not None:
            self._ts_file.close()
            self._ts_file = None
