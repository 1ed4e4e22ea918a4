"""Metric writer: JSONL always, TensorBoard when it can be imported
(counterpart of ``esr_tpu/utils/writer.py``).

- ``metrics.jsonl`` in the log directory: one JSON object per scalar
  (``{"step", "tag", "value"}``) and per image (``{"step", "tag",
  "image": true}``: that an image was logged, not its pixels), with tags
  ``<key>/<mode>``; the same records as the reference's;
- TensorBoard through ``torch.utils.tensorboard`` when asked for and
  importable; a logged warning when it is not (then JSONL only);
- :meth:`MetricWriter.set_step` emits ``steps_per_sec`` on every step
  advance, as the reference does;
- the telemetry sink (``esr_tpu_torch.obs``): every scalar is mirrored as a
  ``metric`` record (``source: "writer"``) and every image as an ``image``
  event. ``sink``: an explicit sink wins; ``None`` (the default) takes the
  process-active sink at construction; ``False`` disables the mirror. The
  writer never closes the sink.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from esr_tpu_torch.obs import active_sink


class MetricWriter:
    def __init__(self, log_dir: str, logger=None, enable_tensorboard: bool = True,
                 sink=None):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.step = 0
        self.mode = ""
        self._timer = time.perf_counter()
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.sink = active_sink() if sink is None else (sink or None)
        self.tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                if logger is not None:
                    logger.warning("TensorBoard unavailable (%s); JSONL metrics only", e)
            else:
                self.tb = SummaryWriter(log_dir)

    def set_step(self, step: int, mode: str = "train") -> None:
        """Advance the global step; emits ``steps_per_sec``."""
        self.mode = mode
        if step == 0:
            self._timer = time.perf_counter()
        else:
            now = time.perf_counter()
            dt = now - self._timer
            if dt > 0 and step > self.step:
                self.add_scalar("steps_per_sec", (step - self.step) / dt)
            self._timer = now
        self.step = step

    def _tag(self, key: str) -> str:
        return f"{key}/{self.mode}" if self.mode else key

    def _write(self, record: dict) -> None:
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def add_scalar(self, key: str, value: float, step: Optional[int] = None) -> None:
        step = self.step if step is None else step
        self._write({"step": step, "tag": self._tag(key), "value": float(value)})
        if self.sink is not None:
            self.sink.metric(self._tag(key), float(value), step=step, source="writer")
        if self.tb is not None:
            self.tb.add_scalar(self._tag(key), float(value), global_step=step)

    def add_image(self, key: str, image, step: Optional[int] = None) -> None:
        """``image``: HWC or HW uint8/float numpy array (TensorBoard only;
        the JSONL line records that it was logged)."""
        step = self.step if step is None else step
        self._write({"step": step, "tag": self._tag(key), "image": True})
        if self.sink is not None:
            self.sink.event("image", tag=self._tag(key), step=step)
        if self.tb is not None:
            fmt = "HWC" if getattr(image, "ndim", 2) == 3 else "HW"
            self.tb.add_image(self._tag(key), image, global_step=step, dataformats=fmt)

    def close(self) -> None:
        self._jsonl.close()
        if self.tb is not None:
            self.tb.close()

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
