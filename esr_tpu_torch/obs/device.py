"""The card in the telemetry stream (counterpart of ``esr_tpu/obs/device.py``).

- :class:`DeviceWatermark`: a polling thread that emits
  ``device_mem_bytes_in_use`` / ``device_mem_peak_bytes`` gauges from
  ``torch.cuda.memory_stats()`` (the caching allocator's host-side
  counters: reading them touches no tensor and syncs nothing). Without a
  card, or before CUDA is initialized in this process, the first poll
  emits one ``device_watermark_unavailable`` event and the thread stops.
- :class:`ProfilerCapture`: ``--profile-steps N``. It records the next
  ``N`` train steps or serving chunks with ``torch.profiler`` (CPU
  activity, and CUDA activity when the capture is for the card), writes
  the trace to ``trace_dir`` as a Chrome trace, and stamps a
  ``profiler_capture`` event carrying the directory and the file. The
  trainer's run-long ``profile.enabled`` uses :func:`start_trace` /
  :func:`stop_trace` directly.

A capture that fails to start or stop is logged and stamped with
``error``; it never raises into the loop it observes.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
from typing import Dict, Optional

from esr_tpu_torch.obs.sink import active_sink

logger = logging.getLogger(__name__)

__all__ = ["DeviceWatermark", "ProfilerCapture", "device_memory_stats",
           "start_trace", "stop_trace"]

# numbers the trace files of one process (replicas share the process)
_TRACE_SEQ = itertools.count()


def device_memory_stats(device_index: int = 0) -> Optional[Dict]:
    """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}`` of one
    card from the caching allocator, or None when CUDA is absent or not
    initialized in this process (this never initializes it)."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        if device_index >= torch.cuda.device_count():
            return None
        stats = torch.cuda.memory_stats(device_index)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(device_index).total_memory),
        }
    except Exception:  # noqa: BLE001 - visibility is best-effort
        return None


class DeviceWatermark:
    """Poll the card's memory into the telemetry stream: ``start()``
    spawns a daemon thread, ``stop()`` joins it, ``poll_once()`` is the
    body."""

    def __init__(self, sink=None, interval_s: float = 1.0, device_index: int = 0):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._sink = sink
        self.interval_s = float(interval_s)
        self.device_index = int(device_index)
        self.polls = 0
        self.peak_bytes = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._reported_unavailable = False

    def _sink_now(self):
        return self._sink if self._sink is not None else active_sink()

    def poll_once(self) -> Optional[Dict]:
        """One poll: the gauges when stats exist; else one
        ``device_watermark_unavailable`` event (the first time) and None."""
        self.polls += 1
        stats = device_memory_stats(self.device_index)
        sink = self._sink_now()
        if stats is None:
            if sink is not None and not self._reported_unavailable:
                self._reported_unavailable = True
                sink.event("device_watermark_unavailable", device_index=self.device_index)
            return None
        in_use = stats["bytes_in_use"]
        self.peak_bytes = max(self.peak_bytes, stats["peak_bytes_in_use"], in_use)
        if sink is not None:
            sink.gauge("device_mem_bytes_in_use", in_use, device_index=self.device_index)
            sink.gauge("device_mem_peak_bytes", self.peak_bytes,
                       device_index=self.device_index, limit_bytes=stats["bytes_limit"])
        return {"bytes_in_use": in_use, "peak_bytes": self.peak_bytes,
                "bytes_limit": stats["bytes_limit"]}

    def _run(self, trace_ctx=None) -> None:
        # adopt the starter's trace context: contextvars do not flow into
        # threads
        from esr_tpu_torch.obs import trace

        with trace.adopt(trace_ctx):
            while not self._stop.is_set():
                if self.poll_once() is None:
                    return
                self._stop.wait(self.interval_s)

    def start(self) -> "DeviceWatermark":
        if self._thread is not None and not self._thread.is_alive():
            self._thread = None
        if self._thread is None:
            self._stop.clear()
            from esr_tpu_torch.obs import trace

            self._thread = threading.Thread(target=self._run, args=(trace.capture(),),
                                            daemon=True, name="device-watermark")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, 2 * self.interval_s))
            if self._thread.is_alive():
                # keep the handle: start() stays a no-op until it exits
                return
            self._thread = None


def start_trace(cuda: bool):
    """Start a ``torch.profiler`` capture (CUDA activity when ``cuda``);
    returns the profiler."""
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if cuda:
        activities.append(tp.ProfilerActivity.CUDA)
    prof = tp.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, trace_dir: str, site: str) -> str:
    """Stop ``prof`` and write its Chrome trace under ``trace_dir``;
    returns the file's path."""
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{site}_{os.getpid()}_{next(_TRACE_SEQ)}.trace.json")
    prof.export_chrome_trace(path)
    return path


class ProfilerCapture:
    """Trace the next ``steps`` steps or chunks, then stop and stamp a
    ``profiler_capture`` event. ``maybe_start()`` before the loop,
    ``step(n)`` after each unit (stops itself at the budget), ``stop()`` in
    the teardown (idempotent). ``cuda`` adds CUDA activity (the caller's
    device is the card)."""

    def __init__(self, trace_dir: str, steps: int, sink=None, site: str = "train",
                 cuda: bool = False):
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        self.trace_dir = trace_dir
        self.steps = int(steps)
        self.site = site
        self.cuda = bool(cuda)
        self._sink = sink
        self.steps_covered = 0
        self.trace_file: Optional[str] = None
        self._prof = None
        self._done = False
        self._error: Optional[str] = None

    def maybe_start(self) -> bool:
        if self._prof is not None or self._done:
            return self._prof is not None
        try:
            self._prof = start_trace(self.cuda)
        except Exception as e:  # noqa: BLE001 - capture is best-effort
            self._error = repr(e)
            self._done = True
            logger.warning("profiler capture failed to start (%s): %r", self.trace_dir, e)
            self._emit()
        return self._prof is not None

    def step(self, n: int = 1) -> None:
        if self._prof is None:
            return
        self.steps_covered += int(n)
        if self.steps_covered >= self.steps:
            self.stop()

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            return
        self._done = True
        try:
            self.trace_file = stop_trace(prof, self.trace_dir, self.site)
        except Exception as e:  # noqa: BLE001 - capture is best-effort
            self._error = repr(e)
            logger.warning("profiler capture failed to stop: %r", e)
        self._emit()

    def _emit(self) -> None:
        sink = self._sink if self._sink is not None else active_sink()
        if sink is None:
            return
        sink.event("profiler_capture", dir=self.trace_dir, file=self.trace_file,
                   steps=self.steps, steps_covered=self.steps_covered, site=self.site,
                   ok=self._error is None, error=self._error)
