"""Structured JSONL telemetry sink: events, counters, gauges, metrics, spans
(counterpart of ``esr_tpu/obs/sink.py``; the same records, field order and
``SCHEMA_VERSION``, so the reference's reporter reads the port's files).

- **host-side only**, stdlib-only at import; ``torch`` is read only inside
  :func:`run_manifest`, and only if the caller already imported it;
- **monotonic clock**: every record carries ``t``, seconds since the sink
  opened (``time.monotonic``); wall-clock time appears only in the
  manifest (``ts``);
- **never raises into the hot loop**: an I/O failure drops the record and
  counts it (``sink.dropped``);
- **stable key order**: ``t`` / ``type`` / ``name`` first, the payload keys
  sorted;
- every record is flushed when written, so a killed process leaves at most
  one torn last line.

The manifest names the framework where the reference's names JAX:
``torch_version``, ``cuda_version`` and, once CUDA is initialized in the
process, the card (``torch.cuda.get_device_name``), ``platform: "gpu"`` and
the device count.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import logging
import os
import socket
import sys
import threading
import time
from typing import Callable, Dict, Optional, Tuple

# module-level, not per-record: trace.py imports the sink lazily (inside
# SpanHandle.end), so there is no cycle; _trace_fields runs on every write
from esr_tpu_torch.obs.trace import current as _trace_current

logger = logging.getLogger(__name__)

# v2: span records may carry trace context (trace_id / span_id /
# parent_id), begin/end on the sink's clock and a host thread name;
# events/counters/gauges may carry trace_id/parent_id
SCHEMA_VERSION = 2


def config_fingerprint(config: Dict) -> str:
    """Stable 16-hex digest of an effective run config (order-insensitive:
    canonical JSON with sorted keys; non-JSON leaves stringified)."""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _framework_info() -> Dict:
    """torch and CUDA versions, and the card once CUDA is initialized in
    this process (nulls before: the manifest never initializes CUDA)."""
    info: Dict = {"torch_version": None, "cuda_version": None,
                  "device_kind": None, "platform": None, "device_count": None}
    torch = sys.modules.get("torch")
    if torch is None:
        return info
    info["torch_version"] = torch.__version__
    info["cuda_version"] = torch.version.cuda
    if torch.cuda.is_initialized():
        info["device_kind"] = torch.cuda.get_device_name(0)
        info["platform"] = "gpu"
        info["device_count"] = torch.cuda.device_count()
    return info


_STATIC_MANIFEST: Optional[Dict] = None


def run_manifest(config_fingerprint: Optional[str] = None) -> Dict:
    """The per-run environment manifest: host, pid, python, torch and CUDA
    versions, the card (once CUDA is initialized), optional config
    fingerprint. Static fields are computed once per process; the framework
    fields are probed on each call."""
    global _STATIC_MANIFEST
    if _STATIC_MANIFEST is None:
        import platform

        _STATIC_MANIFEST = {
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "python": platform.python_version(),
        }
    man = dict(_STATIC_MANIFEST)
    man.update(_framework_info())
    if config_fingerprint is not None:
        man["config_fingerprint"] = config_fingerprint
    return man


class TelemetrySink:
    """Append-only JSONL event/metric sink with a manifest header record.

    Thread-safe (several threads may write one sink); every record is
    flushed the moment it exists.
    """

    def __init__(self, path: str, manifest: Optional[Dict] = None):
        self.path = path
        # `t` and the span edges (raw time.monotonic values, obs/trace.py,
        # mapped by rel()) share this zero
        self._t0 = time.monotonic()
        self._lock = threading.RLock()
        self._counts: Dict[str, float] = {}
        self.dropped = 0
        # record observers (the live plane):
        # each is called with every record dict right after it is built —
        # the LiveAggregator's tap. Copy-on-write tuple so the hot write
        # path iterates without taking the lock; observer exceptions are
        # counted + warned once, never raised into the emitting loop.
        self._observers: Tuple[Callable[[Dict], None], ...] = ()
        self.observer_errors = 0
        self._observer_warned = False
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")
        man = dict(manifest) if manifest is not None else run_manifest()
        man["schema_version"] = SCHEMA_VERSION
        man["ts"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        self._write("manifest", "run", man)
        # crash-safe teardown: every record is already flushed on write, so
        # a SIGKILL leaves at worst one torn final line (tolerated by the
        # v1/v2 reader); atexit covers the softer exits — an interpreter
        # shutting down with the sink still open closes the file cleanly
        # instead of relying on GC order.
        self._atexit = self.close
        atexit.register(self._atexit)

    # -- record plumbing ---------------------------------------------------

    def _write(self, type_: str, name: str, fields: Dict, sort: bool = True):
        rec = {
            "t": round(time.monotonic() - self._t0, 6),
            "type": type_,
            "name": name,
        }
        for k, v in (sorted(fields.items()) if sort else fields.items()):
            rec[k] = v
        try:
            line = json.dumps(rec)
        except (TypeError, ValueError):
            rec = {**{k: rec[k] for k in ("t", "type", "name")},
                   "unserializable": True}
            line = json.dumps(rec)
        written = False
        with self._lock:
            if self._f is None or self._f.closed:
                self.dropped += 1
            else:
                try:
                    # the file IS the resource the lock serializes, and
                    # flush-per-record is the crash-safety contract: one
                    # line appended to a local file and flushed is a
                    # bounded syscall, not an unbounded wait; the line is
                    # serialised before the lock is taken and the
                    # observers run after it is released, so no other lock
                    # is ever taken inside this one
                    self._f.write(line + "\n")  # esr: noqa(CX003)
                    self._f.flush()  # esr: noqa(CX003)
                    written = True
                except (OSError, ValueError):
                    self.dropped += 1
        # observers see EXACTLY the records that landed in the JSONL
        # (including the unserializable fallback) — a dropped record
        # (closed sink, full disk) must not advance the live view, or
        # live and offline rollups silently diverge
        if written:
            for observer in self._observers:
                try:
                    observer(rec)
                except Exception:  # noqa: BLE001 - live must not kill I/O
                    self.observer_errors += 1
                    if not self._observer_warned:
                        self._observer_warned = True
                        logger.warning(
                            "telemetry observer %r raised; counting "
                            "further failures silently "
                            "(sink.observer_errors)", observer,
                        )

    # -- record observers (the live plane) ---------------------------------

    def add_observer(self, fn: Callable[[Dict], None]) -> None:
        """Register ``fn`` to receive every record dict this sink writes
        (called on the emitting thread, after the record is built and
        before the file write). The live plane's tap
        (``obs.aggregate.LiveAggregator.attach``)."""
        with self._lock:
            if fn not in self._observers:
                self._observers = self._observers + (fn,)

    def remove_observer(self, fn: Callable[[Dict], None]) -> None:
        with self._lock:
            self._observers = tuple(o for o in self._observers if o != fn)

    # -- v2 trace plumbing -------------------------------------------------

    def rel(self, monotonic_t: float) -> float:
        """Map a raw ``time.monotonic()`` stamp onto this sink's ``t``
        axis (seconds since the sink opened) — the clock base for span
        ``begin``/``end`` fields (obs/trace.py)."""
        return monotonic_t - self._t0

    @staticmethod
    def _trace_fields(fields: Dict) -> Dict:
        """Attach the ambient trace context (obs/trace.py) when the caller
        did not link explicitly — this is what makes nested spans, compile
        events, and stall counters auto-join the enclosing trace without
        their call sites knowing about tracing."""
        if "trace_id" in fields:
            return fields
        ctx = _trace_current()
        if ctx is None:
            return fields
        out = dict(fields)
        out["trace_id"] = ctx.trace_id
        out.setdefault("parent_id", ctx.span_id)
        return out

    # -- record kinds ------------------------------------------------------

    def event(self, name: str, **fields) -> None:
        """A point-in-time occurrence (``compile``, ``prefetch_close``, …).
        v2: carries the emitting host thread like spans do, so the
        exporter draws instants on the track they causally belong to."""
        fields.setdefault("thread", threading.current_thread().name)
        self._write("event", name, self._trace_fields(fields))

    def counter(self, name: str, inc: float = 1, **fields) -> None:
        """A monotonically accumulating count; each record carries this
        increment and the running total."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + inc
            total = self._counts[name]
        self._write(
            "counter", name,
            self._trace_fields({"inc": inc, "total": total, **fields}),
        )

    def gauge(self, name: str, value, **fields) -> None:
        """A sampled instantaneous value (queue depth, lookahead fill)."""
        self._write("gauge", name,
                    self._trace_fields({"value": value, **fields}))

    def metric(self, name: str, value: float, step=None, **fields) -> None:
        """A training metric scalar (the MetricWriter/MetricTracker path)."""
        self._write("metric", name, {"value": float(value), "step": step,
                                     **fields})

    def numerics(self, tag: str, stats: Dict, step=None, **fields) -> None:
        """One probe tag's merged statistics (``obs.numerics.stats_fields``)
        at the trainer's cadence-gated readback."""
        self._write("numerics", tag, self._trace_fields({"step": step, **stats, **fields}))

    def attribution(self, fields: Dict) -> None:
        """A per-step wall-clock attribution record (``obs/spans.py``); the
        producer's field order is kept."""
        self._write("attribution", "super_step", fields, sort=False)

    def span(self, name: str, seconds: float, **fields) -> None:
        """A completed named duration. v2: carries the host thread name
        (one exporter track per thread) and — explicitly from obs/trace.py
        or implicitly from the ambient context — its trace linkage."""
        payload = {"seconds": round(float(seconds), 6), **fields}
        payload.setdefault("thread", threading.current_thread().name)
        self._write("span", name, self._trace_fields(payload))

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self._f is not None and not self._f.closed:
                try:
                    # a bounded local flush of at most one buffered line
                    # (every _write flushes); the lock excludes a
                    # concurrent _write during teardown and nothing else
                    # is locked inside it (see _write)
                    self._f.flush()  # esr: noqa(CX003)
                except (OSError, ValueError):
                    pass
                self._f.close()
            cb, self._atexit = getattr(self, "_atexit", None), None
        if cb is not None:
            try:
                atexit.unregister(cb)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass

    def __enter__(self) -> "TelemetrySink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# process-active sink: the one registry every instrumented component checks.
# None (the default) makes every telemetry call site a no-op — telemetry is
# strictly opt-in per process (the serving entry point activates one).

_ACTIVE: Optional[TelemetrySink] = None


def set_active_sink(sink: Optional[TelemetrySink]) -> Optional[TelemetrySink]:
    """Install ``sink`` as the process-active sink; returns the previous
    one (restore it to scope activation, e.g. in tests)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = sink
    return prev


def active_sink() -> Optional[TelemetrySink]:
    return _ACTIVE
