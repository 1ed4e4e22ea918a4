"""In-process live rollups over the telemetry record stream (counterpart
of ``esr_tpu/obs/aggregate.py``: ``QuantileSketch``, ``LiveAggregator`` and
the ``/snapshot`` wire format).

:class:`LiveAggregator` registers as a record observer on a
:class:`~esr_tpu_torch.obs.sink.TelemetrySink` (``sink.add_observer``: the
tap fires once per record written, so the live and JSONL views are one
stream) and keeps:

- **counters** (running totals from ``inc``), **gauges** (last value);
- **span sketches**: one mergeable log-bucketed quantile sketch
  (:class:`QuantileSketch`, DDSketch-style, fixed relative error) per span
  name, and per request class a window-latency sketch weighted by
  ``windows``, the reporter's expansion;
- **goodput / serving / traces / faults**: the report-shaped aggregates
  ``configs/slo*.yml`` dot into.

:meth:`LiveAggregator.snapshot` returns the reporter's dotted namespace, so
``obs.report.evaluate_slo`` gates a live snapshot with the YAML it gates a
finished file. Records also land in a ring of ``epoch_s``-second epoch
states; since sketches merge exactly (merge == concat), a trailing window
is the merge of the epochs that overlap it.

**The wire format.** :meth:`LiveAggregator.snapshot_wire` emits a
versioned, JSON-safe document carrying the merged accumulation state itself
(sketch buckets, counters, gauges, numerics table); :func:`parse_snapshot_wire`
parses it back, and a parsed state merges bucket for bucket like the
original. A version mismatch or a torn document raises ``ValueError``,
never merges. The documents are the reference's, key for key, so either
package parses the other's.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, Iterable, Optional

# the reporter's conventions, shared: live snapshot values match offline
# report values to formatting, and the router-level status taxonomy
# (continued / rootless terminals) classifies identically live and offline
from esr_tpu_torch.obs import numerics as _numerics
from esr_tpu_torch.obs.report import (
    _CONTINUED_STATUSES,
    _ROOTLESS_STATUSES,
    _round,
)

__all__ = [
    "QuantileSketch",
    "LiveAggregator",
    "SNAPSHOT_WIRE_VERSION",
    "state_to_wire",
    "state_from_wire",
    "render_state",
    "parse_snapshot_wire",
]

# the snapshot wire schema: bumped on any change to the state
# document shape; a parser seeing an unknown version must refuse to
# merge (a silently-misparsed remote snapshot would corrupt the fleet
# rollup without any visible failure)
SNAPSHOT_WIRE_VERSION = 1


class QuantileSketch:
    """Mergeable log-bucketed quantile sketch (DDSketch-style).

    Values are counted in geometric buckets ``(gamma^(k-1), gamma^k]``
    with ``gamma = (1 + rel_err) / (1 - rel_err)``; every bucket's
    representative value ``2 * gamma^k / (gamma + 1)`` is within
    ``rel_err`` (relative) of every value the bucket holds, so any
    rank-based estimate is within ``rel_err`` of the true order statistic.
    Non-positive / sub-``min_value`` inputs land in an exact ``zeros``
    bucket (span seconds are non-negative; exact zeros stay exact).

    Mergeable by construction: two sketches with the same ``rel_err`` add
    bucket-wise, and ``merge(a, b)`` is indistinguishable from a sketch
    that ingested both input streams (the windowed-rollup property the
    live plane is built on). Inserts take an optional integer ``weight``
    so the per-class window-latency expansion (``[seconds] * windows`` in
    the offline reporter) costs one bucket update, not ``windows``.
    """

    __slots__ = ("rel_err", "_gamma", "_lg", "_min_value", "_buckets",
                 "zeros", "count", "sum", "min", "max")

    def __init__(self, rel_err: float = 0.01, min_value: float = 1e-9):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = float(rel_err)
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._lg = math.log(self._gamma)
        self._min_value = float(min_value)
        self._buckets: Dict[int, int] = {}
        self.zeros = 0
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def insert(self, value: float, weight: int = 1) -> None:
        v = float(value)
        w = int(weight)
        if w <= 0:
            return
        self.count += w
        self.sum += v * w
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v <= self._min_value:
            self.zeros += w
            return
        key = math.ceil(math.log(v) / self._lg)
        self._buckets[key] = self._buckets.get(key, 0) + w

    def merge(self, other: "QuantileSketch") -> None:
        if abs(other.rel_err - self.rel_err) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with rel_err {self.rel_err} != "
                f"{other.rel_err}"
            )
        for key, n in other._buckets.items():
            self._buckets[key] = self._buckets.get(key, 0) + n
        self.zeros += other.zeros
        self.count += other.count
        self.sum += other.sum
        for attr, pick in (("min", min), ("max", max)):
            mine, theirs = getattr(self, attr), getattr(other, attr)
            if theirs is not None:
                setattr(self, attr,
                        theirs if mine is None else pick(mine, theirs))

    # -- estimation ---------------------------------------------------------

    def _bucket_value(self, key: int) -> float:
        v = 2.0 * math.exp(key * self._lg) / (self._gamma + 1.0)
        # exact extremes tighten the estimate for the edge buckets without
        # ever violating the relative-error bound
        if self.max is not None:
            v = min(v, self.max)
        if self.min is not None:
            v = max(v, self.min)
        return v

    def _value_at(self, index: int) -> float:
        """The estimated value of the ``index``-th (0-based) element of
        the sorted inserted multiset."""
        if index < self.zeros:
            return 0.0
        remaining = index - self.zeros
        for key in sorted(self._buckets):
            remaining -= self._buckets[key]
            if remaining < 0:
                return self._bucket_value(key)
        return self.max if self.max is not None else 0.0

    def quantile(self, q: float) -> Optional[float]:
        """The ``q``-th percentile (0..100), linearly interpolated between
        order statistics — the same convention as
        :func:`esr_tpu_torch.obs.report.percentile`, so live and offline agree
        within ``rel_err`` on identical data."""
        if self.count == 0:
            return None
        rank = (q / 100.0) * (self.count - 1)
        lo = int(math.floor(rank))
        hi = int(math.ceil(rank))
        v_lo = self._value_at(lo)
        if lo == hi:
            return v_lo
        v_hi = self._value_at(hi)
        frac = rank - lo
        return v_lo * (1.0 - frac) + v_hi * frac

    # -- wire ---------------------------------------------------------------

    def to_wire(self) -> Dict:
        """JSON-safe serialization. Bucket keys become strings (JSON
        objects cannot key on ints); counts and the running sum are
        carried exactly (ints exactly, floats via repr), so
        ``from_wire(to_wire(sk))`` merges bucket-for-bucket identically
        to ``sk`` — the round-trip half of the rel_err guarantee."""
        return {
            "rel_err": self.rel_err,
            "min_value": self._min_value,
            "buckets": {str(k): n for k, n in self._buckets.items()},
            "zeros": self.zeros,
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
        }

    @classmethod
    def from_wire(cls, doc: Dict) -> "QuantileSketch":
        sk = cls(rel_err=float(doc["rel_err"]),
                 min_value=float(doc["min_value"]))
        sk._buckets = {int(k): int(n) for k, n in doc["buckets"].items()}
        sk.zeros = int(doc["zeros"])
        sk.count = int(doc["count"])
        sk.sum = float(doc["sum"])
        sk.min = None if doc["min"] is None else float(doc["min"])
        sk.max = None if doc["max"] is None else float(doc["max"])
        return sk


class _State:
    """One accumulation scope: the cumulative rollup, or one epoch of the
    window ring. All updates are O(1) dict/scalar ops under the
    aggregator's single lock."""

    __slots__ = (
        "records", "counters", "gauges", "events", "spans", "class_lat",
        "class_windows", "chunk_busy", "chunk_begin", "chunk_end",
        "chunk_kinds", "attr_records", "attr_wall", "attr_wall_x_goodput",
        "requests", "completed_requests", "failed_requests", "statuses",
        "windows_total", "chunk_windows_valid", "windows_skipped",
        "trace_requests", "trace_complete",
        "faults_injected", "recovery_events", "numerics",
    )

    def __init__(self, rel_err: float):
        self.records = 0
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, object] = {}
        self.events: Dict[str, int] = {}
        self.spans: Dict[str, QuantileSketch] = {}
        self.class_lat: Dict[str, QuantileSketch] = {}
        self.class_windows: Dict[str, int] = {}
        self.chunk_busy = 0.0
        self.chunk_begin: Optional[float] = None
        self.chunk_end: Optional[float] = None
        self.chunk_kinds: set = set()
        self.attr_records = 0
        self.attr_wall = 0.0
        self.attr_wall_x_goodput = 0.0
        self.requests = 0
        self.completed_requests = 0
        self.failed_requests = 0
        self.statuses: Dict[str, int] = {}
        self.windows_total = 0
        self.chunk_windows_valid = 0
        self.windows_skipped = 0
        self.trace_requests = 0
        self.trace_complete = 0
        self.faults_injected = 0
        self.recovery_events = 0
        # the numerics plane's per-tag worst-case table (obs/numerics.py
        # ingest/merge_states/rollup — shared with the offline reporter)
        self.numerics: Dict[str, Dict] = {}

    def sketch_for(self, table: Dict[str, QuantileSketch], name: str,
                   rel_err: float) -> QuantileSketch:
        sk = table.get(name)
        if sk is None:
            sk = table[name] = QuantileSketch(rel_err)
        return sk


class LiveAggregator:
    """Streaming rollups + mergeable sketches over the sink record tap
    (module docstring). Attach with :meth:`attach`; every record the sink
    writes is observed exactly once, on the emitting thread, under one
    short lock."""

    def __init__(self, rel_err: float = 0.01, epoch_s: float = 5.0,
                 max_epochs: int = 256, max_roots: int = 8192):
        if epoch_s <= 0:
            raise ValueError(f"epoch_s must be > 0, got {epoch_s}")
        if max_epochs < 2:
            raise ValueError(f"max_epochs must be >= 2, got {max_epochs}")
        self.rel_err = float(rel_err)
        self.epoch_s = float(epoch_s)
        self.max_epochs = int(max_epochs)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        # Each record updates EXACTLY ONE state — the current epoch (the
        # hot path stays a single pass of O(1) ops). Epochs evicted from
        # the ring merge into the archive; a cumulative snapshot is
        # archive + ring, merged at poll time (rare) instead of per
        # record (hot). Mergeable sketches are what make this exact.
        self._archive = _State(self.rel_err)
        self._epochs: deque = deque()  # (epoch_index, _State), bounded below
        # recent trace roots, FIFO-bounded (insertion-ordered dict): the
        # serving tier emits a request's root span immediately before its
        # terminal event, so a window of the newest max_roots root ids is
        # all the live completeness check ever needs — an unbounded set
        # would leak one entry per request forever, the exact memory
        # hazard of a live aggregator
        self._roots: Dict[str, None] = {}
        self.max_roots = int(max_roots)
        self.observer_errors = 0

    # -- registration --------------------------------------------------------

    def attach(self, sink) -> "LiveAggregator":
        sink.add_observer(self.observe)
        return self

    def detach(self, sink) -> None:
        sink.remove_observer(self.observe)

    # -- ingestion -----------------------------------------------------------

    def _epoch_state(self, now: float) -> _State:
        idx = int((now - self._t0) / self.epoch_s)
        if not self._epochs or self._epochs[-1][0] != idx:
            self._epochs.append((idx, _State(self.rel_err)))
            while len(self._epochs) > self.max_epochs:
                _, old = self._epochs.popleft()
                _merge_state(self._archive, old)
        return self._epochs[-1][1]

    def observe(self, rec: Dict) -> None:
        """The sink tap: one normalized record dict, exactly as written
        to the JSONL (obs/sink.py ``_write``). Never raises into the hot
        loop — the sink wraps observer dispatch."""
        kind = rec.get("type")
        if kind == "manifest":
            return
        name = rec.get("name", "")
        now = time.monotonic()
        with self._lock:
            st = self._epoch_state(now)
            st.records += 1
            if kind == "counter":
                inc = rec.get("inc", 1)
                try:
                    inc = float(inc)
                except (TypeError, ValueError):
                    inc = 1.0
                st.counters[name] = st.counters.get(name, 0.0) + inc
            elif kind == "gauge":
                st.gauges[name] = rec.get("value")
            elif kind == "span":
                if rec.get("parent_id") is None and rec.get("span_id"):
                    self._roots[rec["span_id"]] = None
                    while len(self._roots) > self.max_roots:
                        self._roots.pop(next(iter(self._roots)))
                self._observe_span(st, name, rec)
            elif kind == "event":
                self._observe_event(st, name, rec)
            elif kind == "numerics":
                _numerics.ingest(st.numerics, rec)
            elif kind == "attribution":
                wall = float(rec.get("wall_s", 0.0) or 0.0)
                good = float(rec.get("goodput", 0.0) or 0.0)
                st.attr_records += 1
                st.attr_wall += wall
                st.attr_wall_x_goodput += wall * good

    def _observe_span(self, st: _State, name: str, rec: Dict) -> None:
        seconds = float(rec.get("seconds", 0.0) or 0.0)
        st.sketch_for(st.spans, name, self.rel_err).insert(seconds)
        if name == "serve_chunk_part":
            cls = rec.get("cls", "default")
            n = int(rec.get("windows", 0) or 0)
            if n > 0:
                st.sketch_for(st.class_lat, cls, self.rel_err).insert(
                    seconds, weight=n
                )
                st.class_windows[cls] = st.class_windows.get(cls, 0) + n
        elif name in ("serve_chunk", "infer_chunk"):
            st.chunk_busy += seconds
            begin, end = rec.get("begin"), rec.get("end")
            if begin is None or end is None:
                end = float(rec.get("t", 0.0))
                begin = end - seconds
            begin, end = float(begin), float(end)
            st.chunk_begin = (begin if st.chunk_begin is None
                              else min(st.chunk_begin, begin))
            st.chunk_end = (end if st.chunk_end is None
                            else max(st.chunk_end, end))
            st.chunk_kinds.add(name)
            # activity gating: mirror the offline reporter's
            # computed-vs-skipped tally (serve_chunk ONLY — infer_chunk
            # windows are not serving compute) so
            # serving.active_window_frac evaluates identically live
            # and offline
            if name == "serve_chunk":
                st.chunk_windows_valid += int(rec.get("windows", 0) or 0)
                st.windows_skipped += int(
                    rec.get("skipped_windows", 0) or 0
                )

    def _observe_event(self, st: _State, name: str, rec: Dict) -> None:
        st.events[name] = st.events.get(name, 0) + 1
        if name == "serve_gating_flush":
            # trailing gated windows with no chunk span to ride
            # (serving/server.py drain path) — keep live == offline
            st.windows_skipped += int(rec.get("skipped", 0) or 0)
        if name == "fault_injected":
            st.faults_injected += 1
        elif name.startswith("recovery_"):
            st.recovery_events += 1
        elif name == "serve_request_done":
            status = rec.get("status") or (
                "ok" if rec.get("completed", False) else "bad_stream"
            )
            st.statuses[status] = st.statuses.get(status, 0) + 1
            # the reporter's status taxonomy, shared:
            # rootless terminals (shed, replica_lost, retry-exhausted —
            # the emitting replica never ran the request root) are skipped
            # by trace completeness, and continued terminals (shed,
            # migrated, replica_lost — the request lives on elsewhere)
            # never count toward request/window totals. This is what lets
            # router-level ledger records join a merge without a migrated
            # stream reading as a failed request.
            if status not in _ROOTLESS_STATUSES:
                # live completeness: the root span (serve_request) is
                # emitted immediately before the terminal event, so
                # parent-of-done resolving to a seen root is the live
                # analogue of the reporter's parent-chain walk
                st.trace_requests += 1
                if rec.get("parent_id") in self._roots:
                    st.trace_complete += 1
            if status in _CONTINUED_STATUSES:
                return
            st.requests += 1
            st.windows_total += int(rec.get("windows", 0) or 0)
            if rec.get("completed", False):
                st.completed_requests += 1
            else:
                st.failed_requests += 1

    # -- snapshots -----------------------------------------------------------

    def _merged_state(self, window_s: Optional[float], now: float) -> _State:
        """Archive + ring for the cumulative view; ring-only for a
        window. A window may reach at most ``epoch_s * max_epochs``
        seconds back (default ~21 min — far beyond the burn-rate pair);
        older epochs live only in the archive."""
        merged = _State(self.rel_err)
        if window_s is None:
            _merge_state(merged, self._archive)
            for _idx, st in self._epochs:
                _merge_state(merged, st)
            return merged
        cutoff_idx = int((now - self._t0 - window_s) / self.epoch_s)
        for idx, st in self._epochs:
            # include every epoch overlapping the window (coarse on
            # purpose: epoch_s granularity, documented)
            if idx >= cutoff_idx:
                _merge_state(merged, st)
        return merged

    def snapshot(self, window_s: Optional[float] = None) -> Dict:
        """The report-shaped live rollup (the offline reporter's dotted
        namespace — ``goodput.value``, ``spans.<name>.p99_ms``,
        ``serving.classes.<cls>.window_latency_p99_ms``,
        ``counters.<name>``, ``traces.incomplete`` — so configs/slo.yml
        evaluates unchanged). ``window_s`` restricts to the trailing
        window; either way the result is an epoch MERGE built at poll
        time, so the record hot path only ever touches one epoch state."""
        now = time.monotonic()
        with self._lock:
            st = self._merged_state(
                None if window_s is None else float(window_s), now
            )
            return self._render(st, window_s, now)

    def merged_state(self, window_s: Optional[float] = None) -> "_State":
        """The merged accumulation state itself (cumulative, or the
        trailing window) — a fresh :class:`_State` the caller owns. This
        is the in-process twin of parsing a ``/snapshot`` wire document:
        fleet-level consumers merge these instead of re-rendering."""
        now = time.monotonic()
        with self._lock:
            return self._merged_state(
                None if window_s is None else float(window_s), now
            )

    def snapshot_wire(self, windows: Iterable[float] = ()) -> Dict:
        """The versioned wire document (module docstring): the cumulative
        accumulation state plus one state per requested trailing window,
        serialized with :func:`state_to_wire`. One call, one lock pass —
        this is the single fetch the fleet plane lives on."""
        now = time.monotonic()
        with self._lock:
            return {
                "version": SNAPSHOT_WIRE_VERSION,
                "rel_err": self.rel_err,
                "uptime_s": round(now - self._t0, 3),
                "state": state_to_wire(self._merged_state(None, now)),
                "window_states": {
                    str(float(w)): state_to_wire(
                        self._merged_state(float(w), now)
                    )
                    for w in windows
                },
            }

    def _render(self, st: _State, window_s, now: float) -> Dict:
        return render_state(st, window_s=window_s,
                            uptime_s=round(now - self._t0, 3),
                            rel_err=self.rel_err)


def render_state(st: "_State", window_s: Optional[float] = None,
                 uptime_s: Optional[float] = None,
                 rel_err: float = 0.01) -> Dict:
    """Render one accumulation state into the report-shaped dotted
    namespace (:meth:`LiveAggregator.snapshot`'s body, shared so the
    fleet plane renders MERGED states through the exact same code path —
    ``configs/slo*.yml`` cannot tell a fleet snapshot from a replica
    one)."""
    goodput: Dict = {"value": None, "source": None}
    if st.attr_records and st.attr_wall > 0:
        goodput = {
            "value": round(st.attr_wall_x_goodput / st.attr_wall, 6),
            "source": "attribution",
            "records": st.attr_records,
        }
    elif st.chunk_begin is not None:
        wall = max((st.chunk_end or 0.0) - st.chunk_begin, 1e-9)
        goodput = {
            "value": round(min(st.chunk_busy / wall, 1.0), 6),
            "source": ("serving" if "serve_chunk" in st.chunk_kinds
                       else "inference"),
            "busy_s": round(st.chunk_busy, 6),
            "wall_s": round(wall, 6),
        }
    spans_out = {
        name: {
            "count": sk.count,
            "total_s": round(sk.sum, 6),
            "p50_ms": _round(sk.quantile(50), 1e3),
            "p99_ms": _round(sk.quantile(99), 1e3),
            "max_ms": _round(sk.max, 1e3),
        }
        for name, sk in sorted(st.spans.items())
    }
    serving = {
        "requests": st.requests,
        "completed": st.completed_requests,
        "errors": st.failed_requests,
        "statuses": {k: st.statuses[k] for k in sorted(st.statuses)},
        "windows": st.windows_total,
        "windows_skipped": st.windows_skipped,
        "active_window_frac": (
            round(st.chunk_windows_valid
                  / (st.chunk_windows_valid + st.windows_skipped), 6)
            if (st.chunk_windows_valid + st.windows_skipped) else None
        ),
        "preemptions": st.events.get("serve_preempt", 0),
        "backpressure": st.counters.get("serve_backpressure", 0.0),
        "classes": {
            cls: {
                "windows": st.class_windows.get(cls, 0),
                "window_latency_p50_ms": _round(sk.quantile(50), 1e3),
                "window_latency_p99_ms": _round(sk.quantile(99), 1e3),
            }
            for cls, sk in sorted(st.class_lat.items())
        },
    }
    return {
        "live": True,
        "window_s": window_s,
        "uptime_s": uptime_s,
        "records": st.records,
        "sketch_rel_err": rel_err,
        "goodput": goodput,
        "spans": spans_out,
        "counters": {k: st.counters[k] for k in sorted(st.counters)},
        "gauges": {k: st.gauges[k] for k in sorted(st.gauges)},
        "events": {k: st.events[k] for k in sorted(st.events)},
        "serving": serving,
        "traces": {
            "requests": st.trace_requests,
            "complete": st.trace_complete,
            "incomplete": st.trace_requests - st.trace_complete,
        },
        "faults": {
            "injected": st.faults_injected,
            "recovery_events": st.recovery_events,
        },
        "numerics": _numerics.rollup(st.numerics),
    }


def _merge_state(dst: _State, src: _State) -> None:
    dst.records += src.records
    for k, v in src.counters.items():
        dst.counters[k] = dst.counters.get(k, 0.0) + v
    dst.gauges.update(src.gauges)  # ring order == time order: last wins
    for k, v in src.events.items():
        dst.events[k] = dst.events.get(k, 0) + v
    for table_name in ("spans", "class_lat"):
        dst_t = getattr(dst, table_name)
        for k, sk in getattr(src, table_name).items():
            mine = dst_t.get(k)
            if mine is None:
                mine = dst_t[k] = QuantileSketch(sk.rel_err)
            mine.merge(sk)
    for k, v in src.class_windows.items():
        dst.class_windows[k] = dst.class_windows.get(k, 0) + v
    dst.chunk_busy += src.chunk_busy
    if src.chunk_begin is not None:
        dst.chunk_begin = (src.chunk_begin if dst.chunk_begin is None
                           else min(dst.chunk_begin, src.chunk_begin))
    if src.chunk_end is not None:
        dst.chunk_end = (src.chunk_end if dst.chunk_end is None
                         else max(dst.chunk_end, src.chunk_end))
    dst.chunk_kinds |= src.chunk_kinds
    dst.attr_records += src.attr_records
    dst.attr_wall += src.attr_wall
    dst.attr_wall_x_goodput += src.attr_wall_x_goodput
    dst.requests += src.requests
    dst.completed_requests += src.completed_requests
    dst.failed_requests += src.failed_requests
    for k, v in src.statuses.items():
        dst.statuses[k] = dst.statuses.get(k, 0) + v
    dst.windows_total += src.windows_total
    dst.chunk_windows_valid += src.chunk_windows_valid
    dst.windows_skipped += src.windows_skipped
    dst.trace_requests += src.trace_requests
    dst.trace_complete += src.trace_complete
    dst.faults_injected += src.faults_injected
    dst.recovery_events += src.recovery_events
    _numerics.merge_states(dst.numerics, src.numerics)


# ---------------------------------------------------------------------------
# the snapshot wire format: every _State slot, JSON-safe


def state_to_wire(st: _State) -> Dict:
    """Serialize one accumulation state — every ``_State`` slot, sketches
    via :meth:`QuantileSketch.to_wire`, ``chunk_kinds`` as a sorted list,
    the numerics table verbatim (it is already JSON-scalar rows)."""
    return {
        "records": st.records,
        "counters": dict(st.counters),
        "gauges": dict(st.gauges),
        "events": dict(st.events),
        "spans": {k: sk.to_wire() for k, sk in st.spans.items()},
        "class_lat": {k: sk.to_wire() for k, sk in st.class_lat.items()},
        "class_windows": dict(st.class_windows),
        "chunk_busy": st.chunk_busy,
        "chunk_begin": st.chunk_begin,
        "chunk_end": st.chunk_end,
        "chunk_kinds": sorted(st.chunk_kinds),
        "attr_records": st.attr_records,
        "attr_wall": st.attr_wall,
        "attr_wall_x_goodput": st.attr_wall_x_goodput,
        "requests": st.requests,
        "completed_requests": st.completed_requests,
        "failed_requests": st.failed_requests,
        "statuses": dict(st.statuses),
        "windows_total": st.windows_total,
        "chunk_windows_valid": st.chunk_windows_valid,
        "windows_skipped": st.windows_skipped,
        "trace_requests": st.trace_requests,
        "trace_complete": st.trace_complete,
        "faults_injected": st.faults_injected,
        "recovery_events": st.recovery_events,
        "numerics": {tag: dict(row) for tag, row in st.numerics.items()},
    }


def state_from_wire(doc: Dict) -> _State:
    """Rebuild a :class:`_State` from :func:`state_to_wire` output. The
    round-trip is exact (ints exactly; floats survive JSON via repr), so
    merging a parsed state is indistinguishable from merging the
    original."""
    st = _State(0.01)  # per-sketch rel_err rides each sketch's own wire
    st.records = int(doc["records"])
    st.counters = {str(k): float(v) for k, v in doc["counters"].items()}
    st.gauges = dict(doc["gauges"])
    st.events = {str(k): int(v) for k, v in doc["events"].items()}
    st.spans = {
        str(k): QuantileSketch.from_wire(v) for k, v in doc["spans"].items()
    }
    st.class_lat = {
        str(k): QuantileSketch.from_wire(v)
        for k, v in doc["class_lat"].items()
    }
    st.class_windows = {
        str(k): int(v) for k, v in doc["class_windows"].items()
    }
    st.chunk_busy = float(doc["chunk_busy"])
    st.chunk_begin = (None if doc["chunk_begin"] is None
                      else float(doc["chunk_begin"]))
    st.chunk_end = (None if doc["chunk_end"] is None
                    else float(doc["chunk_end"]))
    st.chunk_kinds = set(doc["chunk_kinds"])
    st.attr_records = int(doc["attr_records"])
    st.attr_wall = float(doc["attr_wall"])
    st.attr_wall_x_goodput = float(doc["attr_wall_x_goodput"])
    st.requests = int(doc["requests"])
    st.completed_requests = int(doc["completed_requests"])
    st.failed_requests = int(doc["failed_requests"])
    st.statuses = {str(k): int(v) for k, v in doc["statuses"].items()}
    st.windows_total = int(doc["windows_total"])
    st.chunk_windows_valid = int(doc["chunk_windows_valid"])
    st.windows_skipped = int(doc["windows_skipped"])
    st.trace_requests = int(doc["trace_requests"])
    st.trace_complete = int(doc["trace_complete"])
    st.faults_injected = int(doc["faults_injected"])
    st.recovery_events = int(doc["recovery_events"])
    st.numerics = {
        str(tag): dict(row) for tag, row in doc["numerics"].items()
    }
    return st


def parse_snapshot_wire(doc: Dict) -> Dict:
    """Parse one ``/snapshot`` wire document back into accumulation
    state: ``{"version", "rel_err", "uptime_s", "state": _State,
    "windows": {window_s: _State}}`` plus the live-plane context keys
    (``replica``, ``health``, ``slo_verdict``) passed through untouched.

    Raises :class:`ValueError` LOUDLY on a version mismatch or a torn
    document — an unparseable snapshot must never be merged into a fleet
    rollup (the caller marks the replica unhealthy instead)."""
    if not isinstance(doc, dict):
        raise ValueError(
            f"snapshot wire document must be a dict, got "
            f"{type(doc).__name__}"
        )
    version = doc.get("version")
    if version != SNAPSHOT_WIRE_VERSION:
        raise ValueError(
            f"snapshot wire version {version!r} is not the supported "
            f"{SNAPSHOT_WIRE_VERSION} — refusing to merge"
        )
    try:
        parsed: Dict = {
            "version": int(version),
            "rel_err": float(doc["rel_err"]),
            "uptime_s": float(doc.get("uptime_s", 0.0)),
            "state": state_from_wire(doc["state"]),
            "windows": {
                float(k): state_from_wire(v)
                for k, v in (doc.get("window_states") or {}).items()
            },
        }
    except (KeyError, TypeError, ValueError, AttributeError) as exc:
        raise ValueError(f"torn snapshot wire document: {exc!r}") from exc
    for key in ("replica", "health", "slo_verdict"):
        if key in doc:
            parsed[key] = doc[key]
    return parsed
