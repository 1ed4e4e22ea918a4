"""Span-based step-time attribution (counterpart of ``esr_tpu/obs/spans.py``):
where does a train step's wall go?

The trainer drives a :class:`StepAttribution` through its loop, and every
step gives one ``attribution`` record splitting host wall-clock into
named spans (the reference's schema; the port's "super-step" is one step):

- ``data_wait``: blocked pulling the next batch from the loader or the
  ``DevicePrefetcher``'s queue;
- ``stage_megabatch``: the host->device copy of the batch; reported as
  *overlapped* (and left out of the identity below) when the prefetcher
  staged it on its producer thread;
- ``dispatch``: the train step's Python call, which queues the forward,
  backward and optimizer kernels on the card;
- ``device_step``: from the end of the dispatch to the end of the step's
  one scalar readback (the readback waits for the card), so no host sync
  is added;
- ``metric_readback``: the host-blocked part of that readback (inside
  ``device_step``, reported apart and never counted twice);
- ``checkpoint`` / ``validate``: the cadence-gated save and validation;
- ``residual``: ``wall - accounted``.

    wall ~ data_wait + stage_megabatch(inline) + dispatch + device_step
           + checkpoint + validate + residual

Derived per record: ``samples_per_sec`` and ``goodput = device_step /
wall``. Each record also emits its ``super_step`` span tree (the root for
every step, the children at the ``train_log_step`` cadence).
:func:`instrument_dispatch` wraps the step callable so its call is the
``dispatch`` span. Stdlib only.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from esr_tpu_torch.obs import trace


class StepSpans:
    """One super-step's span bucket.

    Created by :meth:`StepAttribution.begin`, finalized when both the loop
    body closed it (wall-clock end) and the metrics readback resolved it
    (device span end); whichever happens last emits.

    Schema v2: the bucket carries a trace identity from birth
    (``span_id`` is the ``super_step`` root span, parented under the
    ambient context at :meth:`StepAttribution.begin`, the trainer's
    ``train_run`` span), and every :meth:`measure` block records its
    begin/end edges (``marks``) so emission gives nested child spans. The
    dispatch wrapper (:func:`instrument_dispatch`) adopts :attr:`ctx`
    around the step call.
    """

    __slots__ = (
        "first", "k", "t0", "t_close", "t_dispatch", "t_resolved",
        "spans", "overlapped", "readback_s", "emitted",
        "trace_id", "span_id", "parent_id", "marks",
    )

    def __init__(self, t0: float, trace_id: str, parent_id: Optional[str]):
        self.first: Optional[int] = None
        self.k: int = 0
        self.t0 = t0
        self.t_close: Optional[float] = None
        self.t_dispatch: Optional[float] = None
        self.t_resolved: Optional[float] = None
        self.spans: Dict[str, float] = {}
        self.overlapped: set = set()
        self.readback_s = 0.0
        self.emitted = False
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.span_id = trace.new_id()
        self.marks: Dict[str, List[Tuple[float, float]]] = {}

    @property
    def ctx(self) -> trace.TraceContext:
        """The context child records adopt to join this super-step."""
        return trace.TraceContext(self.trace_id, self.span_id)

    def add(self, name: str, seconds: float, overlapped: bool = False):
        self.spans[name] = self.spans.get(name, 0.0) + float(seconds)
        if overlapped:
            self.overlapped.add(name)

    def mark(self, name: str, t0: float, t1: float):
        """Record one timed block's clock edges (same clock as ``t0``)."""
        self.marks.setdefault(name, []).append((t0, t1))


class StepAttribution:
    """Per-super-step wall-clock attribution (host-side).

    Every method is a no-op-safe cheap host operation: with no open bucket
    (or no sink) instrumented call sites cost a ``None`` check, so wrapped
    steps stay usable outside the training loop (tests, bench).
    """

    def __init__(
        self,
        sink=None,
        batch_size: int = 1,
        log_step: int = 1,
        clock=time.monotonic,
    ):
        self.sink = sink
        self.batch_size = max(int(batch_size), 1)
        self.log_step = max(int(log_step), 1)
        self._clock = clock
        self.current: Optional[StepSpans] = None
        self.emitted_records = 0
        # one trace per attribution object (i.e. per train run) when no
        # ambient trace encloses the loop; under an ambient span (the
        # Trainer's `train_run`) buckets join ITS trace instead
        self._trace_id: Optional[str] = None

    # -- super-step lifecycle ---------------------------------------------

    def begin(self) -> StepSpans:
        """Open a fresh bucket at the top of a loop iteration; the bucket
        is born with a trace identity — a child of the ambient span when
        one is open (the Trainer's ``train_run``)."""
        ambient = trace.current()
        if ambient is not None:
            trace_id, parent_id = ambient.trace_id, ambient.span_id
        else:
            if self._trace_id is None:
                self._trace_id = trace.new_id()
            trace_id, parent_id = self._trace_id, None
        self.current = StepSpans(self._clock(), trace_id, parent_id)
        return self.current

    def discard(self) -> None:
        """Drop an empty bucket (source exhausted before a group arrived)."""
        self.current = None

    def current_ctx(self) -> Optional[trace.TraceContext]:
        """The open bucket's trace context, or None — THE way work done
        on a super-step's behalf (the instrumented dispatch, checkpoint
        snapshot/commit) joins its trace via ``trace.adopt``."""
        cur = self.current
        return cur.ctx if cur is not None else None

    def note(self, first: int, k: int) -> None:
        """Record which iterations this super-step covers."""
        if self.current is not None:
            self.current.first = int(first)
            self.current.k = int(k)

    def close(self) -> None:
        """Mark the wall-clock end of the loop body; detaches the bucket
        (it lives on in the pending entry until the readback resolves it).
        Idempotent."""
        cur = self.current
        if cur is None:
            return
        if cur.t_close is None:
            cur.t_close = self._clock()
        self.current = None
        self._maybe_emit(cur)

    # -- span recording ----------------------------------------------------

    @contextmanager
    def measure(self, name: str):
        """Time a block into the current bucket (nested/overlapping blocks
        each record their full duration under their own name)."""
        cur = self.current
        if cur is None:
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            t1 = self._clock()
            cur.add(name, t1 - t0)
            cur.mark(name, t0, t1)

    def add(self, name: str, seconds: float, overlapped: bool = False):
        if self.current is not None:
            self.current.add(name, seconds, overlapped=overlapped)

    def dispatched(self) -> None:
        """Timestamp the (async) dispatch of this super-step's device work."""
        if self.current is not None:
            self.current.t_dispatch = self._clock()

    @contextmanager
    def resolving(self, bucket: Optional[StepSpans]):
        """Wrap the cadence-gated scalar readback that forces the device
        sync: the block duration is the host-blocked ``metric_readback``;
        its end resolves the non-blocking ``device_step`` span."""
        if bucket is None:
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            now = self._clock()
            bucket.readback_s += now - t0
            bucket.mark("metric_readback", t0, now)
            bucket.t_resolved = now
            self._maybe_emit(bucket)

    # -- emission ----------------------------------------------------------

    def record(self, bucket: StepSpans) -> Dict:
        """The attribution record for a finalized bucket (field order is
        the reference's schema)."""
        # wall is the loop-BODY's span (t_close); under lookahead the
        # readback lands later and device work overlaps the next
        # iterations by design — t_resolved never extends the wall
        if bucket.t_close is not None:
            end = bucket.t_close
        elif bucket.t_resolved is not None:
            end = bucket.t_resolved
        else:
            end = self._clock()
        wall = max(end - bucket.t0, 1e-9)
        device = 0.0
        if bucket.t_dispatch is not None and bucket.t_resolved is not None:
            device = max(bucket.t_resolved - bucket.t_dispatch, 0.0)
        spans = bucket.spans
        accounted = device + sum(
            v for n, v in spans.items() if n not in bucket.overlapped
        )
        k = bucket.k or 1
        return {
            "first_iteration": bucket.first,
            "k": k,
            "wall_s": round(wall, 6),
            "data_wait_s": round(spans.get("data_wait", 0.0), 6),
            "stage_megabatch_s": round(spans.get("stage_megabatch", 0.0), 6),
            "stage_overlapped": "stage_megabatch" in bucket.overlapped,
            "dispatch_s": round(spans.get("dispatch", 0.0), 6),
            "device_step_s": round(device, 6),
            "metric_readback_s": round(bucket.readback_s, 6),
            "checkpoint_s": round(spans.get("checkpoint", 0.0), 6),
            "validate_s": round(spans.get("validate", 0.0), 6),
            "residual_s": round(wall - accounted, 6),
            "samples_per_sec": round(k * self.batch_size / wall, 3),
            "goodput": round(min(max(device / wall, 1e-9), 1.0), 6),
            # v2 trace linkage, trailing so the v1 column order is a
            # strict prefix: span_id IS the super_step root span below
            "trace_id": bucket.trace_id,
            "span_id": bucket.span_id,
            "parent_id": bucket.parent_id,
        }

    def _due(self, bucket: StepSpans) -> bool:
        """Emission snaps to the ``train_log_step`` cadence exactly like
        the Trainer's loss line: due when ANY covered iteration hits it."""
        if bucket.first is None:
            return False
        return any(
            (bucket.first + j) % self.log_step == 0 for j in range(bucket.k)
        )

    def _maybe_emit(self, bucket: StepSpans) -> None:
        # a bucket emits once, after BOTH wall end and readback are known:
        # lookahead=0 resolves mid-body and emits at close; lookahead>0
        # closes first and emits at the deferred readback.
        if bucket.emitted:
            return
        if bucket.t_close is None or bucket.t_resolved is None:
            return
        bucket.emitted = True
        due = self._due(bucket)
        if not due:
            # root-only emission: components that ADOPTED this bucket's
            # context (compile events inside the dispatch, checkpoint
            # snapshot/commit) reference its span_id as parent — the root
            # span must exist in the file for EVERY super-step or those
            # links dangle; the attribution record and the child span
            # tree stay behind the train_log_step cadence.
            if self.sink is not None:
                self._emit_root(bucket, self.record(bucket))
            return
        rec = self.record(bucket)
        self.emitted_records += 1
        if self.sink is not None:
            self.sink.attribution(rec)
            self._emit_trace_spans(bucket, rec)

    def _edge_conv(self):
        """Clock edges translate onto the sink's ``t`` axis only when
        this object runs on the real monotonic clock (the production
        configuration); under an injected test clock spans carry
        durations only — same contract as v1 spans."""
        return self.sink.rel if self._clock is time.monotonic else None

    def _emit_root(self, bucket: StepSpans, rec: Dict) -> None:
        conv = self._edge_conv()
        end = bucket.t_close if bucket.t_close is not None else bucket.t0
        edges = ({} if conv is None else
                 {"begin": round(conv(bucket.t0), 6),
                  "end": round(conv(end), 6)})
        self.sink.span(
            "super_step", max(end - bucket.t0, 0.0),
            trace_id=bucket.trace_id, span_id=bucket.span_id,
            parent_id=bucket.parent_id,
            first_iteration=bucket.first, k=bucket.k or 1,
            goodput=rec["goodput"],
            **edges,
        )

    def _emit_trace_spans(self, bucket: StepSpans, rec: Dict) -> None:
        """The bucket as a span tree: one ``super_step`` root plus one
        child per named attribution block (schema v2).

        Children are emitted at the same ``train_log_step`` cadence as
        the attribution record, so trace volume scales with the logging
        budget, not the step count (the root alone is emitted for every
        super-step — see :meth:`_maybe_emit`).
        """
        sink = self.sink
        conv = self._edge_conv()

        def _edges(t0, t1):
            if conv is None or t0 is None or t1 is None:
                return {}
            return {"begin": round(conv(t0), 6), "end": round(conv(t1), 6)}

        self._emit_root(bucket, rec)
        for name, edges in bucket.marks.items():
            over = {"overlapped": True} if name in bucket.overlapped else {}
            for t0, t1 in edges:
                sink.span(
                    name, t1 - t0,
                    trace_id=bucket.trace_id, span_id=trace.new_id(),
                    parent_id=bucket.span_id,
                    **over, **_edges(t0, t1),
                )
        # buckets recorded via add() only (the prefetcher's producer-thread
        # staging parks a duration, no edges) still surface as children
        for name in bucket.spans:
            if name in bucket.marks:
                continue
            over = {"overlapped": True} if name in bucket.overlapped else {}
            sink.span(
                name, bucket.spans[name],
                trace_id=bucket.trace_id, span_id=trace.new_id(),
                parent_id=bucket.span_id, **over,
            )
        if bucket.t_dispatch is not None and bucket.t_resolved is not None:
            sink.span(
                "device_step",
                max(bucket.t_resolved - bucket.t_dispatch, 0.0),
                trace_id=bucket.trace_id, span_id=trace.new_id(),
                parent_id=bucket.span_id,
                **_edges(bucket.t_dispatch, bucket.t_resolved),
            )


class _InstrumentedStep:
    """A step callable whose calls are the open bucket's ``dispatch`` span
    (run under the bucket's trace context), stamping the start of its
    ``device_step``. With no open bucket it is a plain pass-through."""

    def __init__(self, step, attribution: StepAttribution):
        self._step = step
        self._attribution = attribution

    def __call__(self, *args, **kwargs):
        attribution = self._attribution
        with trace.adopt(attribution.current_ctx()):
            with attribution.measure("dispatch"):
                out = self._step(*args, **kwargs)
            attribution.dispatched()
        return out

    def __getattr__(self, name):
        return getattr(self._step, name)


def instrument_dispatch(step, attribution: StepAttribution):
    """Wrap ``step`` so each call records its ``dispatch`` span and the
    dispatch timestamp into ``attribution``."""
    return _InstrumentedStep(step, attribution)
