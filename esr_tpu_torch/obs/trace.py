"""Ambient trace context: every span gets an identity and a family tree
(counterpart of ``esr_tpu/obs/trace.py``; schema v2 of the telemetry).

- spans carry ``trace_id`` / ``span_id`` / ``parent_id`` (16 hex digits
  from ``os.urandom``) and ``begin`` / ``end`` on the sink's clock
  (:meth:`esr_tpu_torch.obs.sink.TelemetrySink.rel`);
- the current ``(trace_id, span_id)`` rides a ``contextvars.ContextVar``:
  opening a span points the ambient context at it, so every record emitted
  inside (a nested span, an event, a counter) parents under it without its
  call site knowing (``sink._trace_fields``);
- context does not flow into threads on its own: a component that hands
  work to a thread captures the submitter's context (:func:`capture`) and
  the worker adopts it (:func:`adopt`).

``with trace.span("name", field=...):`` closes on every exit path;
``handle = trace.begin("name") ... handle.end()`` is for loops whose begin
and end live in different blocks, with ``end()`` in a ``finally``. With no
active sink every operation is cheap bookkeeping.
"""

from __future__ import annotations

import contextvars
import os
import time
from contextlib import contextmanager
from typing import NamedTuple, Optional


class TraceContext(NamedTuple):
    """The ambient position in the trace tree: records emitted under this
    context belong to ``trace_id`` with parent ``span_id``."""

    trace_id: str
    span_id: str


_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "esr_tpu_torch_obs_trace", default=None
)


def new_id() -> str:
    """A fresh 16-hex span/trace id (``os.urandom`` — unique across
    processes and threads, deterministic-clock-free)."""
    return os.urandom(8).hex()


def current() -> Optional[TraceContext]:
    """The ambient trace context of this thread/task, or None."""
    return _CTX.get()


def capture() -> Optional[TraceContext]:
    """Snapshot the ambient context for hand-off to a worker thread
    (alias of :func:`current`, named for intent at call sites)."""
    return _CTX.get()


@contextmanager
def adopt(ctx: Optional[TraceContext]):
    """Run a block under a captured context (worker-thread half of the
    cross-thread link). ``adopt(None)`` is a no-op, so producers created
    outside any trace cost nothing."""
    if ctx is None:
        yield
        return
    token = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(token)


# span-record keys the trace machinery owns; a payload field with one of
# these names is emitted with a trailing underscore instead of crashing
# end() (which runs in finallys) with a duplicate-kwarg TypeError
_RESERVED_FIELDS = frozenset(
    ("name", "seconds", "trace_id", "span_id", "parent_id", "begin", "end")
)


class SpanHandle:
    """One open span: identity + begin timestamp + the ambient token.

    Created by :func:`begin`/:func:`span`; emitted by :meth:`end`.
    ``end()`` is idempotent and never raises — it must be safe in the
    ``finally`` of a crashing loop. Payload fields colliding with the
    reserved span keys (``name``/``seconds``/``trace_id``/``span_id``/
    ``parent_id``/``begin``/``end``) emit as ``<key>_``.
    """

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "fields", "_sink", "_t0", "_token", "_ended",
    )

    def __init__(self, name: str, sink=None, **fields):
        parent = _CTX.get()
        self.name = name
        self.trace_id = parent.trace_id if parent else new_id()
        self.parent_id = parent.span_id if parent else None
        self.span_id = new_id()
        self.fields = dict(fields)
        self._sink = sink
        self._t0 = time.monotonic()
        self._token = _CTX.set(TraceContext(self.trace_id, self.span_id))
        self._ended = False

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def note(self, **fields) -> None:
        """Attach/override payload fields before the span closes."""
        self.fields.update(fields)

    def end(self, **fields) -> None:
        """Close the span: restore the parent ambient context and emit one
        v2 span record to the explicit (or process-active) sink."""
        if self._ended:
            return
        self._ended = True
        t1 = time.monotonic()
        try:
            _CTX.reset(self._token)
        except ValueError:
            # end() on a different thread/context than begin(): the token
            # is unusable there. Leave the ending thread's ambient context
            # ALONE — it belongs to whatever that thread is running under
            # (e.g. an adopt() block), and re-pointing it at this handle's
            # parent would mis-parent every record the thread emits next.
            # The begin thread's context dies with its thread/scope.
            pass
        if fields:
            self.fields.update(fields)
        sink = self._sink
        if sink is None:
            from esr_tpu_torch.obs.sink import active_sink

            sink = active_sink()
        if sink is None:
            return
        payload = {
            (k + "_" if k in _RESERVED_FIELDS else k): v
            for k, v in self.fields.items()
        }
        sink.span(
            self.name,
            t1 - self._t0,
            trace_id=self.trace_id,
            span_id=self.span_id,
            parent_id=self.parent_id,
            begin=round(sink.rel(self._t0), 6),
            end=round(sink.rel(t1), 6),
            **payload,
        )


def begin(name: str, sink=None, **fields) -> SpanHandle:
    """Open a span MANUALLY (non-``with`` host-loop form). The caller owns
    the matching :meth:`SpanHandle.end`, in a ``finally``: a leaked span
    leaves its context ambient for everything emitted afterwards."""
    return SpanHandle(name, sink=sink, **fields)


@contextmanager
def span(name: str, sink=None, **fields):
    """Open a span for a ``with`` block — closes on every exit path.

    Yields the :class:`SpanHandle` so the block can ``note(...)`` extra
    payload resolved mid-flight."""
    handle = SpanHandle(name, sink=sink, **fields)
    try:
        yield handle
    finally:
        handle.end()


__all__ = [
    "TraceContext",
    "SpanHandle",
    "adopt",
    "begin",
    "capture",
    "current",
    "new_id",
    "span",
]
