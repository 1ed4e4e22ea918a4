"""Continuous-batching lane scheduler: admission queue -> lanes (a copy of
``esr_tpu/serving/scheduler.py``, whose package imports JAX).

Host-side policy only; ``serving/server.py`` owns the device half.

- **Admission** is FIFO through a bounded queue; a full queue rejects the
  submit (:class:`AdmissionFull`): backpressure is explicit.
- **Binding** happens only at chunk boundaries (:meth:`LaneScheduler.
  bind_free_lanes`); a fresh request gets a zeroed recurrent state, a
  resumed one its saved state back.
- **Preemption** is quantum-based round robin: with a non-empty queue and no
  free lane, a lane held for at least ``preempt_quantum`` chunks may be
  evicted (most-served first); the request re-enters the queue tail with
  its saved state and window position, so it resumes bit-identically.
- **Chunk sizing**: each request's :class:`RequestClass` caps the windows
  fused per dispatch while it holds a lane (the minimum over bound lanes).
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "AdmissionFull",
    "RequestClass",
    "StreamRequest",
    "LaneScheduler",
    "DEFAULT_CLASSES",
]


class AdmissionFull(RuntimeError):
    """The admission queue is at capacity — the caller must retry later or
    shed the request (explicit backpressure; the queue never grows
    unboundedly)."""


@dataclass(frozen=True)
class RequestClass:
    """An SLO class: how aggressively windows are fused for its streams.

    ``chunk_windows`` is the latency/throughput knob — the maximum windows
    scan-fused per dispatch while a stream of this class is lane-bound.
    ``preemptible=False`` pins a stream to its lane once bound (it is
    never offered by :meth:`LaneScheduler.preempt_candidates`).

    ``min_activity`` is the activity-gating knob: a window whose rasterized
    active-tile fraction falls below it is SKIPPED at chunk-build time —
    consumed from the stream with near-zero lane compute, never packed
    into a device dispatch, while the stream's recurrent state is carried
    forward untouched (a skipped window never enters the scan, so the
    state a later active window sees is identical to never having had
    the idle window). 0.0 (default) disables gating — every window is
    dense compute."""

    name: str
    chunk_windows: int = 8
    preemptible: bool = True
    min_activity: float = 0.0

    def __post_init__(self):
        if self.chunk_windows < 1:
            raise ValueError(
                f"chunk_windows must be >= 1, got {self.chunk_windows}"
            )
        if not 0.0 <= self.min_activity <= 1.0:
            raise ValueError(
                f"min_activity must be in [0, 1], got {self.min_activity}"
            )


# the stock classes serve.py exposes; callers can define their own
DEFAULT_CLASSES: Dict[str, RequestClass] = {
    # latency-sensitive: small fusion so results (and re-scheduling
    # opportunities) surface every few windows
    "interactive": RequestClass("interactive", chunk_windows=2),
    # the default: the engine's balanced fusion depth
    "standard": RequestClass("standard", chunk_windows=8),
    # throughput-oriented offline backfill: deep fusion, first to yield
    "bulk": RequestClass("bulk", chunk_windows=16),
}


@dataclass
class StreamRequest:
    """One live stream request and its scheduling/runtime bookkeeping.

    The scheduler owns the policy fields; ``server.py`` attaches the
    host-side window ``source`` and the saved recurrent state across
    preemptions. ``saved_state``/``peek`` persist across evictions — they
    ARE the resume point."""

    request_id: str
    path: object  # a recording path or an in-memory recording
    cls: RequestClass
    submitted_t: float = 0.0

    # trace identity: one trace per request, rooted at the `serve_request`
    # span the server emits at completion; every admit / chunk
    # participation / preempt record parents under root_span_id.
    # submitted_mono is time.monotonic() at submit, the root's begin edge.
    trace_id: Optional[str] = None
    root_span_id: Optional[str] = None
    submitted_mono: Optional[float] = None

    # runtime (server-owned)
    source: object = None          # window iterator, built at first bind
    peek: object = None            # one-window lookahead (lane-free probe)
    saved_state: object = None     # host pytree while evicted / pre-resume
    ended: bool = False            # stream exhausted (awaiting last chunk)

    # accounting
    inflight: int = 0              # dispatched chunks not yet resolved
    windows_done: int = 0
    # idle windows consumed by activity gating (RequestClass.min_activity)
    # — served with near-zero lane compute, never dispatched
    windows_skipped: int = 0
    chunks_since_bind: int = 0
    preemptions: int = 0
    first_bind_t: Optional[float] = None
    completed_t: Optional[float] = None
    error: Optional[str] = None
    window_latencies: List[float] = field(default_factory=list)

    # terminal classification and the bounded-retry ledger: ``status`` is
    # one of ok / bad_stream / faulted / quarantine_exhausted / migrated
    # (``serving/server.py``); ``error_kind`` is ``resilience.recovery.
    # classify_error``'s verdict on the terminal exception; ``retries``
    # counts fault-triggered re-admissions.
    status: Optional[str] = None
    error_kind: Optional[str] = None
    retries: int = 0
    # completed migrations this stream has ridden (extract -> bytes ->
    # inject); ``admit_handoff`` carries the count forward.
    handoffs: int = 0

    @property
    def resumable(self) -> bool:
        return self.saved_state is not None


class LaneScheduler:
    """Admission queue + lane binding + quantum preemption (host policy).

    One instance per :class:`esr_tpu_torch.serving.server.ServingEngine`; all
    methods are called from the serving loop thread (no internal locking —
    the server serializes rounds)."""

    def __init__(
        self,
        lanes: int,
        max_pending: int = 64,
        preempt_quantum: int = 4,
    ):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {max_pending}"
            )
        if preempt_quantum < 0:
            raise ValueError(
                f"preempt_quantum must be >= 0 (0 disables preemption), "
                f"got {preempt_quantum}"
            )
        self.num_lanes = int(lanes)
        self.max_pending = int(max_pending)
        self.preempt_quantum = int(preempt_quantum)
        self.lanes: List[Optional[StreamRequest]] = [None] * self.num_lanes
        self._queue: deque = deque()
        self._ids = itertools.count()
        self.rejected = 0
        self.completed: List[StreamRequest] = []
        # circuit-broken lanes: a quarantined lane is
        # never offered by bind_free_lanes until the session ends — the
        # server's LaneHealth ledger decides WHEN (serving.lane_quarantine_k)
        self.quarantined: set = set()

    # -- admission -----------------------------------------------------------

    def submit(self, req: StreamRequest) -> StreamRequest:
        """FIFO admission; raises :class:`AdmissionFull` at capacity."""
        if len(self._queue) >= self.max_pending:
            self.rejected += 1
            raise AdmissionFull(
                f"admission queue at capacity ({self.max_pending} pending); "
                f"retry after a lane frees"
            )
        self._queue.append(req)
        return req

    def requeue(self, req: StreamRequest) -> None:
        """Re-admit a preempted request at the queue TAIL (round-robin
        fairness). Exempt from the ``max_pending`` cap: the request was
        already admitted — eviction must never be able to LOSE it."""
        self._queue.append(req)

    def next_request_id(self) -> str:
        return f"req-{next(self._ids):05d}"

    # -- binding -------------------------------------------------------------

    def bind_free_lanes(self, now: float) -> List[Tuple[int, StreamRequest]]:
        """Fill every free lane from the queue head; returns the new
        ``(lane, request)`` bindings (the server resets/injects the device
        state and emits the ``serve_admit`` span per binding)."""
        out = []
        for lane in range(self.num_lanes):
            if (self.lanes[lane] is not None or lane in self.quarantined
                    or not self._queue):
                continue
            req = self._queue.popleft()
            self.lanes[lane] = req
            req.chunks_since_bind = 0
            if req.first_bind_t is None:
                req.first_bind_t = now
            out.append((lane, req))
        return out

    def release(self, lane: int, completed_t: Optional[float] = None) -> None:
        """Free a lane whose stream ended (or errored)."""
        req = self.lanes[lane]
        if req is not None:
            if completed_t is not None:
                req.completed_t = completed_t
            self.completed.append(req)
        self.lanes[lane] = None

    def unbind(self, lane: int) -> Optional[StreamRequest]:
        """Clear a faulted lane WITHOUT completing its request — the
        retry path (the server re-admits the request after resetting its
        stream). Returns the unbound request."""
        req = self.lanes[lane]
        self.lanes[lane] = None
        return req

    def drain_queue(self) -> List[StreamRequest]:
        """Pop EVERY queued request (the voluntary-drain half of the
        handoff): the server has
        already stripped the bound lanes; the queue's requests leave
        with whatever saved state they carry. Returns them in FIFO
        order; the queue is empty afterwards."""
        out = list(self._queue)
        self._queue.clear()
        return out

    def quarantine(self, lane: int) -> None:
        """Circuit-break a lane: it must be empty (drained first) and is
        excluded from every future bind. The last healthy lane can never
        be quarantined — a session with zero bindable lanes could neither
        drain its queue nor fail its requests loudly."""
        assert self.lanes[lane] is None, f"quarantine of bound lane {lane}"
        if self.healthy_lanes() <= 1:
            raise ValueError(
                f"refusing to quarantine lane {lane}: it is the last "
                "healthy lane (circuit breaker saturated)"
            )
        # REBIND, never mutate: the live plane's /healthz source reads
        # this set from the HTTP thread (sorted/iteration); an in-place
        # .add() racing that read raises "set changed size during
        # iteration", which the health registry would report as a false
        # unhealthy — and under the router contract (503 -> drain) a
        # transient read race must never drain a healthy replica.
        # Attribute rebinding is atomic; readers iterate their snapshot.
        self.quarantined = self.quarantined | {lane}

    def healthy_lanes(self) -> int:
        return self.num_lanes - len(self.quarantined)

    # -- preemption ----------------------------------------------------------

    def preempt_candidates(self) -> List[int]:
        """Lanes to evict THIS boundary: only when the queue is non-empty
        and no lane is free, only preemptible requests that have held
        their lane for >= ``preempt_quantum`` chunks, most-served first,
        at most one eviction per queued request. Quantum 0 disables."""
        if not self.preempt_quantum or not self._queue:
            return []
        if any(r is None for r in self.lanes):
            return []
        eligible = [
            (req.chunks_since_bind, lane)
            for lane, req in enumerate(self.lanes)
            if req is not None and req.cls.preemptible and not req.ended
            and req.chunks_since_bind >= self.preempt_quantum
        ]
        eligible.sort(reverse=True)
        return [lane for _, lane in eligible[: len(self._queue)]]

    def evict(self, lane: int) -> StreamRequest:
        """Unbind (the server must have saved the lane state first) and
        requeue; returns the evicted request."""
        req = self.lanes[lane]
        assert req is not None, f"evict of empty lane {lane}"
        self.lanes[lane] = None
        req.preemptions += 1
        self.requeue(req)
        return req

    # -- chunk sizing --------------------------------------------------------

    def chunk_windows(self, default: int = 8) -> int:
        """Fused windows for the NEXT chunk: min over the bound requests'
        class caps (the latency-sensitive class bounds the whole batch —
        every lane shares one program), ``default`` when idle."""
        caps = [
            r.cls.chunk_windows for r in self.lanes if r is not None
        ]
        return min(caps) if caps else int(default)

    # -- introspection -------------------------------------------------------

    def queue_depth(self) -> int:
        return len(self._queue)

    def occupancy(self) -> int:
        return sum(1 for r in self.lanes if r is not None)

    def drained(self) -> bool:
        return self.occupancy() == 0 and not self._queue
