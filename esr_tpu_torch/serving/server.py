"""The serving session: live streams through continuous-batched lanes
(counterpart of ``esr_tpu/serving/server.py``).

``ServingEngine`` feeds the streaming engine's chunk function
(``inference/engine.make_chunk_fn``: fused windows, per-lane recurrent
state, metric sums on the card) from live traffic instead of a fixed
datalist:

- a :class:`~esr_tpu_torch.serving.scheduler.LaneScheduler` binds admitted
  streams to lanes as they free, at chunk boundaries, and preempts by
  quantum under load;
- an evicted stream's recurrent state is extracted to the host
  (``engine.extract_lane_state``) and injected back when it resumes
  (``engine.inject_lane_state``), so it resumes bit-identically;
- the fused depth ``W`` of each chunk is the least ``chunk_windows`` of
  the bound requests' classes (one chunk function per distinct ``W``);
- activity gating: a window whose active-tile fraction is below its
  class's ``min_activity`` is consumed from the stream but never computed,
  and leaves the lane's state untouched;
- chunk readbacks resolve one chunk behind dispatch, and each folds the
  per-lane sums into per-request reports with window-latency series.

A lane that faults is recorded on a circuit-breaker ledger (quarantined at
``lane_quarantine_k`` faults) and its request retried at most
``request_retries`` times. Recovery actions are logged as warnings, emitted
as ``recovery_*`` events and counted in :meth:`ServingEngine.summary`
(``recoveries``). The ``serve_chunk`` fault site (``resilience.faults``)
fires once per dispatched chunk: ``lane_fault`` / ``stream_error`` raise in
one bound lane's pull, ``preempt_signal`` drains every bound lane with its
state saved.

Telemetry, into the process-active sink read on every call (a fleet swaps
it around each replica's calls): a ``serve_admit`` span per binding, a
``serve_chunk`` span per chunk, a ``serve_chunk_part`` span per request
and chunk (its build-to-readback latency, the reporter's per-class window
latency), ``serve_queue_depth`` / ``serve_lane_occupancy`` gauges when
they change, a ``serve_backpressure`` counter per shed submit,
``serve_preempt`` / ``serve_handoff_out`` / ``serve_handoff_in`` /
``serve_request_done`` events, and the ``serve_request`` root span at
completion: each request is one connected trace. ``live_port`` (0:
ephemeral) serves the live plane (``obs.http``: ``/metrics``,
``/healthz`` with the lane-quarantine source, ``/slo`` against
``live_slo``, ``/snapshot``) beside the active sink; ``health_ns``
namespaces the health sources of co-resident replicas.

``profile_steps`` records the first N dispatched chunks with
``torch.profiler`` (CUDA activity on the card) into ``profile_dir`` and
stamps a ``profiler_capture`` event.

``aot_programs`` (``{chunk_windows: artifact path}``, from
``inference/export.export_checkpoint(program="engine_chunk")``) serves
through loaded chunk programs: each depth's artifact is loaded once, its
sidecar checked against the session first (the rung, ``(lanes,
chunk_windows)``, the grids and ``seqn``; a missing depth raises
``KeyError``, an artifact of another device ``ValueError``), and it runs
this engine's own weights. The first dispatch that needs one loads every
class depth's artifact, so no later chunk waits on a load. Lane states, eviction, resume and the ESRLANE1
wire are the traced path's.

``precision`` is the rung the session serves at (``None``: f32; the entry
point resolves CLI > checkpoint > f32): at bf16 the lane states live in
bf16 and an evicted stream's state leaves as its raw 16-bit words; at int8
the seams quantize (``inference/engine.make_chunk_fn``).
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from esr_tpu_torch.config.precision import compute_dtype_of, resolve_precision
from esr_tpu_torch.data.loader import engine_windows, window_activity, window_tuple
from esr_tpu_torch.data.records import recording_name
from esr_tpu_torch.device import DeviceLike, resolve_device
from esr_tpu_torch.inference.engine import (
    METRIC_KEYS,
    extract_lane_state,
    inject_lane_state,
    lane_states,
    make_chunk_fn,
)
from esr_tpu_torch.obs import active_sink, trace
from esr_tpu_torch.obs.report import percentile_ms
from esr_tpu_torch.resilience import faults as _faults
from esr_tpu_torch.resilience.recovery import (
    LaneHealth,
    classify_error,
    emit_recovery,
    fault_id_of,
)
from esr_tpu_torch.serving.scheduler import (
    DEFAULT_CLASSES,
    AdmissionFull,
    LaneScheduler,
    RequestClass,
    StreamRequest,
)

logger = logging.getLogger(__name__)

__all__ = ["RecordingStream", "ServingEngine", "AdmissionFull"]

# the longest sleep of an idle loop waiting for the next scheduled arrival
_IDLE_SLICE_S = 0.005


def _path_str(path) -> str:
    """A request's recording for reports: the path, or the in-memory
    recording's name."""
    return os.fspath(path) if isinstance(path, (str, os.PathLike)) else recording_name(path)


class RecordingStream:
    """The window source of one stream, in stream order: ``(inp_scaled,
    gt_mid, inp_mid, activity)`` tuples, ``activity`` the window's
    active-tile fraction (``data.loader.window_activity``). The serving tier
    holds the iterator (and a one-window peek) across preemptions, so a
    resumed stream continues at the next unserved window."""

    def __init__(self, path, config: Dict, activity_tile: int = 8):
        self.path = path
        self.seqn = int(config["sequence"].get("seqn", 3))
        self.activity_tile = int(activity_tile)
        self._loader = engine_windows(path, config)
        self.inp_resolution = tuple(self._loader.inp_resolution)
        self.gt_resolution = tuple(self._loader.gt_resolution)
        self._it = self._windows()

    def _windows(self):
        for batch in self._loader:
            win = window_tuple(batch, self.seqn)
            yield win + (window_activity(win[0], self.activity_tile),)

    def __iter__(self):
        return self._it

    def __next__(self):
        return next(self._it)


class ServingEngine:
    """Multi-tenant continuous-batching serving session (module docstring).
    ``model`` is a trained ``DeepRecurrNet`` or a UNet-family windowed model
    (``SRUNetRecurrentSeq``, ``UNetRecurrentSeq``): any model with
    ``init_states`` and the windowed ``forward``; it is moved to ``device``
    (the card unless the CPU is asked for)."""

    def __init__(
        self,
        model: torch.nn.Module,
        dataset_config: Dict,
        seqn: Optional[int] = None,
        lanes: int = 4,
        classes: Optional[Dict[str, RequestClass]] = None,
        default_class: str = "standard",
        max_pending: int = 64,
        preempt_quantum: int = 4,
        aot_programs: Optional[Dict[int, str]] = None,
        lane_quarantine_k: int = 3,
        request_retries: int = 1,
        activity_tile: int = 8,
        live_port: Optional[int] = None,
        live_slo: Optional[str] = None,
        profile_steps: int = 0,
        profile_dir: Optional[str] = None,
        health_ns: Optional[str] = None,
        precision: Optional[str] = None,
        device: DeviceLike = None,
    ):
        self.precision = resolve_precision(cli=precision)
        self.compute_dtype = compute_dtype_of(self.precision)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dataset_config = dict(dataset_config)
        seq = dict(self.dataset_config.get("sequence", {}))
        if seqn is not None:
            seq["seqn"] = int(seqn)
        self.dataset_config["sequence"] = seq
        self.seqn = int(seq.get("seqn", 3))
        self.lanes = int(lanes)
        self.classes = dict(classes if classes is not None else DEFAULT_CLASSES)
        if default_class not in self.classes:
            raise ValueError(f"default_class {default_class!r} not among classes "
                             f"{sorted(self.classes)}")
        self.default_class = default_class
        self.default_chunk_windows = self.classes[default_class].chunk_windows
        self.scheduler = LaneScheduler(lanes, max_pending=max_pending,
                                       preempt_quantum=preempt_quantum)
        self._lane_health = LaneHealth(lane_quarantine_k)
        self.request_retries = int(request_retries)
        if self.request_retries < 0:
            raise ValueError(f"request_retries must be >= 0, got {self.request_retries}")
        self.activity_tile = int(activity_tile)
        self._programs: Dict[int, object] = {}
        self._aot_paths = {int(w): p for w, p in (aot_programs or {}).items()}
        # seconds to build (or load) each depth's program, at its first use
        self.program_seconds: Dict[int, float] = {}
        self._requests: Dict[str, StreamRequest] = {}
        self._acc: Dict[str, Dict] = {}
        self._pending: deque = deque()
        self._states = None
        self._resolutions = None  # ((ih, iw), (kh, kw)) once probed
        self._shapes = None
        self._chunk_idx = 0
        self._window_steps = 0  # the model's forwards: W per dispatched chunk
        self._t0 = time.perf_counter()
        self._first_dispatch_t: Optional[float] = None
        self._last_resolve_t: Optional[float] = None
        self._windows_total = 0
        # lanes whose next dispatched chunk must reset the state (fresh
        # binds); kept across rounds, since a gated lane may dispatch late
        self._lane_needs_reset: set = set()
        # gated windows of rounds that dispatched no chunk, carried onto the
        # next serve_chunk span (or a serve_gating_flush event at drain), so
        # the telemetry's skip totals equal the requests'
        self._skipped_carry = 0
        self._last_gauges = None
        self.recoveries: Dict[str, int] = {}
        self._profiler = None
        if int(profile_steps) > 0:
            from esr_tpu_torch.obs.device import ProfilerCapture

            self._profiler = ProfilerCapture(profile_dir or "serve_profile", int(profile_steps),
                                             site="serving", cuda=self.device.type == "cuda")
        self.live = None
        self.health_ns = health_ns
        self._health_source_name = ("serving_lanes" if health_ns is None
                                    else f"serving_lanes@{health_ns}")
        if live_port is not None:
            from esr_tpu_torch.obs.http import register_health_source, start_live_plane

            self.live = start_live_plane(active_sink(), port=int(live_port),
                                         slo_path=live_slo, ns=health_ns)
            # a quarantined lane flips /healthz to 503
            register_health_source(self._health_source_name, self._lane_health_doc)

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _recovery(self, name: str, **fields) -> None:
        """A recovery action: a warning in the log, a ``recovery_*`` event at
        the ``serve_chunk`` site and a count in the summary."""
        self.recoveries[name] = self.recoveries.get(name, 0) + 1
        logger.warning("%s %s", name, fields)
        emit_recovery(name, site="serve_chunk", **fields)

    def _lane_health_doc(self) -> Dict:
        """The ``serving_lanes`` /healthz source, called from an HTTP thread:
        host state only (one snapshot of the quarantine set, which the
        scheduler rebinds and never mutates)."""
        quarantined = self.scheduler.quarantined
        return {
            "healthy": not quarantined,
            "lanes": self.lanes,
            "quarantined": sorted(quarantined),
            "healthy_lanes": self.lanes - len(quarantined),
            "queue_depth": self.scheduler.queue_depth(),
        }

    # -- programs / device state ---------------------------------------------

    def _program(self, w: int):
        """The fused chunk program at depth ``w``: loaded from its artifact
        when ``aot_programs`` were given (the session then never traces),
        else built once per distinct ``w``. The first artifact needed loads
        every class depth's at once, so no later chunk waits on a load."""
        prog = self._programs.get(w)
        if prog is not None:
            return prog
        if self._aot_paths:
            if w not in self._aot_paths:
                raise KeyError(
                    f"no AOT chunk program for chunk_windows={w}; exported depths: "
                    f"{sorted(self._aot_paths)} (export one per request-class "
                    "chunk_windows)")
            depths = {c.chunk_windows for c in self.classes.values()} | {w}
            for d in sorted(depths & set(self._aot_paths) - set(self._programs)):
                t0 = time.perf_counter()
                self._programs[d] = self._load_aot(d)
                self.program_seconds[d] = time.perf_counter() - t0
            return self._programs[w]
        t0 = time.perf_counter()
        kh, kw = self._resolutions[1]
        prog = make_chunk_fn(self.model, self.lanes, w, kh, kw, self.compute_dtype,
                             self.precision)
        self.program_seconds[w] = time.perf_counter() - t0
        self._programs[w] = prog
        return prog

    def _load_aot(self, w: int):
        """The artifact of depth ``w``, its sidecar checked against this
        session first (the reference's refusals: another rung, ``(lanes,
        chunk_windows)``, grid or ``seqn``; the loader refuses another
        device), then loaded with this engine's weights."""
        from esr_tpu_torch.inference.export import load_exported_model, read_sidecar

        path = self._aot_paths[w]
        sidecar = read_sidecar(path)
        # the rung is baked in at export; another would serve other numerics
        aot_precision = sidecar.get("precision") or "f32"
        if aot_precision != self.precision:
            raise ValueError(
                f"AOT artifact {path} was exported at precision={aot_precision!r}, "
                f"serving was asked for {self.precision!r}")
        got = (sidecar.get("lanes"), sidecar.get("chunk_windows"))
        if got != (self.lanes, w):
            raise ValueError(
                f"AOT artifact {path} was exported for (lanes, chunk_windows)={got}, "
                f"serving needs ({self.lanes}, {w})")
        # the grid too: a mismatch would otherwise surface as a shape error
        # of the program mid-loop
        want = {"gt_hw": list(self._resolutions[1]), "lr_hw": list(self._resolutions[0]),
                "seqn": self.seqn}
        got_geo = {k: sidecar.get(k) for k in want}
        if any(got_geo[k] is not None and got_geo[k] != want[k] for k in want):
            raise ValueError(f"AOT artifact {path} geometry {got_geo} does not match "
                             f"the serving pack's {want}")
        prog, _ = load_exported_model(path, device=self.device, model=self.model)
        return prog

    def _ensure_device(self, stream: RecordingStream) -> None:
        """The first admitted stream fixes the pack's resolutions and the
        lane states (on the GT grid, where the inputs live)."""
        if self._resolutions is None:
            self._resolutions = (stream.inp_resolution, stream.gt_resolution)
        if self._states is None:
            kh, kw = self._resolutions[1]
            self._states = lane_states(self.model, self.lanes, kh, kw, self.device,
                                       self.compute_dtype)

    def _new_acc(self) -> Dict:
        return {"sums": {k: 0.0 for k in METRIC_KEYS}, "count": 0}

    # -- session API ---------------------------------------------------------

    def submit(self, path, request_class: Union[str, RequestClass, None] = None,
               request_id: Optional[str] = None) -> str:
        """Admit one stream (a recording path or an in-memory recording);
        returns its request id. Raises :class:`AdmissionFull` when the
        admission queue is at capacity."""
        if request_class is None:
            cls = self.classes[self.default_class]
        elif isinstance(request_class, RequestClass):
            cls = request_class
        else:
            cls = self.classes[request_class]
        rid = request_id or self.scheduler.next_request_id()
        if rid in self._requests:
            raise ValueError(f"duplicate request_id {rid!r}")
        req = StreamRequest(rid, path, cls, submitted_t=self._now(),
                            trace_id=trace.new_id(), root_span_id=trace.new_id(),
                            submitted_mono=time.monotonic())
        try:
            self.scheduler.submit(req)
        except AdmissionFull:
            sink = active_sink()
            if sink is not None:
                sink.counter("serve_backpressure", queue_depth=self.scheduler.queue_depth())
                # a shed submit still ends classified; no journey existed
                sink.event("serve_request_done", request=rid, trace_id=req.trace_id,
                           cls=req.cls.name, windows=0, preemptions=0, completed=False,
                           error="AdmissionFull", status="shed", error_kind="backpressure")
            raise
        self._requests[rid] = req
        self._acc[rid] = self._new_acc()
        return rid

    # -- the serving loop ----------------------------------------------------

    def _bind(self, now: float) -> None:
        sink = active_sink()
        for lane, req in self.scheduler.bind_free_lanes(now):
            if req.source is None:
                try:
                    req.source = RecordingStream(req.path, self.dataset_config,
                                                 activity_tile=self.activity_tile)
                    self._ensure_device(req.source)
                    if (req.source.inp_resolution,
                            req.source.gt_resolution) != self._resolutions:
                        raise ValueError(
                            f"stream {_path_str(req.path)} resolution "
                            f"{req.source.inp_resolution}->{req.source.gt_resolution} "
                            f"does not match the serving pack's {self._resolutions}")
                except Exception as e:  # noqa: BLE001 - fails its request only
                    req.error = repr(e)
                    req.error_kind = classify_error(e)
                    req.status = "bad_stream"
                    req.ended = True
                    logger.warning("request %s failed at bind (lane %d): %r [%s]",
                                   req.request_id, lane, e, req.error_kind)
                    self.scheduler.release(lane, completed_t=self._now())
                    self._finish(req)
                    continue
            action = "resume" if req.resumable else "fresh"
            if req.resumable:
                self._states = inject_lane_state(self._states, lane, req.saved_state)
                req.saved_state = None
                self._lane_needs_reset.discard(lane)
            else:
                # zeroed by the chunk's reset mask at its first real dispatch
                self._lane_needs_reset.add(lane)
            if sink is not None:
                mono = time.monotonic()
                sink.span("serve_admit", mono - req.submitted_mono, trace_id=req.trace_id,
                          span_id=trace.new_id(), parent_id=req.root_span_id,
                          begin=round(sink.rel(req.submitted_mono), 6),
                          end=round(sink.rel(mono), 6), request=req.request_id,
                          cls=req.cls.name, lane=lane, action=action,
                          queue_depth=self.scheduler.queue_depth())

    def _finish(self, req: StreamRequest) -> None:
        if req.completed_t is None:
            req.completed_t = self._now()
        if req.status is None:
            req.status = "ok" if req.error is None else "bad_stream"
        sink = active_sink()
        if sink is not None:
            # the trace root (submit -> completion); the terminal event
            # parents under it, closing the request's connected trace
            mono = time.monotonic()
            sink.span("serve_request", mono - req.submitted_mono, trace_id=req.trace_id,
                      span_id=req.root_span_id, parent_id=None,
                      begin=round(sink.rel(req.submitted_mono), 6),
                      end=round(sink.rel(mono), 6), request=req.request_id,
                      cls=req.cls.name, windows=req.windows_done,
                      preemptions=req.preemptions, completed=req.error is None)
            sink.event("serve_request_done", request=req.request_id, trace_id=req.trace_id,
                       parent_id=req.root_span_id, cls=req.cls.name,
                       windows=req.windows_done, preemptions=req.preemptions,
                       completed=req.error is None, error=req.error, status=req.status,
                       error_kind=req.error_kind, retries=req.retries)

    def _preempt_event(self, req: StreamRequest, lane: int, **fields) -> None:
        sink = active_sink()
        if sink is not None:
            sink.event("serve_preempt", request=req.request_id, trace_id=req.trace_id,
                       parent_id=req.root_span_id, cls=req.cls.name, lane=lane,
                       windows_done=req.windows_done,
                       queue_depth=self.scheduler.queue_depth(), **fields)

    def _preempt_drain(self, spec) -> None:
        """Simulated host preemption (``serve_chunk`` / ``preempt_signal``):
        every bound lane's state is extracted and its request requeued, the
        eviction path, so every stream resumes bit-identically."""
        sched = self.scheduler
        drained = 0
        for lane in range(self.lanes):
            req = sched.lanes[lane]
            if req is None:
                continue
            # a fresh lane that never dispatched holds no state of its own
            req.saved_state = (None if lane in self._lane_needs_reset
                               else extract_lane_state(self._states, lane))
            sched.evict(lane)
            drained += 1
            self._preempt_event(req, lane, signal=True)
        self._recovery("recovery_preempt_drain", fault_id=spec.fault_id,
                       lanes_drained=drained, chunk=self._chunk_idx)

    def _lane_fault(self, lane: int, req: StreamRequest, e: BaseException) -> None:
        """A lane fault in the chunk loop: record it on the lane's ledger
        (quarantine at ``lane_quarantine_k``), then re-admit the request from
        window 0 (at most ``request_retries`` times) or fail it."""
        kind = classify_error(e)
        fid = fault_id_of(e)
        n = self._lane_health.record(lane)
        sched = self.scheduler
        sched.unbind(lane)
        logger.warning("lane %d faulted serving %s (fault %d on this lane): %r [%s]",
                       lane, req.request_id, n, e, kind)
        if self._lane_health.should_quarantine(lane) and lane not in sched.quarantined:
            try:
                sched.quarantine(lane)
                self._recovery("recovery_lane_quarantine", fault_id=fid, lane=lane,
                               faults=n, healthy_lanes=sched.healthy_lanes())
            except ValueError:
                logger.error("circuit breaker saturated: lane %d kept in service "
                             "(last healthy lane)", lane)
        if req.retries < self.request_retries:
            req.retries += 1
            req.source = None
            req.peek = None
            req.saved_state = None
            req.ended = False
            req.windows_done = 0
            req.windows_skipped = 0
            req.chunks_since_bind = 0
            req.window_latencies = []
            self._acc[req.request_id] = self._new_acc()
            self._recovery("recovery_request_retry", fault_id=fid, request=req.request_id,
                           attempt=req.retries, retries=self.request_retries, lane=lane,
                           error_kind=kind)
            sched.requeue(req)
            return
        req.error = repr(e)
        req.error_kind = kind
        req.status = "quarantine_exhausted" if lane in sched.quarantined else "faulted"
        req.ended = True
        req.completed_t = self._now()
        sched.completed.append(req)
        if req.inflight == 0:
            self._finish(req)

    def _pull(self, req: StreamRequest, w: int) -> Tuple[List[tuple], int]:
        """Up to ``w`` windows of a lane's stream, with a one-window
        lookahead (a stream whose length is a multiple of ``w`` frees its
        lane at once); windows below the class's ``min_activity`` are
        consumed and skipped. Returns ``(windows, skipped)``."""
        min_act = req.cls.min_activity
        wins: List[tuple] = []
        skipped = 0
        while len(wins) < w:
            if req.peek is not None:
                win, req.peek = req.peek, None
            else:
                try:
                    win = next(req.source)
                except StopIteration:
                    req.ended = True
                    return wins, skipped
            if min_act > 0.0 and win[3] < min_act:
                skipped += 1
                continue
            wins.append(win)
        try:
            req.peek = next(req.source)
        except StopIteration:
            req.ended = True
        return wins, skipped

    def pump(self) -> str:
        """One round: bind free lanes, build and dispatch one fused chunk,
        resolve the previous readback, preempt under load. Returns
        ``"dispatched"``, ``"idle"`` (queued requests, but every bind this
        round failed) or ``"drained"`` (nothing bound or queued; pending
        readbacks are flushed first)."""
        self._bind(self._now())
        sched = self.scheduler
        sink = active_sink()
        gauges = (sched.queue_depth(), sched.occupancy())
        if sink is not None and gauges != self._last_gauges:
            # on change only: an idle polling loop would write rows forever
            sink.gauge("serve_queue_depth", gauges[0], round=self._chunk_idx)
            sink.gauge("serve_lane_occupancy", gauges[1], lanes=self.lanes,
                       round=self._chunk_idx)
            self._last_gauges = gauges
        if sched.occupancy() == 0:
            if sched.drained():
                self.flush()
                if self._skipped_carry:
                    # the session's last windows were all gated: no chunk
                    # span carries them
                    if sink is not None:
                        sink.event("serve_gating_flush", skipped=self._skipped_carry)
                    self._skipped_carry = 0
                return "drained"
            return "idle"

        # the serve_chunk fault site, keyed by chunk index and fired only
        # past the occupancy returns, so a scheduled fault always finds a
        # bound lane to enact it on
        specs = _faults.fire("serve_chunk", self._chunk_idx)
        lane_faults = [s for s in specs if s.kind in ("lane_fault", "stream_error")]
        for s in specs:
            if s.kind == "preempt_signal":
                self._preempt_drain(s)

        w = sched.chunk_windows(default=self.default_chunk_windows)
        program = self._program(w)
        t_build = time.monotonic()
        per_lane: List[List[tuple]] = [[] for _ in range(self.lanes)]
        meta: List[Optional[Dict]] = [None] * self.lanes
        reset_keep = np.zeros(self.lanes, np.float32)
        chunk_skipped = 0
        for lane in range(self.lanes):
            req = sched.lanes[lane]
            if req is None:
                continue
            try:
                if lane_faults:
                    # enact one scheduled lane fault on this bound lane
                    raise _faults.InjectedFault(lane_faults.pop(0))
                wins, skipped = self._pull(req, w)
            except Exception as e:  # noqa: BLE001 - fails or retries its request
                self._lane_fault(lane, req, e)
                continue
            req.windows_skipped += skipped
            chunk_skipped += skipped
            per_lane[lane] = wins
            if wins:
                meta[lane] = {"request": req, "windows": len(wins),
                              "retries": req.retries}
                reset_keep[lane] = 0.0 if lane in self._lane_needs_reset else 1.0

        if all(m is None for m in meta):
            # every bound stream gave no window this round (empty, or all
            # gated): release the ended ones without a dispatch
            self._skipped_carry += chunk_skipped
            for lane in range(self.lanes):
                req = sched.lanes[lane]
                if req is not None and req.ended:
                    sched.release(lane, completed_t=self._now())
                    if req.inflight == 0:
                        self._finish(req)
            return "dispatched"

        if self._shapes is None:
            first = next(wins[0] for wins in per_lane if wins)
            self._shapes = tuple(a.shape for a in first[:3])
        arrays = [np.zeros((w, self.lanes) + s, np.float32) for s in self._shapes]
        valid = np.zeros((w, self.lanes), np.float32)
        for lane, wins in enumerate(per_lane):
            for t, win in enumerate(wins):
                for arr, a in zip(arrays, win[:3]):
                    arr[t, lane] = a
                valid[t, lane] = 1.0
        dev = self.device
        windows = {k: torch.from_numpy(a).to(dev) for k, a in
                   zip(("inp_scaled", "gt", "inp_mid", "valid"), arrays + [valid])}
        if self._profiler is not None:
            self._profiler.maybe_start()
        t_dispatch = time.monotonic()
        self._states, sums, _ = program(self._states, torch.from_numpy(reset_keep).to(dev),
                                        windows)
        if self._profiler is not None:
            # one profiled unit per dispatched chunk; stops itself at the budget
            self._profiler.step(1)
        for lane, wins in enumerate(per_lane):
            if wins:
                self._lane_needs_reset.discard(lane)
        if self._first_dispatch_t is None:
            self._first_dispatch_t = self._now()
        for m in meta:
            if m is not None:
                m["request"].inflight += 1
                m["request"].chunks_since_bind += 1
        self._pending.append({"chunk": self._chunk_idx, "meta": meta, "sums": sums,
                              "w": w, "t_build": t_build, "t_dispatch": t_dispatch,
                              "occupancy": sched.occupancy(),
                              "queue_depth": sched.queue_depth(),
                              "skipped": chunk_skipped + self._skipped_carry})
        self._skipped_carry = 0
        self._chunk_idx += 1
        self._window_steps += w

        # boundary housekeeping: free ended lanes, then preempt under load
        # (extraction waits for the chunk just dispatched)
        for lane in range(self.lanes):
            req = sched.lanes[lane]
            if req is not None and req.ended:
                sched.release(lane)
                if req.inflight == 0:
                    self._finish(req)
        for lane in sched.preempt_candidates():
            req = sched.lanes[lane]
            # a fresh lane that never dispatched holds no state of its own
            req.saved_state = (None if lane in self._lane_needs_reset
                               else extract_lane_state(self._states, lane))
            sched.evict(lane)
            self._preempt_event(req, lane)
        if len(self._pending) > 1:
            self._resolve(self._pending.popleft())
        return "dispatched"

    def _resolve(self, entry: Dict) -> None:
        """Read one chunk's sums back and fold them into the per-request
        accumulators and window-latency series."""
        sums = {k: v.cpu().numpy() for k, v in entry["sums"].items()}
        t_res = time.monotonic()
        self._last_resolve_t = self._now()
        latency = t_res - entry["t_build"]
        total_valid = int(round(float(sums["count"].sum())))
        sink = active_sink()
        for lane, m in enumerate(entry["meta"]):
            if m is None:
                continue
            req: StreamRequest = m["request"]
            req.inflight -= 1
            if m["retries"] == req.retries:
                acc = self._acc[req.request_id]
                for k in METRIC_KEYS:
                    acc["sums"][k] += float(sums[k][lane])
                acc["count"] += m["windows"]
                req.windows_done += m["windows"]
                req.window_latencies.extend([latency] * m["windows"])
                if sink is not None:
                    # this request's part of the chunk: its latency is what
                    # every window of it waited (the per-class p50/p99)
                    sink.span("serve_chunk_part", latency, trace_id=req.trace_id,
                              span_id=trace.new_id(), parent_id=req.root_span_id,
                              begin=round(sink.rel(entry["t_build"]), 6),
                              end=round(sink.rel(t_res), 6), request=req.request_id,
                              cls=req.cls.name, chunk=entry["chunk"], lane=lane,
                              windows=m["windows"])
            # else: the request was retried after this chunk; its fresh
            # accumulators must not take the failed run's sums
            if req.ended and req.inflight == 0:
                self._finish(req)
        self._windows_total += total_valid
        if sink is not None:
            seconds = t_res - entry["t_dispatch"]
            skipped = entry["skipped"]
            sink.span("serve_chunk", seconds, span_id=trace.new_id(),
                      begin=round(sink.rel(entry["t_dispatch"]), 6),
                      end=round(sink.rel(t_res), 6), chunk=entry["chunk"],
                      lanes=self.lanes, occupancy=entry["occupancy"],
                      chunk_windows=entry["w"], windows=total_valid,
                      skipped_windows=skipped, queue_depth=entry["queue_depth"],
                      requests=[m["request"].request_id if m else None
                                for m in entry["meta"]],
                      windows_per_sec=(round(total_valid / seconds, 3)
                                       if seconds > 0 else None))
            if total_valid + skipped:
                sink.gauge("serve_active_window_frac",
                           round(total_valid / (total_valid + skipped), 6),
                           chunk=entry["chunk"], windows=total_valid, skipped=skipped)

    def run(self, arrivals: Optional[Sequence] = None,
            max_wall_s: Optional[float] = None) -> Dict:
        """Drive the loop until every admitted stream and every scheduled
        arrival (``loadgen.Arrival``: ``t`` seconds from the start of this
        call) completes; returns :meth:`summary`. An arrival that finds the
        queue full waits (backpressure delays traffic, it never drops a
        scheduled request). ``max_wall_s`` bounds the loop."""
        t_run0 = time.perf_counter()
        todo = deque(sorted(arrivals or [], key=lambda a: a.t))
        while True:
            if max_wall_s is not None and time.perf_counter() - t_run0 > max_wall_s:
                logger.warning("serving loop hit max_wall_s=%s", max_wall_s)
                break
            rel = time.perf_counter() - t_run0
            while todo and todo[0].t <= rel:
                if self.scheduler.queue_depth() >= self.scheduler.max_pending:
                    break  # retry after the next round frees a slot
                a = todo.popleft()
                self.submit(a.path, a.request_class, request_id=a.request_id)
            if self.pump() == "drained":
                if not todo:
                    break
                wait = todo[0].t - (time.perf_counter() - t_run0)
                if wait > 0:
                    time.sleep(min(wait, _IDLE_SLICE_S))
        self.flush()
        if self._profiler is not None:
            # a session shorter than the budget still lands its record
            self._profiler.stop()
        return self.summary()

    def flush(self) -> None:
        """Resolve every in-flight chunk readback."""
        while self._pending:
            self._resolve(self._pending.popleft())

    # -- drain / handoff -----------------------------------------------------

    def _handoff_entry(self, req: StreamRequest, state, lane: Optional[int] = None) -> Dict:
        """One handoff entry for ``req``, which ends here with status
        ``migrated``; ``state`` is its host lane state (None for a stream
        that never dispatched: it rebinds fresh)."""
        acc = self._acc[req.request_id]
        entry = {
            "request_id": req.request_id,
            "path": req.path,
            "class": req.cls.name,
            "state": state,
            "acc_sums": dict(acc["sums"]),
            "acc_count": int(acc["count"]),
            "windows_done": int(req.windows_done),
            "windows_skipped": int(req.windows_skipped),
            "preemptions": int(req.preemptions),
            "retries": int(req.retries),
            "handoffs": int(req.handoffs) + 1,
            "window_latencies": list(req.window_latencies),
        }
        sink = active_sink()
        if sink is not None:
            sink.event("serve_handoff_out", request=req.request_id, trace_id=req.trace_id,
                       parent_id=req.root_span_id, cls=req.cls.name, lane=lane,
                       windows_done=req.windows_done, with_state=state is not None)
        req.status = "migrated"
        req.ended = True
        req.completed_t = self._now()
        self.scheduler.completed.append(req)
        self._finish(req)
        return entry

    def evacuate(self) -> List[Dict]:
        """Drain every live request for a handoff: flush the readbacks, then
        take each bound lane's request with its state extracted and each
        queued request with whatever state a preemption left it. Each ends
        here as ``migrated``; the entries go to ``admit_handoff`` of another
        engine (the state through ``serving.wire``)."""
        self.flush()
        sched = self.scheduler
        out: List[Dict] = []
        for lane in range(self.lanes):
            req = sched.lanes[lane]
            if req is None:
                continue
            state = (None if lane in self._lane_needs_reset
                     else extract_lane_state(self._states, lane))
            self._lane_needs_reset.discard(lane)
            sched.unbind(lane)
            out.append(self._handoff_entry(req, state, lane=lane))
        for req in sched.drain_queue():
            state, req.saved_state = req.saved_state, None
            out.append(self._handoff_entry(req, state))
        return out

    def admit_handoff(self, entry: Dict, state=None) -> str:
        """Re-admit a migrated stream, outside the ``max_pending`` cap (it was
        admitted once already). ``state`` (the host lane state) resumes the
        recurrent state bit-exactly at the next bind; None restarts it. The
        window source is rebuilt and fast-forwarded past the windows already
        served (computed and skipped), so the stream continues at its next
        unserved window."""
        rid = entry["request_id"]
        existing = self._requests.get(rid)
        if existing is not None and existing.status != "migrated":
            raise ValueError(f"duplicate request_id {rid!r}")
        cls_name = entry["class"]
        if cls_name not in self.classes:
            raise ValueError(f"handoff request class {cls_name!r} not among this "
                             f"engine's classes {sorted(self.classes)}")
        req = StreamRequest(rid, entry["path"], self.classes[cls_name],
                            submitted_t=self._now(), trace_id=trace.new_id(),
                            root_span_id=trace.new_id(), submitted_mono=time.monotonic())
        req.windows_done = int(entry.get("windows_done", 0))
        req.windows_skipped = int(entry.get("windows_skipped", 0))
        req.preemptions = int(entry.get("preemptions", 0))
        req.retries = int(entry.get("retries", 0))
        req.handoffs = int(entry.get("handoffs", 0))
        req.window_latencies = list(entry.get("window_latencies", []))
        sums = entry.get("acc_sums", {})
        self._acc[rid] = {"sums": {k: float(sums.get(k, 0.0)) for k in METRIC_KEYS},
                          "count": int(entry.get("acc_count", 0))}
        src = RecordingStream(req.path, self.dataset_config,
                              activity_tile=self.activity_tile)
        self._ensure_device(src)
        if (src.inp_resolution, src.gt_resolution) != self._resolutions:
            raise ValueError(f"handoff stream {_path_str(req.path)} resolution "
                             f"{src.inp_resolution}->{src.gt_resolution} does not "
                             f"match the serving pack's {self._resolutions}")
        for _ in range(req.windows_done + req.windows_skipped):
            try:
                next(src)
            except StopIteration:
                break  # shorter than claimed: the first pull ends it
        req.source = src
        req.saved_state = state
        self._requests[rid] = req
        self.scheduler.requeue(req)
        sink = active_sink()
        if sink is not None:
            sink.event("serve_handoff_in", request=rid, trace_id=req.trace_id,
                       parent_id=req.root_span_id, cls=cls_name,
                       windows_done=req.windows_done, resumed=state is not None,
                       handoffs=req.handoffs)
        return rid

    def terminal_request_ids(self) -> List[str]:
        """Ids of the requests whose terminal status is classified, in
        submission order: a fleet replica's completion poll."""
        return [rid for rid, req in self._requests.items() if req.status is not None]

    def close_live(self) -> None:
        """Tear down the live plane (idempotent): the lane-health source
        unregistered, the aggregator detached, the HTTP thread stopped."""
        if self.live is not None:
            from esr_tpu_torch.obs.http import unregister_health_source

            unregister_health_source(self._health_source_name)
            live, self.live = self.live, None
            live.close()
        if self._profiler is not None:
            self._profiler.stop()

    def abandon(self) -> None:
        """Drop what this engine holds on the card (the lane states, the
        chunk programs, the unresolved readbacks) with no flush, no drain
        and no terminal event, as a crashed process leaves them: a fleet
        replica's ``kill`` and ``fence``. The engine serves no more."""
        self._states = None
        self._programs.clear()
        self._pending.clear()

    # -- reports -------------------------------------------------------------

    @staticmethod
    def _pctl(lat_s: Sequence[float]) -> Tuple[Optional[float], Optional[float]]:
        if not lat_s:
            return None, None
        return percentile_ms(lat_s, 50), percentile_ms(lat_s, 99)

    def report(self, request_id: str) -> Dict:
        """Per-request report: metric means, window counts, status,
        admission latency, window-latency p50/p99, preemptions."""
        req = self._requests[request_id]
        acc = self._acc[request_id]
        n = acc["count"]
        completed = (req.error is None and req.ended and req.inflight == 0
                     and req.status != "migrated")
        out = {
            "request_id": request_id,
            "path": _path_str(req.path),
            "request_class": req.cls.name,
            "n_windows": n,
            "n_windows_skipped": req.windows_skipped,
            "completed": completed,
            "error": req.error,
            "status": req.status or ("ok" if completed else None),
            "error_kind": req.error_kind,
            "retries": req.retries,
            "handoffs": req.handoffs,
            "preemptions": req.preemptions,
            "admit_latency_s": (round(req.first_bind_t - req.submitted_t, 6)
                                if req.first_bind_t is not None else None),
        }
        out["window_latency_p50_ms"], out["window_latency_p99_ms"] = self._pctl(
            req.window_latencies)
        for k in METRIC_KEYS:
            out[k] = acc["sums"][k] / n if n else 0.0
        return out

    def reports(self) -> Dict[str, Dict]:
        return {rid: self.report(rid) for rid in self._requests}

    def summary(self) -> Dict:
        """Session summary: sustained windows/s (first dispatch to last
        resolve), global and per-class window-latency p50/p99, admission,
        preemption, skip and recovery counts."""
        all_lat: List[float] = []
        by_cls: Dict[str, List[float]] = {}
        admit: List[float] = []
        completed = preemptions = skipped = 0
        statuses: Dict[str, int] = {}
        for req in self._requests.values():
            all_lat.extend(req.window_latencies)
            by_cls.setdefault(req.cls.name, []).extend(req.window_latencies)
            preemptions += req.preemptions
            skipped += req.windows_skipped
            if (req.error is None and req.ended and req.inflight == 0
                    and req.status != "migrated"):
                completed += 1
            status = req.status or "live"
            statuses[status] = statuses.get(status, 0) + 1
            if req.first_bind_t is not None:
                admit.append(req.first_bind_t - req.submitted_t)
        wall = None
        if self._first_dispatch_t is not None and self._last_resolve_t is not None:
            wall = self._last_resolve_t - self._first_dispatch_t
        served = self._windows_total + skipped
        p50, p99 = self._pctl(all_lat)
        out = {
            "requests": len(self._requests),
            "completed": completed,
            "rejected": self.scheduler.rejected,
            "statuses": {k: statuses[k] for k in sorted(statuses)},
            "quarantined_lanes": sorted(self.scheduler.quarantined),
            "preemptions": preemptions,
            "windows": self._windows_total,
            "windows_skipped": skipped,
            "active_window_frac": round(self._windows_total / served, 6) if served else None,
            "chunks": self._chunk_idx,
            "window_steps": self._window_steps,
            "wall_s": round(wall, 6) if wall else None,
            "windows_per_sec": round(self._windows_total / wall, 3) if wall else None,
            "served_windows_per_sec": round(served / wall, 3) if wall else None,
            "p50_window_ms": p50,
            "p99_window_ms": p99,
            "admit_p50_ms": percentile_ms(admit, 50),
            "recoveries": dict(sorted(self.recoveries.items())),
            "classes": {},
        }
        for name, lat in sorted(by_cls.items()):
            c50, c99 = self._pctl(lat)
            out["classes"][name] = {"p50_window_ms": c50, "p99_window_ms": c99,
                                    "windows": len(lat)}
        return out
