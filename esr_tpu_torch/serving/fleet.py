"""N serving replicas behind one router (counterpart of
``esr_tpu/serving/fleet.py``: ``HashRing``, ``ReplicaSupervisor``,
``FleetRouter``).

A :class:`FleetRouter` admits streams per class and places them on
:class:`~esr_tpu_torch.serving.replica.Replica` workers by consistent
hashing of the request id; which replica hosts a stream is router policy,
changeable at any chunk boundary: voluntarily (drain and handoff) or not
(fail-over when a replica dies).

- **Supervision** rides one fetch per replica per poll:
  :class:`ReplicaSupervisor` polls ``/snapshot`` over loopback HTTP; the
  document carries the replica's health body, its ``/slo`` verdict and
  its serialized rollup, so death detection and the fleet view (fed
  through the supervisor's ``observer``) read the same fetches. An
  unhealthy body or a "page" verdict drains the replica; ``miss_budget``
  failed polls in a row declare it dead (a partitioned replica is fenced
  first).
- **Drain / handoff** moves each lane state through
  ``extract_lane_state`` -> ESRLANE1 bytes (digest-checked) ->
  ``inject_lane_state`` on the target: a stream migrates bit-exactly and
  resumes at its next unserved window.
- **Fail-over** re-admits a dead replica's streams elsewhere from window 0
  (the state died with it), within a per-request ``failover_budget``;
  re-admission ignores the queue cap, so backpressure never loses an
  admitted request.
- **Zero lost requests**: every submitted request ends in exactly one
  classified terminal status in the router's ledger: ``ok`` / ``shed`` /
  ``bad_stream`` / ``faulted`` / ``quarantine_exhausted`` (from a replica)
  or ``failover_retry_exhausted`` (the router); ``migrated`` and
  ``replica_lost`` classify single attempts in the telemetry.

The ``fleet_router`` fault site fires once per router round:
``replica_kill``, ``replica_partition``, ``router_handoff``, each answered
by a ``recovery_*`` event (``recovery_replica_failover`` /
``recovery_replica_fence`` / ``recovery_router_handoff``), so the merged
report over the router's and the replicas' files proves fault -> recovery
completeness.

The router loop is single-threaded and cooperative: it swaps the
process-active sink around each replica's calls. The only thread is the
supervisor's optional poller, which touches its own lock-guarded ledger
and serves no card state; fetches run outside the lock.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
import time
from bisect import bisect_right
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from esr_tpu_torch.obs.aggregate import parse_snapshot_wire
from esr_tpu_torch.obs.fleetview import http_fetch as _http_fetch
from esr_tpu_torch.resilience import faults as _faults
from esr_tpu_torch.resilience.recovery import emit_recovery
from esr_tpu_torch.serving.replica import HandoffPacket, Replica

logger = logging.getLogger(__name__)

__all__ = [
    "HashRing",
    "ReplicaSupervisor",
    "FleetRouter",
    "ROUTER_TERMINAL_STATUSES",
]

# router-level terminal statuses: `migrated` and `replica_lost` classify
# one ATTEMPT (the stream continued on another replica);
# `failover_retry_exhausted` is final
ROUTER_TERMINAL_STATUSES = frozenset(
    {"migrated", "replica_lost", "failover_retry_exhausted"}
)


# ---------------------------------------------------------------------------
# consistent-hash placement


class HashRing:
    """Consistent hashing over replica ids (sha256, ``vnodes`` virtual
    points per node): :meth:`place` maps a stream key to the first node
    clockwise, so adding or removing one replica remaps only ~1/N of the
    keys. Deterministic across
    processes and platforms — placement is reproducible under a fixed
    request-id schedule, which is what makes fleet chaos runs seedable."""

    def __init__(self, nodes: Iterable[str] = (), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: List[Tuple[int, str]] = []
        self._hashes: List[int] = []
        self._nodes: set = set()
        for node in nodes:
            self.add(node)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:8], "big"
        )

    def _rebuild(self) -> None:
        self._points.sort()
        self._hashes = [h for h, _ in self._points]

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        self._points.extend(
            (self._hash(f"{node}#{v}"), node) for v in range(self.vnodes)
        )
        self._rebuild()

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._points = [(h, n) for h, n in self._points if n != node]
        self._rebuild()

    @property
    def nodes(self) -> List[str]:
        return sorted(self._nodes)

    def place(self, key: str, exclude: Sequence[str] = ()) -> Optional[str]:
        """The owning node for ``key`` (first point clockwise), skipping
        ``exclude``; None when every node is excluded."""
        if not self._points:
            return None
        excluded = set(exclude)
        start = bisect_right(self._hashes, self._hash(key))
        n = len(self._points)
        for i in range(n):
            node = self._points[(start + i) % n][1]
            if node not in excluded:
                return node
        return None

    def ownership(self) -> Dict[str, float]:
        """Fraction of the 2^64 key space each node owns (clockwise arc
        lengths, wraparound included; fractions sum to 1) — the
        placement-topology view the fleet plane's ``/fleet`` endpoint
        surfaces."""
        if not self._points:
            return {}
        out = {n: 0.0 for n in self._nodes}
        span = float(2 ** 64)
        prev = self._points[-1][0] - 2 ** 64
        for h, node in self._points:
            out[node] += (h - prev) / span
            prev = h
        return {n: round(v, 6) for n, v in sorted(out.items())}


# ---------------------------------------------------------------------------
# supervision: one /snapshot poll per replica, heartbeat ledger
# (_http_fetch is the obs fleet-view fetch: (status, body), HTTPError IS
# an answer, transport failure raises — the heartbeat-miss signal)


class ReplicaSupervisor:
    """Heartbeat + verdict ledger over every watched replica's
    ``/snapshot`` endpoint — ONE fetch per replica per poll.

    :meth:`poll_once` fetches each replica's snapshot document, which
    carries the health body (``/healthz``'s verdict), the replica's own
    ``/slo`` verdict, AND the serialized rollup state — so supervision
    needs no second or third fetch, and the fleet view
    (``obs.fleetview.FleetAggregator``), fed every parsed document (or
    miss) through the ``observer`` hook, sees exactly the fetch stream
    death detection acted on. Transport failures count as heartbeat
    MISSES; a replica that ANSWERS with an unusable document
    (wire-version mismatch, torn JSON) is alive-but-unhealthy, never a
    miss, and never merged. Deterministic callers (the tests, the chaos
    scenario) call ``poll_once`` from the router round; production wires
    the optional poller thread (:meth:`start`) for wall-clock cadence —
    either way the ledger semantics are identical.

    Thread discipline: every access to ``_targets``/``_ledger``
    holds ``_lock``; the HTTP fetches and the observer callback run
    OUTSIDE the lock; the poller is a daemon thread stopped via Event +
    timed join."""

    def __init__(
        self,
        miss_budget: int = 3,
        timeout_s: float = 1.0,
        fetch=None,
        observer=None,
    ):
        if miss_budget < 1:
            raise ValueError(f"miss_budget must be >= 1, got {miss_budget}")
        self.miss_budget = int(miss_budget)
        self.timeout_s = float(timeout_s)
        self._fetch = fetch if fetch is not None else _http_fetch
        # observer signature == FleetAggregator.ingest: (replica_id,
        # parsed_snapshot_or_None, wire_bytes=, error=, unusable=)
        self._observer = observer
        self._lock = threading.Lock()
        self._targets: Dict[str, Optional[str]] = {}
        self._ledger: Dict[str, Dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- watch list ----------------------------------------------------------

    def watch(self, replica_id: str,
              snapshot_url: Optional[str]) -> None:
        with self._lock:
            self._targets[replica_id] = snapshot_url
            self._ledger.setdefault(replica_id, {
                "polls": 0, "misses": 0, "healthy": None,
                "slo_verdict": None, "last_error": None,
            })

    def unwatch(self, replica_id: str) -> None:
        with self._lock:
            self._targets.pop(replica_id, None)

    # -- polling -------------------------------------------------------------

    def poll_once(self) -> None:
        """One supervision pass over every watched replica. Fetches run
        outside the lock; ledger updates inside; the observer is handed
        each outcome after the ledger settles."""
        with self._lock:
            targets = dict(self._targets)
        for rid, url in targets.items():
            parsed = None
            nbytes = None
            healthy = None
            slo_verdict = None
            error = None
            miss = False
            try:
                if url is None:
                    raise OSError("no endpoint (replica down)")
                status, body = self._fetch(url, self.timeout_s)
                if status != 200:
                    raise ValueError(
                        f"snapshot endpoint answered {status}, not 200"
                    )
                parsed = parse_snapshot_wire(json.loads(body))
                nbytes = len(body)
                health = parsed.get("health") or {}
                healthy = bool(health.get("healthy", False))
                slo_verdict = parsed.get("slo_verdict")
            except ValueError as e:
                # answered, unusable (wire-version mismatch, torn JSON):
                # ALIVE but unhealthy — never a heartbeat miss, never
                # merged (parse_snapshot_wire's loud-rejection rule)
                parsed = None
                healthy = False
                error = f"unusable snapshot: {e}"
            except Exception as e:  # noqa: BLE001
                # invariant: transport failure IS the signal — a missed
                # heartbeat, recorded on the ledger below and consumed
                # by the router's declare-dead transition (never
                # swallowed silently)
                miss = True
                error = repr(e)
            with self._lock:
                slot = self._ledger.setdefault(rid, {
                    "polls": 0, "misses": 0, "healthy": None,
                    "slo_verdict": None, "last_error": None,
                })
                slot["polls"] += 1
                if miss:
                    slot["misses"] += 1
                    slot["last_error"] = error
                else:
                    slot["misses"] = 0
                    slot["healthy"] = healthy
                    slot["slo_verdict"] = slo_verdict
                    slot["last_error"] = error
            if self._observer is not None:
                try:
                    self._observer(
                        rid, parsed, wire_bytes=nbytes, error=error,
                        unusable=(not miss and parsed is None),
                    )
                except Exception as e:
                    # the fleet view must never break supervision; the
                    # failure is logged, not swallowed silently
                    logger.warning(
                        "supervisor observer failed for %s: %r", rid, e
                    )

    def verdict(self, replica_id: str) -> Dict:
        """Snapshot verdict: ``alive`` flips False after ``miss_budget``
        consecutive misses (a never-polled replica is alive — grace)."""
        with self._lock:
            slot = dict(self._ledger.get(replica_id, {
                "polls": 0, "misses": 0, "healthy": None,
                "slo_verdict": None, "last_error": None,
            }))
        slot["alive"] = slot["misses"] < self.miss_budget
        return slot

    # -- optional poller thread ---------------------------------------------

    def start(self, interval_s: float = 0.5) -> "ReplicaSupervisor":
        """Spawn the daemon poller (production cadence); idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_s):
                self.poll_once()

        self._thread = threading.Thread(
            target=_loop, daemon=True, name="fleet-supervisor"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if not self._thread.is_alive():
                self._thread = None


# ---------------------------------------------------------------------------
# the router


class FleetRouter:
    """Front-end of the fleet: admission, placement, supervision,
    migration, fail-over, and the authoritative per-request ledger.

    The router runs cooperatively and single-threaded: one
    :meth:`run` loop admits due arrivals, fires the ``fleet_router``
    fault site, applies supervision verdicts, pumps every live replica
    one engine round (under that replica's own sink), and folds replica
    terminals into the ledger. Router-level telemetry (placement,
    handoff, fail-over, recovery events) goes to whatever sink is active
    around :meth:`run` — one router file beside the N replica files,
    merged by ``python -m esr_tpu_torch.obs report <files...>``."""

    def __init__(
        self,
        replicas: Sequence[Replica],
        default_class: str = "standard",
        class_pending_cap: Optional[Dict[str, int]] = None,
        failover_budget: int = 1,
        miss_budget: int = 2,
        heartbeat_timeout_s: float = 1.0,
        supervise_interval_s: Optional[float] = None,
        vnodes: int = 64,
        supervisor: Optional[ReplicaSupervisor] = None,
    ):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.replicas: Dict[str, Replica] = {
            r.replica_id: r for r in replicas
        }
        if len(self.replicas) != len(replicas):
            raise ValueError("duplicate replica ids")
        self.default_class = default_class
        # per-class SLO admission: live (non-terminal) requests a class
        # may hold fleet-wide; beyond it a submit is SHED — explicit
        # router-level backpressure, classified, never an unbounded queue
        self.class_pending_cap = dict(class_pending_cap or {})
        self.failover_budget = int(failover_budget)
        self.ring = HashRing(self.replicas, vnodes=vnodes)
        self.supervisor = supervisor or ReplicaSupervisor(
            miss_budget=miss_budget, timeout_s=heartbeat_timeout_s,
        )
        self._own_poller = supervise_interval_s is not None
        if self._own_poller:
            self.supervisor.start(float(supervise_interval_s))
        for rep in replicas:
            self.supervisor.watch(rep.replica_id, rep.url("snapshot"))
        # replica lifecycle state: up | drained (alive, SLO-evacuated,
        # excluded from placement until its endpoints recover) | dead
        self._state: Dict[str, str] = {
            rid: "up" for rid in self.replicas
        }
        # the authoritative request ledger: every submitted request has
        # exactly one row; `status` None while live, classified terminal
        # at the end — zero lost requests is `all(status is not None)`
        self._ledger: Dict[str, Dict] = {}
        self._held: deque = deque()   # rids delayed by fleet-wide backpressure
        self._ids = 0
        self.round_idx = 0
        self.migrations = 0
        self.failovers = 0
        self.sheds = 0
        # fault attribution: a kill/partition spec's fault_id, consumed
        # by the failover it causes so recovery events pair by id
        self._fault_attrib: Dict[str, str] = {}
        # scheduled router_handoff faults waiting for a replica with
        # something to evacuate (a forced drain of an idle replica would
        # be vacuous); answered at the latest on loop exit
        self._pending_handoffs: List = []
        self._t0 = time.perf_counter()
        self._run_wall: Optional[float] = None

    # -- telemetry helpers ---------------------------------------------------

    def _event(self, name: str, **fields) -> None:
        from esr_tpu_torch.obs import active_sink

        sink = active_sink()
        if sink is not None:
            sink.event(name, **fields)

    def _terminal_event(self, rid: str, status: str, **fields) -> None:
        """A router-emitted ``serve_request_done``: no journey root
        exists in the ROUTER's file (the replica files hold the spans),
        so the completeness walker skips these statuses by design
        (``obs.report``'s rootless statuses)."""
        entry = self._ledger[rid]
        fields.setdefault("error_kind", None)
        self._event(
            "serve_request_done", request=rid, cls=entry["class"],
            windows=0, preemptions=0, completed=False, error=None,
            status=status, **fields,
        )

    # -- admission + placement ----------------------------------------------

    def next_request_id(self) -> str:
        rid = f"fleet-{self._ids:05d}"
        self._ids += 1
        return rid

    def _class_live(self, cls: str) -> int:
        return sum(
            1 for e in self._ledger.values()
            if e["class"] == cls and e["status"] is None
        )

    def _accepting(self, rid: str, cap_exempt: bool = False) -> bool:
        rep = self.replicas.get(rid)
        if rep is None or not rep.alive or rep.engine is None:
            return False
        if self._state.get(rid) != "up":
            return False
        if cap_exempt:
            # re-placement of an already-admitted stream (drain /
            # fail-over): ServingEngine.admit_handoff is cap-exempt, so
            # a full queue must not cost the stream its placement
            return True
        sched = rep.engine.scheduler
        return sched.queue_depth() < sched.max_pending

    def _place_for(self, key: str, exclude: Sequence[str] = (),
                   cap_exempt: bool = False) -> Optional[str]:
        """Consistent-hash placement with supervision-aware ring walk:
        dead/drained (and, for fresh submits, full) replicas are
        skipped; replicas whose live ``/slo`` verdict is ``warn`` (429 —
        ease new placements) are used only when no clean candidate
        exists. ``cap_exempt`` (drain/fail-over re-placement) ignores
        queue capacity — backpressure delays NEW admissions, it never
        loses an already-admitted stream."""
        hard = set(exclude) | {
            rid for rid in self.replicas
            if not self._accepting(rid, cap_exempt=cap_exempt)
        }
        eased = {
            rid for rid in self.replicas
            if self.supervisor.verdict(rid).get("slo_verdict") == "warn"
        }
        choice = self.ring.place(key, exclude=hard | eased)
        if choice is None:
            choice = self.ring.place(key, exclude=hard)
        return choice

    def submit(
        self,
        path,
        request_class: Optional[str] = None,
        request_id: Optional[str] = None,
    ) -> str:
        """Admit one stream (a recording path or an in-memory recording)
        fleet-wide; ALWAYS returns a ledger-tracked
        request id (a shed request is terminal ``status="shed"``, a
        backpressured one is HELD and retried — scheduled traffic is
        delayed, never dropped)."""
        cls = request_class or self.default_class
        rid = request_id or self.next_request_id()
        if rid in self._ledger:
            raise ValueError(f"duplicate request_id {rid!r}")
        entry = {
            "request_id": rid, "path": path, "class": cls,
            "replica": None, "served_on": set(), "status": None,
            "report": None, "failovers": 0, "handoffs": 0,
            "submitted_t": round(time.perf_counter() - self._t0, 6),
        }
        self._ledger[rid] = entry
        cap = self.class_pending_cap.get(cls)
        if cap is not None and self._class_live(cls) > cap:
            # per-class SLO admission: the class is over its fleet-wide
            # live budget — shed explicitly with a classified terminal
            entry["status"] = "shed"
            self.sheds += 1
            self._terminal_event(rid, "shed", error_kind="backpressure")
            return rid
        self._try_place(rid)
        return rid

    def _try_place(self, rid: str) -> bool:
        entry = self._ledger[rid]
        target_id = self._place_for(rid, exclude=entry["served_on"])
        if target_id is None:
            # every replica full/down right now: hold and retry next
            # round — an admitted request is delayed, never lost
            if rid not in self._held:
                self._held.append(rid)
            return False
        rep = self.replicas[target_id]
        try:
            rep.submit(entry["path"], request_class=entry["class"],
                       request_id=rid)
        except Exception as e:  # noqa: BLE001 - retried loudly below
            # a failed placement (racing drain, bad class) is retried on
            # the next round against fresh supervision state — loudly
            logger.warning(
                "placement of %s on %s failed: %r", rid, target_id, e,
            )
            if rid not in self._held:
                self._held.append(rid)
            return False
        entry["replica"] = target_id
        entry["served_on"].add(target_id)
        self._event(
            "fleet_place", request=rid, replica=target_id,
            cls=entry["class"], round=self.round_idx,
        )
        return True

    def _retry_held(self) -> None:
        fleet_alive = any(
            rep.alive and self._state[rid] != "dead"
            for rid, rep in self.replicas.items()
        )
        for _ in range(len(self._held)):
            rid = self._held.popleft()
            if self._ledger[rid]["status"] is not None:
                continue
            if not fleet_alive:
                # no replica left to EVER place on: holding would spin
                # run() forever with an unclassified request — the
                # zero-lost contract demands a loud terminal instead
                self._ledger[rid]["status"] = "failover_retry_exhausted"
                self._terminal_event(
                    rid, "failover_retry_exhausted", reason="no-replica",
                )
                continue
            self._try_place(rid)

    # -- migration + fail-over ----------------------------------------------

    def drain_replica(self, replica_id: str, fault_id: Optional[str] = None,
                      reason: str = "handoff") -> int:
        """Voluntary drain: evacuate every stream on ``replica_id`` as
        wire-format packets and re-admit each on another replica
        (bit-exact resume). Returns the number of migrated streams.
        ``reason="handoff"`` (rebalance / scripted) leaves the replica
        in placement; ``reason="slo"`` parks it ``drained`` until its
        endpoints recover."""
        rep = self.replicas[replica_id]
        packets = rep.drain()
        moved = 0
        for packet in packets:
            rid = packet.request_id
            entry = self._ledger.get(rid)
            if entry is None:
                continue
            # prefer a replica that never served this stream; fall back
            # to any live one (a migrated-out copy may return — the
            # engine accepts a returning rid whose record is terminal
            # `migrated`). Cap-exempt: migration never sheds.
            target_id = self._place_for(
                rid, exclude={replica_id} | entry["served_on"],
                cap_exempt=True,
            ) or self._place_for(rid, exclude={replica_id},
                                 cap_exempt=True)
            if target_id is None:
                entry["status"] = "failover_retry_exhausted"
                self._terminal_event(
                    rid, "failover_retry_exhausted",
                    replica=replica_id, reason="no-target",
                )
                continue
            self.replicas[target_id].admit_handoff(packet)
            entry["replica"] = target_id
            entry["served_on"].add(target_id)
            entry["handoffs"] += 1
            self.migrations += 1
            moved += 1
            self._event(
                "fleet_handoff", request=rid, source=replica_id,
                target=target_id, cls=entry["class"],
                windows_done=packet.entry.get("windows_done"),
                with_state=packet.state_bytes is not None,
            )
        emit_recovery(
            "recovery_router_handoff", site="fleet_router",
            fault_id=fault_id, replica=replica_id, streams=moved,
            reason=reason,
        )
        if reason == "slo":
            self._state[replica_id] = "drained"
        return moved

    def _failover(self, replica_id: str, fault_id: Optional[str] = None
                  ) -> int:
        """Involuntary fail-over: every non-terminal request last placed
        on ``replica_id`` gets a ``replica_lost`` attempt terminal and —
        within ``failover_budget`` — a fresh cap-exempt re-admission
        elsewhere (state died with the replica: restart from window 0,
        accumulators reset, exactly the bounded-retry semantics of the
        lane-fault path one level down)."""
        lost = [
            e for e in self._ledger.values()
            if e["replica"] == replica_id and e["status"] is None
        ]
        recovered = 0
        for entry in lost:
            rid = entry["request_id"]
            self._terminal_event(rid, "replica_lost", replica=replica_id)
            entry["failovers"] += 1
            if entry["failovers"] > self.failover_budget:
                entry["status"] = "failover_retry_exhausted"
                self._terminal_event(
                    rid, "failover_retry_exhausted", replica=replica_id,
                    failovers=entry["failovers"],
                )
                continue
            target_id = self._place_for(
                rid, exclude={replica_id} | entry["served_on"],
                cap_exempt=True,
            ) or self._place_for(rid, exclude={replica_id},
                                 cap_exempt=True)
            if target_id is None:
                entry["status"] = "failover_retry_exhausted"
                self._terminal_event(
                    rid, "failover_retry_exhausted", replica=replica_id,
                    reason="no-target",
                )
                continue
            packet = HandoffPacket({
                "request_id": rid, "path": entry["path"],
                "class": entry["class"], "windows_done": 0,
                "windows_skipped": 0, "acc_sums": {}, "acc_count": 0,
                "retries": 0, "preemptions": 0,
                "handoffs": entry["handoffs"],
            }, None)
            self.replicas[target_id].admit_handoff(packet)
            entry["replica"] = target_id
            entry["served_on"].add(target_id)
            self.failovers += 1
            recovered += 1
            self._event(
                "fleet_failover", request=rid, source=replica_id,
                target=target_id, cls=entry["class"],
                attempt=entry["failovers"],
            )
        emit_recovery(
            "recovery_replica_failover", site="fleet_router",
            fault_id=fault_id, replica=replica_id,
            streams=len(lost), readmitted=recovered,
        )
        return recovered

    # -- chaos enactment (the fleet_router fault site) -----------------------

    def _alive_target(self, arg: float) -> Optional[str]:
        """Map a fault spec's ``arg`` to an alive replica id: the
        BUSIEST one (most live ledger entries — worst-case chaos, and a
        scripted drain/kill never lands vacuously on an idle replica),
        ``arg`` ordering as the tie-break, walked past dead replicas."""
        ids = sorted(self.replicas)
        start = int(arg) % len(ids)
        ranked: List[Tuple[int, int, str]] = []
        for i in range(len(ids)):
            rid = ids[(start + i) % len(ids)]
            if self.replicas[rid].alive and self._state[rid] != "dead":
                live = sum(
                    1 for e in self._ledger.values()
                    if e["replica"] == rid and e["status"] is None
                )
                ranked.append((-live, i, rid))
        if not ranked:
            return None
        return min(ranked)[2]

    def _enact(self, spec) -> None:
        target = self._alive_target(spec.arg)
        if target is None:
            logger.error("fleet fault %s: no alive replica to enact on",
                         spec.fault_id)
            return
        if spec.kind == "router_handoff":
            # deferred until some replica has evacuable streams — a
            # forced drain is only meaningful with something to migrate
            # (_enact_pending_handoffs, called every round + at exit)
            self._pending_handoffs.append(spec)
        elif spec.kind == "replica_kill":
            logger.warning("chaos: killing replica %s (%s)", target,
                           spec.fault_id)
            # NOTE: the router state stays "up" — death is DETECTED by
            # missed heartbeats (_apply_supervision), which owns the
            # dead transition and the fail-over; flipping state here
            # would skip both (the dead-replica streams would strand)
            self.replicas[target].kill()
            self._fault_attrib[target] = spec.fault_id
            self.supervisor.watch(target, None)  # polls now miss
        elif spec.kind == "replica_partition":
            logger.warning("chaos: partitioning replica %s (%s)", target,
                           spec.fault_id)
            self.replicas[target].partition()
            self._fault_attrib[target] = spec.fault_id
            self.supervisor.watch(target, None)

    def _evacuable(self, replica_id: str) -> int:
        """Streams a drain of ``replica_id`` would actually move: bound
        lanes + admission queue (resolved-and-released streams have
        nothing left to migrate)."""
        rep = self.replicas[replica_id]
        if (not rep.alive or rep.engine is None
                or self._state[replica_id] == "dead"):
            return 0
        sched = rep.engine.scheduler
        return sched.occupancy() + sched.queue_depth()

    def _enact_pending_handoffs(self, final: bool = False) -> None:
        """Enact deferred ``router_handoff`` faults on the replica with
        the most evacuable streams; with none anywhere, keep waiting —
        except at loop exit (``final``), where the fault is answered
        with an empty drain (or a bare recovery event when no replica
        survives) so fault -> recovery completeness always holds."""
        still: List = []
        for spec in self._pending_handoffs:
            ranked = sorted(
                ((self._evacuable(rid), rid) for rid in self.replicas),
                reverse=True,
            )
            alive = [
                rid for rid in self.replicas
                if self.replicas[rid].alive and self._state[rid] != "dead"
            ]
            if ranked and ranked[0][0] > 0:
                self.drain_replica(ranked[0][1], fault_id=spec.fault_id)
            elif not final:
                still.append(spec)
            elif alive:
                self.drain_replica(alive[0], fault_id=spec.fault_id)
            else:
                emit_recovery(
                    "recovery_router_handoff", site="fleet_router",
                    fault_id=spec.fault_id, replica=None, streams=0,
                    reason="no-replica",
                )
        self._pending_handoffs = still

    # -- supervision transitions ---------------------------------------------

    def _apply_supervision(self) -> None:
        for rid, rep in self.replicas.items():
            state = self._state[rid]
            if state == "dead":
                continue
            verdict = self.supervisor.verdict(rid)
            if verdict["polls"] > 0 and not verdict["alive"]:
                # missed-heartbeat death: fence a partitioned replica
                # (it may still be serving — it must not, once its
                # streams move), then fail its streams over
                fault_id = self._fault_attrib.pop(rid, None)
                if rep.partitioned and rep.engine is not None:
                    rep.fence()
                    emit_recovery(
                        "recovery_replica_fence", site="fleet_router",
                        fault_id=fault_id, replica=rid,
                        misses=verdict["misses"],
                    )
                self._state[rid] = "dead"
                self.supervisor.unwatch(rid)
                self._event(
                    "fleet_replica_dead", replica=rid,
                    misses=verdict["misses"],
                    error=verdict.get("last_error"),
                )
                self._failover(rid, fault_id=fault_id)
                continue
            burning = (verdict.get("healthy") is False
                       or verdict.get("slo_verdict") == "page")
            if state == "up" and burning and rep.alive:
                # burn-rate 503 (or unhealthy /healthz): voluntary drain
                self._event(
                    "fleet_slo_drain", replica=rid,
                    healthy=verdict.get("healthy"),
                    slo_verdict=verdict.get("slo_verdict"),
                )
                self.drain_replica(rid, reason="slo")
            elif state == "drained" and not burning and rep.alive:
                self._state[rid] = "up"   # recovered: rejoin placement

    # -- the loop ------------------------------------------------------------

    def _collect_terminals(self) -> None:
        for rid, rep in self.replicas.items():
            if rep.engine is None:
                continue
            for req_id, report in rep.poll_terminals():
                entry = self._ledger.get(req_id)
                if entry is None or entry["status"] is not None:
                    continue
                if entry["replica"] != rid:
                    continue  # stale: the request moved on
                entry["status"] = report["status"]
                entry["report"] = report
                entry["handoffs"] = report.get("handoffs",
                                               entry["handoffs"])

    def _work_remaining(self) -> bool:
        if self._held:
            return True
        if any(e["status"] is None for e in self._ledger.values()):
            return True
        return False

    def run(
        self,
        arrivals: Optional[Sequence] = None,
        max_wall_s: Optional[float] = None,
        idle_slice_s: float = 0.005,
        max_rounds: Optional[int] = None,
    ) -> Dict:
        """Drive the fleet until every submitted request (and every
        scheduled arrival) reaches a classified terminal status; returns
        :meth:`summary`. The caller owns the ROUTER's sink (install it
        around this call); each replica writes its own."""
        t_run0 = time.perf_counter()
        todo = deque(sorted(arrivals or [], key=lambda a: a.t))
        while True:
            if max_wall_s is not None and (
                    time.perf_counter() - t_run0) > max_wall_s:
                logger.warning("fleet loop hit max_wall_s=%s", max_wall_s)
                break
            if max_rounds is not None and self.round_idx >= max_rounds:
                break
            rel = time.perf_counter() - t_run0
            while todo and todo[0].t <= rel:
                a = todo.popleft()
                self.submit(
                    a.path, request_class=a.request_class,
                    request_id=getattr(a, "request_id", None),
                )
            self._retry_held()
            for spec in _faults.fire("fleet_router", self.round_idx,
                                     round=self.round_idx):
                self._enact(spec)
            self._enact_pending_handoffs()
            if not self._own_poller:
                self.supervisor.poll_once()
            self._apply_supervision()
            progressed = False
            for rid, rep in self.replicas.items():
                if not rep.alive or self._state[rid] == "dead":
                    continue
                status = rep.pump()
                progressed = progressed or status == "dispatched"
            self._collect_terminals()
            self.round_idx += 1
            if not todo and not self._work_remaining():
                break
            if not progressed and not todo:
                time.sleep(idle_slice_s)
            elif todo and not progressed:
                wait = todo[0].t - (time.perf_counter() - t_run0)
                if wait > 0:
                    time.sleep(min(wait, idle_slice_s))
        # a handoff fault still pending at exit is answered now (empty
        # drain) — fault -> recovery completeness must not depend on
        # traffic having been in flight at the scheduled round
        self._enact_pending_handoffs(final=True)
        # settle any straggler readbacks + terminals on live replicas
        for rid, rep in self.replicas.items():
            if rep.alive and rep.engine is not None:
                rep.flush()
        self._collect_terminals()
        self._run_wall = time.perf_counter() - t_run0
        return self.summary()

    def close(self) -> None:
        """Tear down: supervisor poller stopped, every live replica
        closed gracefully (idempotent)."""
        self.supervisor.stop()
        for rep in self.replicas.values():
            rep.close()

    # -- reports -------------------------------------------------------------

    def report(self, request_id: str) -> Dict:
        """The fleet-level per-request report: the terminal replica's
        engine report plus the router's placement/fail-over history."""
        entry = self._ledger[request_id]
        out = dict(entry["report"] or {})
        out.update({
            "request_id": request_id,
            "status": entry["status"],
            "request_class": entry["class"],
            "replica": entry["replica"],
            "served_on": sorted(entry["served_on"]),
            "failovers": entry["failovers"],
            "handoffs": entry["handoffs"],
        })
        return out

    def reports(self) -> Dict[str, Dict]:
        return {rid: self.report(rid) for rid in sorted(self._ledger)}

    def summary(self) -> Dict:
        """Fleet SLO summary: zero-lost accounting, statuses, sustained
        fleet windows/s, migration/fail-over totals, replica states.
        Percentile detail (per-class p50/p99) comes from the merged
        telemetry files (``python -m esr_tpu_torch.obs report <router.jsonl>
        <replica files...>``) — exactly, not approximately."""
        statuses: Dict[str, int] = {}
        windows = 0
        unfinished = 0
        for entry in self._ledger.values():
            status = entry["status"] or "live"
            statuses[status] = statuses.get(status, 0) + 1
            if entry["status"] is None:
                unfinished += 1
            if entry["report"]:
                windows += int(entry["report"].get("n_windows", 0) or 0)
        wall = self._run_wall
        return {
            "replicas": {
                rid: self._state[rid] for rid in sorted(self.replicas)
            },
            "requests": len(self._ledger),
            "statuses": {k: statuses[k] for k in sorted(statuses)},
            "unfinished": unfinished,
            "zero_lost": unfinished == 0,
            "windows": windows,
            "wall_s": round(wall, 6) if wall else None,
            "windows_per_sec": (
                round(windows / wall, 3) if wall else None
            ),
            "migrations": self.migrations,
            "failovers": self.failovers,
            "sheds": self.sheds,
            "rounds": self.round_idx,
        }
