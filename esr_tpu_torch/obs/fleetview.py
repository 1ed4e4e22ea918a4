"""The fleet view: N replicas' live planes merged into one (counterpart of
``esr_tpu/obs/fleetview.py``).

Sketches merge exactly (merge == concat), so N replicas' accumulation
states, fetched as ``/snapshot`` wire documents, merge into one state that
a single aggregator observing every record would have built.

- :class:`FleetAggregator` merges the documents (pulled with
  :meth:`~FleetAggregator.scrape_once`, or pushed by the
  ``ReplicaSupervisor``'s polls through :meth:`~FleetAggregator.ingest`:
  one fetch per replica per poll serves death detection and the view),
  tracks per-replica staleness and renders merged snapshots in the
  reporter's dotted namespace, so ``configs/slo*.yml`` evaluate them
  unchanged.
- **Staleness, never silence**: a replica that missed ``scrape_budget``
  scrapes in a row, or never gave a parseable document, is marked stale and
  left out of every merge, and the snapshot's ``fleet`` section says so.
- :class:`ScalingPolicy` (``configs/fleet_scale.yml``): the advisory
  ``desired_replicas`` from merged queue depth and per-class p99, with
  hysteresis.
- :class:`FleetTelemetryServer` / :func:`start_fleet_plane`: ``/metrics``,
  ``/healthz`` (quorum), ``/slo`` (merged windows), ``/fleet`` (topology
  and the scaling signal), ``/snapshot`` (the merged state on the wire).

One lock guards the ledger; HTTP fetches run outside it; the optional
scraper is a daemon thread stopped by an Event and a timed join.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from esr_tpu_torch.obs.aggregate import (
    SNAPSHOT_WIRE_VERSION,
    _State,
    _merge_state,
    parse_snapshot_wire,
    render_state,
    state_to_wire,
)
from esr_tpu_torch.obs.http import parse_windows_query, render_prometheus

logger = logging.getLogger(__name__)

__all__ = [
    "http_fetch",
    "SnapshotClient",
    "ScalingPolicy",
    "FleetAggregator",
    "FleetTelemetryServer",
    "FleetPlane",
    "start_fleet_plane",
]


def http_fetch(url: str, timeout_s: float) -> Tuple[int, str]:
    """GET ``url``; returns ``(status, body)`` — an HTTPError IS an
    answer (its status and body come back, 429/503 are valid verdicts).
    Raises on transport failure (connect refused, timeout): the
    heartbeat-miss / staleness signal."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return int(resp.status), resp.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:
        return int(e.code), e.read().decode("utf-8", "replace")


class SnapshotClient:
    """One replica ``/snapshot`` fetch+parse. The error taxonomy is the
    contract: transport failures (``OSError`` family) propagate — the
    replica may be DEAD; a replica that ANSWERS but with a non-200 or an
    unparseable/mis-versioned document raises ``ValueError`` — the
    replica is alive but must never be merged (parse_snapshot_wire's
    loud-rejection rule)."""

    def __init__(self, timeout_s: float = 1.0, fetch=None):
        self.timeout_s = float(timeout_s)
        self._fetch = fetch if fetch is not None else http_fetch

    def fetch(self, url: str) -> Tuple[Dict, int]:
        """Returns ``(parsed_snapshot, wire_bytes)``."""
        status, body = self._fetch(url, self.timeout_s)
        if status != 200:
            raise ValueError(
                f"snapshot endpoint answered {status}, not 200"
            )
        return parse_snapshot_wire(json.loads(body)), len(body)


# ---------------------------------------------------------------------------
# the advisory scaling signal


class ScalingPolicy:
    """Inputs of the ``desired_replicas`` formula:

    ``raw = clamp(max(min_replicas, ceil(queue_total /
    target_queue_per_replica), healthy + 1 if burning), min..max)``

    where *burning* means any fresh replica's own ``/slo`` verdict is
    "page" or any merged fast-window class p99 exceeds its
    ``class_p99_target_ms`` entry. The advice only MOVES after
    ``hold_polls`` consecutive polls agree on the same new value
    (hysteresis — a one-poll queue spike must not flap the fleet)."""

    __slots__ = ("target_queue_per_replica", "min_replicas",
                 "max_replicas", "hold_polls", "class_p99_target_ms")

    def __init__(
        self,
        target_queue_per_replica: float = 8.0,
        min_replicas: int = 1,
        max_replicas: int = 8,
        hold_polls: int = 2,
        class_p99_target_ms: Optional[Dict[str, float]] = None,
    ):
        if target_queue_per_replica <= 0:
            raise ValueError(
                f"target_queue_per_replica must be > 0, got "
                f"{target_queue_per_replica}"
            )
        if not 1 <= int(min_replicas) <= int(max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}"
            )
        if hold_polls < 1:
            raise ValueError(f"hold_polls must be >= 1, got {hold_polls}")
        self.target_queue_per_replica = float(target_queue_per_replica)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.hold_polls = int(hold_polls)
        self.class_p99_target_ms = {
            str(k): float(v)
            for k, v in (class_p99_target_ms or {}).items()
        }

    @classmethod
    def from_yaml(cls, path: str) -> "ScalingPolicy":
        """Load ``configs/fleet_scale.yml`` (schema 1) with the port's YAML
        reader. Fail fast on an unknown schema — a misread policy silently
        scaling a fleet is the exact failure mode the wire version check
        exists for."""
        from esr_tpu_torch.config.parser import loads

        with open(path) as f:
            doc = loads(f.read(), path) or {}
        if doc.get("schema") != 1:
            raise ValueError(
                f"unsupported fleet_scale schema {doc.get('schema')!r} "
                f"in {path} (supported: 1)"
            )
        return cls(
            target_queue_per_replica=doc.get(
                "target_queue_per_replica", 8.0),
            min_replicas=doc.get("min_replicas", 1),
            max_replicas=doc.get("max_replicas", 8),
            hold_polls=doc.get("hold_polls", 2),
            class_p99_target_ms=doc.get("class_p99_target_ms"),
        )


# ---------------------------------------------------------------------------
# the merger


def _fresh_row(row: Dict, scrape_budget: int) -> Tuple[bool, Optional[str]]:
    """(fresh?, exclusion reason). Fresh = has a parseable document and
    is within its scrape budget; the budget tolerates transient misses
    by merging the LAST GOOD document until the budget runs out."""
    if row["doc"] is None:
        return False, ("never_scraped" if row["scrapes"] == 0
                       else "no_parseable_snapshot")
    if row["misses"] >= scrape_budget:
        return False, "scrape_budget_exhausted"
    return True, None


class FleetAggregator:
    """Merged live rollups over N replica ``/snapshot`` documents plus
    any locally-attached aggregators (the router's own ledger records —
    handoffs, sheds, fail-over terminals — join the merge through
    :meth:`attach_local`, so fleet totals classify every journey
    segment).

    Feed it either way (the ledger semantics are identical):

    - :meth:`scrape_once` — pull mode: fetch every watched URL itself
      (fetches outside the lock);
    - :meth:`ingest` — push mode: the ``ReplicaSupervisor`` hands over
      each poll's parsed document (or ``None`` for a miss), so one HTTP
      fetch per replica per poll serves BOTH death detection and the
      fleet view.

    Staleness (module docstring): ``misses >= scrape_budget`` or no
    parseable document ever → excluded from every merge, annotated on
    ``snapshot()['fleet']['excluded']``, never silently merged.
    """

    def __init__(
        self,
        rel_err: float = 0.01,
        windows: Tuple[float, float] = (60.0, 300.0),
        scrape_budget: int = 3,
        timeout_s: float = 1.0,
        fetch=None,
        policy: Optional[ScalingPolicy] = None,
    ):
        if scrape_budget < 1:
            raise ValueError(
                f"scrape_budget must be >= 1, got {scrape_budget}")
        if not (len(windows) == 2 and 0 < windows[0] <= windows[1]):
            raise ValueError(
                f"windows must be (fast_s, slow_s) with 0 < fast <= slow, "
                f"got {windows!r}"
            )
        self.rel_err = float(rel_err)
        self.windows = (float(windows[0]), float(windows[1]))
        self.scrape_budget = int(scrape_budget)
        self.policy = policy if policy is not None else ScalingPolicy()
        self._client = SnapshotClient(timeout_s=timeout_s, fetch=fetch)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._targets: Dict[str, Optional[str]] = {}
        self._ledger: Dict[str, Dict] = {}
        self._locals: Dict[str, object] = {}
        # scaling-signal hysteresis state (one tick per covered round)
        self._round_seen: set = set()
        self._signal: Dict = {
            "desired_replicas": None, "raw": None, "healthy": 0,
            "queue_depth": 0.0, "page": False, "classes_over": [],
            "pending": None, "pending_polls": 0, "ticks": 0,
        }

    # -- watch list ----------------------------------------------------------

    def _new_row(self, url: Optional[str]) -> Dict:
        return {
            "url": url, "scrapes": 0, "misses": 0, "doc": None,
            "wire_bytes": None, "uptime_s": None, "healthy": None,
            "slo_verdict": None, "last_error": None,
        }

    def watch(self, replica_id: str, snapshot_url: Optional[str]) -> None:
        """Watch (or re-point) one replica's ``/snapshot`` URL. ``None``
        keeps the replica ON the ledger with no endpoint — every scrape
        misses, so it goes stale on budget (the fenced/killed-replica
        path)."""
        with self._lock:
            self._targets[replica_id] = snapshot_url
            row = self._ledger.setdefault(
                replica_id, self._new_row(snapshot_url))
            row["url"] = snapshot_url

    def unwatch(self, replica_id: str) -> None:
        with self._lock:
            self._targets.pop(replica_id, None)
            self._ledger.pop(replica_id, None)
            self._round_seen.discard(replica_id)

    def attach_local(self, name: str, aggregator) -> None:
        """A same-process :class:`LiveAggregator` that joins every merge
        directly (no wire, never stale) — the router's ledger stream."""
        with self._lock:
            self._locals[name] = aggregator

    # -- feeding -------------------------------------------------------------

    def ingest(self, replica_id: str, parsed: Optional[Dict],
               wire_bytes: Optional[int] = None,
               error: Optional[str] = None,
               unusable: bool = False) -> None:
        """Record one poll's outcome for ``replica_id``: a parsed
        snapshot document (``parse_snapshot_wire`` output), or ``None``
        for a miss (transport failure — the last GOOD document keeps
        merging until the scrape budget runs out) or, with
        ``unusable=True``, an answered-but-unparseable reply whose
        stored document can no longer be trusted as "last good". A
        mis-matched ``rel_err`` is rejected loudly here (merging it
        would silently void the quantile guarantee)."""
        if parsed is not None and abs(
                parsed["rel_err"] - self.rel_err) > 1e-12:
            error = (f"snapshot rel_err {parsed['rel_err']} != fleet "
                     f"{self.rel_err} — refusing to merge")
            logger.warning("fleetview: %s: %s", replica_id, error)
            parsed = None
            unusable = True
        with self._lock:
            row = self._ledger.setdefault(
                replica_id, self._new_row(self._targets.get(replica_id)))
            row["scrapes"] += 1
            if parsed is None:
                row["misses"] += 1
                row["last_error"] = error
                if unusable:
                    row["doc"] = None
            else:
                row["misses"] = 0
                row["doc"] = parsed
                row["wire_bytes"] = wire_bytes
                row["uptime_s"] = parsed.get("uptime_s")
                health = parsed.get("health") or {}
                row["healthy"] = bool(health.get("healthy", False))
                row["slo_verdict"] = parsed.get("slo_verdict")
                row["last_error"] = None
            self._round_seen.add(replica_id)
            # a poll round is COMPLETE once it covered every watched
            # replica that could still answer — a budget-exhausted
            # (stale) replica must not stall the signal forever: its
            # push-mode feeder (the supervisor) unwatches dead replicas,
            # so it would never be "seen" again
            blocking = set()
            for rid in self._targets:
                other = self._ledger.get(rid)
                if (other is None or other["scrapes"] == 0
                        or other["misses"] < self.scrape_budget):
                    blocking.add(rid)
            if self._round_seen >= blocking:
                self._round_seen.clear()
                self._tick_signal_locked()

    def scrape_once(self) -> Dict[str, bool]:
        """Pull mode: one scrape pass over every watched replica
        (fetches OUTSIDE the lock). Returns ``{replica_id: fresh_doc?}``.
        The scrape URL pins this fleet's windows via ``?window_s=`` so
        merged-window evaluation never depends on replica defaults."""
        with self._lock:
            targets = dict(self._targets)
        qs = "window_s=" + ",".join(str(w) for w in self.windows)
        results: Dict[str, bool] = {}
        for rid, url in targets.items():
            parsed, nbytes, error, unusable = None, None, None, False
            if url is None:
                error = "no endpoint (replica down)"
            else:
                sep = "&" if "?" in url else "?"
                try:
                    parsed, nbytes = self._client.fetch(f"{url}{sep}{qs}")
                except ValueError as e:
                    # answered, unusable: alive but never merged
                    error, unusable = str(e), True
                except Exception as e:  # noqa: BLE001
                    # invariant: transport failure IS the staleness
                    # signal — recorded on the ledger by the ingest
                    # below, surfaced on /fleet (never swallowed)
                    error = repr(e)
            self.ingest(rid, parsed, wire_bytes=nbytes, error=error,
                        unusable=unusable)
            results[rid] = parsed is not None
        return results

    # -- the merged view -----------------------------------------------------

    def _window_state(self, parsed: Dict, window_s: Optional[float],
                      rid: str) -> _State:
        if window_s is None:
            return parsed["state"]
        st = parsed["windows"].get(float(window_s))
        if st is None:
            raise ValueError(
                f"replica {rid!r} snapshot carries windows "
                f"{sorted(parsed['windows'])}, not {window_s} — scrape "
                f"with ?window_s= matching the fleet windows"
            )
        return st

    def merged_state(self, window_s: Optional[float] = None
                     ) -> Tuple[_State, List[str], Dict[str, str]]:
        """Merge every FRESH replica document (+ locals) for the
        cumulative view or one trailing window. Returns
        ``(state, merged_ids, excluded)`` where ``excluded`` maps stale
        replica ids to their exclusion reason — callers must surface it
        (the never-silently-merged rule)."""
        # local states first, OUTSIDE our lock (each local aggregator
        # has its own lock; never nest them)
        with self._lock:
            locals_now = dict(self._locals)
        local_states = {
            name: agg.merged_state(window_s)
            for name, agg in locals_now.items()
        }
        merged = _State(self.rel_err)
        merged_ids: List[str] = []
        excluded: Dict[str, str] = {}
        with self._lock:
            for rid in sorted(self._ledger):
                row = self._ledger[rid]
                fresh, reason = _fresh_row(row, self.scrape_budget)
                if not fresh:
                    excluded[rid] = reason
                    continue
                _merge_state(
                    merged, self._window_state(row["doc"], window_s, rid))
                merged_ids.append(rid)
        for name in sorted(local_states):
            _merge_state(merged, local_states[name])
            merged_ids.append(f"local:{name}")
        return merged, merged_ids, excluded

    def snapshot(self, window_s: Optional[float] = None) -> Dict:
        """The MERGED report-shaped rollup (``render_state`` — the same
        renderer as a replica snapshot, so ``configs/slo*.yml`` dots in
        unchanged) plus a ``fleet`` section: who merged, who was
        excluded and why, the per-replica table, the scaling signal."""
        st, merged_ids, excluded = self.merged_state(window_s)
        snap = render_state(
            st, window_s=window_s,
            uptime_s=round(time.monotonic() - self._t0, 3),
            rel_err=self.rel_err,
        )
        snap["fleet"] = {
            "merged": merged_ids,
            "excluded": excluded,
            "replicas": self.replica_table(),
            "scaling": self.scaling_signal(),
        }
        return snap

    def snapshot_wire(self, windows: Iterable[float] = ()) -> Dict:
        """The fleet's own MERGED state as the same versioned wire
        document a replica serves — fleet views compose: a higher-level
        aggregator scrapes this fleet's ``/snapshot`` exactly like a
        replica's (exclusions still surface on ``/fleet``, never inside
        the wire doc)."""
        cum, _ids, _exc = self.merged_state(None)
        return {
            "version": SNAPSHOT_WIRE_VERSION,
            "rel_err": self.rel_err,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "state": state_to_wire(cum),
            "window_states": {
                str(float(w)): state_to_wire(self.merged_state(float(w))[0])
                for w in windows
            },
        }

    def replica_table(self) -> Dict[str, Dict]:
        """Per-replica supervision/merge status: health, staleness (with
        reason), scrape ledger, queue depth + lane occupancy (the
        engine's per-round gauges, read from the replica's own cumulative
        state), wire bytes of the last snapshot."""
        with self._lock:
            out: Dict[str, Dict] = {}
            for rid in sorted(self._ledger):
                row = self._ledger[rid]
                fresh, reason = _fresh_row(row, self.scrape_budget)
                gauges = (row["doc"]["state"].gauges
                          if row["doc"] is not None else {})
                out[rid] = {
                    "url": row["url"],
                    "healthy": row["healthy"],
                    "slo_verdict": row["slo_verdict"],
                    "stale": not fresh,
                    "stale_reason": reason,
                    "scrapes": row["scrapes"],
                    "misses": row["misses"],
                    "last_error": row["last_error"],
                    "uptime_s": row["uptime_s"],
                    "wire_bytes": row["wire_bytes"],
                    "queue_depth": gauges.get("serve_queue_depth"),
                    "lane_occupancy": gauges.get("serve_lane_occupancy"),
                }
            return out

    def quorum_stats(self) -> Dict:
        """Healthy-replica fraction over the WATCHED set (locals are the
        router's own process — not quorum members)."""
        with self._lock:
            watched = len(self._targets)
            fresh_healthy = 0
            fresh = 0
            for rid in self._targets:
                row = self._ledger.get(rid)
                if row is None:
                    continue
                ok, _ = _fresh_row(row, self.scrape_budget)
                if ok:
                    fresh += 1
                    if row["healthy"]:
                        fresh_healthy += 1
        return {
            "watched": watched,
            "fresh": fresh,
            "healthy": fresh_healthy,
            "fraction": (round(fresh_healthy / watched, 6)
                         if watched else None),
        }

    # -- the scaling signal --------------------------------------------------

    def _tick_signal_locked(self) -> None:
        """One hysteresis step (ScalingPolicy docstring), taken each
        time a poll round has covered every watched replica. Lock held
        by the caller; pure dict/sketch math, no IO."""
        policy = self.policy
        healthy = 0
        queue_total = 0.0
        page = False
        fast_states: List[_State] = []
        for rid in self._targets:
            row = self._ledger.get(rid)
            if row is None:
                continue
            fresh, _ = _fresh_row(row, self.scrape_budget)
            if not fresh:
                continue
            if row["healthy"]:
                healthy += 1
            if row["slo_verdict"] == "page":
                page = True
            gauges = row["doc"]["state"].gauges
            try:
                queue_total += float(gauges.get("serve_queue_depth") or 0)
            except (TypeError, ValueError):
                pass
            fast = row["doc"]["windows"].get(self.windows[0])
            if fast is not None:
                fast_states.append(fast)
        classes_over: List[str] = []
        if policy.class_p99_target_ms and fast_states:
            merged = _State(self.rel_err)
            for st in fast_states:
                _merge_state(merged, st)
            for cls, target_ms in sorted(
                    policy.class_p99_target_ms.items()):
                sk = merged.class_lat.get(cls)
                if sk is None or sk.count == 0:
                    continue
                p99 = sk.quantile(99)
                if p99 is not None and p99 * 1e3 > target_ms:
                    classes_over.append(cls)
        burning = page or bool(classes_over)
        raw = max(
            policy.min_replicas,
            int(math.ceil(queue_total / policy.target_queue_per_replica)),
        )
        if burning:
            raw = max(raw, healthy + 1)
        raw = max(policy.min_replicas, min(policy.max_replicas, raw))
        sig = self._signal
        sig.update(raw=raw, healthy=healthy,
                   queue_depth=round(queue_total, 6), page=page,
                   classes_over=classes_over, ticks=sig["ticks"] + 1)
        if sig["desired_replicas"] is None:
            # first covered round: the advice has to start somewhere
            sig.update(desired_replicas=raw, pending=None,
                       pending_polls=0)
        elif raw == sig["desired_replicas"]:
            sig.update(pending=None, pending_polls=0)
        else:
            if raw == sig["pending"]:
                sig["pending_polls"] += 1
            else:
                sig.update(pending=raw, pending_polls=1)
            if sig["pending_polls"] >= policy.hold_polls:
                sig.update(desired_replicas=raw, pending=None,
                           pending_polls=0)

    def scaling_signal(self) -> Dict:
        with self._lock:
            return dict(self._signal)


# ---------------------------------------------------------------------------
# the fleet HTTP surface


def fleet_metrics_block(table: Dict[str, Dict], signal: Dict,
                        quorum: Dict, prefix: str = "esr_fleet") -> str:
    """The per-replica + signal Prometheus block appended to the merged
    exposition. The ``replica`` label vocabulary is the WATCHED fleet
    ledger — bounded by fleet configuration, never per-request."""
    def fmt(v) -> str:
        if v is None:
            return "NaN"
        if isinstance(v, bool):
            return "1" if v else "0"
        return repr(float(v))

    lines: List[str] = []
    for name, key in (("up", "healthy"), ("stale", "stale"),
                      ("queue_depth", "queue_depth"),
                      ("lane_occupancy", "lane_occupancy"),
                      ("scrape_misses", "misses"),
                      ("snapshot_bytes", "wire_bytes")):
        metric = f"{prefix}_replica_{name}"
        lines.append(f"# TYPE {metric} gauge")
        for rid in sorted(table):
            lines.append(
                f'{metric}{{replica="{rid}"}} {fmt(table[rid].get(key))}'
            )
    lines.append(f"# TYPE {prefix}_replicas_watched gauge")
    lines.append(f"{prefix}_replicas_watched {fmt(quorum.get('watched'))}")
    lines.append(f"# TYPE {prefix}_replicas_healthy gauge")
    lines.append(f"{prefix}_replicas_healthy {fmt(quorum.get('healthy'))}")
    lines.append(f"# HELP {prefix}_desired_replicas advisory scaling "
                 f"signal (queue + burn, with hysteresis)")
    lines.append(f"# TYPE {prefix}_desired_replicas gauge")
    lines.append(f"{prefix}_desired_replicas "
                 f"{fmt(signal.get('desired_replicas'))}")
    return "\n".join(lines) + "\n"


class FleetTelemetryServer:
    """The fleet plane's HTTP surface over one :class:`FleetAggregator`
    (module docstring): ``/metrics``, ``/healthz`` (quorum), ``/slo``
    (merged multi-window burn), ``/fleet`` (topology + scaling signal),
    ``/snapshot`` (the MERGED state in the replica wire format — fleet
    views compose). Same lifecycle and handler discipline as the
    per-replica ``LiveTelemetryServer``."""

    def __init__(
        self,
        fleet: FleetAggregator,
        port: int = 0,
        host: str = "127.0.0.1",
        slo_path: Optional[str] = None,
        quorum: float = 0.5,
        topology: Optional[Callable[[], Dict]] = None,
    ):
        if not 0.0 < quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1], got {quorum}")
        self.fleet = fleet
        self.quorum = float(quorum)
        self._topology = topology
        self._host = host
        self._want_port = int(port)
        self.slo_path = slo_path
        self._slo = None
        if slo_path is not None:
            from esr_tpu_torch.obs.report import load_slo

            self._slo = load_slo(slo_path)  # fail fast on a broken gate
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- endpoint bodies (pure, testable without sockets) -------------------

    def metrics_page(self) -> str:
        merged = render_prometheus(self.fleet.snapshot(),
                                   prefix="esr_fleet")
        block = fleet_metrics_block(
            self.fleet.replica_table(), self.fleet.scaling_signal(),
            self.fleet.quorum_stats(),
        )
        return merged + block

    def healthz_doc(self) -> Tuple[int, Dict]:
        """Quorum health: 200 while at least ``quorum`` of the watched
        replicas are FRESH and healthy (an empty watch list has no
        quorum to claim)."""
        stats = self.fleet.quorum_stats()
        frac = stats["fraction"]
        ok = frac is not None and frac >= self.quorum
        doc = {
            "healthy": ok,
            "quorum": self.quorum,
            "watched": stats["watched"],
            "fresh": stats["fresh"],
            "healthy_replicas": stats["healthy"],
            "fraction": frac,
            "replicas": {
                rid: {"healthy": row["healthy"], "stale": row["stale"]}
                for rid, row in self.fleet.replica_table().items()
            },
        }
        return (200 if ok else 503), doc

    def slo_doc(self) -> Tuple[int, Dict]:
        """Multi-window burn over MERGED windows — the per-replica
        ``/slo`` contract verbatim (same shared window semantics, same
        verdict mapping), just evaluated on fleet-merged snapshots."""
        if self._slo is None:
            return 404, {"error": "no SLO file configured (slo_path)"}
        from esr_tpu_torch.obs.report import evaluate_slo_window

        fast_s, slow_s = self.fleet.windows
        fast = evaluate_slo_window(
            self.fleet.snapshot(window_s=fast_s), self._slo)
        slow = evaluate_slo_window(
            self.fleet.snapshot(window_s=slow_s), self._slo)
        if not fast["ok"] and not slow["ok"]:
            status, verdict = 503, "page"       # sustained burn
        elif not (fast["ok"] and slow["ok"]):
            status, verdict = 429, "warn"       # spike or recovering
        else:
            status, verdict = 200, "ok"
        return status, {
            "verdict": verdict,
            "slo": self.slo_path,
            "windows_s": [fast_s, slow_s],
            "fast": fast,
            "slow": slow,
        }

    def fleet_doc(self) -> Dict:
        """The topology/autoscaler document: per-replica health + queue
        + staleness, who merged, quorum, the scaling signal, optional
        ring ownership from the router."""
        table = self.fleet.replica_table()
        _st, merged_ids, excluded = self.fleet.merged_state(None)
        doc = {
            "replicas": table,
            "merged": merged_ids,
            "excluded": excluded,
            "quorum": {"threshold": self.quorum,
                       **self.fleet.quorum_stats()},
            "scaling": self.fleet.scaling_signal(),
            "windows_s": list(self.fleet.windows),
        }
        if self._topology is not None:
            try:
                doc["topology"] = self._topology()
            except Exception as e:
                # a router mid-teardown must not take /fleet down with it
                doc["topology"] = {"error": repr(e)}
        return doc

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        return (self._httpd.server_address[1]
                if self._httpd is not None else None)

    def start(self) -> "FleetTelemetryServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, status: int, body: str, ctype: str) -> None:
                payload = body.encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                parts = self.path.split("?", 1)
                path = parts[0].rstrip("/") or "/"
                query = parts[1] if len(parts) > 1 else ""
                try:
                    if path == "/metrics":
                        self._send(
                            200, server.metrics_page(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/healthz":
                        status, doc = server.healthz_doc()
                        self._send(status, json.dumps(doc, indent=2),
                                   "application/json")
                    elif path == "/slo":
                        status, doc = server.slo_doc()
                        self._send(status, json.dumps(doc, indent=2),
                                   "application/json")
                    elif path == "/fleet":
                        self._send(200,
                                   json.dumps(server.fleet_doc(), indent=2),
                                   "application/json")
                    elif path == "/snapshot":
                        try:
                            windows = parse_windows_query(query)
                        except ValueError as e:
                            self._send(400, json.dumps({"error": str(e)}),
                                       "application/json")
                            return
                        if windows is None:
                            windows = server.fleet.windows
                        self._send(
                            200,
                            json.dumps(
                                server.fleet.snapshot_wire(windows)),
                            "application/json",
                        )
                    else:
                        self._send(
                            404,
                            json.dumps({"endpoints": [
                                "/metrics", "/healthz", "/slo", "/fleet",
                                "/snapshot"]}),
                            "application/json",
                        )
                except Exception as e:  # noqa: BLE001 - endpoint must answer
                    self._send(500, json.dumps({"error": repr(e)}),
                               "application/json")

        self._httpd = ThreadingHTTPServer(
            (self._host, self._want_port), Handler
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            daemon=True,
            name="obs-fleet-http",
        )
        self._thread.start()
        return self

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class FleetPlane:
    """One running fleet view: aggregator + HTTP server + the optional
    scraper daemon. ``close()`` stops scraper then server (idempotent)."""

    def __init__(self, fleet: FleetAggregator,
                 server: FleetTelemetryServer):
        self.fleet = fleet
        self.server = server
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self.server.port

    def close(self) -> None:
        self.server.close()


def start_fleet_plane(
    replicas: Iterable = (),
    port: int = 0,
    host: str = "127.0.0.1",
    slo_path: Optional[str] = None,
    windows: Tuple[float, float] = (60.0, 300.0),
    rel_err: float = 0.01,
    scrape_budget: int = 3,
    quorum: float = 0.5,
    policy: Optional[ScalingPolicy] = None,
    topology: Optional[Callable[[], Dict]] = None,
    fleet: Optional[FleetAggregator] = None,
) -> FleetPlane:
    """The one-call wiring for the fleet view: build (or adopt) a
    :class:`FleetAggregator`, watch every replica's ``/snapshot``
    (``replicas`` are ``serving.Replica``-shaped: ``.replica_id`` +
    ``.url(endpoint)``), serve it, and optionally start the pull-mode
    scraper. The caller owns ``close()`` — put it in the teardown
    ``finally`` next to the router's."""
    if fleet is None:
        fleet = FleetAggregator(
            rel_err=rel_err, windows=windows,
            scrape_budget=scrape_budget, policy=policy,
        )
    for rep in replicas:
        fleet.watch(rep.replica_id, rep.url("snapshot"))
    server = FleetTelemetryServer(
        fleet, port=port, host=host, slo_path=slo_path,
        quorum=quorum, topology=topology,
    ).start()
    return FleetPlane(fleet, server)
