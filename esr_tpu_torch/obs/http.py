"""Dependency-free HTTP exposition of the live telemetry plane (counterpart
of ``esr_tpu/obs/http.py``).

A ``http.server`` thread serving, over one
:class:`~esr_tpu_torch.obs.aggregate.LiveAggregator`:

- ``/metrics``: Prometheus text format v0.0.4 (counters, gauges, span
  sketches as summaries, per-class window latency, goodput, serving
  totals); label values only from bounded vocabularies (span names,
  request classes);
- ``/healthz``: every registered health source (:func:`register_health_source`;
  the serving tier's lane-quarantine ledger); 200 when all are healthy, 503
  when any is not. A source name may carry an ``@<ns>`` suffix: a server
  built with ``ns=...`` sees only its own sources and the un-suffixed
  process-wide ones, so co-resident replicas cannot 503 each other;
- ``/slo``: the rules of an SLO file evaluated on the aggregator's fast and
  slow trailing windows (60 s and 300 s): both violating 503 (page), one
  429 (warn), neither 200;
- ``/snapshot?window_s=``: the versioned wire document
  (``LiveAggregator.snapshot_wire``) with this replica's health body and
  its ``/slo`` verdict: the one fetch per poll the fleet supervisor and
  fleet view live on.

Handler threads read host state only (the aggregator and the registered
sources); nothing here touches the card. ``port=0`` binds an ephemeral
loopback port, readable at ``server.port``.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

__all__ = [
    "parse_windows_query",
    "register_health_source",
    "unregister_health_source",
    "health_snapshot",
    "LiveTelemetryServer",
    "LivePlane",
    "start_live_plane",
]


# ---------------------------------------------------------------------------
# health registry: components report liveness without knowing who asks.
# The pattern of obs.set_active_sink: process-global, explicit, cheap. Each source is a callable returning a dict with at least
# {"healthy": bool}; a raising source reports unhealthy (never raises
# into the endpoint).

_HEALTH_LOCK = threading.Lock()
_HEALTH_SOURCES: Dict[str, Callable[[], Dict]] = {}


def register_health_source(name: str, fn: Callable[[], Dict]) -> None:
    """Register (or replace) a named component health callable."""
    with _HEALTH_LOCK:
        _HEALTH_SOURCES[name] = fn


def unregister_health_source(name: str) -> None:
    with _HEALTH_LOCK:
        _HEALTH_SOURCES.pop(name, None)


def health_snapshot(ns: Optional[str] = None) -> Tuple[bool, Dict[str, Dict]]:
    """``(all_healthy, {source: detail})`` over every registered source.

    ``ns`` scopes the view for multi-replica processes (the fleet tier):
    source names may carry an ``@<ns>``
    suffix (``serving_lanes@r0``), and a namespaced snapshot sees only
    its own ``@<ns>`` sources plus the un-suffixed process-wide ones —
    replica A's lane quarantine must never flip replica B's ``/healthz``
    to 503 (the router would drain a healthy replica). ``ns=None`` (the
    default, every single-replica process) keeps today's behavior: every
    source, namespaced or not."""
    with _HEALTH_LOCK:
        sources = dict(_HEALTH_SOURCES)
    if ns is not None:
        suffix = "@" + str(ns)
        sources = {
            name: fn for name, fn in sources.items()
            if "@" not in name or name.endswith(suffix)
        }
    out: Dict[str, Dict] = {}
    healthy = True
    for name in sorted(sources):
        try:
            detail = dict(sources[name]())
        except Exception as e:  # noqa: BLE001
            # not silent: the failure IS the health signal — it surfaces
            # as {"healthy": false, "error": ...} in the /healthz body
            # and flips the endpoint to 503
            detail = {"healthy": False, "error": repr(e)}
        detail.setdefault("healthy", True)
        out[name] = detail
        healthy = healthy and bool(detail["healthy"])
    return healthy, out


# ---------------------------------------------------------------------------
# Prometheus text exposition (v0.0.4)

_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _pname(name: str) -> str:
    out = _NAME_SANITIZE.sub("_", str(name))
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _label(value) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n"
    )


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    try:
        return repr(float(v))
    except (TypeError, ValueError):
        return "NaN"


def render_prometheus(snapshot: Dict, prefix: str = "esr") -> str:
    """An aggregator snapshot (``LiveAggregator.snapshot()``) → the
    Prometheus v0.0.4 text page. Pure function."""
    lines = []

    def emit(name, kind, samples, help_=None):
        if help_:
            lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in samples:
            if labels:
                body = ",".join(
                    f'{k}="{_label(v)}"' for k, v in labels.items()
                )
                lines.append(f"{name}{{{body}}} {_fmt(value)}")
            else:
                lines.append(f"{name} {_fmt(value)}")

    emit(f"{prefix}_records_total", "counter",
         [({}, snapshot.get("records", 0))],
         "telemetry records observed by the live aggregator")
    for name, total in snapshot.get("counters", {}).items():
        emit(f"{prefix}_{_pname(name)}_total", "counter", [({}, total)])
    for name, value in snapshot.get("gauges", {}).items():
        emit(f"{prefix}_{_pname(name)}", "gauge", [({}, value)])
    events = snapshot.get("events", {})
    if events:
        emit(f"{prefix}_event_total", "counter",
             [({"event": k}, v) for k, v in sorted(events.items())])
    goodput = snapshot.get("goodput", {})
    emit(f"{prefix}_goodput", "gauge", [({}, goodput.get("value"))],
         "live goodput (attribution-weighted or chunk busy/wall)")
    serving = snapshot.get("serving", {})
    if serving:
        for key in ("requests", "completed", "errors", "windows",
                    "preemptions"):
            emit(f"{prefix}_serving_{key}_total", "counter",
                 [({}, serving.get(key, 0))])
    # span-family sketches as summaries: bounded label vocabulary (span
    # family names are static in the codebase)
    spans = snapshot.get("spans", {})
    if spans:
        name = f"{prefix}_span_seconds"
        lines.append(f"# TYPE {name} summary")
        for fam, rec in sorted(spans.items()):
            for q, key in ((0.5, "p50_ms"), (0.99, "p99_ms")):
                v = rec.get(key)
                v = None if v is None else v / 1e3
                lines.append(
                    f'{name}{{span="{_label(fam)}",quantile="{q}"}} '
                    f"{_fmt(v)}"
                )
            lines.append(
                f'{name}_sum{{span="{_label(fam)}"}} '
                f"{_fmt(rec.get('total_s'))}"
            )
            lines.append(
                f'{name}_count{{span="{_label(fam)}"}} '
                f"{_fmt(rec.get('count'))}"
            )
    # the numerics section: bounded tag vocabulary (the static probe
    # catalog), worst-case per-tag readings
    num = snapshot.get("numerics", {}) or {}
    if num.get("tags"):
        emit(f"{prefix}_numerics_finite_frac", "gauge",
             [({}, num.get("finite_frac"))],
             "worst per-tag finite fraction across the probed tensors")
        emit(f"{prefix}_numerics_nonfinite_total", "counter",
             [({"tag": t}, rec.get("nonfinite"))
              for t, rec in sorted(num["tags"].items())])
        for key in ("max_abs", "finite_frac", "underflow_frac",
                    "overflow_frac"):
            emit(f"{prefix}_numerics_tag_{key}", "gauge",
                 [({"tag": t}, rec.get(key))
                  for t, rec in sorted(num["tags"].items())])
    classes = serving.get("classes", {}) if serving else {}
    if classes:
        name = f"{prefix}_serving_window_latency_seconds"
        lines.append(f"# TYPE {name} summary")
        for cls, rec in sorted(classes.items()):
            for q, key in ((0.5, "window_latency_p50_ms"),
                           (0.99, "window_latency_p99_ms")):
                v = rec.get(key)
                v = None if v is None else v / 1e3
                lines.append(
                    f'{name}{{cls="{_label(cls)}",quantile="{q}"}} '
                    f"{_fmt(v)}"
                )
            lines.append(
                f'{name}_count{{cls="{_label(cls)}"}} '
                f"{_fmt(rec.get('windows'))}"
            )
    return "\n".join(lines) + "\n"


def parse_windows_query(query: str) -> Optional[Tuple[float, ...]]:
    """``window_s=60`` / ``window_s=60,300`` → the explicit trailing
    windows a ``/snapshot`` request asks for; absent/empty → ``None``
    (the server substitutes its burn-rate pair). Raises ``ValueError``
    on junk — the endpoint answers 400, never a torn document."""
    raw = parse_qs(query).get("window_s")
    if not raw:
        return None
    try:
        windows = tuple(
            float(tok) for part in raw for tok in part.split(",") if tok
        )
    except ValueError:
        raise ValueError(
            f"window_s must be comma-separated seconds, got {raw!r}"
        ) from None
    if any(w <= 0 for w in windows):
        raise ValueError(f"window_s values must be > 0, got {raw!r}")
    return windows or None


# ---------------------------------------------------------------------------
# the server


class LiveTelemetryServer:
    """The live plane's HTTP surface over one :class:`LiveAggregator`
    (module docstring). ``start()`` binds and serves on a daemon thread;
    ``close()`` shuts down. Never touches the card."""

    def __init__(
        self,
        aggregator,
        port: int = 0,
        host: str = "127.0.0.1",
        slo_path: Optional[str] = None,
        windows: Tuple[float, float] = (60.0, 300.0),
        ns: Optional[str] = None,
    ):
        self.aggregator = aggregator
        # health-source namespace (fleet tier): /healthz consults only
        # this server's @<ns> sources + the un-suffixed global ones
        self.ns = ns
        self._host = host
        self._want_port = int(port)
        self.slo_path = slo_path
        self._slo = None
        if slo_path is not None:
            from esr_tpu_torch.obs.report import load_slo

            self._slo = load_slo(slo_path)  # fail fast on a broken gate
        if not (len(windows) == 2 and 0 < windows[0] <= windows[1]):
            raise ValueError(
                f"windows must be (fast_s, slow_s) with 0 < fast <= slow, "
                f"got {windows!r}"
            )
        self.windows = (float(windows[0]), float(windows[1]))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- endpoint bodies (pure, testable without sockets) -------------------

    def metrics_page(self) -> str:
        return render_prometheus(self.aggregator.snapshot())

    def healthz_doc(self) -> Tuple[int, Dict]:
        healthy, sources = health_snapshot(ns=self.ns)
        snap = self.aggregator.snapshot()
        doc = {
            "healthy": healthy,
            "uptime_s": snap.get("uptime_s"),
            "records": snap.get("records"),
            "sources": sources,
        }
        return (200 if healthy else 503), doc

    def _eval_window(self, window_s: float) -> Dict:
        """One window's burn verdict — delegated to the SHARED windowed
        semantics (:func:`esr_tpu_torch.obs.report.evaluate_slo_window`: empty
        window = no data; metric absent from the window = skipped as
        missing, not violated; present-but-non-finite still violates) so
        this endpoint and the fleet plane's merged-window evaluation can
        never diverge."""
        from esr_tpu_torch.obs.report import evaluate_slo_window

        return evaluate_slo_window(
            self.aggregator.snapshot(window_s=window_s), self._slo
        )

    def slo_doc(self) -> Tuple[int, Dict]:
        if self._slo is None:
            return 404, {"error": "no SLO file configured (--live-slo / "
                                  "slo_path)"}
        fast_s, slow_s = self.windows
        fast = self._eval_window(fast_s)
        slow = self._eval_window(slow_s)
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

    def snapshot_doc(self, windows: Optional[Tuple[float, ...]] = None
                     ) -> Dict:
        """The ``/snapshot`` body: ONE document carrying
        everything a fleet consumer needs per poll — the versioned wire
        state (cumulative + the requested trailing windows, defaulting
        to this server's burn-rate pair), this replica's health body,
        and its own ``/slo`` verdict — so death detection and the fleet
        merge ride a single HTTP fetch per replica per poll."""
        if windows is None:
            windows = self.windows
        doc = self.aggregator.snapshot_wire(windows=windows)
        doc["replica"] = self.ns
        healthy, sources = health_snapshot(ns=self.ns)
        doc["health"] = {"healthy": healthy, "sources": sources}
        doc["slo_verdict"] = (None if self._slo is None
                              else self.slo_doc()[1]["verdict"])
        return doc

    # -- lifecycle ----------------------------------------------------------

    @property
    def port(self) -> Optional[int]:
        return (self._httpd.server_address[1]
                if self._httpd is not None else None)

    def start(self) -> "LiveTelemetryServer":
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
                parts = urlsplit(self.path)
                path = parts.path.rstrip("/") or "/"
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
                    elif path == "/snapshot":
                        try:
                            windows = parse_windows_query(parts.query)
                        except ValueError as e:
                            self._send(400, json.dumps({"error": str(e)}),
                                       "application/json")
                            return
                        self._send(200,
                                   json.dumps(server.snapshot_doc(windows)),
                                   "application/json")
                    else:
                        self._send(
                            404,
                            json.dumps({"endpoints": [
                                "/metrics", "/healthz", "/slo",
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
            name="obs-live-http",
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


class LivePlane:
    """One attached live plane: aggregator tapped into a sink + the HTTP
    server over it. ``close()`` detaches and shuts down (idempotent)."""

    def __init__(self, sink, aggregator, server: LiveTelemetryServer):
        self.sink = sink
        self.aggregator = aggregator
        self.server = server

    @property
    def port(self) -> Optional[int]:
        return self.server.port

    def close(self) -> None:
        self.server.close()
        if self.sink is not None:
            name = ("numerics" if self.server.ns is None
                    else f"numerics@{self.server.ns}")
            unregister_health_source(name)
            self.aggregator.detach(self.sink)
            self.sink = None


def start_live_plane(
    sink,
    port: int = 0,
    host: str = "127.0.0.1",
    slo_path: Optional[str] = None,
    windows: Tuple[float, float] = (60.0, 300.0),
    rel_err: float = 0.01,
    ns: Optional[str] = None,
) -> LivePlane:
    """The one-call wiring every entry point uses: build a
    :class:`~esr_tpu_torch.obs.aggregate.LiveAggregator`, attach it to ``sink``,
    and serve it. The caller owns ``close()`` (put it in the teardown
    ``finally`` next to the sink's)."""
    from esr_tpu_torch.obs.aggregate import LiveAggregator

    if sink is None:
        raise ValueError(
            "live telemetry requires an active TelemetrySink (the live "
            "plane runs BESIDE the JSONL stream, never instead of it)"
        )
    aggregator = LiveAggregator(rel_err=rel_err).attach(sink)
    # the numerics component health, registered for every live plane as
    # the reference does: /healthz flips to 503 once any probed tag reports
    # non-finite elements; healthy while no probes report
    from esr_tpu_torch.obs.numerics import numerics_health_source

    register_health_source(
        "numerics" if ns is None else f"numerics@{ns}",
        numerics_health_source(aggregator),
    )
    server = LiveTelemetryServer(
        aggregator, port=port, host=host, slo_path=slo_path,
        windows=windows, ns=ns,
    ).start()
    return LivePlane(sink, aggregator, server)
