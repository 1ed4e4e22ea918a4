"""Offline run rollup and SLO gate over telemetry files (counterpart of
``esr_tpu/obs/report.py``, the functions the serving fleet needs, and of
``esr_tpu/obs/export.py:read_telemetry``).

``python -m esr_tpu_torch.obs report telemetry.jsonl [more.jsonl ...]
[--slo configs/slo.yml]`` turns the JSONL stream into one verdict. The
report's sections (always present, empty-but-typed when the run had no such
activity): ``goodput`` (serving or inference chunk busy time over the chunk
wall), ``spans`` (per span name: count, total, p50/p99/max ms),
``counters``, ``events``, ``serving`` (requests, statuses, windows, per
class window-latency p50/p99 from ``serve_chunk_part`` spans), ``traces``
(is every ``serve_request_done`` connected to its ``serve_request`` root?),
``faults`` (every ``fault_injected`` matched to a ``recovery_*`` event) and
``numerics`` (empty in the port: it has no probe plane).

Several files (a fleet's router and replica files) merge into one fleet
rollup with a per-replica ``replicas`` section. An SLO file is a mapping
with a ``rules:`` list of ``{name, metric (dotted path), min and/or max,
allow_missing}``; exit codes: 0 every rule passed, 1 a violation, 2 an
unreadable input or SLO file. SLO files are read by the port's own YAML
reader (``config/parser.py``).

:func:`percentile` is the one percentile definition of the port's serving
summaries, this reporter and the live aggregator.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from esr_tpu_torch.obs import numerics as _numerics


__all__ = [
    "percentile",
    "percentile_ms",
    "build_report",
    "load_slo",
    "evaluate_slo",
    "evaluate_slo_window",
    "report_file",
    "split_label",
    "merge_fleet_reports",
    "report_files",
    "read_telemetry",
]


def read_telemetry(
    path: str, run_index: int = -1
) -> Tuple[Optional[Dict], List[Dict], int]:
    """Parse one telemetry.jsonl → ``(manifest, records, torn_lines)``.

    - the manifest is the run's ``type: "manifest"`` header record (None
      for a file that lost its header — still readable);
    - **appended multi-run files return ONE run** (``run_index``, default
      ``-1`` = the last — today's pinned behavior): the sink opens its
      file in append mode, and every run's ``t``/``begin`` axis restarts
      at zero — merging two runs would overlay their timelines (inflating
      the reporter's serving wall and drawing two runs on top of each
      other). Each manifest record starts a fresh segment;
      ``run_index`` selects among them (negative indices count from the
      end, list-style), and an out-of-range index raises ``ValueError``
      naming how many runs the file holds — plumbed through
      ``obs report --run-index`` so earlier
      runs stay reachable;
    - v1 files (``schema_version: 1``, spans without trace fields) come
      back as-is; consumers treat missing trace fields as "unlinked";
    - unparseable lines are skipped and counted (``torn_lines``): a
      SIGKILL mid-write tears at most the final line because every record
      is flushed as it is written (obs/sink.py).
    """
    # Streaming with bounded retention: only segments still REACHABLE by
    # the requested index keep their parsed records (the last |run_index|
    # for a negative index — one for the default -1, matching the old
    # last-run-wins memory profile on arbitrarily long appended files;
    # exactly the target segment for a non-negative index). Every other
    # segment is parsed only enough to be counted.
    keep_last = None if run_index >= 0 else -run_index
    # (ordinal, manifest, records, torn) for retained segments only
    segments: List[Tuple[int, Optional[Dict], List[Dict], int]] = []
    ordinal = -1  # index of the open segment; -1 = none opened yet
    manifest: Optional[Dict] = None
    records: List[Dict] = []
    torn = 0

    def _keep(idx: int) -> bool:
        return keep_last is not None or idx == run_index

    def _close_open() -> None:
        if ordinal < 0:
            return
        if _keep(ordinal):
            segments.append((ordinal, manifest, records, torn))
            if keep_last is not None and len(segments) > keep_last:
                segments.pop(0)

    # errors="replace": a SIGKILL can tear the final line mid-multibyte
    # character; strict decoding would raise UnicodeDecodeError before
    # json.loads ever ran, breaking the crash-safe contract — replacement
    # chars make the torn line fail JSON parsing and count as torn
    with open(path, errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                rec = None
            if rec is not None and (
                not isinstance(rec, dict) or "type" not in rec
            ):
                rec = None
            if rec is not None and rec["type"] == "manifest":
                # a new run appended to the same file: close the previous
                # segment (headerless leading records form their own)
                _close_open()
                ordinal += 1
                manifest, records, torn = rec, [], 0
                continue
            if ordinal < 0:
                ordinal = 0  # headerless leading lines open segment 0
                manifest, records, torn = None, [], 0
            if rec is None:
                torn += 1
            elif _keep(ordinal):
                records.append(rec)
    _close_open()
    total = ordinal + 1
    if total == 0:
        return None, [], 0  # empty file: the pinned pre-multi-run shape
    actual = run_index if run_index >= 0 else total + run_index
    if not 0 <= actual < total:
        raise ValueError(
            f"run_index {run_index} out of range: {path!r} holds "
            f"{total} run(s)"
        )
    for idx, man, recs, torn_n in segments:
        if idx == actual:
            return man, recs, torn_n
    raise AssertionError("retained segment lookup cannot miss")


def _span_edges(rec: Dict) -> Tuple[float, float]:
    """(begin, end) seconds on the sink's ``t`` axis. v2 spans carry the
    edges; v1 spans end at their record time ``t``."""
    seconds = float(rec.get("seconds", 0.0) or 0.0)
    if rec.get("begin") is not None and rec.get("end") is not None:
        return float(rec["begin"]), float(rec["end"])
    t = float(rec.get("t", 0.0))
    return t - seconds, t


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0..100) with linear interpolation between
    order statistics — numpy.percentile's default method, implemented
    stdlib-only and pinned against numpy in tests.

    THE percentile definition of the whole telemetry surface: the offline
    reporter, ``ServingEngine.report``/``summary`` (the live per-request
    numbers), and the live aggregator's sketch interpolation all route
    through this method so the three views can never drift on percentile
    convention (the ``np.percentile``-vs-pure-python split this PR
    removed)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    rank = (q / 100.0) * (len(vals) - 1)
    lo = int(math.floor(rank))
    hi = int(math.ceil(rank))
    if lo == hi:
        return vals[lo]
    frac = rank - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def percentile_ms(
    values_s: Sequence[float], q: float, ndigits: int = 3
) -> Optional[float]:
    """:func:`percentile` over seconds, reported in rounded milliseconds —
    the shared seconds→ms convention of the serving summaries and the
    reporter's span tables."""
    p = percentile(values_s, q)
    return None if p is None else round(p * 1e3, ndigits)


def _pctl_ms(lat_s: Sequence[float]) -> Dict[str, Optional[float]]:
    return {
        "p50_ms": _round(percentile(lat_s, 50), 1e3),
        "p99_ms": _round(percentile(lat_s, 99), 1e3),
        "max_ms": _round(max(lat_s) if lat_s else None, 1e3),
    }


def _round(v: Optional[float], scale: float = 1.0) -> Optional[float]:
    return None if v is None else round(v * scale, 4)


# the terminal event a complete request trace must hang off of
_REQUEST_TERMINAL = "serve_request_done"

# terminal statuses that legitimately have NO journey root in the file
# that carries them: `shed` never had a journey; `replica_lost` and
# `failover_retry_exhausted` are ROUTER-emitted (the journey spans live
# in the replica files, the router classifies the outcome —
# the status taxonomy of docs/RESILIENCE.md). `migrated` is NOT here: the
# source replica emits it WITH its root span, so it stays walkable.
_ROOTLESS_STATUSES = frozenset(
    {"shed", "replica_lost", "failover_retry_exhausted"}
)

# attempt-terminal statuses excluded from request/window totals: the
# stream CONTINUED on another replica, whose final terminal carries the
# full-stream accounting — folding these in would double-count.
_CONTINUED_STATUSES = frozenset({"shed", "migrated", "replica_lost"})


def _trace_completeness(records: List[Dict]) -> Dict:
    """Walk every ``serve_request_done`` event's parent chain: complete
    iff it reaches a root span (``parent_id: None``) of the same trace
    through recorded spans."""
    spans = {
        r["span_id"]: r
        for r in records
        if r.get("type") == "span" and r.get("span_id")
    }
    requests = 0
    complete = 0
    incomplete_ids: List[str] = []
    for rec in records:
        if rec.get("type") != "event" or rec.get("name") != _REQUEST_TERMINAL:
            continue
        if rec.get("status") in _ROOTLESS_STATUSES:
            # classified, not incomplete: these statuses never had a
            # journey root in THIS file (module constant above)
            continue
        requests += 1
        rid = rec.get("request", "?")
        trace_id = rec.get("trace_id")
        ok = False
        if trace_id is not None:
            seen = set()
            pid = rec.get("parent_id")
            while pid is not None and pid not in seen:
                seen.add(pid)
                parent = spans.get(pid)
                if parent is None or parent.get("trace_id") != trace_id:
                    break
                if parent.get("parent_id") is None:
                    ok = True
                    break
                pid = parent.get("parent_id")
        if ok:
            complete += 1
        else:
            incomplete_ids.append(rid)
    return {
        "requests": requests,
        "complete": complete,
        "incomplete": requests - complete,
        "incomplete_ids": incomplete_ids,
    }


def _fault_completeness(records: List[Dict]) -> Dict:
    """Match every ``fault_injected`` event to a ``recovery_*`` event —
    the chaos gate's acceptance check (docs/RESILIENCE.md): a fault the
    run did not visibly recover from is a broken recovery path.

    Matching is two-pass and one-to-one: first by explicit ``fault_id``
    (recovery paths that know their cause carry it), then by ``site`` in
    record order (recovery paths that only observe the symptom — the
    stall watchdog — still pair with the fault they answered). A fault's
    symptom can surface one stage downstream of its injection point (a
    corrupted prefetch batch is caught by the TRAIN STEP's anomaly
    guard), so site matching accepts the documented answer sites."""
    answers = {
        "prefetch": ("prefetch", "train_step"),
        "train_step": ("train_step",),
        "ckpt_commit": ("ckpt_commit",),
        "ckpt_restore": ("ckpt_restore",),
        "serve_chunk": ("serve_chunk",),
        "fleet_router": ("fleet_router",),
    }
    faults = [
        r for r in records
        if r.get("type") == "event" and r.get("name") == "fault_injected"
    ]
    recoveries = [
        r for r in records
        if r.get("type") == "event"
        and str(r.get("name", "")).startswith("recovery_")
    ]
    used = [False] * len(recoveries)
    matched: Dict[int, Dict] = {}
    for fi, fault in enumerate(faults):
        fid = fault.get("fault_id")
        for ri, rec in enumerate(recoveries):
            if not used[ri] and fid and rec.get("fault_id") == fid:
                used[ri] = True
                matched[fi] = rec
                break
    for fi, fault in enumerate(faults):
        if fi in matched:
            continue
        ok_sites = answers.get(fault.get("site"), (fault.get("site"),))
        for ri, rec in enumerate(recoveries):
            if not used[ri] and rec.get("site") in ok_sites:
                used[ri] = True
                matched[fi] = rec
                break
    by_site: Dict[str, Dict] = {}
    unrecovered_ids: List[str] = []
    for fi, fault in enumerate(faults):
        site = fault.get("site", "?")
        slot = by_site.setdefault(site, {"injected": 0, "recovered": 0})
        slot["injected"] += 1
        if fi in matched:
            slot["recovered"] += 1
        else:
            unrecovered_ids.append(fault.get("fault_id", "?"))
    return {
        "injected": len(faults),
        "recovered": len(matched),
        "unrecovered": len(faults) - len(matched),
        "unrecovered_ids": unrecovered_ids,
        "recovery_events": len(recoveries),
        "by_site": {k: by_site[k] for k in sorted(by_site)},
    }


def build_report(
    records: List[Dict],
    manifest: Optional[Dict] = None,
    torn_lines: int = 0,
) -> Dict:
    """One run's telemetry records → the rollup dict (module docstring)."""
    span_secs: Dict[str, List[float]] = {}
    counters: Dict[str, float] = {}
    event_counts: Dict[str, int] = {}
    attributions: List[Dict] = []
    class_lat: Dict[str, List[float]] = {}
    class_windows: Dict[str, int] = {}
    chunk_edges: List[Tuple[float, float]] = []
    chunk_busy = 0.0
    chunk_kinds: set = set()
    chunk_windows_valid = 0
    windows_skipped = 0
    requests_done = 0
    requests_failed = 0
    windows_total = 0
    statuses: Dict[str, int] = {}
    numerics_states: Dict[str, Dict] = {}

    for rec in records:
        kind = rec.get("type")
        name = rec.get("name", "")
        if kind == "span":
            span_secs.setdefault(name, []).append(
                float(rec.get("seconds", 0.0) or 0.0)
            )
            if name == "serve_chunk_part":
                cls = rec.get("cls", "default")
                n = int(rec.get("windows", 0) or 0)
                class_lat.setdefault(cls, []).extend(
                    [float(rec.get("seconds", 0.0))] * n
                )
                class_windows[cls] = class_windows.get(cls, 0) + n
            elif name in ("serve_chunk", "infer_chunk"):
                chunk_edges.append(_span_edges(rec))
                chunk_busy += float(rec.get("seconds", 0.0) or 0.0)
                chunk_kinds.add(name)
                # activity gating: windows the SERVING
                # scheduler served with zero lane compute. serve_chunk
                # only — folding infer_chunk windows into the computed
                # side would report active_window_frac 1.0 for
                # inference-only files and understate serving savings
                if name == "serve_chunk":
                    chunk_windows_valid += int(rec.get("windows", 0) or 0)
                    windows_skipped += int(
                        rec.get("skipped_windows", 0) or 0
                    )
        elif kind == "counter":
            counters[name] = float(rec.get("total", 0.0) or 0.0)
        elif kind == "event":
            event_counts[name] = event_counts.get(name, 0) + 1
            if name == "serve_gating_flush":
                # gated windows from after the last dispatched chunk
                # (serving/server.py): no span carries them
                windows_skipped += int(rec.get("skipped", 0) or 0)
            if name == _REQUEST_TERMINAL:
                status = rec.get("status") or (
                    "ok" if rec.get("completed", False) else "bad_stream"
                )
                statuses[status] = statuses.get(status, 0) + 1
                if status in _CONTINUED_STATUSES:
                    # classified but not SERVED here: shed never ran;
                    # migrated / replica_lost continued elsewhere and the
                    # final terminal carries the full-stream totals
                    continue
                requests_done += 1
                windows_total += int(rec.get("windows", 0) or 0)
                if not rec.get("completed", False):
                    requests_failed += 1
        elif kind == "numerics":
            _numerics.ingest(numerics_states, rec)
        elif kind == "attribution":
            attributions.append(rec)

    spans_out = {
        name: {
            "count": len(vals),
            "total_s": round(sum(vals), 6),
            **_pctl_ms(vals),
        }
        for name, vals in sorted(span_secs.items())
    }

    # -- goodput ------------------------------------------------------------
    goodput: Dict = {"value": None, "source": None}
    if attributions:
        walls = [float(a.get("wall_s", 0.0) or 0.0) for a in attributions]
        goods = [float(a.get("goodput", 0.0) or 0.0) for a in attributions]
        total_wall = sum(walls)
        if total_wall > 0:
            goodput = {
                "value": round(
                    sum(w * g for w, g in zip(walls, goods)) / total_wall, 6
                ),
                "source": "attribution",
                "records": len(attributions),
                "min": round(min(goods), 6),
                "max": round(max(goods), 6),
            }
    elif chunk_edges:
        begin = min(e[0] for e in chunk_edges)
        end = max(e[1] for e in chunk_edges)
        wall = max(end - begin, 1e-9)
        goodput = {
            # resolve-one-behind overlaps dispatches, so busy/wall can
            # nominally exceed 1 — clamp like the attribution goodput
            "value": round(min(chunk_busy / wall, 1.0), 6),
            # name the tier honestly: an offline StreamingEngine run
            # (infer_chunk spans only) is "inference", not "serving"
            "source": ("serving" if "serve_chunk" in chunk_kinds
                       else "inference"),
            "busy_s": round(chunk_busy, 6),
            "wall_s": round(wall, 6),
        }

    serving = {
        "requests": requests_done,
        "completed": requests_done - requests_failed,
        "errors": requests_failed,
        "statuses": {k: statuses[k] for k in sorted(statuses)},
        "windows": windows_total,
        # how much compute activity gating saved (docs/PERF.md): idle
        # windows served without a dispatch, and the computed fraction —
        # 1.0 (or None when no chunks) means gating removed nothing
        "windows_skipped": windows_skipped,
        "active_window_frac": (
            round(chunk_windows_valid
                  / (chunk_windows_valid + windows_skipped), 6)
            if (chunk_windows_valid + windows_skipped) else None
        ),
        "preemptions": event_counts.get("serve_preempt", 0),
        "backpressure": counters.get("serve_backpressure", 0.0),
        "classes": {
            cls: {
                "windows": class_windows.get(cls, 0),
                "window_latency_p50_ms": _round(
                    percentile(lat, 50), 1e3
                ),
                "window_latency_p99_ms": _round(
                    percentile(lat, 99), 1e3
                ),
            }
            for cls, lat in sorted(class_lat.items())
        },
    }

    return {
        "schema_version": (manifest or {}).get("schema_version"),
        "records": len(records),
        "torn_lines": torn_lines,
        "goodput": goodput,
        "spans": spans_out,
        "counters": {k: counters[k] for k in sorted(counters)},
        "events": {k: event_counts[k] for k in sorted(event_counts)},
        "serving": serving,
        "traces": _trace_completeness(records),
        "faults": _fault_completeness(records),
        "numerics": _numerics.rollup(numerics_states),
    }


# -- SLO evaluation ---------------------------------------------------------


def load_slo(path: str) -> Dict:
    """Parse an SLO YAML; raises ``ValueError`` on a malformed file (the
    CLI maps that to exit 2 — a broken gate must not silently pass)."""
    from esr_tpu_torch.config.parser import loads

    with open(path) as f:
        # a broken gate file is exit 2 (unreadable, ValueError), never exit
        # 1 (a real SLO violation)
        doc = loads(f.read(), path)
    if not isinstance(doc, dict) or not isinstance(doc.get("rules"), list):
        raise ValueError(
            f"SLO file {path!r} must be a mapping with a `rules:` list "
            "(see configs/slo.yml)"
        )
    for rule in doc["rules"]:
        if not isinstance(rule, dict) or "metric" not in rule:
            raise ValueError(f"SLO rule without a `metric:`: {rule!r}")
        if "min" not in rule and "max" not in rule:
            raise ValueError(
                f"SLO rule {rule.get('name', rule['metric'])!r} has "
                "neither `min:` nor `max:`"
            )
    return doc


def _lookup(report: Dict, dotted: str):
    cur = report
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def evaluate_slo(report: Dict, slo: Dict) -> Tuple[bool, List[Dict]]:
    """Apply every rule; returns ``(all_ok, verdicts)`` where each verdict
    is ``{name, metric, value, min, max, ok, reason}``."""
    verdicts: List[Dict] = []
    all_ok = True
    for rule in slo.get("rules", []):
        metric = rule["metric"]
        value = _lookup(report, metric)
        lo = rule.get("min")
        hi = rule.get("max")
        verdict = {
            "name": rule.get("name", metric),
            "metric": metric,
            "value": value,
            "min": lo,
            "max": hi,
        }
        if value is None or (
            isinstance(value, float) and not math.isfinite(value)
        ):
            if rule.get("allow_missing", False) and value is None:
                verdict.update(ok=True, reason="missing (allowed)")
            else:
                verdict.update(
                    ok=False,
                    reason="metric missing or non-finite",
                )
        else:
            try:
                num = float(value)
            except (TypeError, ValueError):
                verdict.update(ok=False, reason="metric not numeric")
                verdicts.append(verdict)
                all_ok = False
                continue
            if lo is not None and num < float(lo):
                verdict.update(ok=False, reason=f"{num} < min {lo}")
            elif hi is not None and num > float(hi):
                verdict.update(ok=False, reason=f"{num} > max {hi}")
            else:
                verdict.update(ok=True, reason="within bounds")
        all_ok = all_ok and verdict["ok"]
        verdicts.append(verdict)
    return all_ok, verdicts


def evaluate_slo_window(snapshot: Dict, slo: Dict) -> Dict:
    """One LIVE window's burn verdict — the windowed relaxation of
    :func:`evaluate_slo`, shared by the per-replica ``/slo`` endpoint
    (obs/http.py) and the fleet plane's merged-window evaluation
    (obs/fleetview.py) so the two can never diverge on semantics.

    Absence of evidence is not a burn: an EMPTY window (zero records —
    an idle replica) is "no data" as a whole, and a rule whose metric is
    simply ABSENT from the window (goodput between attribution records,
    serving classes before the first resolve) is skipped-as-missing
    rather than violated. The offline gate keeps its strict
    missing=violation semantics for finished runs; a live WINDOW
    legitimately lacks subsystems that did not emit during it, and
    scoring that as a sustained burn would make the router contract
    (503 → drain) kill healthy replicas on every traffic lull or cadence
    gap. A present-but-non-finite metric (NaN) still violates.

    Returns ``{"ok", "no_data", "violations", "missing"}``.
    """
    if snapshot.get("records", 0) == 0:
        return {"ok": True, "no_data": True, "violations": [],
                "missing": []}
    _ok, verdicts = evaluate_slo(snapshot, slo)
    missing = [v["name"] for v in verdicts
               if not v["ok"] and v["value"] is None]
    violations = [v for v in verdicts
                  if not v["ok"] and v["value"] is not None]
    return {"ok": not violations, "no_data": False,
            "violations": violations, "missing": missing}


def report_file(
    telemetry_path: str,
    slo_path: Optional[str] = None,
    out_path: Optional[str] = None,
    run_index: int = -1,
) -> Tuple[Dict, int]:
    """The CLI body: read, roll up, optionally gate; returns
    ``(document, exit_code)``. The document always contains the report;
    with an SLO it adds ``{"slo": {"ok", "verdicts"}}``. ``run_index``
    selects a run of an appended multi-run file (:func:`read_telemetry`)."""
    manifest, records, torn = read_telemetry(
        telemetry_path, run_index=run_index
    )
    report = build_report(records, manifest, torn_lines=torn)
    doc: Dict = {"report": report}
    code = 0
    if slo_path is not None:
        slo = load_slo(slo_path)
        ok, verdicts = evaluate_slo(report, slo)
        doc["slo"] = {"ok": ok, "path": slo_path, "verdicts": verdicts}
        code = 0 if ok else 1
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=2)
    return doc, code


# -- fleet rollup: one report over many telemetry files ----------------------


def split_label(arg: str) -> Tuple[str, str]:
    """``label=path`` -> ``(label, path)``; a bare path derives its label
    from the filename (``telemetry_r0.jsonl`` -> ``telemetry_r0``), or —
    for the conventional per-run ``telemetry.jsonl`` name — from the
    parent directory, so replica rows stay tellable apart by default."""
    if "=" in arg and not os.path.exists(arg):
        label, _, path = arg.partition("=")
        if label and path:
            return label, path
    base = os.path.basename(arg)
    stem = base[: -len(".jsonl")] if base.endswith(".jsonl") else base
    if stem == "telemetry":
        parent = os.path.basename(os.path.dirname(os.path.abspath(arg)))
        stem = parent or stem
    return stem, arg


def merge_fleet_reports(
    labeled: List[Tuple[str, Optional[Dict], List[Dict], int]],
) -> Dict:
    """Fleet-level rollup over per-replica telemetry (docs/SERVING.md
    "The fleet"): ``labeled`` is ``(replica label, manifest, records,
    torn)`` per file.

    The fleet sections are built from the CONCATENATED record stream, so
    everything distribution-shaped is EXACT — percentiles over durations
    are order-free (the same merge==concat property the live plane's
    ``QuantileSketch`` pins), fault->recovery matching and trace
    completeness walk ids that are unique across processes. Two sections
    need per-file composition instead: ``counters`` carry running totals
    (last-wins under concat; the fleet sums each file's final total) and
    ``goodput`` walls live on per-file clock bases (the fleet reports a
    wall-weighted mean plus the per-replica values). A ``replicas``
    section labels each file's own rollup row, so per-replica and fleet
    views come from the same files."""
    if not labeled:
        raise ValueError("merge_fleet_reports needs at least one file")
    per: List[Tuple[str, Dict]] = [
        (label, build_report(records, manifest, torn_lines=torn))
        for label, manifest, records, torn in labeled
    ]
    all_records = [rec for _, _, records, _ in labeled for rec in records]
    fleet = build_report(
        all_records, labeled[0][1],
        torn_lines=sum(torn for _, _, _, torn in labeled),
    )
    counters: Dict[str, float] = {}
    for _, rep in per:
        for name, total in rep["counters"].items():
            counters[name] = counters.get(name, 0.0) + total
    fleet["counters"] = {k: counters[k] for k in sorted(counters)}
    valued = [(label, rep["goodput"]) for label, rep in per
              if rep["goodput"]["value"] is not None]
    if valued:
        weights = [float(g.get("wall_s") or 0.0) or 1.0 for _, g in valued]
        fleet["goodput"] = {
            "value": round(
                sum(g["value"] * w for (_, g), w in zip(valued, weights))
                / sum(weights), 6,
            ),
            "source": "fleet",
            "wall_s": round(max(
                float(g.get("wall_s") or 0.0) for _, g in valued
            ), 6),
            "busy_s": round(sum(
                float(g.get("busy_s") or 0.0) for _, g in valued
            ), 6),
            "replicas": {label: g["value"] for label, g in valued},
        }
    else:
        fleet["goodput"] = {"value": None, "source": "fleet"}
    fleet["replicas"] = {
        label: {
            "records": rep["records"],
            "torn_lines": rep["torn_lines"],
            "goodput": rep["goodput"]["value"],
            "requests": rep["serving"]["requests"],
            "completed": rep["serving"]["completed"],
            "errors": rep["serving"]["errors"],
            "windows": rep["serving"]["windows"],
            "statuses": rep["serving"]["statuses"],
            "preemptions": rep["serving"]["preemptions"],
            "faults_injected": rep["faults"]["injected"],
            "faults_unrecovered": rep["faults"]["unrecovered"],
            "traces_incomplete": rep["traces"]["incomplete"],
        }
        for label, rep in per
    }
    return fleet


def report_files(
    telemetry_args: Sequence[str],
    slo_path: Optional[str] = None,
    out_path: Optional[str] = None,
    run_index: int = -1,
) -> Tuple[Dict, int]:
    """Multi-file CLI body (``python -m esr_tpu_torch.obs report a.jsonl
    b.jsonl ...``): one file behaves exactly like :func:`report_file`;
    several are merged into the fleet rollup (labels via
    :func:`split_label` — ``r0=path`` or filename-derived) and the SLO
    gate evaluates the FLEET-level report."""
    if len(telemetry_args) == 1 and "=" not in telemetry_args[0]:
        return report_file(telemetry_args[0], slo_path, out_path,
                           run_index=run_index)
    labeled = []
    for arg in telemetry_args:
        label, path = split_label(arg)
        manifest, records, torn = read_telemetry(path, run_index=run_index)
        labeled.append((label, manifest, records, torn))
    report = merge_fleet_reports(labeled)
    doc: Dict = {"report": report}
    code = 0
    if slo_path is not None:
        slo = load_slo(slo_path)
        ok, verdicts = evaluate_slo(report, slo)
        doc["slo"] = {"ok": ok, "path": slo_path, "verdicts": verdicts}
        code = 0 if ok else 1
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=2)
    return doc, code
