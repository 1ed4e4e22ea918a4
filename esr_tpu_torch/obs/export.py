"""telemetry.jsonl -> Chrome trace-event / Perfetto JSON (counterpart of
``esr_tpu/obs/export.py``, event for event).

The sink's JSONL becomes a timeline to open in ``ui.perfetto.dev`` or
``chrome://tracing``, beside the ``torch.profiler`` trace of the same run
(``trainer.profile_steps`` writes it under ``<log_dir>/profile``):

- one track per host thread (process "host"): spans as complete events,
  placed by their ``begin``/``end`` (v2) or ending at their record time
  ``t`` (v1);
- one track per lane (process "lanes") for records with a ``lane``;
- one track per request class (process "requests"): ``serve_request``
  roots, ``serve_admit`` spans and request events;
- counter tracks (``ph: "C"``) for counters and gauges;
- point events as instants; trace linkage rides in ``args``.

The reader is the reporter's (:func:`esr_tpu_torch.obs.report.read_telemetry`):
appended multi-run files give one run (``run_index``) and a torn last line
is skipped. Stdlib only.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

from esr_tpu_torch.obs.report import read_telemetry, split_label

__all__ = [
    "read_telemetry",
    "to_chrome_trace",
    "export_file",
    "export_files",
    "span_index",
    "trace_of",
]

# fixed virtual-process ids for the exported track groups
_PID_HOST = 1
_PID_LANES = 2
_PID_REQUESTS = 3
_PID_COUNTERS = 4


def span_index(records: Iterable[Dict]) -> Dict[str, Dict]:
    """``{span_id: span record}`` over every identified span."""
    out: Dict[str, Dict] = {}
    for rec in records:
        if rec.get("type") == "span" and rec.get("span_id"):
            out[rec["span_id"]] = rec
    return out


def trace_of(records: Iterable[Dict], trace_id: str) -> List[Dict]:
    """Every record belonging to one trace, in file order."""
    return [r for r in records if r.get("trace_id") == trace_id]


def _span_edges(rec: Dict) -> Tuple[float, float]:
    """(begin, end) seconds on the sink's ``t`` axis. v2 spans carry the
    edges; v1 spans end at their record time ``t``."""
    seconds = float(rec.get("seconds", 0.0) or 0.0)
    if rec.get("begin") is not None and rec.get("end") is not None:
        return float(rec["begin"]), float(rec["end"])
    t = float(rec.get("t", 0.0))
    return t - seconds, t


def _args_of(rec: Dict) -> Dict:
    skip = {"t", "type", "name", "seconds", "begin", "end", "thread"}
    return {k: v for k, v in rec.items() if k not in skip}


class _Tids:
    """Stable small integer tids per track label within one process."""

    def __init__(self):
        self._by_label: Dict[object, int] = {}

    def get(self, label) -> int:
        if label not in self._by_label:
            self._by_label[label] = len(self._by_label)
        return self._by_label[label]

    def items(self):
        return self._by_label.items()


def to_chrome_trace(
    records: Iterable[Dict], manifest: Optional[Dict] = None
) -> Dict:
    """Normalized telemetry records → a Chrome trace-event JSON object
    (``{"traceEvents": [...], ...}``) loadable in ``ui.perfetto.dev``."""
    events: List[Dict] = []
    host_tids = _Tids()
    lane_tids = _Tids()
    class_tids = _Tids()
    host_tids.get("main")  # tid 0 is always the main host track

    def _track(rec: Dict) -> Tuple[int, int]:
        # serve_admit spans cover submit -> bind (mostly QUEUE wait):
        # drawing them on the lane track would paint the lane occupied
        # for the whole wait, overlapping the chunks it actually served
        # — they belong to the request-class story, like the roots
        if rec.get("name") == "serve_request" or (
            rec.get("name") == "serve_admit" and rec.get("cls") is not None
        ) or (
            rec.get("type") == "event" and rec.get("request") is not None
            and rec.get("lane") is None
        ):
            return _PID_REQUESTS, class_tids.get(rec.get("cls", "default"))
        if rec.get("lane") is not None:
            return _PID_LANES, lane_tids.get(int(rec["lane"]))
        return _PID_HOST, host_tids.get(rec.get("thread", "main"))

    for rec in records:
        kind = rec.get("type")
        if kind == "span":
            begin, end = _span_edges(rec)
            pid, tid = _track(rec)
            events.append({
                "ph": "X",
                "name": rec.get("name", "span"),
                "pid": pid,
                "tid": tid,
                "ts": round(begin * 1e6, 3),
                "dur": round(max(end - begin, 0.0) * 1e6, 3),
                "cat": "span",
                "args": _args_of(rec),
            })
        elif kind in ("counter", "gauge"):
            value = rec.get("total") if kind == "counter" else rec.get("value")
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            events.append({
                "ph": "C",
                "name": rec.get("name", kind),
                "pid": _PID_COUNTERS,
                "tid": 0,
                "ts": round(float(rec.get("t", 0.0)) * 1e6, 3),
                "args": {"value": value},
            })
        elif kind == "event":
            pid, tid = _track(rec)
            events.append({
                "ph": "i",
                "s": "t",
                "name": rec.get("name", "event"),
                "pid": pid,
                "tid": tid,
                "ts": round(float(rec.get("t", 0.0)) * 1e6, 3),
                "cat": "event",
                "args": _args_of(rec),
            })
        elif kind == "attribution":
            # the span tree for a super-step is emitted alongside the
            # attribution record (obs/spans.py); the record itself would
            # only duplicate those slices
            continue

    meta: List[Dict] = []

    def _name(pid: int, name: str, sort: int) -> None:
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "args": {"name": name}})
        meta.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                     "args": {"sort_index": sort}})

    _name(_PID_HOST, "host", 0)
    _name(_PID_LANES, "lanes", 1)
    _name(_PID_REQUESTS, "requests", 2)
    _name(_PID_COUNTERS, "counters", 3)
    for label, tid in host_tids.items():
        meta.append({"ph": "M", "name": "thread_name", "pid": _PID_HOST,
                     "tid": tid, "args": {"name": str(label)}})
    for label, tid in lane_tids.items():
        meta.append({"ph": "M", "name": "thread_name", "pid": _PID_LANES,
                     "tid": tid, "args": {"name": f"lane {label}"}})
    for label, tid in class_tids.items():
        meta.append({"ph": "M", "name": "thread_name", "pid": _PID_REQUESTS,
                     "tid": tid, "args": {"name": f"class {label}"}})

    out = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
    }
    if manifest is not None:
        out["metadata"] = {
            k: manifest.get(k)
            for k in ("host", "pid", "jax_version", "device_kind",
                      "platform", "schema_version", "config_fingerprint")
            if k in manifest
        }
    return out


def export_file(in_path: str, out_path: str, run_index: int = -1) -> Dict:
    """Read a telemetry.jsonl and write the Perfetto-loadable JSON;
    returns ``{"events": n, "torn_lines": n, "out": path}``.
    ``run_index`` selects a run of an appended multi-run file
    (:func:`read_telemetry`)."""
    manifest, records, torn = read_telemetry(in_path, run_index=run_index)
    doc = to_chrome_trace(records, manifest)
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return {
        "events": len(doc["traceEvents"]),
        "records": len(records),
        "torn_lines": torn,
        "out": out_path,
    }


# pid stride between replica process groups in a merged fleet export:
# each file keeps its host/lanes/requests/counters track split, shifted
# into its own block and labeled "<replica>: <track>"
_FLEET_PID_STRIDE = 10


def export_files(
    in_args, out_path: str, run_index: int = -1
) -> Dict:
    """Merge N telemetry files (a fleet: router + one per replica) into
    ONE Perfetto trace: each file's tracks land in their own pid block,
    process names prefixed with the replica label
    (``obs.report.split_label`` — ``r0=path`` or filename-derived), so
    lanes/requests/counters of different replicas never overlay. Each
    file keeps its own zero-based time axis — replicas start together in
    a fleet run, so tracks align to within startup skew (the same reason
    appended RUNS of one file are still selected, never merged)."""
    events = []
    total_records = 0
    total_torn = 0
    for i, arg in enumerate(in_args):
        label, path = split_label(arg)
        manifest, records, torn = read_telemetry(path, run_index=run_index)
        total_records += len(records)
        total_torn += torn
        doc = to_chrome_trace(records, manifest)
        offset = i * _FLEET_PID_STRIDE
        for ev in doc["traceEvents"]:
            ev = dict(ev)
            if "pid" in ev:
                ev["pid"] = int(ev["pid"]) + offset
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                ev["args"] = {
                    "name": f"{label}: {ev['args'].get('name', '')}"
                }
            events.append(ev)
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(out_path, "w") as f:
        json.dump(out, f)
    return {
        "events": len(events),
        "records": total_records,
        "torn_lines": total_torn,
        "files": len(list(in_args)),
        "out": out_path,
    }
