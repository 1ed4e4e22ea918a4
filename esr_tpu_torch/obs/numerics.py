"""The numerics rollup shared by the reporter and the live aggregator (the
host half of ``esr_tpu/obs/numerics.py``: ``order_tags``, ``finite_frac``,
``ingest``, ``merge_states``, ``rollup`` and the ``/healthz`` source).

The port has no numerics probe plane yet, so its own runs write no
``numerics`` records; the rollup still reads them, so a report or a live
snapshot keeps the reference's ``numerics`` section (empty-but-typed when
the run carried no probes) and a record stream from either package rolls
up the same.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# the probe-tag catalog in model order: input to output through
# DeepRecurrNet's seams, then the training-side taps
TAG_ORDER = (
    "head_out",
    "enc0", "enc1", "enc2",
    "gru_fwd", "gru_bwd",
    "dcn_offsets", "dcn_mask", "dcn_out",
    "dec0", "dec1", "dec2",
    "tail_out",
    "loss", "grad_norm",
)


def order_tags(tags) -> List[str]:
    """``tags`` sorted in catalog order; unknown tags (future models)
    follow alphabetically after the known catalog."""
    known = {t: i for i, t in enumerate(TAG_ORDER)}
    return sorted(tags, key=lambda t: (known.get(t, len(TAG_ORDER)), t))


def finite_frac(nonfinite: float, count: float) -> Optional[float]:
    """THE finite-fraction convention of the whole plane (records, the
    offline report, the live snapshot, /healthz, the SLO rule): ``None``
    with no data, and NEVER exactly 1.0 while any non-finite element was
    counted — plain ``round(1 - tiny/huge, 6)`` rounds back up to 1.0
    and would pass the ``min: 1.0`` SLO gate with NaNs present."""
    if count <= 0:
        return None
    if nonfinite <= 0:
        return 1.0
    return min(round(1.0 - nonfinite / count, 6), 0.999999)


def new_tag_state() -> Dict[str, float]:
    return {
        "records": 0,
        "rms": 0.0,
        "max_abs": 0.0,
        "nonfinite": 0.0,
        "count": 0.0,
        "underflow": 0.0,
        "overflow": 0.0,
    }


def ingest(states: Dict[str, Dict], rec: Dict) -> None:
    """Fold one ``numerics`` record into a per-tag state table. Extrema
    keep their max, counts sum."""
    tag = rec.get("name", "?")
    st = states.get(tag)
    if st is None:
        st = states[tag] = new_tag_state()
    st["records"] += 1
    for key in ("rms", "max_abs", "underflow", "overflow"):
        try:
            st[key] = max(st[key], float(rec.get(key, 0.0) or 0.0))
        except (TypeError, ValueError):
            pass
    for key in ("nonfinite", "count"):
        try:
            st[key] += float(rec.get(key, 0.0) or 0.0)
        except (TypeError, ValueError):
            pass


def merge_states(dst: Dict[str, Dict], src: Dict[str, Dict]) -> None:
    """Merge one state table into another (the live plane's epoch-ring
    merge) — same per-field law as :func:`ingest`."""
    for tag, st in src.items():
        mine = dst.get(tag)
        if mine is None:
            dst[tag] = dict(st)
            continue
        mine["records"] += st["records"]
        for key in ("rms", "max_abs", "underflow", "overflow"):
            mine[key] = max(mine[key], st[key])
        for key in ("nonfinite", "count"):
            mine[key] += st[key]


def rollup(states: Dict[str, Dict]) -> Dict:
    """The report/snapshot ``numerics`` section: per-tag worst-case
    readings plus the headline ``finite_frac`` (the worst tag's) the
    shipped SLO rule gates on. Always present; empty-but-typed when the
    run carried no probes (``finite_frac: None`` + ``allow_missing``)."""
    tags_out = {}
    worst_tag = None
    worst_frac = None
    nonfinite_total = 0.0
    for tag in order_tags(states):
        st = states[tag]
        frac = finite_frac(st["nonfinite"], st["count"])
        tags_out[tag] = {
            "records": st["records"],
            "rms": round(st["rms"], 6),
            "max_abs": round(st["max_abs"], 6),
            "nonfinite": st["nonfinite"],
            "count": st["count"],
            "finite_frac": frac,
            "underflow_frac": round(st["underflow"], 6),
            "overflow_frac": round(st["overflow"], 6),
        }
        nonfinite_total += st["nonfinite"]
        if frac is not None and (worst_frac is None or frac < worst_frac):
            worst_frac, worst_tag = frac, tag
    return {
        "records": sum(st["records"] for st in states.values()),
        "finite_frac": worst_frac,
        "worst_tag": worst_tag,
        "nonfinite_total": nonfinite_total,
        "tags": tags_out,
    }


def numerics_health_source(aggregator):
    """A ``/healthz`` component source over a live aggregator: healthy
    while every probed tag stays fully finite (or no probes have
    reported). Registered by ``obs.http.start_live_plane`` so both the
    trainer's and the serving tier's live planes expose it."""

    def source() -> Dict:
        num = aggregator.snapshot().get("numerics", {}) or {}
        frac = num.get("finite_frac")
        return {
            "healthy": frac is None or frac >= 1.0,
            "finite_frac": frac,
            "worst_tag": num.get("worst_tag"),
            "tags": len(num.get("tags", {})),
        }

    return source
