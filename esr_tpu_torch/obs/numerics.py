"""The numerics plane, host side (counterpart of ``esr_tpu/obs/numerics.py``).

It consumes the device probes of :mod:`esr_tpu_torch.ops.numerics` and
turns them into

- the step's per-tag vectors (:func:`merge_readback`) and ``numerics``
  JSONL records (:func:`stats_fields`, one per tag at the trainer's
  ``train_log_step`` cadence);
- the rollup shared by the offline reporter and the live aggregator
  (:func:`ingest`, :func:`merge_states`, :func:`rollup`), so one SLO YAML
  gates ``numerics.finite_frac`` in a finished file and in a live window;
- the anomaly guard's layer attribution (:func:`first_offending_tag`,
  :func:`poison_tag`);
- the precision-drift harness (:func:`run_drift`, ``python -m
  esr_tpu_torch.obs drift``): one seeded batch through an f32 model and a
  candidate-dtype twin, diffed tag by tag.

The records are the reference's, so either package's reporter reads the
other's. Only :func:`run_drift` imports torch (lazily).
"""

from __future__ import annotations

from typing import Dict, List, Optional

# the device half's field order and reduce law (esr_tpu_torch.ops.numerics),
# kept here so this module imports no torch
STAT_FIELDS = ("rms", "max_abs", "mean", "nonfinite", "underflow", "overflow", "count")
REDUCE_KINDS = ("max", "max", "last", "sum", "max", "max", "sum")
NSTATS = len(STAT_FIELDS)

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


def merge_host(acc, new):
    """The numpy twin of ``ops.numerics.merge_stat_vectors``."""
    import numpy as np

    acc = np.asarray(acc, np.float32)
    new = np.asarray(new, np.float32)
    out = np.where([k == "max" for k in REDUCE_KINDS], np.maximum(acc, new),
                   np.where([k == "sum" for k in REDUCE_KINDS], acc + new, new))
    return out.astype(np.float32)


def merge_readback(numerics) -> Dict[str, object]:
    """One vector per tag from a step's readback: ``{tag: [NSTATS]}``,
    ``{tag: [k, NSTATS]}`` (stacked steps) or a list of per-step dicts."""
    import numpy as np

    if isinstance(numerics, (list, tuple)):
        merged: Dict[str, object] = {}
        for entry in numerics:
            for tag, vec in entry.items():
                vec = np.asarray(vec, np.float32)
                merged[tag] = vec if tag not in merged else merge_host(merged[tag], vec)
        return merged
    out: Dict[str, object] = {}
    for tag, stacked in numerics.items():
        arr = np.asarray(stacked, np.float32)
        if arr.ndim == 1:
            out[tag] = arr
            continue
        acc = arr[0]
        for row in arr[1:]:
            acc = merge_host(acc, row)
        out[tag] = acc
    return out


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


def stats_fields(vec) -> Dict[str, float]:
    """One merged stats vector -> the ``numerics`` record's payload (the
    :data:`STAT_FIELDS` and ``finite_frac``)."""
    import numpy as np

    vec = np.asarray(vec, np.float64)
    fields = {name: round(float(v), 6) for name, v in zip(STAT_FIELDS, vec)}
    fields["finite_frac"] = finite_frac(fields["nonfinite"], fields["count"])
    return fields


def first_offending_tag(numerics: Optional[Dict]) -> Optional[str]:
    """The earliest catalog tag whose stats count non-finite elements (the
    anomaly guard's layer attribution), or None."""
    import numpy as np

    if not numerics:
        return None
    idx = STAT_FIELDS.index("nonfinite")
    for tag in order_tags(numerics):
        vec = np.asarray(numerics[tag], np.float64)
        if vec.shape[-1] == NSTATS and float(vec[idx]) > 0:
            return tag
    return None


def poison_tag(numerics: Dict, tag: str = "loss") -> Dict:
    """An injected ``nan_loss`` fault enacted on the readback: every
    element of ``tag`` marked non-finite, where the fault plane poisons the
    loss scalars."""
    import numpy as np

    out = dict(numerics)
    vec = np.array(out.get(tag, np.zeros(NSTATS, np.float32)), np.float32, copy=True)
    count = max(float(vec[STAT_FIELDS.index("count")]), 1.0)
    vec[STAT_FIELDS.index("count")] = count
    vec[STAT_FIELDS.index("nonfinite")] = count
    out[tag] = vec
    return out


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


# -- the precision-drift harness (``python -m esr_tpu_torch.obs drift``) ----


def _rel_error(ref, cand) -> float:
    """``||ref - cand|| / (||ref|| + eps)`` in f64, the worst over a raw
    tap's firings."""
    import numpy as np

    worst = 0.0
    for a, b in zip(ref, cand):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        denom = float(np.linalg.norm(a.ravel())) + 1e-12
        worst = max(worst, float(np.linalg.norm((a - b).ravel())) / denom)
    return worst


def drift_ladder(ref: Dict, cand: Dict, tolerance: float) -> Dict:
    """The per-tag relative-error ladder of candidate taps against
    reference taps (``{tag: [tensor per firing]}``), in tag order: each
    rung's ``rel_err`` and whether it ``exceeds`` ``tolerance``, the first
    tag over it and the worst tag."""
    ladder = []
    first = None
    worst_tag, worst_rel = None, -1.0
    for tag in order_tags(ref):
        rel = _rel_error(ref[tag], cand[tag])
        exceeds = rel > tolerance
        ladder.append({"tag": tag, "rel_err": round(rel, 6), "exceeds": exceeds})
        if exceeds and first is None:
            first = tag
        if rel > worst_rel:
            worst_rel, worst_tag = rel, tag
    return {"first_offender": first, "worst_tag": worst_tag,
            "n_exceeding": sum(1 for e in ladder if e["exceeds"]), "ladder": ladder}


def run_drift(dtype: str = "bfloat16", basech: int = 8, hw: int = 32, frames: int = 3,
              batch: int = 1, seed: int = 0, tolerance: float = 0.25,
              break_tag: Optional[str] = None, inch: int = 2, device=None) -> Dict:
    """One seeded batch through an f32 model with raw probe taps and through
    a candidate-dtype twin of the same weights; the per-tag relative-error
    ladder names the first seam over ``tolerance``.

    The twin casts the parameters, the input and the states to ``dtype``
    (the harness's bf16 rung). ``dtype="int8"`` casts nothing and reruns
    the same f32 feed under :func:`esr_tpu_torch.config.quantize.int8_scope`
    (the PTQ serving rung), so the ladder attributes quantization error.
    ``break_tag`` routes that tag through the precision breaker, which the
    ladder must then name. Runs on the card unless ``device`` is the CPU.
    """
    import copy

    import numpy as np
    import torch

    from esr_tpu_torch.config.precision import canonical_dtype
    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.models.esr import DeepRecurrNet
    from esr_tpu_torch.ops.numerics import collect

    dev = resolve_device(device)
    name = canonical_dtype(dtype)
    cand_dtype = None if name == "int8" else getattr(torch, name)
    torch.manual_seed(seed)
    model = DeepRecurrNet(inch=inch, basech=basech, num_frame=frames, numerics=True,
                          numerics_mode="raw", numerics_break=break_tag).to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (batch, frames, hw, hw, inch)).astype(np.float32)).to(dev)
    states = model.init_states(batch, hw, hw, device=dev)

    def taps(net, xx, ss):
        with torch.no_grad(), collect() as sown:
            net(xx, ss)
        return {tag: [t.float().cpu().numpy() for t in vals] for tag, vals in sown.items()}

    ref = taps(model, x, states)
    if cand_dtype is None:
        from esr_tpu_torch.config.quantize import int8_scope

        with int8_scope():
            cand = taps(model, x, states)
    else:
        twin = copy.deepcopy(model).to(cand_dtype)
        cand = taps(twin, x.to(cand_dtype), tuple(s.to(cand_dtype) for s in states))
    found = drift_ladder(ref, cand, tolerance)
    return {
        "dtype": "int8" if cand_dtype is None else str(cand_dtype).replace("torch.", ""),
        "reference": "float32",
        "tolerance": tolerance,
        "seed": seed,
        "device": dev.type,
        "model": {"name": "DeepRecurrNet", "basech": basech, "hw": hw, "frames": frames,
                  "batch": batch, "inch": inch},
        "break_tag": break_tag,
        **found,
    }
