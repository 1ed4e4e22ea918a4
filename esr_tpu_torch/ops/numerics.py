"""Tensor-statistics probes on the device (counterpart of
``esr_tpu/ops/numerics.py``, the in-graph half of the numerics plane).

Each probed tensor gives one f32 stats vector (:data:`STAT_FIELDS`),
computed on the tensor's device with no host sync; the trainer reads the
vectors back in the same copy that brings the step's scalars to the host.
The host half (records, rollups, the drift harness, the anomaly guard's
layer attribution) is :mod:`esr_tpu_torch.obs.numerics`.

====================  ======  ==============================================
field                 reduce  meaning
====================  ======  ==============================================
``rms``               max     sqrt(mean(x^2)) over finite elements
``max_abs``           max     max |x| over finite elements
``mean``              last    mean over finite elements
``nonfinite``         sum     count of nan/inf elements
``underflow``         max     fraction of finite nonzero elements with
                              ``|x| < finfo(dtype).tiny``
``overflow``          max     fraction of finite elements within one decade
                              of ``finfo(dtype).max``
``count``             sum     elements probed
====================  ======  ==============================================

The ``reduce`` column is the law by which several firings of one tag (the
two DCN calls of a window, the windows of a BPTT step) accumulate:
:func:`merge_stat_vectors`, whose identity is :func:`zero_stats`.

A probe (:func:`probe`) is a no-op unless its model was built with
``numerics=True``; even then it records only inside a :func:`collect`
block, the counterpart of a flax ``sow`` into a mutable collection. The
stats are taken on a detached copy, so a probed forward computes the same
bits as an unprobed one, and a remat recompute (which runs outside the
train step's :func:`collect` block) records nothing twice.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional

import torch

STAT_FIELDS = ("rms", "max_abs", "mean", "nonfinite", "underflow", "overflow", "count")
REDUCE_KINDS = ("max", "max", "last", "sum", "max", "max", "sum")
NSTATS = len(STAT_FIELDS)

_MAX_MASK = tuple(k == "max" for k in REDUCE_KINDS)
_SUM_MASK = tuple(k == "sum" for k in REDUCE_KINDS)

# the reduce law's masks, one pair per device: made once, so a merge
# copies nothing host->device (a pageable copy would wait on the stream)
_MASKS: Dict[torch.device, tuple] = {}

# the active collection: {tag: stats vector} (stats mode) or {tag: [raw
# tensors]} (raw mode); None outside a collect() block
_COLLECTION: contextvars.ContextVar = contextvars.ContextVar(
    "esr_torch_numerics_collection", default=None)


def tensor_stats(x: torch.Tensor) -> torch.Tensor:
    """The f32 stats vector of one tensor, on its device. Non-finite
    elements are counted and masked out of the moments; the underflow and
    overflow thresholds are the probed dtype's."""
    with torch.no_grad():
        x = x.detach()
        if not x.is_floating_point():
            x = x.float()
        info = torch.finfo(x.dtype)
        xf = x.float()
        finite = torch.isfinite(xf)
        safe = torch.where(finite, xf, torch.zeros((), dtype=xf.dtype, device=xf.device))
        absx = safe.abs()
        n_finite = finite.sum(dtype=torch.float32)
        denom = n_finite.clamp_min(1.0)
        rms = torch.sqrt((safe * safe).sum() / denom)
        max_abs = absx.max() if absx.numel() else torch.zeros((), device=xf.device)
        mean = safe.sum() / denom
        # count the bad elements directly (a difference n - n_finite loses
        # small counts past 2**24 elements in f32)
        nonfinite = (~finite).sum(dtype=torch.float32)
        nonzero = finite & (absx > 0.0)
        n_nonzero = nonzero.sum(dtype=torch.float32).clamp_min(1.0)
        underflow = (nonzero & (absx < info.tiny)).sum(dtype=torch.float32) / n_nonzero
        overflow = (finite & (absx >= info.max / 10.0)).sum(dtype=torch.float32) / denom
        n = torch.full((), float(x.numel()), dtype=torch.float32, device=xf.device)
        return torch.stack([rms, max_abs, mean, nonfinite, underflow, overflow, n])


def zero_stats(device=None) -> torch.Tensor:
    """The accumulation identity of :func:`merge_stat_vectors`."""
    return torch.zeros(NSTATS, dtype=torch.float32, device=device)


def merge_stat_vectors(acc: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Accumulate one firing into a running stats vector (the
    :data:`REDUCE_KINDS` law: max for extrema, sum for counts, the newest
    ``mean``)."""
    masks = _MASKS.get(acc.device)
    if masks is None:
        masks = _MASKS[acc.device] = (torch.tensor(_MAX_MASK, device=acc.device),
                                      torch.tensor(_SUM_MASK, device=acc.device))
    max_mask, sum_mask = masks
    return torch.where(max_mask, torch.maximum(acc, new),
                       torch.where(sum_mask, acc + new, new))


def numerics_breaker(x: torch.Tensor) -> torch.Tensor:
    """The drift harness's precision-breaking transform ``(x + 256) - 256``
    in the tensor's own dtype: about ``2**-15`` relative in f32, the
    layer's values destroyed in bf16 (a grid of step 2.0 at 256)."""
    c = torch.tensor(256.0, dtype=x.dtype, device=x.device)
    return (x + c) - c


@contextlib.contextmanager
def collect() -> Iterator[Dict]:
    """Record every enabled probe fired inside the block into the yielded
    ``{tag: value}`` dict."""
    sown: Dict = {}
    token = _COLLECTION.set(sown)
    try:
        yield sown
    finally:
        _COLLECTION.reset(token)


def probe(tag: str, x: torch.Tensor, *, enabled: bool, mode: str = "stats",
          break_tag: Optional[str] = None) -> torch.Tensor:
    """Tap ``x`` under ``tag`` and return it.

    - ``enabled=False``: ``x`` untouched, nothing computed;
    - ``mode="stats"``: :func:`tensor_stats` merged into the active
      collection under the reduce law;
    - ``mode="raw"`` (the drift harness only): a detached copy appended to
      the tag's list, one entry per firing;
    - ``break_tag == tag``: ``x`` goes through :func:`numerics_breaker` in
      the path, so what follows sees the broken values.
    """
    if not enabled:
        return x
    if break_tag is not None and break_tag == tag:
        x = numerics_breaker(x)
    sown = _COLLECTION.get()
    if sown is None:
        return x
    if mode == "raw":
        sown.setdefault(tag, []).append(x.detach().clone())
    else:
        stats = tensor_stats(x)
        sown[tag] = merge_stat_vectors(sown.get(tag, zero_stats(stats.device)), stats)
    return x


def flatten_probes(tree) -> Dict:
    """A (possibly nested) probe collection as ``{tag: value}``; a tag that
    appears twice raises (tags are unique across the model)."""
    out: Dict = {}

    def walk(node):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val)
            else:
                if key in out:
                    raise ValueError(f"duplicate numerics probe tag {key!r}: tags "
                                     "must be unique across the model")
                out[key] = val

    walk(dict(tree))
    return out
