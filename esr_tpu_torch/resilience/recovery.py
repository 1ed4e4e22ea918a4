"""Recovery telemetry and the serving tier's error taxonomy and lane
circuit-breaker ledger (counterpart of ``esr_tpu/resilience/recovery.py``:
``emit_recovery``, ``classify_error``, ``fault_id_of``, ``LaneHealth``).

Every recovery action emits a ``recovery_*`` event (same ``site`` field as
the fault it answers, ``fault_id`` when the cause is known), so ``python -m
esr_tpu_torch.obs report`` can prove fault -> recovery completeness. The
trainer's anomaly guard, checkpoint retry and restore integrity are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

from esr_tpu_torch.resilience.faults import InjectedFault


def emit_recovery(name: str, site: str, fault_id: Optional[str] = None, **fields) -> None:
    """Emit one ``recovery_*`` event through the process-active sink (no-op
    without one). ``site`` names the fault site being answered; the offline
    completeness check matches on it."""
    if not name.startswith("recovery_"):
        raise ValueError(f"recovery event name must start with 'recovery_', got {name!r}")
    from esr_tpu_torch.obs import active_sink

    sink = active_sink()
    if sink is not None:
        sink.event(name, site=site, fault_id=fault_id, **fields)


def classify_error(e: BaseException) -> str:
    """``injected`` (the fault plane), ``io`` (file or stream I/O),
    ``bad_input`` (a malformed request or recording), ``runtime`` (the
    card's runtime) or ``internal``: the ``error_kind`` of serving reports
    and ``serve_request_done`` events."""
    if isinstance(e, InjectedFault):
        return "injected"
    if isinstance(e, (FileNotFoundError, PermissionError, OSError, EOFError)):
        return "io"
    if isinstance(e, (ValueError, KeyError)):
        return "bad_input"
    text = f"{type(e).__name__}: {e}"
    if "CUDA" in text or "cudaError" in text or "out of memory" in text:
        return "runtime"
    return "internal"


def fault_id_of(e: BaseException) -> Optional[str]:
    """The causing fault's id when ``e`` came from the fault plane."""
    spec = getattr(e, "spec", None)
    return getattr(spec, "fault_id", None)


class LaneHealth:
    """Per-lane fault counts: a lane with ``quarantine_k`` faults should be
    drained and quarantined (the decision is the server's)."""

    def __init__(self, quarantine_k: int = 3):
        if quarantine_k < 1:
            raise ValueError(f"quarantine_k must be >= 1, got {quarantine_k}")
        self.quarantine_k = int(quarantine_k)
        self.faults: Dict[int, int] = {}

    def record(self, lane: int) -> int:
        self.faults[lane] = self.faults.get(lane, 0) + 1
        return self.faults[lane]

    def should_quarantine(self, lane: int) -> bool:
        return self.faults.get(lane, 0) >= self.quarantine_k
