"""The serving tier's error taxonomy and lane circuit-breaker ledger
(copies of ``esr_tpu/resilience/recovery.py:classify_error``,
``fault_id_of`` and ``LaneHealth``). The fault-injection plane is not
ported, so no exception here is ever ``injected``."""

from __future__ import annotations

from typing import Dict, Optional


def classify_error(e: BaseException) -> str:
    """``io`` (file or stream I/O), ``bad_input`` (a malformed request or
    recording), ``runtime`` (the card's runtime) or ``internal``."""
    if isinstance(e, (FileNotFoundError, PermissionError, OSError, EOFError)):
        return "io"
    if isinstance(e, (ValueError, KeyError)):
        return "bad_input"
    text = f"{type(e).__name__}: {e}"
    if "CUDA" in text or "cudaError" in text or "out of memory" in text:
        return "runtime"
    return "internal"


def fault_id_of(e: BaseException) -> Optional[str]:
    """The causing fault's id, for an exception that carries a fault spec."""
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
