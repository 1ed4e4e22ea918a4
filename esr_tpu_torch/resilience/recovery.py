"""Recovery machinery (counterpart of ``esr_tpu/resilience/recovery.py``).

Every recovery action answers one fault site of :mod:`.faults` and emits a
``recovery_*`` event (same ``site`` field, ``fault_id`` when the cause is
known), so ``python -m esr_tpu_torch.obs report`` can prove fault ->
recovery completeness:

- :class:`AnomalyGuard`: the trainer's finite-loss check at the step's
  scalar readback. A non-finite step is skipped and logged
  (``recovery_skip_step``) up to ``trainer.max_bad_steps`` consecutive bad
  steps; then :class:`RollbackSignal` sends the trainer back to the last
  valid committed checkpoint (``recovery_rollback``), which replays the
  same batches.
- :func:`retry_with_backoff`: bounded exponential-backoff retry of the
  checkpoint commit (``recovery_ckpt_retry``) and the step dispatch
  (``recovery_dispatch_retry``).
- checkpoint integrity: :func:`state_digest` (sha256 over the checkpoint's
  host state, keys in sorted order) goes into a ``digest.json`` beside the
  commit marker; :func:`validate_restored` recomputes it at restore and
  sweeps for non-finite values; :func:`restore_with_fallback` walks the
  committed checkpoints newest first and falls back past a bad one, loudly
  (``recovery_restore_fallback``).
- :class:`LaneHealth`: the serving circuit breaker's per-lane ledger.

Module-level imports are stdlib only: the data layer's prefetcher imports
:func:`emit_recovery`.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from esr_tpu_torch.resilience.faults import InjectedFault

logger = logging.getLogger(__name__)


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


# -- bounded retry (checkpoint commit, step dispatch) ------------------------


def retry_with_backoff(fn: Callable, retries: int, backoff_s: float, site: str, event: str,
                       sleep=time.sleep, **fields):
    """``fn()`` with up to ``retries`` retries, ``backoff_s * 2**attempt``
    apart. Every retried failure emits ``event`` with the attempt and the
    classified error; the last failure re-raises as it is."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - re-raised when exhausted
            attempt += 1
            if attempt > retries:
                raise
            emit_recovery(event, site=site, fault_id=fault_id_of(e), attempt=attempt,
                          retries=retries, error_kind=classify_error(e), error=repr(e),
                          **fields)
            logger.warning("%s: attempt %d/%d failed (%r); retrying in %.3fs", site, attempt,
                           retries, e, backoff_s * (2 ** (attempt - 1)))
            sleep(backoff_s * (2 ** (attempt - 1)))


# -- the trainer's anomaly guard -------------------------------------------


class RollbackSignal(Exception):
    """Raised by :class:`AnomalyGuard` when the bad-step budget is spent;
    the trainer restores the last valid committed checkpoint and replays.
    ``bad_tag`` is the numerics plane's first offending probe tag, when
    probes are on."""

    def __init__(self, at_iteration: int, bad_steps: int, fault_id: Optional[str] = None,
                 bad_tag: Optional[str] = None):
        where = f" (first offending tag: {bad_tag})" if bad_tag else ""
        super().__init__(f"{bad_steps} consecutive non-finite super-steps "
                         f"(last at iteration {at_iteration}){where}; rolling back")
        self.at_iteration = int(at_iteration)
        self.bad_steps = int(bad_steps)
        self.fault_id = fault_id
        self.bad_tag = bad_tag


class AnomalyGuard:
    """The finite-loss sentry of the training loop. :meth:`check` takes a
    step's host loss scalars (already read back: no new sync). A finite
    step resets the count of consecutive bad steps; a non-finite one emits
    ``recovery_skip_step`` and returns False (the caller keeps it out of
    its trackers), and once more than ``max_bad_steps`` are consecutive it
    raises :class:`RollbackSignal` instead. ``max_bad_steps=0`` rolls back
    at the first bad step. With probes on, the step's ``{tag: stats}``
    names the first offending seam (``bad_tag``, :attr:`last_bad_tag`)."""

    def __init__(self, max_bad_steps: int = 2):
        if max_bad_steps < 0:
            raise ValueError(f"max_bad_steps must be >= 0, got {max_bad_steps}")
        self.max_bad_steps = int(max_bad_steps)
        self.consecutive_bad = 0
        self.skipped_iterations: List[int] = []
        self.rollbacks = 0
        self.last_bad_tag: Optional[str] = None

    def check(self, losses: List[float], first_iteration: int,
              fault_id: Optional[str] = None, numerics: Optional[Dict] = None) -> bool:
        """True when every loss is finite (the step's metrics may be
        recorded)."""
        if all(math.isfinite(v) for v in losses):
            self.consecutive_bad = 0
            return True
        from esr_tpu_torch.obs.numerics import first_offending_tag

        bad_tag = first_offending_tag(numerics)
        self.last_bad_tag = bad_tag
        self.consecutive_bad += 1
        covered = list(range(first_iteration, first_iteration + len(losses)))
        self.skipped_iterations.extend(covered)
        if self.consecutive_bad > self.max_bad_steps:
            self.rollbacks += 1
            raise RollbackSignal(first_iteration, self.consecutive_bad, fault_id=fault_id,
                                 bad_tag=bad_tag)
        emit_recovery("recovery_skip_step", site="train_step", fault_id=fault_id,
                      iteration=first_iteration, iterations=covered,
                      consecutive_bad=self.consecutive_bad, budget=self.max_bad_steps,
                      bad_tag=bad_tag)
        logger.warning("non-finite loss at super-step %d (losses=%s, first offending tag=%s); "
                       "skipped (%d/%d bad before rollback)", first_iteration, losses, bad_tag,
                       self.consecutive_bad, self.max_bad_steps)
        return False


# -- checkpoint integrity ----------------------------------------------------

DIGEST_SIDECAR = "digest.json"


def state_digest(host_state: Dict) -> str:
    """sha256 over a checkpoint's host state (``training.checkpoint
    .host_state``: a flat ``{key: numpy array}``): every key, shape, dtype
    and the raw bytes, in sorted key order."""
    import numpy as np

    h = hashlib.sha256()
    for key in sorted(host_state):
        arr = np.ascontiguousarray(np.asarray(host_state[key]))
        h.update(key.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def write_digest(path: str, digest: str) -> None:
    """Write ``digest.json`` (temp, then rename, like the commit marker)."""
    sidecar = os.path.join(path, DIGEST_SIDECAR)
    tmp = sidecar + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"algo": "sha256", "digest": digest}, f)
    os.replace(tmp, sidecar)


def read_digest(path: str) -> Optional[str]:
    try:
        with open(os.path.join(path, DIGEST_SIDECAR)) as f:
            return json.load(f)["digest"]
    except (OSError, ValueError, KeyError):
        return None


def validate_restored(path: str, restored: Dict) -> Tuple[bool, str]:
    """``(ok, reason)`` for a restored host state: every float array
    finite, and its digest equal to the sidecar's when there is one."""
    import numpy as np

    for arr in restored.values():
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            return False, "non-finite leaf values"
    want = read_digest(path)
    if want is not None:
        got = state_digest(restored)
        if got != want:
            return False, f"digest mismatch (sidecar {want[:12]}…, restored {got[:12]}…)"
    return True, "ok"


def restore_with_fallback(root: str, model, optimizer, config: Dict, reset: bool = False
                          ) -> Tuple[int, Optional[float], Optional[str]]:
    """A validated resume over every committed checkpoint under ``root``,
    newest first, into ``model`` and ``optimizer``. The ``ckpt_restore``
    fault site fires before each attempt (``truncate`` cuts the
    candidate's largest file on disk); a candidate that fails to load or
    to validate is skipped with a ``recovery_restore_fallback`` event.
    Returns ``(start_iteration, monitor_best, path)``; ``path`` is None
    (and nothing is loaded) when no valid checkpoint exists."""
    from esr_tpu_torch.resilience import faults
    from esr_tpu_torch.training.checkpoint import (
        find_committed_checkpoints,
        restore_state,
        resume_checkpoint,
    )

    candidates = find_committed_checkpoints(root)
    for attempt, path in enumerate(candidates):
        for spec in faults.fire("ckpt_restore", attempt, path=path):
            if spec.kind == "truncate":
                faults.truncate_checkpoint_arrays(path)
        try:
            restored = restore_state(path)
            ok, reason = validate_restored(path, restored)
        except Exception as e:  # noqa: BLE001 - a corrupted artifact: fall back
            ok, reason = False, repr(e)
            logger.warning("checkpoint %s failed to restore (%r); trying the previous "
                           "commit", path, e)
        if ok:
            start, best = resume_checkpoint(path, model, optimizer, config, reset=reset)
            return start, best, path
        logger.error("checkpoint %s failed restore-time integrity validation (%s); falling "
                     "back to the previous commit", path, reason)
        emit_recovery("recovery_restore_fallback", site="ckpt_restore", path=path,
                      reason=reason, attempt=attempt, remaining=len(candidates) - attempt - 1)
    return 0, None, None


# -- the serving circuit breaker's ledger -----------------------------------


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
