"""Asynchronous checkpointing: the snapshot on the training loop, the
commit on a writer thread (counterpart of
``esr_tpu/training/async_checkpoint.py``).

A save is split in two (``training.checkpoint``):

- **snapshot** (blocking): :func:`~esr_tpu_torch.training.checkpoint.snapshot_state`
  copies the parameters and the optimizer state into host memory the
  snapshot owns. It must be complete before :meth:`AsyncCheckpointer.save`
  returns: the next optimizer step updates the parameters and Adam's
  moments in place, and ``optimizer.state_dict()`` holds those live
  tensors, not copies.
- **commit** (a daemon thread named ``ckpt-commit``):
  :func:`~esr_tpu_torch.training.checkpoint.commit_checkpoint`, the sync
  path's protocol unchanged (arrays, then ``digest.json``, then the
  ``meta.json`` marker by ``os.replace``), retried ``commit_retries`` times
  (``recovery_ckpt_retry``). A commit cut short leaves a directory without
  a marker, which ``find_latest_checkpoint`` never picks.

A **barrier** (:meth:`AsyncCheckpointer.wait`) joins the commit in flight
and re-raises its error as :class:`AsyncCheckpointError`. :meth:`save`
takes one first, so at most one commit is ever in flight and host memory
holds at most one extra copy of the state. The trainer adds three more:
before a rollback's restore, after the final save, and first in
``train()``'s ``finally``.

Telemetry: the trainer emits the blocking ``checkpoint_snapshot`` span;
the writer emits ``checkpoint_commit`` through the process-active sink,
under the trace context that was current when the save was submitted.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, Optional

import torch.nn as nn

from esr_tpu_torch.training.checkpoint import commit_checkpoint, snapshot_state
from esr_tpu_torch.training.optim import ScheduledOptimizer

logger = logging.getLogger(__name__)


class AsyncCheckpointError(RuntimeError):
    """A background commit failed; raised at the next barrier, so the
    training loop, not the writer thread, owns the failure."""


class AsyncCheckpointer:
    """One checkpoint writer with a single slot.

    ``save()`` = barrier + blocking snapshot + the commit started on the
    writer; ``wait()`` = join the commit in flight and account for it.
    ``commits`` and ``last_commit_s`` count the commits that a barrier has
    seen land.
    """

    def __init__(self, commit_retries: int = 2, commit_backoff_s: float = 0.1):
        if commit_retries < 0:
            raise ValueError(f"commit_retries must be >= 0, got {commit_retries}")
        if commit_backoff_s <= 0:
            raise ValueError(f"commit_backoff_s must be > 0, got {commit_backoff_s}")
        self.commit_retries = int(commit_retries)
        self.commit_backoff_s = float(commit_backoff_s)
        self.commits = 0
        self.last_commit_s: Optional[float] = None
        self._thread: Optional[threading.Thread] = None
        # the writer's outcome, handed to the barrier: ("ok", seconds) or
        # ("error", exception); one slot, as one commit is in flight
        self._outcome: queue.Queue = queue.Queue(maxsize=1)

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def save(self, save_dir: str, model: nn.Module, optimizer: ScheduledOptimizer,
             config: Dict, iteration: int, monitor_best: float,
             training_mode: str = "iteration_based_train", save_best: bool = False) -> float:
        """Barrier, snapshot, and the commit started on the writer.
        Returns the seconds the call blocked. Raises
        :class:`AsyncCheckpointError` when the previous commit failed."""
        from esr_tpu_torch.obs import trace

        t0 = time.monotonic()
        self.wait()
        params, opt_state = snapshot_state(model, optimizer)
        self._thread = threading.Thread(
            target=self._commit,
            args=(save_dir, params, opt_state, config, int(iteration), float(monitor_best),
                  training_mode, bool(save_best), trace.capture()),
            name="ckpt-commit",
            # a crash elsewhere must not hang the process on a disk write;
            # a commit cut short leaves no marker
            daemon=True)
        self._thread.start()
        return time.monotonic() - t0

    def wait(self, raise_error: bool = True, timeout: Optional[float] = None) -> None:
        """Join the commit in flight (a no-op when there is none). Its
        error re-raises as :class:`AsyncCheckpointError`, or, with
        ``raise_error`` false, is logged and dropped (a teardown barrier
        must not mask the exception already on its way)."""
        t = self._thread
        if t is None:
            return
        t.join(timeout)
        if t.is_alive():  # timed out: a later barrier joins it
            return
        self._thread = None
        kind, value = self._outcome.get_nowait()
        if kind == "ok":
            self.commits += 1
            self.last_commit_s = value
            return
        if raise_error:
            raise AsyncCheckpointError(
                f"background checkpoint commit failed: {value!r}") from value
        logger.error("background checkpoint commit failed: %r", value)

    # -- the writer thread -------------------------------------------------

    def _commit(self, save_dir, params, opt_state, config, iteration, monitor_best,
                training_mode, save_best, trace_ctx) -> None:
        from esr_tpu_torch.obs import trace

        with trace.adopt(trace_ctx):
            try:
                outcome = ("ok", self._commit_inner(save_dir, params, opt_state, config,
                                                    iteration, monitor_best, training_mode,
                                                    save_best))
            except BaseException as e:  # noqa: BLE001 - raised at the barrier
                outcome = ("error", e)
            self._outcome.put_nowait(outcome)

    def _commit_inner(self, save_dir, params, opt_state, config, iteration, monitor_best,
                      training_mode, save_best) -> float:
        from esr_tpu_torch.obs import active_sink
        from esr_tpu_torch.resilience.recovery import retry_with_backoff

        t0 = time.monotonic()
        path = retry_with_backoff(
            lambda: commit_checkpoint(save_dir, params, opt_state, config, iteration,
                                      monitor_best, training_mode=training_mode,
                                      save_best=save_best),
            retries=self.commit_retries, backoff_s=self.commit_backoff_s,
            site="ckpt_commit", event="recovery_ckpt_retry", iteration=iteration)
        seconds = time.monotonic() - t0
        sink = active_sink()
        if sink is not None:
            try:
                sink.span("checkpoint_commit", seconds, iteration=iteration, best=save_best,
                          path=path)
            except Exception:  # noqa: BLE001 - telemetry never fails a commit
                logger.exception("checkpoint_commit span not written")
        return seconds
