"""The deterministic fault-injection plane (counterpart of
``esr_tpu/resilience/faults.py``).

A :class:`FaultPlan` is a seeded schedule of :class:`FaultSpec` entries
keyed by ``site x index``: which failure, where, at which step, chunk or
round.
Production code carries :func:`fire` hooks at the injection sites; with no
plan installed a hook is one module-global ``None`` check.

Sites and kinds (the reference's catalog, declared whole; the port wires
``serve_chunk`` and ``fleet_router`` so far, the training sites wait for the
trainer's fault plane):

====================  =====================================================
site                  kinds
====================  =====================================================
``prefetch``          ``corrupt``, ``stall``
``train_step``        ``nan_loss``, ``dispatch_error``
``ckpt_commit``       ``fail``, ``torn``
``ckpt_restore``      ``truncate``
``serve_chunk``       ``lane_fault`` (a bound lane's pull raises),
                      ``stream_error`` (the stream iterator raises),
                      ``preempt_signal`` (simulated host preemption: every
                      bound lane is drained with its state saved, and
                      requeued)
``fleet_router``      ``replica_kill`` (a replica dies abruptly; its
                      streams fail over elsewhere), ``replica_partition``
                      (a replica becomes unreachable: fenced, then failed
                      over), ``router_handoff`` (forced voluntary drain:
                      every stream migrates bit-exactly over the ESRLANE1
                      wire). ``arg`` selects the target replica; keyed by
                      the router's round ordinal.
====================  =====================================================

Stdlib only: the plan is installable in processes that never
touch the card.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

SITES = ("prefetch", "train_step", "ckpt_commit", "ckpt_restore",
         "serve_chunk", "fleet_router")

_KINDS: Dict[str, Tuple[str, ...]] = {
    "prefetch": ("corrupt", "stall"),
    "train_step": ("nan_loss", "dispatch_error"),
    "ckpt_commit": ("fail", "torn"),
    "ckpt_restore": ("truncate",),
    "serve_chunk": ("lane_fault", "stream_error", "preempt_signal"),
    "fleet_router": ("replica_kill", "replica_partition",
                     "router_handoff"),
}


class InjectedFault(RuntimeError):
    """An error raised *by* the fault plane at an injection site.

    ``transient=True`` marks faults the matching recovery path is allowed
    to retry; the recovery machinery treats it exactly like the real error
    class it stands in for."""

    def __init__(self, spec: "FaultSpec", transient: bool = True):
        super().__init__(
            f"injected fault {spec.fault_id} "
            f"(site={spec.site}, kind={spec.kind}, index={spec.index})"
        )
        self.spec = spec
        self.transient = transient


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire ``kind`` at ``site`` when that site's
    ordinal counter reaches ``index``. ``arg`` is the kind-specific knob
    (stall seconds, target lane); ``fault_id`` is stamped at plan build
    time and rides every telemetry record the fault causes."""

    site: str
    index: int
    kind: str
    arg: float = 0.0
    fault_id: str = ""

    def __post_init__(self):
        if self.site not in _KINDS:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {sorted(_KINDS)}")
        if self.kind not in _KINDS[self.site]:
            raise ValueError(
                f"unknown kind {self.kind!r} for site {self.site!r}; "
                f"kinds: {_KINDS[self.site]}"
            )


class FaultPlan:
    """A deterministic schedule of faults, consumed one ``(site, index)``
    lookup at a time.

    The plan is a list of specs (the fleet chaos scenario's
    ``build_fleet_plan`` derives one from a seed).
    Each spec fires at most once — :func:`fire` pops it — and every firing
    is appended to :attr:`injected` (the host-side ledger a chaos run
    cross-checks against the telemetry stream). Thread-safe.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self._lock = threading.Lock()
        self._pending: Dict[Tuple[str, int], List[FaultSpec]] = {}
        self.injected: List[FaultSpec] = []
        self._n = 0
        for spec in specs:
            self.add(spec)

    # -- construction --------------------------------------------------------

    def add(self, spec: FaultSpec) -> FaultSpec:
        if not spec.fault_id:
            spec = FaultSpec(
                spec.site, spec.index, spec.kind, spec.arg,
                fault_id=f"{spec.site}:{spec.index}:{spec.kind}:{self._n}",
            )
        self._n += 1
        self._pending.setdefault((spec.site, spec.index), []).append(spec)
        return spec

    # -- consumption ---------------------------------------------------------

    def pop(self, site: str, index: int) -> List[FaultSpec]:
        """The specs scheduled at ``(site, index)``, consumed (each spec
        fires exactly once)."""
        with self._lock:
            specs = self._pending.pop((site, int(index)), [])
            self.injected.extend(specs)
            return specs

    def pending_count(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())


# ---------------------------------------------------------------------------
# process-global plan registry — the pattern of obs.set_active_sink: None
# (the default) makes every hook a single attribute check, and installation
# is strictly explicit (the chaos scenario, tests).

_PLAN: Optional[FaultPlan] = None


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` process-wide; returns the previous plan (restore
    it to scope installation, e.g. in tests)."""
    global _PLAN
    prev = _PLAN
    _PLAN = plan
    return prev


@contextlib.contextmanager
def installed(plan: FaultPlan):
    """Scope a plan installation (the chaos harness / test idiom)."""
    prev = install_plan(plan)
    try:
        yield plan
    finally:
        install_plan(prev)


def fire(site: str, index: int, **ctx) -> Tuple[FaultSpec, ...]:
    """THE hook production call sites embed: the faults scheduled at
    ``(site, index)``, consumed, each announced as a ``fault_injected``
    telemetry event (site, kind, index, fault_id + caller context).

    With no installed plan this is one global ``None`` check returning a
    shared empty tuple — the zero-cost-when-disabled contract. The caller
    owns *enacting* each returned spec (corrupting its batch, raising,
    sleeping): the plane schedules and records, the site executes.
    """
    if _PLAN is None:
        return ()
    specs = _PLAN.pop(site, index)
    if not specs:
        return ()
    from esr_tpu_torch.obs import active_sink

    sink = active_sink()
    if sink is not None:
        for spec in specs:
            sink.event(
                "fault_injected", site=spec.site, kind=spec.kind,
                index=spec.index, fault_id=spec.fault_id, **ctx,
            )
    return tuple(specs)
