"""One fleet replica: a ``ServingEngine`` plus what a router needs
(counterpart of ``esr_tpu/serving/replica.py``: ``HandoffPacket``,
``AotRegistry``, ``Replica``; the ESRLANE1 wire format is
:mod:`esr_tpu_torch.serving.wire`).

- :class:`HandoffPacket`: one migrating stream, the engine's handoff entry
  with its lane state as wire bytes.
- :class:`Replica` owns one engine, its own telemetry sink (one
  ``telemetry_r<i>.jsonl`` per replica; the fleet rollup merges them) and
  its live plane on an ephemeral loopback port, health sources namespaced
  ``@<replica_id>``. The router drives it cooperatively: every engine call
  runs under :meth:`Replica.activated`, which swaps the process-active sink,
  so the engine must read the active sink on each call. ``drain()``
  evacuates every stream as handoff packets, ``admit_handoff()`` re-admits
  one, ``kill()`` simulates an abrupt death (the live plane torn down, no
  terminals, the engine abandoned: its lane states and programs dropped so
  nothing holds their card memory), ``partition()`` an unreachable replica
  whose engine lives on until the router fences it.
- :class:`AotRegistry` raises: AOT chunk programs need the port's export,
  which is not written yet.

Replicas of one process share the model: a replica's engine moves it to
the replica's device once and only reads it.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, List, Optional, Tuple

import torch

from esr_tpu_torch.serving.wire import pack_lane_state, unpack_lane_state

logger = logging.getLogger(__name__)

__all__ = ["AotRegistry", "HandoffPacket", "Replica"]


class HandoffPacket:
    """One migrating stream: the engine's handoff entry with the lane state
    flattened through the wire format (``state_bytes``; None for a stream
    that never dispatched: it rebinds fresh on the target)."""

    __slots__ = ("entry", "state_bytes")

    def __init__(self, entry: Dict, state_bytes: Optional[bytes]):
        self.entry = entry
        self.state_bytes = state_bytes

    @property
    def request_id(self) -> str:
        return self.entry["request_id"]

    def __repr__(self) -> str:
        return (f"HandoffPacket({self.request_id!r}, "
                f"windows_done={self.entry.get('windows_done')}, "
                f"state={'yes' if self.state_bytes else 'no'})")


class AotRegistry:
    """The directory of exported chunk programs replicas cold-start from.
    Not ported: it needs the port's AOT export (``inference/export.py``),
    which is still to be written."""

    def __init__(self, root: str):
        raise NotImplementedError(
            "AotRegistry needs the port's AOT chunk-program export "
            "(inference/export.py), which is not ported yet")


class Replica:
    """One fleet replica: engine, per-replica sink, live plane (module
    docstring). ``engine_kw`` go to ``ServingEngine`` (``device``,
    ``precision``, ``preempt_quantum``, ...)."""

    def __init__(
        self,
        replica_id: str,
        model,
        dataset_config: Dict,
        telemetry_path: str,
        classes: Optional[Dict] = None,
        default_class: str = "standard",
        lanes: int = 2,
        live_slo: Optional[str] = None,
        **engine_kw,
    ):
        self.replica_id = str(replica_id)
        self.telemetry_path = telemetry_path
        self._model = model
        self._dataset_config = dict(dataset_config)
        self._classes = classes
        self._default_class = default_class
        self._lanes = int(lanes)
        self._live_slo = live_slo
        self._engine_kw = dict(engine_kw)
        self.engine = None
        self.sink = None
        self.alive = False
        self.partitioned = False
        self.abandoned_memory: Optional[Tuple[int, int]] = None
        self._reported: set = set()

    # -- sink scoping --------------------------------------------------------

    @contextlib.contextmanager
    def activated(self):
        """Run a block with this replica's sink process-active (the previous
        one restored after): every engine call the router makes goes through
        here, so the telemetry lands in this replica's file."""
        from esr_tpu_torch.obs import set_active_sink

        prev = set_active_sink(self.sink)
        try:
            yield
        finally:
            set_active_sink(prev)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Replica":
        """Open the sink and build the engine with its live plane on an
        ephemeral port, namespaced to this replica."""
        from esr_tpu_torch.obs import TelemetrySink
        from esr_tpu_torch.serving.server import ServingEngine

        self.sink = TelemetrySink(self.telemetry_path)
        with self.activated():
            self.engine = ServingEngine(
                self._model, self._dataset_config, lanes=self._lanes,
                classes=self._classes, default_class=self._default_class,
                live_port=0, live_slo=self._live_slo, health_ns=self.replica_id,
                **self._engine_kw,
            )
        self.alive = True
        return self

    @property
    def port(self) -> Optional[int]:
        if self.engine is None or self.engine.live is None:
            return None
        return self.engine.live.port

    def url(self, endpoint: str) -> Optional[str]:
        port = self.port
        if port is None:
            return None
        return f"http://127.0.0.1:{port}/{endpoint.lstrip('/')}"

    # -- serving (router-driven, cooperative) --------------------------------

    def submit(self, path, request_class=None, request_id: Optional[str] = None) -> str:
        with self.activated():
            return self.engine.submit(path, request_class=request_class,
                                      request_id=request_id)

    def pump(self) -> str:
        """One engine round under this replica's sink; the engine's status
        (``dispatched`` / ``idle`` / ``drained``)."""
        with self.activated():
            return self.engine.pump()

    def flush(self) -> None:
        with self.activated():
            self.engine.flush()

    def poll_terminals(self) -> List[Tuple[str, Dict]]:
        """Requests that became terminal since the last poll, as
        ``(request_id, report)``; ``migrated`` terminals are left out (the
        router started those and owns their continuation)."""
        if self.engine is None:
            return []
        out = []
        for rid in self.engine.terminal_request_ids():
            if rid in self._reported:
                continue
            report = self.engine.report(rid)
            # a migrated record is marked reported too (else its report is
            # rebuilt every poll); admit_handoff clears it when it returns
            self._reported.add(rid)
            if report["status"] == "migrated":
                continue
            out.append((rid, report))
        return out

    # -- migration (voluntary drain / handoff) -------------------------------

    def drain(self) -> List[HandoffPacket]:
        """Evacuate every live stream as handoff packets (the voluntary half
        of migration); the replica stays alive and empty."""
        with self.activated():
            entries = self.engine.evacuate()
        packets = []
        for entry in entries:
            state = entry.pop("state")
            packets.append(HandoffPacket(entry, None if state is None
                                         else pack_lane_state(state)))
        return packets

    def admit_handoff(self, packet: HandoffPacket) -> str:
        """The target half of migration: the wire bytes unpacked (digest and
        key checks) and the stream re-admitted outside the queue cap."""
        state = None
        if packet.state_bytes is not None:
            state = unpack_lane_state(packet.state_bytes, self._model.init_states(1, 1, 1))
        # a returning stream replaces its migrated-out record: its new
        # terminal must reach the router
        self._reported.discard(packet.request_id)
        with self.activated():
            return self.engine.admit_handoff(packet.entry, state=state)

    # -- failure simulation (the fleet_router fault kinds) -------------------

    def _abandon_engine(self) -> None:
        """Drop this replica's engine and what it holds on the card (lane
        states, chunk programs, unresolved readbacks) without a drain or a
        terminal event, as a crashed process leaves them. On the card,
        ``abandoned_memory`` records ``torch.cuda.memory_allocated`` before
        and after."""
        engine, self.engine = self.engine, None
        if engine is None:
            return
        dev = engine.device
        before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
        engine.abandon()
        del engine
        if before is not None:
            self.abandoned_memory = (before, torch.cuda.memory_allocated(dev))

    def kill(self) -> None:
        """Abrupt death (``replica_kill``): the live plane vanishes (the
        supervisor's polls start failing), the engine is abandoned, the
        sink closed, so the file holds every record up to the crash."""
        self.alive = False
        if self.engine is not None:
            with self.activated():
                self.engine.close_live()
        if self.sink is not None:
            self.sink.close()
            self.sink = None
        self._abandon_engine()

    def partition(self) -> None:
        """Network partition (``replica_partition``): the endpoints become
        unreachable (live plane down) but the engine survives; the router
        must fence it before failing its streams over."""
        self.partitioned = True
        if self.engine is not None:
            with self.activated():
                self.engine.close_live()

    def fence(self) -> None:
        """Fence a partitioned replica: stop serving it for good, with no
        terminal events (the router fails its journeys over)."""
        self.alive = False
        if self.sink is not None:
            self.sink.close()
            self.sink = None
        self._abandon_engine()

    def close(self) -> None:
        """Graceful shutdown (idempotent): live plane down, sink closed."""
        self.alive = False
        if self.engine is not None:
            with self.activated():
                self.engine.close_live()
            self.engine = None
        if self.sink is not None:
            self.sink.close()
            self.sink = None
