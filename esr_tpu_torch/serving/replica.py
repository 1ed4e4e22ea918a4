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
- :class:`AotRegistry`: a directory of exported chunk programs
  (``inference/export.py``), its sidecars checked at cold start; a replica
  given one resolves its classes' depths there and never traces.

Replicas of one process share the model: a replica's engine moves it to
the replica's device once and only reads it.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import torch

from esr_tpu_torch.serving.wire import lane_state_keys, pack_lane_state, unpack_lane_state

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
    """A directory of exported chunk programs, checked up front.

    ``inference/export.export_checkpoint(..., program="engine_chunk")``
    writes ``<name>`` + ``<name>.json`` (the geometry sidecar). The registry
    scans the directory once and parses every sidecar; :meth:`programs_for`
    returns the ``{chunk_windows: path}`` map of one serving geometry and
    raises at cold start when a depth is missing or a sidecar disagrees on
    lanes, grid or ``seqn``, with the inventory in the message. The engine
    checks again when it loads (``ServingEngine._load_aot``)."""

    def __init__(self, root: str):
        self.root = root
        self.artifacts: List[Dict] = []
        for name in sorted(os.listdir(root)):
            if not name.endswith(".json"):
                continue
            artifact = os.path.join(root, name[: -len(".json")])
            if not os.path.exists(artifact):
                continue
            try:
                with open(os.path.join(root, name)) as f:
                    sidecar = json.load(f)
            except (OSError, ValueError) as e:
                raise ValueError(f"unreadable artifact sidecar {name!r} in registry "
                                 f"{root!r}: {e!r}")
            self.artifacts.append({"path": artifact, "sidecar": sidecar})
        if not self.artifacts:
            raise ValueError(f"AOT registry {root!r} holds no artifact/sidecar pairs "
                             "(export chunk programs first)")

    def programs_for(self, lanes: int, chunk_windows: Tuple[int, ...],
                     gt_hw: Optional[Tuple[int, int]] = None,
                     lr_hw: Optional[Tuple[int, int]] = None,
                     seqn: Optional[int] = None) -> Dict[int, str]:
        """The ``{W: artifact path}`` map of one serving geometry; every
        requested depth must resolve to an artifact whose sidecar matches (a
        field a sidecar lacks passes; one it has must agree)."""
        want_geo = {"gt_hw": gt_hw, "lr_hw": lr_hw, "seqn": seqn}

        def geo_ok(side: Dict) -> bool:
            for key, want in (("gt_hw", gt_hw), ("lr_hw", lr_hw)):
                if (want is not None and side.get(key) is not None
                        and list(side[key]) != list(want)):
                    return False
            return (seqn is None or side.get("seqn") is None
                    or int(side["seqn"]) == int(seqn))

        out: Dict[int, str] = {}
        for rec in self.artifacts:
            side = rec["sidecar"]
            if side.get("lanes") != int(lanes) or not geo_ok(side):
                continue
            w = side.get("chunk_windows")
            if w is not None:
                out.setdefault(int(w), rec["path"])
        missing = sorted(set(int(w) for w in chunk_windows) - set(out))
        if missing:
            raise ValueError(
                f"AOT registry {self.root!r} has no artifact for chunk_windows={missing} "
                f"at lanes={lanes}, geometry={want_geo} (inventory: "
                f"{[r['sidecar'].get('chunk_windows') for r in self.artifacts]})")
        return {int(w): out[int(w)] for w in chunk_windows}


class Replica:
    """One fleet replica: engine, per-replica sink, live plane (module
    docstring). ``engine_kw`` go to ``ServingEngine`` (``device``,
    ``precision``, ``preempt_quantum``, ...). ``aot_programs`` (``{W:
    path}``), or else ``aot_registry``, gives the engine its chunk
    programs."""

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
        aot_registry: Optional[AotRegistry] = None,
        aot_programs: Optional[Dict[int, str]] = None,
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
        self._aot_registry = aot_registry
        self._aot_programs = dict(aot_programs) if aot_programs else None
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
        """Open the sink, resolve the chunk programs from the registry when
        one is configured (the replica then never traces) and build the
        engine with its live plane on an ephemeral port, namespaced to this
        replica."""
        from esr_tpu_torch.obs import TelemetrySink
        from esr_tpu_torch.serving.scheduler import DEFAULT_CLASSES
        from esr_tpu_torch.serving.server import ServingEngine

        self.sink = TelemetrySink(self.telemetry_path)
        aot_programs = self._aot_programs
        if aot_programs is None and self._aot_registry is not None:
            classes = self._classes or DEFAULT_CLASSES
            depths = tuple(sorted({c.chunk_windows for c in classes.values()}))
            aot_programs = self._aot_registry.programs_for(self._lanes, depths)
        with self.activated():
            self.engine = ServingEngine(
                self._model, self._dataset_config, lanes=self._lanes,
                classes=self._classes, default_class=self._default_class,
                aot_programs=aot_programs, live_port=0, live_slo=self._live_slo,
                health_ns=self.replica_id, **self._engine_kw,
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
            packets.append(HandoffPacket(entry, None if state is None else pack_lane_state(
                state, lane_state_keys(self._model, len(state)))))
        return packets

    def admit_handoff(self, packet: HandoffPacket) -> str:
        """The target half of migration: the wire bytes unpacked (digest and
        key checks) and the stream re-admitted outside the queue cap."""
        state = None
        if packet.state_bytes is not None:
            template = self._model.init_states(1, 1, 1)
            state = unpack_lane_state(packet.state_bytes, template,
                                      lane_state_keys(self._model, len(template)))
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
