"""The scripted fleet chaos scenario: replicas under replica-level faults
(counterpart of ``esr_tpu/resilience/chaos_fleet.py``).

1. **Twin**: every stream through one fault-free ``ServingEngine`` (the
   same request ids and classes): the per-request ground truth.
2. **Fleet**: the same streams, arriving as a burst, through
   ``N_REPLICAS`` replicas behind a
   :class:`~esr_tpu_torch.serving.fleet.FleetRouter` under
   :func:`build_fleet_plan`: ``router_handoff`` (forced drain: streams
   migrate bit-exactly over the ESRLANE1 wire), ``replica_kill`` (abrupt
   death: missed heartbeats, fail-over) and ``replica_partition``
   (unreachable: fenced, then failed over).
3. **Fleet view**: the supervisor's ``/snapshot`` polls feed a
   :class:`~esr_tpu_torch.obs.fleetview.FleetAggregator` through the
   faults, the router's own records joining as a local; the killed replica
   must turn stale (excluded, annotated), never merged.
4. **Checks**: zero lost requests; all three faults fired and recovered
   (``faults.unrecovered == 0`` over the merged router and replica files);
   the killed replica held at least one stream; every stream's metric means
   within ``PARITY_RTOL`` of the twin's with equal window counts (a handoff
   resumes bit-exactly, a fail-over replays from window 0); the merged
   report green against ``configs/slo_fleet.yml``; the fleet view's
   properties above and its merged ``/slo`` verdict agreeing with the
   offline report over the router and surviving replicas' files.

Arrivals come as a burst: every stream is placed before the early fault
rounds land, so the kill always finds streams to fail over, however fast
the rounds run.

``python -m esr_tpu_torch.resilience.chaos_fleet --out DIR [--seed N]
[--device cuda|cpu]`` runs it at a small size (a seeded basech-2 model, six
in-memory 64x64 streams, lanes 2) and exits 0 iff every check held; on the
card unless ``--device cpu`` is given. :func:`run_fleet_scenario` takes any
model, streams and classes (``chip_smoke.py`` runs the flagship width).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from esr_tpu_torch.resilience.faults import FaultPlan, FaultSpec, installed

N_REPLICAS = 3
RATE_HZ = 200.0  # a burst: every stream placed before the first fault round
PARITY_RTOL = 1e-5
# the command line's scale: alternating short and long streams, lanes 2
LANES = 2
N_STREAMS = 6
EVENTS_SCHEDULE = (1600, 4200)
_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")


def dataset_config() -> Dict:
    """The command line's data config (the reference scenario's)."""
    return {
        "scale": 2, "ori_scale": "down8", "time_bins": 1, "mode": "events",
        "window": 1024, "sliding_window": 512, "need_gt_events": True,
        "need_gt_frame": False,
        "data_augment": {"enabled": False, "augment": [], "augment_prob": []},
        "sequence": {"sequence_length": 4, "seqn": 3, "step_size": None,
                     "pause": {"enabled": False}},
    }


def serving_classes() -> Dict:
    """The command line's request classes (the reference scenario's)."""
    from esr_tpu_torch.serving.scheduler import RequestClass

    return {"interactive": RequestClass("interactive", chunk_windows=2),
            "standard": RequestClass("standard", chunk_windows=4)}


def build_fleet_plan(seed: int) -> FaultPlan:
    """Three replica-level faults at early router rounds (streams must
    still be in flight when each lands): handoff first (there is state to
    migrate), the kill next, the partition last (its fence needs the
    detection window), with seeded jitter. Targets walk to a live replica
    when enacted, so the three faults hit three different fates."""
    import numpy as np

    rng = np.random.default_rng(seed)
    handoff_round = 1 + int(rng.integers(0, 2))  # 1-2
    kill_round = handoff_round + 1  # 2-3
    partition_round = kill_round + 2 + int(rng.integers(0, 2))  # 4-6
    return FaultPlan([
        FaultSpec("fleet_router", handoff_round, "router_handoff", arg=0.0),
        FaultSpec("fleet_router", kill_round, "replica_kill", arg=1.0),
        FaultSpec("fleet_router", partition_round, "replica_partition", arg=2.0),
    ])


def _run_twin(out_dir: str, model, schedule, engine_kw: Dict) -> Tuple[Dict, Dict]:
    """Every stream through one fault-free engine with the request ids and
    classes the fleet sees: ``(per-request reports, session summary)``."""
    from esr_tpu_torch.obs import TelemetrySink, set_active_sink
    from esr_tpu_torch.serving.server import ServingEngine

    sink = TelemetrySink(os.path.join(out_dir, "telemetry_twin.jsonl"))
    prev = set_active_sink(sink)
    try:
        engine = ServingEngine(model, preempt_quantum=0, **engine_kw)
        for a in schedule:
            engine.submit(a.path, a.request_class, request_id=a.request_id)
        summary = engine.run(max_wall_s=600.0)
        return engine.reports(), summary
    finally:
        set_active_sink(prev)
        sink.close()


def _metric_parity(twin_reports: Dict, fleet_reports: Dict) -> Dict:
    """The worst relative difference of a per-request metric mean between
    the twin and the fleet's terminal reports, and whether every stream
    served the twin's window count."""
    from esr_tpu_torch.inference.engine import METRIC_KEYS

    worst = 0.0
    worst_at: Optional[Tuple[str, str]] = None
    compared = 0
    windows_match = True
    for rid, fleet_rep in fleet_reports.items():
        if fleet_rep.get("status") != "ok":
            continue
        twin_rep = twin_reports[rid]
        if fleet_rep["n_windows"] != twin_rep["n_windows"]:
            windows_match = False
        compared += 1
        for key in METRIC_KEYS:
            a, b = float(twin_rep[key]), float(fleet_rep[key])
            rel = abs(a - b) / max(abs(a), 1e-12)
            if rel > worst:
                worst, worst_at = rel, (rid, key)
    return {"max_rel_diff": worst, "at": worst_at, "compared": compared,
            "windows_match": windows_match}


def _killed_streams(router_file: str, plan: FaultPlan) -> Dict[str, int]:
    """Streams each ``replica_kill`` left to fail over, from the router's
    ``recovery_replica_failover`` events."""
    from esr_tpu_torch.obs.report import read_telemetry

    kills = {s.fault_id for s in plan.injected if s.kind == "replica_kill"}
    _, records, _ = read_telemetry(router_file)
    return {r["replica"]: int(r["streams"]) for r in records
            if r.get("name") == "recovery_replica_failover" and r.get("fault_id") in kills}


def run_fleet_scenario(out_dir: str, model, streams: Sequence, data_config: Dict,
                       classes: Dict, seed: int = 0, lanes: int = LANES,
                       activity_tile: int = 8, device=None,
                       between: Optional[Callable[[], None]] = None) -> Dict:
    """The scenario (module docstring) over ``streams`` (paths or in-memory
    recordings), classes dealt round robin; returns the summary, every
    check a boolean under ``checks`` and ``ok`` their conjunction.
    ``between`` is called once after the twin's run and before the fleet is
    built, so a caller can read and reset per-run counters (kernel launches)
    for each half on its own."""
    from esr_tpu_torch.obs import LiveAggregator, TelemetrySink, set_active_sink
    from esr_tpu_torch.obs.fleetview import FleetAggregator, http_fetch, start_fleet_plane
    from esr_tpu_torch.obs.report import percentile, report_files
    from esr_tpu_torch.serving.fleet import FleetRouter, ReplicaSupervisor
    from esr_tpu_torch.serving.loadgen import poisson_schedule
    from esr_tpu_torch.serving.replica import Replica

    os.makedirs(out_dir, exist_ok=True)
    schedule = poisson_schedule(streams, rate_hz=RATE_HZ, seed=seed, classes=tuple(classes))
    engine_kw = dict(dataset_config=data_config, lanes=lanes, classes=classes,
                     default_class=next(iter(classes)), activity_tile=activity_tile,
                     device=device)
    twin_reports, twin_summary = _run_twin(out_dir, model, schedule, engine_kw)
    if between is not None:
        between()

    plan = build_fleet_plan(seed)
    live_slo = os.path.join(_CONFIGS, "slo.yml")
    replica_files = {f"r{i}": os.path.join(out_dir, f"telemetry_r{i}.jsonl")
                     for i in range(N_REPLICAS)}
    replicas = [Replica(rid, model, data_config, telemetry_path=path, classes=classes,
                        default_class=engine_kw["default_class"], lanes=lanes,
                        live_slo=live_slo, preempt_quantum=0, activity_tile=activity_tile,
                        device=device).start()
                for rid, path in sorted(replica_files.items())]
    router_file = os.path.join(out_dir, "telemetry_router.jsonl")
    router_sink = TelemetrySink(router_file)
    prev = set_active_sink(router_sink)
    fleet_agg = FleetAggregator(scrape_budget=2)
    fleet_agg.attach_local("router", LiveAggregator().attach(router_sink))
    fetch_s = []

    def timed_fetch(url: str, timeout_s: float):
        t0 = time.perf_counter()
        try:
            return http_fetch(url, timeout_s)
        finally:
            fetch_s.append(time.perf_counter() - t0)

    router = FleetRouter(replicas, default_class=engine_kw["default_class"],
                         failover_budget=2, miss_budget=2,
                         supervisor=ReplicaSupervisor(miss_budget=2, fetch=timed_fetch,
                                                      observer=fleet_agg.ingest))
    fleet_plane = None
    fleet_view = fleet_slo = None
    t0 = time.monotonic()
    try:
        fleet_plane = start_fleet_plane(
            replicas, port=0, slo_path=live_slo, fleet=fleet_agg,
            topology=lambda: {"ring_ownership": router.ring.ownership()})
        with installed(plan):
            summary = router.run(arrivals=schedule, max_wall_s=600.0)
        # one last pull so the merged view covers the survivors' whole run,
        # taken while their planes are still up
        fleet_agg.scrape_once()
        fleet_view = fleet_plane.server.fleet_doc()
        _, fleet_slo = fleet_plane.server.slo_doc()
    finally:
        if fleet_plane is not None:
            fleet_plane.close()
        router.close()
        set_active_sink(prev)
        router_sink.close()
    wall = time.monotonic() - t0

    fleet_reports = router.reports()
    parity = _metric_parity(twin_reports, fleet_reports)
    merged_args = [f"router={router_file}"] + [f"{rid}={path}" for rid, path
                                                in sorted(replica_files.items())]
    merged_doc, merged_code = report_files(
        merged_args, os.path.join(_CONFIGS, "slo_fleet.yml"),
        out_path=os.path.join(out_dir, "FLEET_REPORT.json"))
    faults = merged_doc["report"]["faults"]
    # the offline side of the fleet view: the live /slo's file over the
    # router and the surviving replicas (the dead are stale in the view)
    dead = sorted(rid for rid, state in summary["replicas"].items() if state == "dead")
    survivor_args = [f"router={router_file}"] + [
        f"{rid}={path}" for rid, path in sorted(replica_files.items()) if rid not in dead]
    _survivors, survivor_code = report_files(
        survivor_args, live_slo, out_path=os.path.join(out_dir, "FLEET_VIEW_REPORT.json"))
    killed = _killed_streams(router_file, plan)

    result = {
        "seed": seed,
        "wall_s": round(wall, 3),
        "summary": summary,
        "twin_summary": twin_summary,
        "parity": parity,
        "reports": fleet_reports,
        "faults": faults,
        "classes": merged_doc["report"]["serving"]["classes"],
        "killed_streams": killed,
        "abandoned_memory": {rep.replica_id: rep.abandoned_memory for rep in replicas
                             if rep.abandoned_memory is not None},
        "supervision": {"fetches": len(fetch_s),
                        "fetch_ms_p50": (None if not fetch_s
                                         else round(percentile(fetch_s, 50) * 1e3, 3))},
        "merged_report": os.path.join(out_dir, "FLEET_REPORT.json"),
        "fleet_view": fleet_view,
        "fleet_slo": fleet_slo,
        "telemetry": {"router": router_file, **replica_files,
                      "twin": os.path.join(out_dir, "telemetry_twin.jsonl")},
        "checks": {
            "zero_lost": bool(summary["zero_lost"]),
            "all_requests_ok": all(r["status"] == "ok" for r in fleet_reports.values()),
            "all_faults_fired": plan.pending_count() == 0,
            "enough_faults": faults["injected"] >= 3,
            "all_faults_recovered": faults["unrecovered"] == 0,
            "migrated": summary["migrations"] >= 1,
            "failed_over": summary["failovers"] >= 1,
            "replica_died": "dead" in summary["replicas"].values(),
            # the fail-over check is not hollow: the killed replica held
            # streams when it died
            "killed_held_streams": bool(killed) and min(killed.values()) >= 1,
            "twin_parity": (parity["max_rel_diff"] <= PARITY_RTOL
                            and parity["windows_match"] and parity["compared"] >= 1),
            "merged_slo_ok": merged_code == 0,
            "fleet_killed_stale": (
                fleet_view is not None and bool(dead) and all(
                    fleet_view["replicas"][rid]["stale"] and rid in fleet_view["excluded"]
                    for rid in dead)),
            "fleet_survivors_merged": (
                fleet_view is not None and "local:router" in fleet_view["merged"]
                and all(rid in fleet_view["merged"] for rid in replica_files
                        if rid not in dead)),
            "fleet_slo_matches_offline": (
                fleet_slo is not None
                and (fleet_slo["verdict"] == "ok") == (survivor_code == 0)),
        },
    }
    result["ok"] = all(result["checks"].values())
    return result


def main(argv=None) -> int:
    import argparse

    import torch

    from esr_tpu_torch.models.esr import DeepRecurrNet
    from esr_tpu_torch.serving.loadgen import make_stream_corpus

    p = argparse.ArgumentParser(description="the scripted fleet chaos scenario")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    torch.manual_seed(args.seed)
    model = DeepRecurrNet(inch=2, basech=2, num_frame=3)
    streams = make_stream_corpus(n=N_STREAMS, seed=args.seed, events_schedule=EVENTS_SCHEDULE)
    summary = run_fleet_scenario(args.out, model, streams, dataset_config(), serving_classes(),
                                 seed=args.seed, device=args.device)
    with open(os.path.join(args.out, "FLEET_CHAOS_SUMMARY.json"), "w") as f:
        json.dump(summary, f, indent=2, default=str)
    print(json.dumps({
        "ok": summary["ok"], "checks": summary["checks"],
        "statuses": summary["summary"]["statuses"],
        "migrations": summary["summary"]["migrations"],
        "failovers": summary["summary"]["failovers"],
        "parity_max_rel_diff": summary["parity"]["max_rel_diff"],
        "faults": {k: summary["faults"][k] for k in ("injected", "recovered", "unrecovered")},
    }))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
