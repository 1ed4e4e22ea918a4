"""Serving entry point of the port: one replica, or a fleet of replicas
behind a router, serving a stream corpus.

    python -m esr_tpu_torch.serve --model_path <ckpt-dir> --output_path out/ \\
        (--data_list streams.txt | --loadgen N [--loadgen_kind synthetic|simulate]) \\
        [--rate 4] [--seed 0] \\
        [--lanes 4] [--classes interactive:2,standard:8,bulk:16] \\
        [--default_class standard] [--max_pending 64] [--preempt_quantum 4] \\
        [--max_wall S] [--device cuda|cpu] [--live-port P] [--live-slo YAML] \\
        [--replicas N] [--fleet-port P] [--heartbeat_misses 3] \\
        [--failover_retries 1] [--supervise_interval S] [dataset flags as infer.py]

Arrivals come on a seeded Poisson schedule at ``--rate`` streams/s, with the
classes dealt round robin; ``--loadgen N`` serves N seeded in-memory
streams instead of a datalist: random-walk ones, or with ``--loadgen_kind
simulate`` rendered scenes through the ESIM simulator (``tools/simulate.py``,
no cv2 or h5py), one replica or a fleet alike. ``--classes`` takes
``name:chunk_windows[:min_activity]`` entries; a class with
``min_activity > 0`` skips windows whose active-tile fraction is below it.
The load generator's corpus is described in ``loadgen_corpus.json`` (its
kind, seed, build seconds and each stream's event count per rung). One
replica writes ``serve_requests.jsonl`` (one report per request),
``serve_summary.json`` and ``telemetry.jsonl`` under ``--output_path`` and
prints the summary; ``--live-port`` (0: ephemeral) serves ``/metrics``,
``/healthz``, ``/slo`` (against ``--live-slo``) and ``/snapshot`` while it
runs. ``--replicas N`` (N > 1) runs the fleet (:func:`run_fleet`): N
replicas, each with its own engine, ``telemetry_r<i>.jsonl`` and live
plane, behind a consistent-hash router with supervision, drain / handoff
and fail-over, writing ``telemetry_router.jsonl``,
``fleet_requests.jsonl`` and ``fleet_summary.json``; ``--fleet-port``
serves the merged fleet view. ``python -m esr_tpu_torch.obs report
<files> --slo configs/slo.yml`` rolls the telemetry up. It runs on the card
unless ``--device cpu`` is given. ``--precision`` picks the rung (f32,
bf16 or int8, or an alias); omitted, the checkpoint's
``trainer.precision``, else f32. ``--profile-steps N`` records the first N
dispatched chunks with ``torch.profiler`` into ``<output_path>/profile``
(a ``profiler_capture`` event in the telemetry). ``--aot`` exports one
chunk program per distinct class depth (``inference/export.py``, at the
session's lanes, grid, rung and device) into ``<output_path>/aot/`` before
serving, and serves through them: the serving loop never traces. A fleet
resolves them through an ``AotRegistry`` of that directory at each
replica's cold start. The checkpoint's model is the flagship or a
UNet-family windowed model (the second shipped recipe's
``SRUNetRecurrentSeq``), whose lane state is its flat ``(h, c)`` leaves.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import Dict, Optional, Sequence

from esr_tpu_torch.config.precision import PRECISION_SPELLINGS, resolve_precision


def get_flags(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="ESR serving (PyTorch/CUDA port)")
    p.add_argument("--model_path", type=str, required=True, help="checkpoint dir")
    p.add_argument("--data_list", type=str, default=None, help="datalist of streams")
    p.add_argument("--loadgen", type=int, default=None,
                   help="serve N seeded load-generated streams instead of a datalist")
    p.add_argument("--loadgen_kind", type=str, default="synthetic",
                   choices=["synthetic", "simulate"],
                   help="synthetic = random-walk streams (fast); simulate = ESIM "
                        "contrast-threshold simulation of rendered scenes")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--rate", type=float, default=4.0, help="Poisson arrivals per second")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lanes", type=int, default=4)
    p.add_argument("--classes", type=str, default="interactive:2,standard:8,bulk:16",
                   help="name:chunk_windows[:min_activity][,...]")
    p.add_argument("--default_class", type=str, default="standard")
    p.add_argument("--max_pending", type=int, default=64)
    p.add_argument("--preempt_quantum", type=int, default=4, help="0 disables preemption")
    p.add_argument("--max_wall", type=float, default=None, help="bound on the loop, seconds")
    p.add_argument("--lane_quarantine_k", type=int, default=3)
    p.add_argument("--request_retries", type=int, default=1)
    p.add_argument("--replicas", type=int, default=1,
                   help="serving replicas; >1 runs the fleet router (per-replica "
                        "telemetry files, /snapshot supervision, drain/handoff, fail-over)")
    p.add_argument("--failover_retries", type=int, default=1,
                   help="times a request lost to a dead replica is re-admitted elsewhere "
                        "before failover_retry_exhausted (fleet)")
    p.add_argument("--heartbeat_misses", type=int, default=3,
                   help="failed polls in a row before a replica is declared dead (fleet)")
    p.add_argument("--supervise_interval", type=float, default=None, metavar="S",
                   help="poll replicas from a supervisor thread every S seconds "
                        "(default: inline, each router round)")
    p.add_argument("--aot", action="store_true", default=False,
                   help="export one chunk program per class depth into "
                        "<output_path>/aot and serve through them (never traces)")
    p.add_argument("--live-port", dest="live_port", type=int, default=None, metavar="PORT",
                   help="serve /metrics, /healthz, /slo and /snapshot on this port "
                        "(0 = ephemeral; default off)")
    p.add_argument("--live-slo", dest="live_slo", type=str, default="configs/slo.yml",
                   help="SLO YAML the live /slo endpoint evaluates")
    p.add_argument("--fleet-port", dest="fleet_port", type=int, default=None, metavar="PORT",
                   help="serve the merged fleet view (/metrics, /healthz quorum, /slo, "
                        "/fleet, /snapshot) on this port (fleet only; default off)")
    p.add_argument("--profile-steps", dest="profile_steps", type=int, default=0,
                   help="torch.profiler trace of the first N dispatched chunks into "
                        "<output_path>/profile, stamped as a profiler_capture event")
    p.add_argument("--precision", type=str, default=None, choices=PRECISION_SPELLINGS,
                   help="compute precision: f32, bf16 or int8, or an alias (default: "
                        "the checkpoint's trainer.precision, else f32; int8 = "
                        "post-training quantization at the contraction seams)")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--seqn", type=int, default=3)
    p.add_argument("--seql", type=int, default=9)
    p.add_argument("--step_size", type=int, default=None)
    p.add_argument("--time_bins", type=int, default=1)
    p.add_argument("--ori_scale", type=str, default="down4")
    p.add_argument("--mode", type=str, default="events")
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--sliding_window", type=int, default=1024)
    return p.parse_args(argv)


def parse_classes(spec: str) -> Dict:
    """``name:chunk_windows[:min_activity][,...]`` -> request classes."""
    from esr_tpu_torch.serving.scheduler import RequestClass

    out = {}
    for part in spec.split(","):
        name, _, rest = part.strip().partition(":")
        w, _, min_act = rest.partition(":")
        if not name or not w:
            raise ValueError(f"bad --classes entry {part!r} "
                             "(want name:chunk_windows[:min_activity])")
        out[name] = RequestClass(name, chunk_windows=int(w),
                                 min_activity=float(min_act) if min_act else 0.0)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    flags = get_flags(argv)
    if (flags.data_list is None) == (flags.loadgen is None):
        raise SystemExit("pass exactly one of --data_list / --loadgen")
    logging.basicConfig(level=logging.INFO)

    from esr_tpu_torch.data.records import LADDER
    from esr_tpu_torch.inference.checkpoint import load_checkpoint
    from esr_tpu_torch.obs import TelemetrySink, set_active_sink
    from esr_tpu_torch.serving.loadgen import make_stream_corpus, poisson_schedule
    from esr_tpu_torch.serving.server import ServingEngine

    model, config = load_checkpoint(flags.model_path)
    precision = resolve_precision(
        cli=flags.precision, config=(config.get("trainer") or {}).get("precision"))
    classes = parse_classes(flags.classes)
    dataset_config = {
        "scale": flags.scale, "ori_scale": flags.ori_scale, "time_bins": flags.time_bins,
        "need_gt_frame": False, "need_gt_events": True, "mode": flags.mode,
        "window": flags.window, "sliding_window": flags.sliding_window,
        "data_augment": {"enabled": False, "augment": [], "augment_prob": []},
        "sequence": {"sequence_length": flags.seql, "seqn": flags.seqn,
                     "step_size": flags.step_size, "pause": {"enabled": False}},
    }
    engine_kw = dict(
        seqn=flags.seqn, max_pending=flags.max_pending, preempt_quantum=flags.preempt_quantum,
        lane_quarantine_k=flags.lane_quarantine_k, request_retries=flags.request_retries,
        profile_steps=flags.profile_steps, profile_dir=os.path.join(flags.output_path, "profile"),
        precision=precision, device=flags.device,
    )
    if flags.loadgen is not None:
        t0 = time.perf_counter()
        streams = make_stream_corpus(n=flags.loadgen, seed=flags.seed, kind=flags.loadgen_kind)
        corpus_doc = {"kind": flags.loadgen_kind, "seed": flags.seed,
                      "build_s": time.perf_counter() - t0,
                      "events": {s.name: {rung: s.stream(rung).num_events for rung in LADDER}
                                 for s in streams}}
        logging.info("loadgen: %d %s streams built in %.3f s", len(streams),
                     flags.loadgen_kind, corpus_doc["build_s"])
    else:
        from esr_tpu_torch.data.loader import read_datalist

        streams = read_datalist(flags.data_list)
    schedule = poisson_schedule(streams, rate_hz=flags.rate, seed=flags.seed,
                                classes=tuple(sorted(classes)))
    os.makedirs(flags.output_path, exist_ok=True)
    if flags.loadgen is not None:
        with open(os.path.join(flags.output_path, "loadgen_corpus.json"), "w") as f:
            json.dump(corpus_doc, f, indent=2)
    aot_programs = export_chunk_programs(flags, streams[0], dataset_config, classes,
                                         precision) if flags.aot else None
    if flags.replicas > 1:
        return run_fleet(flags, model, dataset_config, classes, schedule, engine_kw,
                         aot_programs)

    sink = TelemetrySink(os.path.join(flags.output_path, "telemetry.jsonl"))
    prev = set_active_sink(sink)
    server = None
    try:
        server = ServingEngine(
            model, dataset_config, lanes=flags.lanes, classes=classes,
            default_class=flags.default_class, aot_programs=aot_programs,
            live_port=flags.live_port,
            live_slo=flags.live_slo if flags.live_port is not None else None, **engine_kw,
        )
        if server.live is not None:
            print(f"# live telemetry: http://127.0.0.1:{server.live.port}"
                  "/{metrics,healthz,slo,snapshot}", file=sys.stderr)
        summary = server.run(arrivals=schedule, max_wall_s=flags.max_wall)
    finally:
        if server is not None:
            server.close_live()
        set_active_sink(prev)
        sink.close()

    with open(os.path.join(flags.output_path, "serve_requests.jsonl"), "w") as f:
        for rid in sorted(server.reports()):
            f.write(json.dumps(server.report(rid)) + "\n")
    with open(os.path.join(flags.output_path, "serve_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


def export_chunk_programs(flags: argparse.Namespace, probe_stream, dataset_config: Dict,
                          classes: Dict, precision: str) -> Dict[int, str]:
    """``--aot``: one chunk program per distinct class depth, exported from
    ``--model_path`` at the session's lanes, GT grid (read off the first
    stream), rung and device into ``<output_path>/aot/``; ``{W: path}``."""
    from esr_tpu_torch.inference.export import export_checkpoint
    from esr_tpu_torch.serving.server import RecordingStream

    kh, kw = RecordingStream(probe_stream, dataset_config).gt_resolution
    out = {}
    for w in sorted({c.chunk_windows for c in classes.values()}):
        path = os.path.join(flags.output_path, "aot", f"chunk_program.w{w}.pt2")
        export_checkpoint(flags.model_path, path, batch=flags.lanes, height=kh, width=kw,
                          program="engine_chunk", chunk_windows=w, scale=flags.scale,
                          precision=precision, device=flags.device)
        out[w] = path
    return out


def run_fleet(flags: argparse.Namespace, model, dataset_config: Dict, classes: Dict,
              schedule, engine_kw: Dict, aot_programs: Optional[Dict[int, str]] = None
              ) -> Dict:
    """``--replicas N``: N replicas (each its own ``ServingEngine``,
    telemetry file and live plane) behind a consistent-hash router with
    supervision, drain / handoff and fail-over. Writes
    ``telemetry_r<i>.jsonl``, ``telemetry_router.jsonl``,
    ``fleet_requests.jsonl`` and ``fleet_summary.json``; per-class
    percentiles come from the merged report over the telemetry files. With
    ``aot_programs`` every replica resolves its chunk programs through an
    ``AotRegistry`` of their directory at its cold start."""
    from esr_tpu_torch.obs import LiveAggregator, TelemetrySink, set_active_sink
    from esr_tpu_torch.serving.fleet import FleetRouter, ReplicaSupervisor
    from esr_tpu_torch.serving.replica import AotRegistry, Replica

    out = flags.output_path
    registry = None
    if aot_programs:
        registry = AotRegistry(os.path.dirname(next(iter(aot_programs.values()))))
    replicas = [
        Replica(f"r{i}", model, dataset_config,
                telemetry_path=os.path.join(out, f"telemetry_r{i}.jsonl"),
                classes=classes, default_class=flags.default_class, lanes=flags.lanes,
                live_slo=flags.live_slo, aot_registry=registry, **engine_kw).start()
        for i in range(flags.replicas)
    ]
    for rep in replicas:
        print(f"# replica {rep.replica_id}: http://127.0.0.1:{rep.port}/"
              "{metrics,healthz,slo,snapshot}", file=sys.stderr)
    router_sink = TelemetrySink(os.path.join(out, "telemetry_router.jsonl"))
    prev = set_active_sink(router_sink)
    fleet_plane = supervisor = fleet_agg = None
    if flags.fleet_port is not None:
        from esr_tpu_torch.obs.fleetview import FleetAggregator, start_fleet_plane

        # the supervisor's /snapshot polls feed the fleet view (no extra
        # fetches); the router's own records join the merge as a local
        fleet_agg = FleetAggregator(scrape_budget=flags.heartbeat_misses)
        fleet_agg.attach_local("router", LiveAggregator().attach(router_sink))
        supervisor = ReplicaSupervisor(miss_budget=flags.heartbeat_misses,
                                       observer=fleet_agg.ingest)
    router = FleetRouter(replicas, default_class=flags.default_class,
                         failover_budget=flags.failover_retries,
                         miss_budget=flags.heartbeat_misses,
                         supervise_interval_s=flags.supervise_interval, supervisor=supervisor)
    try:
        if fleet_agg is not None:
            fleet_plane = start_fleet_plane(
                replicas, port=flags.fleet_port, slo_path=flags.live_slo, fleet=fleet_agg,
                topology=lambda: {"ring_ownership": router.ring.ownership()})
            print(f"# fleet view: http://127.0.0.1:{fleet_plane.port}/"
                  "{metrics,healthz,slo,fleet}", file=sys.stderr)
        summary = router.run(arrivals=schedule, max_wall_s=flags.max_wall)
        if fleet_plane is not None:
            summary["fleet_view"] = fleet_plane.server.fleet_doc()
    finally:
        if fleet_plane is not None:
            fleet_plane.close()
        router.close()
        set_active_sink(prev)
        router_sink.close()

    with open(os.path.join(out, "fleet_requests.jsonl"), "w") as f:
        for _rid, rep in sorted(router.reports().items()):
            f.write(json.dumps(rep) + "\n")
    with open(os.path.join(out, "fleet_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    files = " ".join(os.path.join(out, name) for name in
                     ["telemetry_router.jsonl"]
                     + [f"telemetry_r{i}.jsonl" for i in range(flags.replicas)])
    print(f"# fleet rollup and SLO verdict:\n"
          f"#   python -m esr_tpu_torch.obs report {files} --slo configs/slo.yml",
          file=sys.stderr)
    return summary


if __name__ == "__main__":
    main()
