"""The port's serving tier and fleet against the reference's, on the CPU.

- the half-idle corpus of ``tests/test_sparse_smoke.py`` (bursty and
  uniform streams, time-mode windows) served by the port's and by the JAX
  ``ServingEngine`` with the sparse model and a gated class: the same
  skipped counts exactly, per-request metric means within rtol 1e-5;
- preemption and resume (a preempted stream's metrics equal the same
  stream served alone), backpressure (``AdmissionFull``), lane quarantine
  after ``lane_quarantine_k`` faults, bad streams, the refusals of the
  options (an AOT session missing a depth);
- the ``serve_chunk`` fault site: one plan (a lane fault, a preemption
  signal) in both engines gives the same retries, statuses and windows,
  metrics within rtol 1e-5, every fault paired with its recovery;
- the live plane (``live_port=0``): ``/metrics``, ``/healthz``, ``/slo``
  and ``/snapshot`` scraped mid-session, the session's telemetry file
  green against ``configs/slo.yml``, and ``/healthz`` 503 on a quarantined
  lane;
- the ESRLANE1 wire format across the packages: a stream evicted from the
  JAX engine resumes in the port's through ``admit_handoff`` and the
  reverse, both within rtol 1e-5 of an unmigrated run, and equal states
  pack to equal bytes in both;
- the host-only copies (scheduler, load generator, percentile) against the
  reference, and ``python -m esr_tpu_torch.serve --device cpu --loadgen 4``
  with one replica and with ``--replicas 3`` (the fleet's files), the
  fleet with the supervisor's poller thread on (``--supervise_interval``),
  and ``serve --aot`` with one replica and with ``--replicas 2`` (through
  an ``AotRegistry``);
- the fleet, exactly the reference's where it is host code: ``HashRing``
  placement and ownership, ``build_fleet_plan`` for seeds 0-4,
  ``LiveAggregator`` snapshots from one record stream,
  ``render_prometheus`` and ``evaluate_slo_window`` on one snapshot under
  ``configs/slo.yml`` and ``configs/slo_fleet.yml``, ``/snapshot`` wire
  documents parsed by the other package both ways; the reference's
  ``report_files`` reads the port's telemetry files to the port's report;
  a replica's ``drain`` -> ``admit_handoff`` resumes a stream bitwise;
  ``ReplicaSupervisor`` over loopback HTTP (healthy, dead after
  ``miss_budget`` misses, recovered); the scripted chaos scenario on the
  corpus served twice (8 streams, a gated class): zero lost requests,
  three faults recovered, every stream within rtol 1e-5 of the JAX
  package's single ``ServingEngine`` with equal window counts;
- the UNet family (the second shipped recipe's ``SRUNetRecurrentSeq``,
  narrow): served by both packages at f32, bf16 and int8, every stream; its
  4-leaf lane state drained from one replica into another at bf16; and
  serving, ``serve`` (one replica, the
  fleet, ``--aot``), the AOT exports and the bf16 and int8 rungs through
  their entry points, each run to completion.

Measured on the CPU: served metric means ~5e-7 relative from the JAX tier.
"""

import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from esr_tpu.data.synthetic import write_synthetic_h5
from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
from esr_tpu.obs.aggregate import LiveAggregator as RefAggregator
from esr_tpu.obs.aggregate import parse_snapshot_wire as ref_parse
from esr_tpu.obs.aggregate import state_to_wire as ref_state_to_wire
from esr_tpu.obs.http import render_prometheus as ref_render
from esr_tpu.obs.report import evaluate_slo_window as ref_eval_window
from esr_tpu.obs.report import load_slo as ref_load_slo
from esr_tpu.obs.report import percentile as ref_percentile
from esr_tpu.obs.report import report_files as ref_report_files
from esr_tpu.resilience.chaos_fleet import build_fleet_plan as ref_build_plan
from esr_tpu.serving import RequestClass as RefClass
from esr_tpu.serving import ServingEngine as RefServing
from esr_tpu.serving.fleet import HashRing as RefRing
from esr_tpu.serving.loadgen import cohorts as ref_cohorts
from esr_tpu.serving.loadgen import fleet_traffic as ref_fleet_traffic
from esr_tpu.serving.loadgen import make_stream_corpus as ref_corpus
from esr_tpu.serving.loadgen import poisson_schedule as ref_poisson
from esr_tpu.serving.replica import pack_lane_state as ref_pack
from esr_tpu.serving.replica import unpack_lane_state as ref_unpack
from esr_tpu.serving.scheduler import LaneScheduler as RefScheduler
from esr_tpu.serving.scheduler import StreamRequest as RefRequest
from esr_tpu_torch.data.records import MemoryRecording
from esr_tpu_torch.inference.checkpoint import save_checkpoint
from esr_tpu_torch.inference.engine import METRIC_KEYS, extract_lane_state, inject_lane_state
from esr_tpu_torch.models import convert
from esr_tpu_torch.models.esr import DeepRecurrNet
from esr_tpu_torch.obs import TelemetrySink, set_active_sink
from esr_tpu_torch.obs.aggregate import LiveAggregator, parse_snapshot_wire, state_to_wire
from esr_tpu_torch.obs.http import render_prometheus, start_live_plane
from esr_tpu_torch.obs.report import (
    evaluate_slo_window,
    load_slo,
    percentile,
    percentile_ms,
    report_files,
)
from esr_tpu_torch.resilience.chaos_fleet import build_fleet_plan, run_fleet_scenario
from esr_tpu_torch.serving import wire
from esr_tpu_torch.serving.fleet import HashRing, ReplicaSupervisor
from esr_tpu_torch.data.records import H5Recording
from esr_tpu_torch.serving.loadgen import cohorts, fleet_traffic, make_stream_corpus, poisson_schedule
from esr_tpu_torch.serving.replica import Replica
from esr_tpu_torch.serving.scheduler import AdmissionFull, LaneScheduler, RequestClass, StreamRequest
from esr_tpu_torch.serving.server import ServingEngine


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work in one intra-op thread: at these sizes a
    thread team gains nothing, and beside other busy processes its
    spinning workers slow every op by orders of magnitude (the serving
    and fleet runs of this module most of all)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent
SLO_FILES = ("slo.yml", "slo_fleet.yml")
MIN_ACTIVITY = 0.3
ACTIVITY_TILE = 4
BURST_FRACS = [0.35, 1.0, 0.35, 1.0]
RTOL = 1e-5
DATASET_CFG = {
    "scale": 2, "ori_scale": "down8", "time_bins": 1, "mode": "time",
    "window": 0.08, "sliding_window": 0.04, "need_gt_events": True,
    "need_gt_frame": False,
    "data_augment": {"enabled": False, "augment": [], "augment_prob": []},
    "sequence": {"sequence_length": 4, "seqn": 3, "step_size": None,
                 "pause": {"enabled": False}},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serving")
    paths = []
    for i, bf in enumerate(BURST_FRACS):
        p = str(tmp / f"rec{i}.h5")
        # the reference's half-idle smoke corpus itself: the comparison is on it
        write_synthetic_h5(p, (64, 64), base_events=900, num_frames=6,  # esr: noqa(TX006)
                           seed=20 + i,
                           burst_frac=bf)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def models():
    """The reference's model and seeded params on its own tree, and the
    port's sparse model with the same weights."""
    ref = FlaxNet(inch=2, basech=2, num_frame=3)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, 16, 16, 2), np.float32), ref.init_states(1, 16, 16))

    def draw(leaf):
        bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.3
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    params = jax.tree.map(draw, shapes)
    port = DeepRecurrNet(inch=2, basech=2, num_frame=3, dcn_sparse=True)
    convert.load_flax_params(port, params)
    return ref, params, port.eval()


def _classes(cls=RequestClass, w=2, min_activity=MIN_ACTIVITY):
    return {"c": cls("c", chunk_windows=w, min_activity=min_activity)}


def _port(models, **kw):
    kw.setdefault("classes", _classes())
    kw.setdefault("preempt_quantum", 0)
    return ServingEngine(models[2], DATASET_CFG, lanes=kw.pop("lanes", 2), default_class="c",
                         activity_tile=ACTIVITY_TILE, device="cpu", **kw)


def _ref(models, **kw):
    kw.setdefault("preempt_quantum", 0)
    return RefServing(models[0], models[1], DATASET_CFG, lanes=kw.pop("lanes", 2),
                      classes=_classes(RefClass), default_class="c",
                      activity_tile=ACTIVITY_TILE, **kw)


def _assert_metrics(got, want, rtol=RTOL):
    for k in METRIC_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.fixture(scope="module")
def served(corpus, models):
    ref = _ref(models)
    ref_ids = [ref.submit(p) for p in corpus]
    ref.run()
    port = _port(models)
    port_ids = [port.submit(p) for p in corpus]
    summary = port.run()
    return ([ref.report(r) for r in ref_ids], [port.report(r) for r in port_ids], summary)


def test_serving_matches_jax_serving_on_half_idle_corpus(served):
    ref, port, summary = served
    assert summary["completed"] == len(port) and summary["windows_skipped"] > 0
    for r, p in zip(ref, port):
        assert p["status"] == "ok" and p["completed"]
        assert (p["n_windows"], p["n_windows_skipped"]) == (r["n_windows"], r["n_windows_skipped"])
        _assert_metrics(p, r)
    # the bursty streams skip their idle tails, the uniform ones nothing
    assert [p["n_windows_skipped"] > 0 for p in port] == [True, False, True, False]


def test_preemption_resumes_where_it_left_off(corpus, models):
    """One lane, two long streams, quantum 1: each is evicted and resumed
    with its state injected back, and ends as if served alone."""
    # the port's engines build no program: one per configuration is cheap
    port = _port(models, lanes=1, preempt_quantum=1,  # esr: noqa(TX001) - no trace
                 classes=_classes(min_activity=0.0))
    rids = [port.submit(p) for p in (corpus[1], corpus[3])]
    summary = port.run()
    assert summary["preemptions"] >= 2 and summary["completed"] == 2
    for rid, path in zip(rids, (corpus[1], corpus[3])):
        alone = _port(models, lanes=1, classes=_classes(min_activity=0.0))
        aid = alone.submit(path)
        alone.run()
        got, want = port.report(rid), alone.report(aid)
        assert got["preemptions"] >= 1 and got["n_windows"] == want["n_windows"]
        _assert_metrics(got, want, rtol=1e-6)


def test_backpressure_raises_admission_full(corpus, models):
    port = _port(models, max_pending=1)  # esr: noqa(TX001) - no trace
    port.submit(corpus[0])
    with pytest.raises(AdmissionFull):
        port.submit(corpus[1])
    with pytest.raises(ValueError, match="duplicate"):
        port.submit(corpus[2], request_id="req-00000")
    summary = port.run()
    assert summary["rejected"] == 1 and summary["completed"] == 1


class _FaultyRecording(MemoryRecording):
    """A recording whose event reads fail: its stream faults inside the
    chunk loop, on the lane that pulls it."""

    def stream(self, prefix):
        s = super().stream(prefix)

        class _Broken(type(s)):
            def window(self, idx0, idx1):
                raise OSError("read failed")

        s.__class__ = _Broken
        return s


def test_lane_quarantine_after_k_faults(corpus, models):
    from esr_tpu_torch.data.synthetic import make_synthetic_recording

    good = make_synthetic_recording((64, 64), base_events=900, num_frames=6, seed=20)
    bad = _FaultyRecording(good.sensor_resolution,
                           {k: (s._xs, s._ys, s.ts, s._ps) for k, s in good._streams.items()},
                           name="faulty")
    port = _port(models, lane_quarantine_k=2, request_retries=1,  # esr: noqa(TX001) - no trace
                 classes=_classes(min_activity=0.0))
    bad_id = port.submit(bad)
    ok_id = port.submit(corpus[1])
    summary = port.run()
    bad_report = port.report(bad_id)
    assert bad_report["status"] in ("faulted", "quarantine_exhausted")
    assert bad_report["error_kind"] == "io" and bad_report["retries"] == 1
    assert port.report(ok_id)["status"] == "ok"
    assert summary["quarantined_lanes"] and summary["recoveries"]["recovery_lane_quarantine"] == 1
    assert summary["recoveries"]["recovery_request_retry"] == 1
    # a stream of another resolution fails at bind, alone
    port2 = _port(models)
    odd = make_synthetic_recording((128, 128), base_events=900, num_frames=6, seed=1)
    ids = [port2.submit(corpus[0]), port2.submit(odd)]
    port2.run()
    assert port2.report(ids[1])["status"] == "bad_stream"
    assert port2.report(ids[0])["status"] == "ok"


def test_unported_options_raise(models, corpus, tmp_path):
    # AOT chunk programs are ported: a session whose class depth has no
    # artifact raises at its first dispatch, naming the depth (the
    # reference's refusal), before any file is read
    server = _port(models, aot_programs={8: str(tmp_path / "nope.pt2")})  # esr: noqa(TX001) - raises
    server.submit(corpus[0])
    with pytest.raises(KeyError, match="chunk_windows=2"):
        server.run()
    # the profiler capture is ported: the first chunk is recorded to a
    # Chrome trace, stamped as a profiler_capture event
    from esr_tpu_torch.obs import TelemetrySink, set_active_sink

    server = _port(models, profile_steps=1, profile_dir=str(tmp_path / "profile"))  # esr: noqa(TX001) - one session
    sink = TelemetrySink(str(tmp_path / "telemetry.jsonl"))
    prev = set_active_sink(sink)
    try:
        server.submit(corpus[0])
        server.run()
    finally:
        set_active_sink(prev)
        sink.close()
    with open(tmp_path / "telemetry.jsonl") as f:
        (cap,) = [r for r in map(json.loads, f) if r["name"] == "profiler_capture"]
    assert cap["ok"] and cap["site"] == "serving" and cap["steps_covered"] == 1
    assert Path(cap["file"]).is_file() and cap["dir"] == str(tmp_path / "profile")
    # the precision rungs are ported: a bf16 session's lanes live in bf16
    server = _port(models, precision="bf16")  # esr: noqa(TX001) - no trace
    assert (server.precision, server.compute_dtype) == ("bf16", torch.bfloat16)
    with pytest.raises(ValueError, match="unknown precision"):
        _port(models, precision="fp8")
    with pytest.raises(ValueError, match="default_class"):
        ServingEngine(models[2], DATASET_CFG, default_class="nope",  # esr: noqa(TX001) - raises
                      device="cpu")


def _evict_after(engine, rounds):
    for _ in range(rounds):
        engine.pump()
    entries = engine.evacuate()
    assert len(entries) == 1 and entries[0]["state"] is not None
    return entries[0]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_esrlane1_handoff_across_packages(corpus, models, direction):
    """A stream evicted after two chunks from one package's engine, its state
    packed by that package's ``pack_lane_state``, resumes in the other's
    through ``admit_handoff`` and ends within rtol 1e-5 of an unmigrated
    run; the two packages pack the same state to the same bytes."""
    path = corpus[1]
    unmigrated = _port(models, lanes=1)  # esr: noqa(TX001) - no trace
    uid = unmigrated.submit(path)
    unmigrated.run()
    src = _ref(models, lanes=1) if direction == "jax_to_port" else _port(models, lanes=1)
    dst = _port(models, lanes=1) if direction == "jax_to_port" else _ref(models, lanes=1)
    src.submit(path, request_id="s")
    entry = _evict_after(src, 2)
    state = tuple(np.asarray(a) for a in entry["state"])
    packet = ref_pack(state) if direction == "jax_to_port" else wire.pack_lane_state(state)
    assert packet == wire.pack_lane_state(state) == ref_pack(state)
    if direction == "jax_to_port":
        got_state = wire.unpack_lane_state(packet, state)
    else:
        got_state = ref_unpack(packet, models[0].init_states(1, 1, 1))
    for a, b in zip(got_state, state):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert 0 < entry["windows_done"] < unmigrated.report(uid)["n_windows"]
    dst.admit_handoff(dict(entry, state=None), state=got_state)
    dst.run()
    got = dst.report("s")
    assert got["status"] == "ok" and got["handoffs"] == 1
    want = unmigrated.report(uid)
    assert (got["n_windows"], got["n_windows_skipped"]) == (want["n_windows"],
                                                             want["n_windows_skipped"])
    _assert_metrics(got, want)


def test_wire_rejects_torn_and_foreign_packets():
    state = (np.arange(6, dtype=np.float32).reshape(2, 3), np.ones((2, 3), np.float32))
    packet = wire.pack_lane_state(state)
    header, arrays = wire.read_wire(packet)
    assert header["keys"] == ["[0]", "[1]"] and header["schema"] == 1
    with pytest.raises(ValueError, match="magic"):
        wire.read_wire(b"NOTLANE1" + packet[8:])
    with pytest.raises(ValueError, match="torn"):
        wire.read_wire(packet[:-20])
    with pytest.raises(ValueError, match="digest"):
        wire.read_wire(packet.replace(header["digest"].encode(), b"0" * 64))
    ones = np.float32(1.0).tobytes()
    at = packet.rindex(ones)
    with pytest.raises(ValueError, match="torn|digest"):  # the zip CRC or the digest
        wire.read_wire(packet[:at] + np.float32(2.0).tobytes() + packet[at + 4:])
    with pytest.raises(ValueError, match="structure"):
        wire.unpack_lane_state(packet, (None,))


@pytest.mark.parametrize("packer", ["jax", "port"])
@pytest.mark.parametrize("family", ["flagship", "unet"])
def test_lane_state_crosses_the_wire_in_both_families(models, unet_models, family, packer):
    """A lane of the flagship (two ConvGRU states) or of the UNet family
    (an ``(h, c)`` pair per ConvLSTM encoder, nested in the reference's
    tree, flat in the port), packed by either package, unpacks bitwise in
    the other: the same keys (``jax.tree_util.keystr`` of the reference's
    tree), the same bytes; a packet read under the other family's keys
    raises."""
    ref_model, _, port = models if family == "flagship" else unet_models
    template = ref_model.init_states(1, 16, 16)
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    assert [p.shape for p in port.init_states(1, 16, 16)] == [leaf.shape for _, leaf in paths]
    rng = np.random.default_rng(7)
    flat = tuple(rng.standard_normal(leaf.shape[1:]).astype(np.float32) for _, leaf in paths)
    keys = wire.lane_state_keys(port, len(flat))
    assert keys == [jax.tree_util.keystr(p) for p, _ in paths]
    assert (family == "unet") == any("][" in k for k in keys)
    ref_state = jax.tree_util.tree_unflatten(treedef, flat)
    packet = ref_pack(ref_state) if packer == "jax" else wire.pack_lane_state(flat, keys)
    assert packet == ref_pack(ref_state) == wire.pack_lane_state(flat, keys)
    if packer == "jax":
        got = wire.unpack_lane_state(packet, port.init_states(1, 1, 1), keys)
    else:
        got = jax.tree_util.tree_leaves(ref_unpack(packet, ref_model.init_states(1, 1, 1)))
    assert len(got) == len(flat)
    for a, b in zip(got, flat):
        assert np.asarray(a).dtype == b.dtype and np.asarray(a).tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="structure"):
        wire.unpack_lane_state(packet, flat, [k + "[0]" for k in keys])


def test_scheduler_copy_matches_reference():
    """The same admissions, binds, preemptions and releases give the same
    lane maps, queues and chunk sizes in both schedulers."""
    rng = np.random.default_rng(4)
    port, ref = LaneScheduler(3, max_pending=4, preempt_quantum=2), \
        RefScheduler(3, max_pending=4, preempt_quantum=2)
    pcls = {w: RequestClass(f"w{w}", chunk_windows=w) for w in (2, 8)}
    rcls = {w: RefClass(f"w{w}", chunk_windows=w) for w in (2, 8)}
    for step in range(60):
        op = rng.integers(4)
        if op == 0:
            w = int(rng.choice([2, 8]))
            outs = []
            for sched, cls, req in ((port, pcls, StreamRequest), (ref, rcls, RefRequest)):
                try:
                    sched.submit(req(f"r{step}", "p", cls[w]))
                    outs.append("ok")
                except Exception as e:  # noqa: BLE001 - compared across the two
                    outs.append(type(e).__name__)
            assert outs[0] == outs[1]
        elif op == 1:
            assert ([(lane, r.request_id) for lane, r in port.bind_free_lanes(step)]
                    == [(lane, r.request_id) for lane, r in ref.bind_free_lanes(step)])
        elif op == 2:
            for sched in (port, ref):
                for r in sched.lanes:
                    if r is not None:
                        r.chunks_since_bind += 1
            cands = port.preempt_candidates()
            assert cands == ref.preempt_candidates()
            for lane in cands:
                port.evict(lane)
                ref.evict(lane)
        else:
            lane = int(rng.integers(3))
            port.release(lane)
            ref.release(lane)
        assert [r and r.request_id for r in port.lanes] == [r and r.request_id for r in ref.lanes]
        assert port.queue_depth() == ref.queue_depth()
        assert port.chunk_windows() == ref.chunk_windows() and port.rejected == ref.rejected
    with pytest.raises(ValueError):
        RequestClass("x", chunk_windows=0)


def test_loadgen_and_percentile_match_reference():
    streams = make_stream_corpus(n=3, seed=1, burst_schedule=(0.35, 1.0))
    assert [s.name for s in streams] == ["stream000", "stream001", "stream002"]
    port = poisson_schedule(streams, rate_hz=8.0, seed=0, classes=("a", "b"))
    ref = ref_poisson(["x"] * 3, rate_hz=8.0, seed=0, classes=("a", "b"))
    assert [(a.t, a.request_class, a.request_id) for a in port] == \
        [(a.t, a.request_class, a.request_id) for a in ref]
    with pytest.raises(ValueError):
        poisson_schedule(streams, rate_hz=0.0)
    vals = list(np.random.default_rng(5).random(17))
    for q in (0, 50, 99, 100):
        assert percentile(vals, q) == ref_percentile(vals, q)
    assert percentile([], 50) is None and percentile_ms([0.0123456], 50) == 12.346


def test_serve_entry_point_on_the_cpu(models, tmp_path):
    """``python -m esr_tpu_torch.serve --device cpu --loadgen 4`` in a
    subprocess: it serves every stream and writes its reports."""
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), models[1], {
        "model": {"name": "DeepRecurrNet",
                  "args": {"inch": 2, "basech": 2, "num_frame": 3, "dcn_sparse": True}},
        "trainer": {"precision": "f32"},
    })
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "esr_tpu_torch.serve", "--model_path", str(ckpt),
         "--output_path", str(out), "--device", "cpu", "--loadgen", "4", "--rate", "50",
         "--lanes", "2", "--classes", "standard:2,gated:2:0.05", "--scale", "2",
         "--ori_scale", "down8", "--window", "1024", "--sliding_window", "512",
         "--seql", "4", "--max_wall", "120"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["requests"] == summary["completed"] == 4
    reports = [json.loads(line) for line in (out / "serve_requests.jsonl").read_text().splitlines()]
    assert len(reports) == 4 and all(r["status"] == "ok" for r in reports)
    assert json.loads((out / "serve_summary.json").read_text()) == summary
    doc, code = report_files([str(out / "telemetry.jsonl")], str(REPO / "configs" / "slo.yml"))
    assert code == 0 and doc["report"]["serving"]["requests"] == 4
    # the fleet: three replicas behind the router, in this process
    from esr_tpu_torch import serve

    fleet_out = tmp_path / "fleet"
    fleet = serve.main(["--model_path", str(ckpt), "--output_path", str(fleet_out),
                        "--device", "cpu", "--loadgen", "4", "--rate", "50", "--lanes", "2",
                        "--classes", "standard:2,gated:2:0.05", "--scale", "2",
                        "--ori_scale", "down8", "--window", "1024", "--sliding_window", "512",
                        "--seql", "4", "--max_wall", "120", "--replicas", "3",
                        "--live-slo", str(REPO / "configs" / "slo.yml")])
    assert fleet["zero_lost"] and fleet["statuses"] == {"ok": 4}
    assert fleet["replicas"] == {"r0": "up", "r1": "up", "r2": "up"}
    rows = [json.loads(line) for line in (fleet_out / "fleet_requests.jsonl").read_text().splitlines()]
    assert len(rows) == 4 and all(r["status"] == "ok" and r["replica"] for r in rows)
    assert json.loads((fleet_out / "fleet_summary.json").read_text()) == fleet
    files = [str(fleet_out / f"telemetry_{n}.jsonl") for n in ("router", "r0", "r1", "r2")]
    doc, code = report_files(files, str(REPO / "configs" / "slo.yml"))
    assert code == 0 and doc["report"]["serving"]["requests"] == 4
    assert sum(r["requests"] for r in doc["report"]["replicas"].values()) == 4
    assert torch.get_num_threads() >= 1


def test_fleet_with_the_supervisor_thread(models, tmp_path):
    """``serve --replicas 3 --supervise_interval 0.05 --fleet-port 0``: the
    supervisor polls each replica's ``/snapshot`` from its own thread while
    the router serves from this one; no request is lost, every replica
    stays up and was polled, and the poller is gone once the fleet closes."""
    import threading

    from esr_tpu_torch import serve

    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), models[1], {
        "model": {"name": "DeepRecurrNet",
                  "args": {"inch": 2, "basech": 2, "num_frame": 3, "dcn_sparse": True}},
    })
    out = tmp_path / "fleet"
    fleet = serve.main(["--model_path", str(ckpt), "--output_path", str(out),
                        "--device", "cpu", "--loadgen", "4", "--rate", "50", "--lanes", "2",
                        "--classes", "standard:2,gated:2:0.05", "--scale", "2",
                        "--ori_scale", "down8", "--window", "1024", "--sliding_window", "512",
                        "--seql", "4", "--max_wall", "120", "--replicas", "3",
                        "--supervise_interval", "0.05", "--fleet-port", "0",
                        "--live-slo", str(REPO / "configs" / "slo.yml")])
    assert fleet["zero_lost"] and fleet["statuses"] == {"ok": 4}
    assert fleet["replicas"] == {"r0": "up", "r1": "up", "r2": "up"}
    view = fleet["fleet_view"]["replicas"]
    assert all(view[rid]["scrapes"] >= 1 and view[rid]["misses"] == 0
               for rid in ("r0", "r1", "r2")), view
    assert not [t for t in threading.enumerate() if t.name == "fleet-supervisor"]


def test_serve_aot_entry_point_one_replica_and_fleet(models, tmp_path):
    """``serve --aot --device cpu``: the entry point exports one chunk
    program per class depth into ``<output_path>/aot`` (the sidecar at the
    session's lanes, grid, rung and device) and serves every stream through
    it, with one replica and with ``--replicas 2`` (each replica resolving
    it through an ``AotRegistry``): every request ok, none lost."""
    from esr_tpu_torch import serve

    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), models[1], {
        "model": {"name": "DeepRecurrNet",
                  "args": {"inch": 2, "basech": 2, "num_frame": 3, "dcn_sparse": True}},
        "trainer": {"precision": "int8"},
    })
    args = ["--model_path", str(ckpt), "--device", "cpu", "--loadgen", "4", "--rate", "50",
            "--lanes", "2", "--classes", "standard:2", "--scale", "2", "--ori_scale", "down8",
            "--window", "1024", "--sliding_window", "512", "--seql", "4", "--max_wall", "120",
            "--aot", "--live-slo", str(REPO / "configs" / "slo.yml")]
    one = serve.main(args + ["--output_path", str(tmp_path / "one")])
    assert one["requests"] == one["completed"] == 4 and one["statuses"] == {"ok": 4}
    side = json.loads((tmp_path / "one" / "aot" / "chunk_program.w2.pt2.json").read_text())
    assert {k: side[k] for k in ("program", "lanes", "chunk_windows", "gt_hw", "lr_hw",
                                 "precision", "device")} == {
        "program": "engine_chunk", "lanes": 2, "chunk_windows": 2, "gt_hw": [16, 16],
        "lr_hw": [8, 8], "precision": "int8", "device": "cpu"}
    fleet = serve.main(args + ["--output_path", str(tmp_path / "fleet"), "--replicas", "2"])
    assert fleet["zero_lost"] and fleet["statuses"] == {"ok": 4}
    assert fleet["replicas"] == {"r0": "up", "r1": "up"}


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_live_plane_serves_metrics_healthz_slo_snapshot(corpus, models, tmp_path):
    """``live_port=0`` beside an active sink: the four endpoints answer
    mid-session, the plane's view matches the file's report, and a
    quarantined lane turns ``/healthz`` to 503 until the plane closes."""
    sink = TelemetrySink(str(tmp_path / "telemetry.jsonl"))
    prev = set_active_sink(sink)
    try:
        port = _port(models, live_port=0,  # esr: noqa(TX001) - no trace
                     live_slo=str(REPO / "configs" / "slo.yml"), health_ns="r0")
        base = f"http://127.0.0.1:{port.live.port}"
        for path in corpus:
            port.submit(path)
        for _ in range(3):
            port.pump()
        status, metrics = _get(base + "/metrics")
        assert status == 200 and "esr_span_seconds" in metrics
        assert 'esr_span_seconds_count{span="serve_chunk"}' in metrics
        status, body = _get(base + "/healthz")
        assert status == 200 and json.loads(body)["sources"]["serving_lanes@r0"]["healthy"]
        status, body = _get(base + "/slo")
        assert status == 200 and json.loads(body)["verdict"] == "ok"
        status, body = _get(base + "/snapshot?window_s=60")
        doc = json.loads(body)
        assert status == 200 and doc["replica"] == "r0" and doc["slo_verdict"] == "ok"
        assert _get(base + "/snapshot?window_s=x")[0] == 400
        summary = port.run()
        live = port.live.aggregator.snapshot()
        port.scheduler.quarantine(1)
        assert _get(base + "/healthz")[0] == 503
        port.close_live()
        assert port.live is None
    finally:
        set_active_sink(prev)
        sink.close()
    doc, code = report_files([str(tmp_path / "telemetry.jsonl")], str(REPO / "configs" / "slo.yml"))
    report = doc["report"]
    assert code == 0 and summary["completed"] == len(corpus)
    # counts exactly; percentiles within the sketch's 1% relative error
    want_cls = report["serving"].pop("classes")
    got_cls = live["serving"].pop("classes")
    assert live["serving"] == {k: report["serving"][k] for k in live["serving"]}
    assert got_cls.keys() == want_cls.keys()
    for name, got in got_cls.items():
        assert got["windows"] == want_cls[name]["windows"]
        for q in ("window_latency_p50_ms", "window_latency_p99_ms"):
            np.testing.assert_allclose(got[q], want_cls[name][q], rtol=0.01)
    assert live["spans"]["serve_chunk"]["count"] == report["spans"]["serve_chunk"]["count"]
    assert report["serving"]["windows_skipped"] == summary["windows_skipped"] > 0


@pytest.fixture(scope="module")
def faulted(corpus, models, tmp_path_factory):
    """The corpus served by the port's and the JAX engine under the same
    ``serve_chunk`` fault plan (a lane fault at chunk 1, a preemption signal
    at chunk 3), each into its own telemetry file."""
    from esr_tpu.obs import TelemetrySink as RefSink
    from esr_tpu.obs import set_active_sink as ref_set_active_sink
    from esr_tpu.resilience.faults import FaultPlan as RefPlan
    from esr_tpu.resilience.faults import FaultSpec as RefSpec
    from esr_tpu.resilience.faults import installed as ref_installed
    from esr_tpu_torch.resilience.faults import FaultPlan, FaultSpec, installed

    tmp = tmp_path_factory.mktemp("torch_serving_faults")
    specs = [("serve_chunk", 1, "lane_fault"), ("serve_chunk", 3, "preempt_signal")]
    out = {}
    for side, sink_cls, set_sink, plan, scope, engine in (
            ("port", TelemetrySink, set_active_sink, FaultPlan([FaultSpec(*a) for a in specs]),
             installed, lambda: _port(models)),
            ("jax", RefSink, ref_set_active_sink, RefPlan([RefSpec(*a) for a in specs]),
             ref_installed, lambda: _ref(models))):
        path = str(tmp / f"{side}.jsonl")
        sink = sink_cls(path)
        prev = set_sink(sink)
        try:
            server = engine()
            ids = [server.submit(p) for p in corpus]
            with scope(plan):
                server.run()
        finally:
            set_sink(prev)
            sink.close()
        out[side] = ([server.report(r) for r in ids], server, path, plan)
    return out


def test_serve_chunk_faults_recover_as_the_reference(faulted):
    """The same plan fires at the same chunks in both engines: the faulted
    request is retried, the preempted ones resume, every request ends ok
    with the reference's window counts and metrics (rtol 1e-5), and the
    port's telemetry pairs each fault with its recovery."""
    port, server, path, plan = faulted["port"]
    ref = faulted["jax"][0]
    assert plan.pending_count() == 0 and len(plan.injected) == 2
    for p, r in zip(port, ref):
        assert (p["status"], p["retries"]) == (r["status"], r["retries"])
        assert (p["n_windows"], p["n_windows_skipped"]) == (r["n_windows"], r["n_windows_skipped"])
        _assert_metrics(p, r)
    assert all(p["status"] == "ok" for p in port) and sum(p["retries"] for p in port) == 1
    assert server.summary()["recoveries"] == {"recovery_preempt_drain": 1,
                                              "recovery_request_retry": 1}
    doc, code = report_files([path], str(REPO / "configs" / "slo.yml"))
    faults = doc["report"]["faults"]
    assert code == 0 and (faults["injected"], faults["unrecovered"]) == (2, 0)
    assert doc == ref_report_files([path], str(REPO / "configs" / "slo.yml"))[0]


# -- the precision rungs in serving ------------------------------------------


@pytest.mark.parametrize("rung", ["bf16", "int8"])
def test_serving_at_a_rung_runs_and_evicts_bit_exactly(corpus, models, rung):
    """A stream served at bf16 or int8 completes; evicted after two chunks,
    its lane state (bf16 words at bf16) crosses the ESRLANE1 wire bitwise
    and resumes in a second engine to the same metrics as an unmigrated
    run at the same rung."""
    path = corpus[1]
    unmigrated = _port(models, lanes=1, precision=rung)  # esr: noqa(TX001) - no trace
    uid = unmigrated.submit(path)
    unmigrated.run()
    want = unmigrated.report(uid)
    assert want["status"] == "ok" and want["n_windows"] > 0
    src = _port(models, lanes=1, precision=rung)  # esr: noqa(TX001) - no trace
    src.submit(path, request_id="s")
    entry = _evict_after(src, 2)
    state = entry["state"]
    packet = wire.pack_lane_state(state)
    header, _ = wire.read_wire(packet)
    got_state = wire.unpack_lane_state(packet, state)
    for a, b in zip(got_state, state):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if rung == "bf16":
        assert header["dtypes"] == ["bfloat16", "bfloat16"]
        assert all(wire.BF16_WORDS == a.dtype and a.dtype.metadata == {"dtype": "bfloat16"}
                   for a in got_state)
    else:
        assert "dtypes" not in header and packet == ref_pack(state)
    dst = _port(models, lanes=1, precision=rung)  # esr: noqa(TX001) - no trace
    dst.admit_handoff(dict(entry, state=None), state=got_state)
    dst.run()
    got = dst.report("s")
    assert got["status"] == "ok" and got["handoffs"] == 1
    _assert_metrics(got, want)


def test_bf16_lane_state_round_trips_the_wire_bitwise():
    """A bf16 lane state leaves the card as its raw 16-bit words, packs with
    a ``bfloat16`` header, unpacks and injects back to the same bits; the
    reference's own bf16 packet (numpy's raw ``|V2``, a digest over
    ``bfloat16``) reads as the same words."""
    import ml_dtypes

    rng = np.random.default_rng(2)
    states = tuple(torch.from_numpy(rng.standard_normal((3, 2, 4, 5)).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(2))
    host = extract_lane_state(states, 1)
    assert all(a.dtype == wire.BF16_WORDS for a in host)
    packet = wire.pack_lane_state(host)
    header, arrays = wire.read_wire(packet)
    assert header["dtypes"] == ["bfloat16", "bfloat16"]
    back = tuple(torch.zeros_like(z) for z in states)
    inject_lane_state(back, 1, wire.unpack_lane_state(packet, host))
    for z, b in zip(states, back):
        assert torch.equal(z[1].view(torch.int16), b[1].view(torch.int16))
        assert not b[0].any()
    # the reference packs an ml_dtypes bf16 state; the port reads it
    ref_state = tuple(a.view(np.uint16).view(ml_dtypes.bfloat16) for a in host)
    _, ref_arrays = wire.read_wire(ref_pack(ref_state))
    for a, b in zip(ref_arrays, host):
        assert a.dtype == wire.BF16_WORDS and a.tobytes() == b.tobytes()
    # an f32 lane refuses bf16 words, a bf16 lane refuses f32 arrays
    with pytest.raises(ValueError):
        inject_lane_state(states, 0, tuple(np.zeros((2, 4, 5), np.float32) for _ in range(2)))
    with pytest.raises(ValueError):
        inject_lane_state(tuple(z.float() for z in states), 0, host)

# -- the serving fleet and the planes it stands on --------------------------

def _fleet_classes(cls):
    """Dealt round robin in this order: the bursty streams are gated."""
    return {"gated": cls("gated", chunk_windows=2, min_activity=0.3),
            "standard": cls("standard", chunk_windows=2)}


# -- host-only copies: exact equality with the reference -------------------


def test_hash_ring_places_and_owns_as_the_reference():
    nodes = [f"r{i}" for i in range(5)]
    port, ref = HashRing(nodes, vnodes=16), RefRing(nodes, vnodes=16)
    keys = [f"lg-{i:04d}" for i in range(200)]
    for exclude in ((), ("r1",), ("r0", "r2", "r3")):
        assert [port.place(k, exclude) for k in keys] == [ref.place(k, exclude) for k in keys]
    assert port.ownership() == ref.ownership()
    assert abs(sum(port.ownership().values()) - 1.0) < 1e-5
    port.remove("r3")
    ref.remove("r3")
    assert port.ownership() == ref.ownership() and port.nodes == ref.nodes
    assert port.place("x", exclude=nodes) is None


@pytest.mark.parametrize("seed", range(5))
def test_fleet_plan_is_the_references(seed):
    def specs(plan):
        return sorted((site, i, [(s.kind, s.arg, s.fault_id) for s in v])
                      for (site, i), v in plan._pending.items())

    assert specs(build_fleet_plan(seed)) == specs(ref_build_plan(seed))


def _record_stream(seed=7):
    """A serving session's records of every kind the aggregator rolls up,
    as the sink writes them."""
    rng = np.random.default_rng(seed)
    out, t = [], 0.0
    for chunk in range(40):
        sec = float(rng.lognormal(-3.5, 0.8))
        t += sec
        out.append({"t": t, "type": "span", "name": "serve_chunk", "seconds": sec,
                    "span_id": f"c{chunk}", "begin": round(t - sec, 6), "end": round(t, 6),
                    "windows": 4, "skipped_windows": chunk % 3, "lanes": 2})
    for i, cls in enumerate(("interactive", "standard", "standard", "gated")):
        rid, root = f"req-{i}", f"root-{i}"
        for chunk in range(12):
            out.append({"t": t, "type": "span", "name": "serve_chunk_part",
                        "seconds": float(rng.lognormal(-3.0, 1.0)), "trace_id": f"tr-{i}",
                        "span_id": f"p{i}-{chunk}", "parent_id": root, "cls": cls,
                        "windows": int(rng.integers(1, 4))})
        out.append({"t": t, "type": "span", "name": "serve_request", "seconds": 1.0,
                    "trace_id": f"tr-{i}", "span_id": root, "parent_id": None})
        status = ("ok", "migrated", "replica_lost", "shed")[i]
        out.append({"t": t, "type": "event", "name": "serve_request_done", "request": rid,
                    "trace_id": f"tr-{i}", "parent_id": root, "completed": status == "ok",
                    "status": status, "windows": 12})
    out += [
        {"t": t, "type": "counter", "name": "serve_backpressure", "inc": 1, "total": 1},
        {"t": t, "type": "gauge", "name": "serve_queue_depth", "value": 3},
        {"t": t, "type": "event", "name": "serve_gating_flush", "skipped": 2},
        {"t": t, "type": "event", "name": "fault_injected", "site": "fleet_router"},
        {"t": t, "type": "event", "name": "recovery_router_handoff", "site": "fleet_router"},
        {"t": t, "type": "numerics", "name": "gru_fwd", "rms": 0.5, "max_abs": 2.0,
         "nonfinite": 0.0, "count": 64.0},
        {"t": t, "type": "attribution", "name": "super_step", "wall_s": 0.2, "goodput": 0.7},
    ]
    return out


def _strip(snap):
    return {k: v for k, v in snap.items() if k != "uptime_s"}


@pytest.fixture(scope="module")
def aggregators():
    port, ref = LiveAggregator(), RefAggregator()
    for rec in _record_stream():
        port.observe(dict(rec))
        ref.observe(dict(rec))
    return port, ref


def test_live_aggregator_snapshots_are_the_references(aggregators):
    port, ref = aggregators
    assert _strip(port.snapshot()) == _strip(ref.snapshot())
    assert _strip(port.snapshot(window_s=60.0)) == _strip(ref.snapshot(window_s=60.0))
    assert port.snapshot()["serving"]["statuses"] == {
        "migrated": 1, "ok": 1, "replica_lost": 1, "shed": 1}


@pytest.mark.parametrize("slo_file", SLO_FILES)
def test_prometheus_and_slo_window_verdicts_are_the_references(aggregators, slo_file):
    snap = aggregators[1].snapshot()
    assert render_prometheus(snap) == ref_render(snap)
    path = str(REPO / "configs" / slo_file)
    slo = load_slo(path)
    assert slo == ref_load_slo(path)
    assert evaluate_slo_window(snap, slo) == ref_eval_window(snap, slo)
    empty = {"records": 0}
    assert evaluate_slo_window(empty, slo) == ref_eval_window(empty, slo)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_snapshot_wire_parses_in_the_other_package(aggregators, direction):
    port, ref = aggregators
    src, parse, to_wire = ((port, ref_parse, ref_state_to_wire) if direction == "port_to_jax"
                           else (ref, parse_snapshot_wire, state_to_wire))
    doc = json.loads(json.dumps(src.snapshot_wire(windows=(60.0, 300.0))))
    doc.update(replica="r0", health={"healthy": True, "sources": {}}, slo_verdict="ok")
    parsed = parse(doc)
    assert to_wire(parsed["state"]) == doc["state"]
    assert sorted(parsed["windows"]) == [60.0, 300.0]
    assert (parsed["replica"], parsed["slo_verdict"]) == ("r0", "ok")
    with pytest.raises(ValueError, match="version"):
        parse(dict(doc, version=99))


# -- the scenario: the port's fleet against the JAX engine ------------------


@pytest.fixture(scope="module")
def scenario(corpus, models, tmp_path_factory):
    """The port's chaos scenario over the corpus served twice, and the JAX
    package's single engine over the same arrivals."""
    out = tmp_path_factory.mktemp("torch_fleet_scenario")
    streams = corpus * 2
    result = run_fleet_scenario(str(out), models[2], streams, DATASET_CFG,
                                _fleet_classes(RequestClass), seed=0, lanes=2,
                                activity_tile=ACTIVITY_TILE, device="cpu")
    ref = RefServing(models[0], models[1], DATASET_CFG, lanes=2, classes=_fleet_classes(RefClass),
                     default_class="gated", activity_tile=ACTIVITY_TILE, preempt_quantum=0)
    classes = tuple(_fleet_classes(RefClass))
    for i, path in enumerate(streams):
        ref.submit(path, classes[i % len(classes)], request_id=f"lg-{i:04d}")
    ref.run(max_wall_s=300.0)
    return result, ref.reports()


def test_chaos_scenario_recovers_and_matches_the_jax_engine(scenario):
    result, jax_reports = scenario
    assert result["ok"], result["checks"]
    assert result["faults"]["injected"] == 3 and result["faults"]["unrecovered"] == 0
    summary = result["summary"]
    assert summary["zero_lost"] and summary["statuses"] == {"ok": 8}
    assert summary["migrations"] >= 1 and summary["failovers"] >= 1
    assert min(result["killed_streams"].values()) >= 1
    reports = result["reports"]
    assert sorted(reports) == sorted(jax_reports)
    assert sum(r["n_windows_skipped"] for r in reports.values()) > 0
    for rid, got in reports.items():
        want = jax_reports[rid]
        assert (got["n_windows"], got["n_windows_skipped"]) == (want["n_windows"],
                                                                 want["n_windows_skipped"])
        for k in METRIC_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=f"{rid} {k}")


def test_reference_reads_the_port_telemetry_files(scenario):
    """The reference's reporter rolls the port's router and replica files up
    to the port reporter's document, SLO verdicts included."""
    tel = scenario[0]["telemetry"]
    args = [f"{k}={tel[k]}" for k in ("router", "r0", "r1", "r2")]
    slo = str(REPO / "configs" / "slo_fleet.yml")
    port_doc, port_code = report_files(args, slo)
    ref_doc, ref_code = ref_report_files(args, slo)
    assert port_doc == ref_doc and port_code == ref_code == 0
    assert port_doc["report"]["faults"]["by_site"] == {
        "fleet_router": {"injected": 3, "recovered": 3}}
    with open(tel["r0"]) as f:
        manifest = json.loads(f.readline())
    assert manifest["schema_version"] == 2 and manifest["torch_version"]
    one_doc, one_code = report_files([tel["twin"]], str(REPO / "configs" / "slo.yml"))
    assert (one_doc, one_code) == ref_report_files([tel["twin"]],
                                                   str(REPO / "configs" / "slo.yml"))
    assert one_code == 0 and one_doc["report"]["traces"]["incomplete"] == 0


# -- a replica's handoff, and supervision over loopback HTTP ---------------


@pytest.fixture(scope="module")
def handoff(corpus, models, tmp_path_factory):
    """One stream drained from replica a after two rounds and admitted on
    replica b, and the same stream served by replica c alone."""
    tmp = tmp_path_factory.mktemp("torch_fleet_handoff")
    reps = [Replica(rid, models[2], DATASET_CFG, telemetry_path=str(tmp / f"{rid}.jsonl"),
                    classes=_fleet_classes(RequestClass), lanes=1, activity_tile=ACTIVITY_TILE,
                    preempt_quantum=0, device="cpu").start() for rid in "abc"]
    try:
        a, b, c = reps
        for rep in (a, c):
            rep.submit(corpus[1], "standard", request_id="s")
        for _ in range(2):
            a.pump()
        packets = a.drain()
        b.admit_handoff(packets[0])
        for rep in (b, c):
            while rep.pump() != "drained":
                pass
        return packets, a.engine.report("s"), b.engine.report("s"), c.engine.report("s")
    finally:
        for rep in reps:
            rep.close()


def test_drain_and_admit_handoff_resume_bitwise(handoff):
    packets, src, got, want = handoff
    assert len(packets) == 1 and packets[0].state_bytes is not None
    assert src["status"] == "migrated" and 0 < packets[0].entry["windows_done"]
    assert got["status"] == "ok" and got["handoffs"] == 1
    assert got["n_windows"] == want["n_windows"]
    for k in METRIC_KEYS:
        assert got[k] == want[k], k


def test_supervisor_over_loopback_http(tmp_path):
    """Healthy while the replica's /snapshot answers; dead after miss_budget
    missed polls once its plane is down; alive again at a new address."""
    sink = TelemetrySink(str(tmp_path / "telemetry.jsonl"))
    slo = str(REPO / "configs" / "slo.yml")
    sup = ReplicaSupervisor(miss_budget=2, timeout_s=5.0)
    plane = start_live_plane(sink, port=0, slo_path=slo, ns="rX")
    try:
        sup.watch("rX", f"http://127.0.0.1:{plane.port}/snapshot")
        sup.poll_once()
        v = sup.verdict("rX")
        assert (v["alive"], v["healthy"], v["misses"], v["slo_verdict"]) == (True, True, 0, "ok")
        plane.close()
        for misses in (1, 2):
            sup.poll_once()
            assert sup.verdict("rX")["misses"] == misses
        assert not sup.verdict("rX")["alive"]
        plane = start_live_plane(sink, port=0, slo_path=slo, ns="rX")
        sup.watch("rX", f"http://127.0.0.1:{plane.port}/snapshot")
        sup.poll_once()
        v = sup.verdict("rX")
        assert (v["alive"], v["healthy"], v["misses"]) == (True, True, 0)
        status, body = _get(f"http://127.0.0.1:{plane.port}/healthz")
        assert status == 200 and "numerics@rX" in json.loads(body)["sources"]
    finally:
        plane.close()
        sink.close()


# -- the UNet family at serving, the fleet and AOT --------------------------
#
# The second shipped recipe's model (SRUNetRecurrentSeq) at a narrow width
# (base 2, 2 encoders; its lane state the flat (h, c) leaves, 4 here),
# seeded, served by both packages' ServingEngine over the half-idle corpus
# at each rung: every stream's windows and skips equal, its metrics within
# UNET_SERVE_RTOL (measured on the CPU: f32 ~1e-6 relative, bf16 3e-5, int8
# 2.3e-4 where one quantization step flips on a 1-ulp difference upstream;
# the SSIM means sit near 0 under random weights, so atol 1e-5).

UNET_ARGS = {"num_frame": 3, "base_num_channels": 2, "num_encoders": 2}
UNET_SERVE_RTOL = {"f32": 1e-5, "bf16": 1e-3, "int8": 1e-3}


@pytest.fixture(scope="module")
def unet_models():
    from esr_tpu.models.registry import get_model as ref_get_model
    from esr_tpu_torch.models.registry import get_model

    ref = ref_get_model("SRUNetRecurrentSeq", **UNET_ARGS)
    rng = np.random.default_rng(5)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, 16, 16, 2), np.float32), ref.init_states(1, 16, 16))
    params = jax.tree.map(lambda s: (rng.uniform(-1.0, 1.0, s.shape)
                                     / np.sqrt(max(np.prod(s.shape[:-1]), 1))).astype(
                                         np.float32), shapes)
    port = get_model("SRUNetRecurrentSeq", **UNET_ARGS)
    convert.load_flax_params(port, params)
    return ref, params, port.eval()


@pytest.fixture(scope="module")
def unet_served(corpus, unet_models):
    out = {}
    for rung in ("f32", "bf16", "int8"):
        ref = _ref(unet_models, precision=rung)
        ref_ids = [ref.submit(p) for p in corpus]
        ref.run()
        port = _port(unet_models, precision=rung)
        port_ids = [port.submit(p) for p in corpus]
        summary = port.run()
        out[rung] = ([ref.report(r) for r in ref_ids], [port.report(r) for r in port_ids],
                     summary, port._states)
    return out


@pytest.mark.parametrize("rung", ["f32", "bf16", "int8"])
def test_unet_serving_matches_jax_serving(unet_served, rung):
    """``ServingEngine`` with SRUNetRecurrentSeq against the reference's at
    the rung, every stream: the same windows and skips (the gated class),
    metrics within :data:`UNET_SERVE_RTOL`; the lane states the flat
    ``(h, c)`` leaves in the rung's dtype; each rung within 1.0 dB of f32."""
    ref, port, summary, states = unet_served[rung]
    assert summary["completed"] == len(port) and summary["windows_skipped"] > 0
    assert len(states) == 2 * UNET_ARGS["num_encoders"]
    assert all(z.dtype == (torch.bfloat16 if rung == "bf16" else torch.float32)
               for z in states)
    for r, p in zip(ref, port):
        assert p["status"] == "ok"
        assert (p["n_windows"], p["n_windows_skipped"]) == (r["n_windows"],
                                                             r["n_windows_skipped"])
        for k in METRIC_KEYS:
            np.testing.assert_allclose(p[k], r[k], rtol=UNET_SERVE_RTOL[rung], atol=1e-5,
                                       err_msg=k)
    f32 = unet_served["f32"][1]
    for p, f in zip(port, f32):
        if p["n_windows"]:
            assert abs(p["esr_psnr"] - f["esr_psnr"]) <= 1.0


@pytest.fixture(scope="module")
def unet_norm_served(corpus):
    """A SRUNetRecurrentSeq with each norm (running statistics drawn away
    from their defaults) served by both packages' ``ServingEngine`` over 4
    streams at f32 and int8: each stream's reports, the reference's and the
    port's."""
    return {norm: _serve_norm_model(corpus[:4], norm) for norm in ("BN", "IN")}


def _serve_norm_model(streams, norm):
    from esr_tpu.models.registry import get_model as ref_get_model
    from esr_tpu_torch.models.registry import get_model

    args = {**UNET_ARGS, "norm": norm}
    ref = ref_get_model("SRUNetRecurrentSeq", **args)
    rng = np.random.default_rng(8)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, 16, 16, 2), np.float32), ref.init_states(1, 16, 16))

    def draw(path, s):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.uniform(-1.0, 1.0, s.shape)
                / np.sqrt(max(np.prod(s.shape[:-1]), 1))).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    port = get_model("SRUNetRecurrentSeq", **args)
    convert.load_flax_params(port, params)
    models = (ref, params, port.eval())
    out = {}
    for rung in ("f32", "int8"):
        r_srv = _ref(models, precision=rung)
        r_ids = [r_srv.submit(p) for p in streams]
        r_srv.run()
        p_srv = _port(models, precision=rung)
        p_ids = [p_srv.submit(p) for p in streams]
        p_srv.run()
        out[rung] = [(r_srv.report(rid), p_srv.report(pid)) for rid, pid in zip(r_ids, p_ids)]
    return out


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_unet_norm_model_serves_as_jax_serving(unet_norm_served, norm):
    """The model with ``norm`` served by one replica at f32 and int8 (the
    norms f32 there) against the reference's ``ServingEngine``: every
    stream's windows and skips equal, its metrics within
    :data:`UNET_SERVE_RTOL`."""
    for rung, pairs in unet_norm_served[norm].items():
        for r, p in pairs:
            assert p["status"] == "ok"
            assert (p["n_windows"], p["n_windows_skipped"]) == (r["n_windows"],
                                                                 r["n_windows_skipped"])
            for k in METRIC_KEYS:
                np.testing.assert_allclose(p[k], r[k], rtol=UNET_SERVE_RTOL[rung], atol=1e-5,
                                           err_msg=f"{rung} {k}")


@pytest.fixture(scope="module")
def unet_handoff(corpus, unet_models, tmp_path_factory):
    """The ``handoff`` fixture's drain -> admit across replicas with a
    UNet-family model at bf16 (its 4 leaves as bf16 words on the wire)."""
    tmp = tmp_path_factory.mktemp("torch_unet_handoff")
    reps = [Replica(rid, unet_models[2], DATASET_CFG, telemetry_path=str(tmp / f"{rid}.jsonl"),
                    classes=_fleet_classes(RequestClass), lanes=1, activity_tile=ACTIVITY_TILE,
                    preempt_quantum=0, precision="bf16", device="cpu").start()
            for rid in "abc"]
    try:
        a, b, c = reps
        for rep in (a, c):
            rep.submit(corpus[1], "standard", request_id="s")
        for _ in range(2):
            a.pump()
        packets = a.drain()
        b.admit_handoff(packets[0])
        for rep in (b, c):
            while rep.pump() != "drained":
                pass
        return packets, a.engine.report("s"), b.engine.report("s"), c.engine.report("s")
    finally:
        for rep in reps:
            rep.close()


def test_unet_drain_and_admit_handoff_resume_bitwise(unet_handoff):
    packets, src, got, want = unet_handoff
    header, _ = wire.read_wire(packets[0].state_bytes)
    assert header["dtypes"] == ["bfloat16"] * 2 * UNET_ARGS["num_encoders"]
    # the reference's keys of its nested (h, c) pairs
    assert header["keys"] == [f"[{i}][{j}]" for i in range(UNET_ARGS["num_encoders"])
                              for j in range(2)]
    assert src["status"] == "migrated" and 0 < packets[0].entry["windows_done"]
    assert got["status"] == "ok" and got["handoffs"] == 1
    assert got["n_windows"] == want["n_windows"]
    for k in METRIC_KEYS:
        assert got[k] == want[k], k


# The entry points that refused the UNet family before it was ported, each
# run to completion on the CPU on the second shipped recipe's model (base 2,
# 2 encoders, 16x16) and its output checked.
UNET_ENTRY_POINTS = ["serving_engine", "serve", "serve_fleet", "serve_aot", "export_forward",
                     "export_chunk", "export_checkpoint", "harness_bf16", "harness_int8",
                     "engine_bf16", "engine_int8", "infer_int8"]


@pytest.fixture(scope="module")
def unet_entry_points(corpus, unet_models, tmp_path_factory):
    """An SRUNetRecurrentSeq port checkpoint and, for each of
    :data:`UNET_ENTRY_POINTS`, a call that runs it and returns what the test
    checks."""
    from esr_tpu_torch import infer as port_infer
    from esr_tpu_torch import serve as port_serve
    from esr_tpu_torch.inference import export as port_export
    from esr_tpu_torch.inference.engine import StreamingEngine
    from esr_tpu_torch.inference.harness import InferenceRunner

    root = tmp_path_factory.mktemp("unet_entry_points")
    _, params, model = unet_models
    ckpt = root / "ckpt"
    save_checkpoint(str(ckpt), params,
                    {"model": {"name": "SRUNetRecurrentSeq", "args": UNET_ARGS},
                     "trainer": {"precision": "f32"}, "valid_dataloader": {
                         "dataset": DATASET_CFG}})
    slo = str(REPO / "configs" / "slo.yml")
    # the uniform streams (the bursty ones hold idle windows whose GT is
    # empty, where PSNR is infinite)
    uniform = corpus[1::2]
    datalist = root / "streams.txt"
    datalist.write_text("\n".join(uniform) + "\n")
    # the dataset config serve.main builds from the flags below
    serve_cfg = dict(DATASET_CFG, mode="events", window=1024, sliding_window=512)

    def serve(tag, rung, *extra):
        """``serve.main`` over the uniform streams at ``rung``, its request
        reports by stream, and the reference's ``ServingEngine`` over the
        same streams at the same rung, by stream."""
        out = root / tag
        summary = port_serve.main([
            "--model_path", str(ckpt), "--output_path", str(out), "--data_list",
            str(datalist), "--rate", "50", "--lanes", "2", "--classes", "standard:2",
            "--scale", "2", "--ori_scale", "down8", "--window", "1024", "--sliding_window",
            "512", "--seql", "4", "--max_wall", "120", "--live-slo", slo, "--device", "cpu",
            "--precision", rung, *extra])
        name = "fleet_requests.jsonl" if "--replicas" in extra else "serve_requests.jsonl"
        rows = [json.loads(line) for line in (out / name).read_text().splitlines()]
        ref = RefServing(unet_models[0], unet_models[1], serve_cfg, lanes=2,
                         classes={"standard": RefClass("standard", chunk_windows=2)},
                         default_class="standard", precision=rung)
        ref_ids = {p: ref.submit(p) for p in uniform}
        ref.run()
        return (summary, {r["path"]: r for r in rows},
                {p: ref.report(rid) for p, rid in ref_ids.items()}, rung)

    def serving_engine():
        srv = _port(unet_models)
        rid = srv.submit(corpus[1])
        srv.run()
        return srv.report(rid)

    def runner(rung):
        return InferenceRunner(model, 3, device="cpu", precision=rung).run_recording(
            uniform[0], DATASET_CFG, report=False)

    def engine(rung):
        results, _ = StreamingEngine(model, 3, lanes=2, chunk_windows=2, precision=rung,
                                     device="cpu").run_datalist(uniform, DATASET_CFG)
        return results

    def infer(rung):
        return port_infer.main([
            "--model_path", str(ckpt), "--data_path", uniform[0], "--output_path",
            str(root / f"infer_{rung}"), "--device", "cpu", "--precision", rung, "--engine",
            "--lanes", "2", "--chunk_windows", "2", "--scale", "2", "--ori_scale", "down8",
            "--window", "512", "--sliding_window", "256", "--seql", "4",
            "--no_need_gt_frame"])

    x = torch.zeros((1, 3, 16, 16, 2))
    calls = {
        "serving_engine": serving_engine,
        "serve": lambda: serve("serve", "bf16"),
        "serve_fleet": lambda: serve("fleet", "f32", "--replicas", "3"),
        "serve_aot": lambda: serve("aot", "int8", "--aot"),
        "export_forward": lambda: port_export.export_forward(model, x,
                                                             model.init_states(1, 16, 16),
                                                             "cpu"),
        "export_chunk": lambda: port_export.export_chunk_program(
            model, 2, 2, (16, 16), precision="bf16", device="cpu"),
        "export_checkpoint": lambda: port_export.export_checkpoint(
            str(ckpt), str(root / "a.pt2"), height=16, width=16, device="cpu"),
        "harness_bf16": lambda: runner("bf16"),
        "harness_int8": lambda: runner("int8"),
        "engine_bf16": lambda: engine("bf16"),
        "engine_int8": lambda: engine("int8"),
        "infer_int8": lambda: {rung: infer(rung) for rung in ("int8", "f32")},
    }
    return {"calls": calls, "root": root, "f32": runner("f32")}


@pytest.mark.parametrize("what", UNET_ENTRY_POINTS)
def test_unet_family_entry_points_run(unet_entry_points, what):
    """Serving, the fleet, the AOT export and the bf16 and int8 rungs each
    run a SRUNetRecurrentSeq to completion on the CPU: ``serve`` (bf16),
    ``serve --replicas 3`` (f32) and ``serve --aot`` (int8) every request ok
    and none lost, each stream within :data:`UNET_SERVE_RTOL` of the JAX
    package's ``ServingEngine`` at the same rung; the artifacts written
    (and their sidecars); the rungs' finite metrics within 1.0 dB of the
    f32 harness's."""
    got = unet_entry_points["calls"][what]()
    root, f32 = unet_entry_points["root"], unet_entry_points["f32"]
    if what == "serving_engine":
        assert got["status"] == "ok" and got["n_windows"] > 0
    elif what.startswith("serve"):
        summary, rows, ref, rung = got
        assert summary["statuses"] == {"ok": 2} and sorted(rows) == sorted(ref)
        if what == "serve_fleet":
            assert summary["zero_lost"]
            assert summary["replicas"] == {"r0": "up", "r1": "up", "r2": "up"}
        else:
            assert summary["completed"] == 2
        if what == "serve_aot":
            side = json.loads((root / "aot" / "aot" / "chunk_program.w2.pt2.json").read_text())
            assert (side["precision"], side["model"]) == ("int8", "FrameRecurrentSR")
        for path, r in ref.items():
            assert rows[path]["n_windows"] == r["n_windows"] > 0
            for k in METRIC_KEYS:
                np.testing.assert_allclose(rows[path][k], r[k], rtol=UNET_SERVE_RTOL[rung],
                                           atol=1e-5, err_msg=k)
    elif what.startswith("export"):
        if what == "export_checkpoint":
            assert got.endswith("a.pt2") and (root / "a.pt2.json").is_file()
            got = (root / "a.pt2").read_bytes()
        assert isinstance(got, bytes) and got[:2] == b"PK"
    elif what == "infer_int8":
        got, f32 = got["int8"], got["f32"]
        assert got["n_windows"] == f32["n_windows"] >= 3 and np.isfinite(got["esr_psnr"])
        assert got["esr_mse"] != f32["esr_mse"]
        assert abs(got["esr_psnr"] - f32["esr_psnr"]) <= 1.0
    elif what.startswith("harness"):
        assert got["n_windows"] >= 3 and np.isfinite(got["esr_psnr"])
        assert abs(got["esr_psnr"] - f32["esr_psnr"]) <= 1.0
        if what == "harness_bf16":
            assert got["esr_mse"] != f32["esr_mse"]
    else:
        assert len(got) == 2 and all(r["n_windows"] > 0 and np.isfinite(r["esr_psnr"])
                                     for r in got)


# -- serve --loadgen_kind simulate ------------------------------------------
#
# The ESIM corpus of seed 0 (4 streams at the default 64x64 sensor, rendered
# at 512x512) is bitwise the reference's HDF5 corpus, and its event counts
# are the table chip_smoke.py holds the card's run to.

sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def reference_simulate_corpus(tmp_path_factory):
    """The reference's ``kind="simulate"`` corpus of seed 0, read back."""
    out = tmp_path_factory.mktemp("ref_simulate")
    paths = ref_corpus(str(out), n=len(chip_smoke.SIMULATE_EVENTS), seed=0, kind="simulate")
    return [H5Recording(p) for p in paths]


def _simulate_args(ckpt, out):
    return ["--model_path", str(ckpt), "--output_path", str(out), "--device", "cpu",
            "--loadgen", str(len(chip_smoke.SIMULATE_EVENTS)), "--loadgen_kind", "simulate",
            "--rate", "50", "--lanes", "2", "--classes", "standard:2", "--scale", "2",
            "--ori_scale", "down8", "--window", "1024", "--sliding_window", "512",
            "--seql", "4", "--max_wall", "240", "--live-slo", str(REPO / "configs" / "slo.yml")]


@pytest.fixture(scope="module")
def simulate_served(models, tmp_path_factory):
    """``serve --loadgen 4 --loadgen_kind simulate --device cpu`` with one
    replica and with ``--replicas 2``, in this process."""
    from esr_tpu_torch import serve

    root = tmp_path_factory.mktemp("serve_simulate")
    ckpt = root / "ckpt"
    save_checkpoint(str(ckpt), models[1], {
        "model": {"name": "DeepRecurrNet",
                  "args": {"inch": 2, "basech": 2, "num_frame": 3, "dcn_sparse": True}}})
    one = serve.main(_simulate_args(ckpt, root / "one"))
    fleet = serve.main(_simulate_args(ckpt, root / "fleet") + ["--replicas", "2"])
    return root, one, fleet


@pytest.fixture(scope="module")
def port_simulate_corpus():
    """The port's first two streams of the same corpus, in memory."""
    return make_stream_corpus(n=2, seed=0, kind="simulate")


def test_simulate_corpus_is_the_references_bitwise(simulate_served, reference_simulate_corpus,
                                                    port_simulate_corpus):
    root = simulate_served[0]
    for run in ("one", "fleet"):
        doc = json.loads((root / run / "loadgen_corpus.json").read_text())
        assert doc["kind"] == "simulate" and doc["build_s"] > 0
        assert doc["events"] == chip_smoke.SIMULATE_EVENTS
    for i, ref in enumerate(reference_simulate_corpus):
        assert {rung: ref.stream(rung).num_events for rung in chip_smoke.SIMULATE_EVENTS[
            f"stream{i:03d}"]} == chip_smoke.SIMULATE_EVENTS[f"stream{i:03d}"]
    # the corpus itself, every rung and frame, against the reference's files
    for p, ref in zip(port_simulate_corpus, reference_simulate_corpus):
        assert p.sensor_resolution == ref.sensor_resolution == (512, 512)
        for rung in ("ori", "down2", "down4", "down8", "down16"):
            a, b = p.stream(rung), ref.stream(rung)
            np.testing.assert_array_equal(a.window(0, a.num_events), b.window(0, b.num_events))
        np.testing.assert_array_equal(p.frame_ts, ref.frame_ts)
        for k in range(p.num_frames):
            np.testing.assert_array_equal(p.frame(k), ref.frame(k))


def test_serve_loadgen_simulate_one_replica_and_fleet(simulate_served):
    root, one, fleet = simulate_served
    n = len(chip_smoke.SIMULATE_EVENTS)
    assert one["requests"] == one["completed"] == n and one["windows"] > 0
    reports = [json.loads(line) for line in
               (root / "one" / "serve_requests.jsonl").read_text().splitlines()]
    assert len(reports) == n and all(r["status"] == "ok" for r in reports)
    assert all(r["n_windows"] > 0 and np.isfinite(r[k]) for r in reports for k in METRIC_KEYS)
    assert fleet["zero_lost"] and fleet["statuses"] == {"ok": n}
    assert fleet["windows"] == one["windows"]


@pytest.fixture(scope="module")
def corpus_refusals(tmp_path_factory):
    """Each package's ``ValueError`` for ``kind="simulate"`` with a
    schedule, and for an unknown kind: ``{case: (port, reference)}``."""
    out = tmp_path_factory.mktemp("refusals")
    cases = {"events_schedule": {"kind": "simulate", "events_schedule": [400, 4000]},
             "burst_schedule": {"kind": "simulate", "burst_schedule": [0.4, 1.0]},
             "unknown_kind": {"kind": "esim"}}
    got = {}
    for case, kw in cases.items():
        messages = []
        for build in (lambda: make_stream_corpus(n=1, seed=0, **kw),
                      lambda: ref_corpus(str(out), n=1, seed=0, **kw)):
            with pytest.raises(ValueError) as err:
                build()
            messages.append(str(err.value))
        got[case] = tuple(messages)
    return got


@pytest.mark.parametrize("case", ["events_schedule", "burst_schedule", "unknown_kind"])
def test_simulate_with_a_schedule_raises_as_the_reference(corpus_refusals, case):
    port, ref = corpus_refusals[case]
    assert port == ref


def test_fleet_traffic_and_cohorts_match_reference(tmp_path):
    recs, sched = fleet_traffic(2, streams_per_replica=2, rate_hz_per_replica=3.0, seed=4,
                                classes=("a", "b"), base_events=(200, 400), num_frames=3)
    paths, ref_sched = ref_fleet_traffic(str(tmp_path), 2, streams_per_replica=2,
                                         rate_hz_per_replica=3.0, seed=4, classes=("a", "b"),
                                         base_events=(200, 400), num_frames=3)
    assert [r.name + ".h5" for r in recs] == [Path(p).name for p in paths]
    assert [(a.t, a.request_class, a.request_id) for a in sched] == \
        [(a.t, a.request_class, a.request_id) for a in ref_sched]
    for r, p in zip(recs, paths):
        ref = H5Recording(p)
        a, b = r.stream("down8"), ref.stream("down8")
        np.testing.assert_array_equal(a.window(0, a.num_events), b.window(0, b.num_events))
    for size in (1, 3, 4):
        got = [(t, [a.request_id for a in g]) for t, g in cohorts(sched, size)]
        want = [(t, [a.request_id for a in g]) for t, g in ref_cohorts(ref_sched, size)]
        assert got == want
    with pytest.raises(ValueError):
        fleet_traffic(0)
    with pytest.raises(ValueError):
        cohorts(sched, 0)
