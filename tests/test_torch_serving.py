"""The port's serving tier against the reference's, on the CPU.

- the half-idle corpus of ``tests/test_sparse_smoke.py`` (bursty and
  uniform streams, time-mode windows) served by the port's and by the JAX
  ``ServingEngine`` with the sparse model and a gated class: the same
  skipped counts exactly, per-request metric means within rtol 1e-5;
- preemption and resume (a preempted stream's metrics equal the same
  stream served alone), backpressure (``AdmissionFull``), lane quarantine
  after ``lane_quarantine_k`` faults, bad streams, the refusals of the
  unported options;
- the ESRLANE1 wire format across the packages: a stream evicted from the
  JAX engine resumes in the port's through ``admit_handoff`` and the
  reverse, both within rtol 1e-5 of an unmigrated run, and equal states
  pack to equal bytes in both;
- the host-only copies (scheduler, load generator, percentile) against the
  reference, and ``python -m esr_tpu_torch.serve --device cpu --loadgen 4``.

Measured on the CPU: served metric means ~5e-7 relative from the JAX tier.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from esr_tpu.data.synthetic import write_synthetic_h5
from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
from esr_tpu.obs.report import percentile as ref_percentile
from esr_tpu.serving import RequestClass as RefClass
from esr_tpu.serving import ServingEngine as RefServing
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
from esr_tpu_torch.serving import wire
from esr_tpu_torch.serving.loadgen import make_stream_corpus, poisson_schedule
from esr_tpu_torch.serving.scheduler import AdmissionFull, LaneScheduler, RequestClass, StreamRequest
from esr_tpu_torch.serving.server import ServingEngine
from esr_tpu_torch.utils.percentile import percentile, percentile_ms

REPO = Path(__file__).resolve().parent.parent
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


def test_unported_options_raise(models):
    for kw in ({"live_port": 0}, {"profile_steps": 1}, {"aot_programs": {2: "x"}}):
        with pytest.raises(NotImplementedError):
            _port(models, **kw)
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
    with pytest.raises(NotImplementedError):
        from esr_tpu_torch import serve

        serve.main(["--model_path", str(ckpt), "--output_path", str(out), "--device", "cpu",
                    "--loadgen", "1", "--replicas", "2"])
    assert torch.get_num_threads() >= 1


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
