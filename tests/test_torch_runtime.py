"""The port's training runtime against the JAX package's, on the CPU: the
numerics probes (tensor stats and a probed window, the attribution
helpers), the recovery machinery (anomaly guard, bounded retry, restore
integrity and fallback), the Chrome trace export and the reference's
reporter over a port training run's ``telemetry.jsonl``, the chaos
scenario against the reference's train phase on the same seed, the
trainer's remat, bf16 transfer, probes-off parity and profiler capture,
``calibrate_ranges`` against the reference's on the same weights and corpus
(rtol 1e-5, plus its rounding to six decimals), the int8 drift ladder
against the reference's on the probed window, and asynchronous
checkpointing (``training.async_checkpoint``) against the sync save.

Tolerances: tensor stats and a probed window's per-tag stats rtol 1e-5
(the sign-carrying ``mean`` also atol 1e-6 x the tag's ``max_abs``: a sum
of mixed signs cancels), ``count`` and ``nonfinite`` exact; the chaos run
rejoins its twin within 1e-5 relative (it is bitwise on the CPU); a remat
train step within the train-step parity tolerance of
``tests/test_torch_train.py`` (rtol 1e-5, atol 1e-6); the int8 ladder's
rungs rtol 1e-3, atol 2e-6; everything else exact.
"""

import json
import os
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
from esr_tpu.obs import TelemetrySink as RefSink
from esr_tpu.obs import set_active_sink as ref_set_active_sink
from esr_tpu.obs import export as J_export
from esr_tpu.obs import numerics as J_obs_numerics
from esr_tpu.obs import report as J_report
from esr_tpu.ops import numerics as J_numerics
from esr_tpu.resilience import chaos as J_chaos
from esr_tpu.resilience import recovery as J_recovery
from esr_tpu.resilience.faults import FaultPlan as RefFaultPlan
from esr_tpu.resilience.faults import FaultSpec as RefFaultSpec
from esr_tpu.resilience.faults import installed as ref_installed
from esr_tpu_torch.config import parser as T_parser
from esr_tpu_torch.device import resolve_device
from esr_tpu_torch.models import convert
from esr_tpu_torch.models.esr import DeepRecurrNet
from esr_tpu_torch.obs import TelemetrySink, set_active_sink
from esr_tpu_torch.obs import export as T_export
from esr_tpu_torch.obs import numerics as T_obs_numerics
from esr_tpu_torch.obs import report as T_report
from esr_tpu_torch.ops import numerics as T_numerics
from esr_tpu_torch.resilience import chaos as T_chaos
from esr_tpu_torch.resilience import recovery as T_recovery
from esr_tpu_torch.resilience.faults import FaultPlan, FaultSpec, installed
from esr_tpu_torch.training import optim as T_optim
from esr_tpu_torch.training import train_step as T_step
from esr_tpu_torch.training.async_checkpoint import AsyncCheckpointer, AsyncCheckpointError
from esr_tpu_torch.training.checkpoint import (
    find_latest_checkpoint,
    host_state,
    restore_state,
    save_checkpoint,
    snapshot_state,
)
from esr_tpu_torch.training.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
B, L, H, W = 2, 5, 16, 20
# fields of a telemetry record that are the writer's, not the event's
_NOISE = ("t", "thread", "trace_id", "parent_id", "span_id")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work in one intra-op thread: at these sizes a
    thread team gains nothing, and beside other busy processes its
    spinning workers slow every op by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _events(path, prefix="recovery_"):
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") == "event" and rec["name"].startswith(prefix):
                out.append({k: v for k, v in rec.items() if k not in _NOISE})
    return out


# -- the numerics probes -------------------------------------------------


def _special(name):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 6, 5)).astype(np.float32)
    if name == "nonfinite":
        x.flat[[0, 7, 30]] = [np.nan, np.inf, -np.inf]
    elif name == "zeros":
        x[:] = 0.0
    elif name == "underflow":
        x.flat[:20] = 1e-42  # f32 subnormals
    elif name == "overflow":
        x.flat[:10] = 3e37
    elif name == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    return x


@pytest.mark.parametrize("name", ["normal", "nonfinite", "zeros", "underflow", "overflow",
                                  "bf16"])
def test_tensor_stats_match_reference(name):
    x = _special(name)
    want = np.asarray(J_numerics.tensor_stats(jnp.asarray(x)))
    t = torch.from_numpy(x.astype(np.float32))
    got = T_numerics.tensor_stats(t.to(torch.bfloat16) if name == "bf16" else t).numpy()
    fields = T_numerics.STAT_FIELDS
    assert fields == J_numerics.STAT_FIELDS and T_numerics.REDUCE_KINDS == J_numerics.REDUCE_KINDS
    for i, f in enumerate(fields):
        if f in ("count", "nonfinite"):
            assert got[i] == want[i], f
        elif f == "underflow" and name == "underflow":
            # XLA's CPU backend flushes subnormals to zero, so the reference
            # reads them as zeros there; the port (and the card) keeps them,
            # and counts them as the field's definition says
            assert want[i] == 0.0
            xf = np.abs(x.astype(np.float32))
            nonzero = xf > 0
            assert got[i] == pytest.approx(
                np.sum(nonzero & (xf < np.finfo(np.float32).tiny)) / np.sum(nonzero))
        else:
            np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-6 * abs(want[1]),
                                       err_msg=f)
    # the merge law, on device and on the host
    acc = T_numerics.merge_stat_vectors(T_numerics.zero_stats(), torch.from_numpy(got))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(J_numerics.merge_stat_vectors(
        J_numerics.zero_stats(), jnp.asarray(got))))
    np.testing.assert_array_equal(T_obs_numerics.merge_host(got, got),
                                  J_obs_numerics.merge_host(got, got))


@pytest.fixture(scope="module")
def probed():
    """One window through both packages' probed models, the same weights."""
    resolve_device("cpu")
    rng = np.random.default_rng(1)
    ref = FlaxNet(inch=2, basech=4, num_frame=3, dcn_impl="jnp", numerics=True)
    x = rng.poisson(0.7, (B, 3, H, W, 2)).astype(np.float32)
    shapes = jax.eval_shape(FlaxNet(inch=2, basech=4, num_frame=3).init,
                            jax.random.PRNGKey(0), x, ref.init_states(B, H, W))

    def draw(leaf):
        bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.3
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    params = jax.tree.map(draw, shapes)
    _, mut = jax.jit(lambda p, xx, ss: ref.apply(p, xx, ss, train=False, mutable=["numerics"]))(
        params, x, ref.init_states(B, H, W))
    want = {k: np.asarray(v) for k, v in J_numerics.flatten_probes(mut["numerics"]).items()}
    port = DeepRecurrNet(inch=2, basech=4, num_frame=3, numerics=True)
    convert.load_flax_params(port, params)
    with torch.no_grad(), T_numerics.collect() as sown:
        port.eval()(torch.from_numpy(x), port.init_states(B, H, W))
    return {"want": want, "got": {k: v.numpy() for k, v in sown.items()}, "params": params,
            "x": x}


def test_probed_window_stats_match_reference(probed):
    want, got = probed["want"], probed["got"]
    assert sorted(got) == sorted(want)
    assert set(got) == set(T_obs_numerics.TAG_ORDER) - {"loss", "grad_norm"}
    for tag in want:
        for i, f in enumerate(T_numerics.STAT_FIELDS):
            if f in ("count", "nonfinite"):
                assert got[tag][i] == want[tag][i], (tag, f)
            else:
                np.testing.assert_allclose(got[tag][i], want[tag][i], rtol=1e-5,
                                           atol=1e-6 * abs(want[tag][1]), err_msg=f"{tag} {f}")


@pytest.mark.parametrize("case", ["clean", "dcn", "gru_and_tail", "none"])
def test_first_offending_tag_and_poison_tag_match_reference(probed, case):
    readback = {t: v.copy() for t, v in probed["got"].items()}
    nf = T_numerics.STAT_FIELDS.index("nonfinite")
    for tag in {"dcn": ["dcn_out", "dec1"], "gru_and_tail": ["tail_out", "gru_bwd"]}.get(case, []):
        readback[tag][nf] = 3.0
    if case == "none":
        readback = {}
    assert (T_obs_numerics.first_offending_tag(readback)
            == J_obs_numerics.first_offending_tag(readback))
    got = T_obs_numerics.poison_tag(readback, "loss")
    want = J_obs_numerics.poison_tag(readback, "loss")
    assert sorted(got) == sorted(want)
    for tag in want:
        np.testing.assert_array_equal(got[tag], want[tag])
    assert T_obs_numerics.first_offending_tag(got) == J_obs_numerics.first_offending_tag(want)
    merged = T_obs_numerics.merge_readback([readback, got])
    ref_merged = J_obs_numerics.merge_readback([readback, want])
    for tag in ref_merged:
        np.testing.assert_array_equal(merged[tag], ref_merged[tag])
        assert T_obs_numerics.stats_fields(merged[tag]) == J_obs_numerics.stats_fields(
            ref_merged[tag])


def test_int8_drift_ladder_matches_reference(probed):
    """The probed window's raw taps at f32 and under each package's own
    ``int8_scope``, the same weights: the port's ladder has the reference's
    tags in its order and its ``worst_tag``, each rung's rel_err within
    0.1% of the reference's, plus 2e-6 for the port's rounding of the rung
    to six decimals (the f32 feeds differ by rounding, so a value on a
    quantization step's edge may round the other way)."""
    from esr_tpu.config.quantize import int8_scope as ref_int8_scope
    from esr_tpu_torch.config.quantize import int8_scope

    params, x = probed["params"], probed["x"]
    ref = FlaxNet(inch=2, basech=4, num_frame=3, dcn_impl="jnp", numerics=True,
                  numerics_mode="raw")

    def ref_taps(p, xx, ss, int8):
        with ref_int8_scope(int8):
            _, mut = ref.apply(p, xx, ss, train=False, mutable=["numerics"])
        return mut["numerics"]

    traced = jax.jit(ref_taps, static_argnums=3)
    want = {int8: J_numerics.flatten_probes(jax.device_get(
        traced(params, x, ref.init_states(B, H, W), int8))) for int8 in (False, True)}
    port = DeepRecurrNet(inch=2, basech=4, num_frame=3, numerics=True, numerics_mode="raw")
    convert.load_flax_params(port, params)
    port.eval()

    def port_taps():
        with torch.no_grad(), T_numerics.collect() as sown:
            port(torch.from_numpy(x), port.init_states(B, H, W))
        return {tag: [t.numpy() for t in vals] for tag, vals in sown.items()}

    f32 = port_taps()
    with int8_scope():
        int8 = port_taps()
    got = T_obs_numerics.drift_ladder(f32, int8, tolerance=0.25)
    ref_tags = J_obs_numerics.order_tags(want[False])
    ref_rel = [J_obs_numerics._rel_error(want[False][t], want[True][t]) for t in ref_tags]
    assert [e["tag"] for e in got["ladder"]] == ref_tags
    assert got["worst_tag"] == ref_tags[int(np.argmax(ref_rel))]
    np.testing.assert_allclose([e["rel_err"] for e in got["ladder"]], ref_rel, rtol=1e-3,
                               atol=2e-6)
    assert min(ref_rel) > 0  # every seam quantized


def test_drift_names_the_broken_tag_and_only_it():
    broken = T_obs_numerics.run_drift(basech=4, hw=16, break_tag="gru_fwd", device="cpu")
    assert broken["first_offender"] == "gru_fwd" and broken["dtype"] == "bfloat16"
    clean = T_obs_numerics.run_drift(basech=4, hw=16, device="cpu")
    assert clean["first_offender"] is None
    assert [e["tag"] for e in clean["ladder"]] == [e["tag"] for e in broken["ladder"]]


# -- the train step: probes and remat --------------------------------------


@pytest.fixture(scope="module")
def steps():
    """Two train steps from the same weights and batches: plain, probed,
    and under remat."""
    resolve_device("cpu")
    rng = np.random.default_rng(2)
    batches = [{k: torch.from_numpy(rng.poisson(0.7, (B, L, H, W, 2)).astype(np.float32))
                for k in ("inp", "gt")} for _ in range(2)]
    torch.manual_seed(0)
    base = DeepRecurrNet(inch=2, basech=4, num_frame=3)
    state = {k: v.clone() for k, v in base.state_dict().items()}
    out = {}
    for name, kw in (("plain", {}), ("numerics", {"numerics": True}),
                     ("remat", {"remat": True})):
        model = DeepRecurrNet(inch=2, basech=4, num_frame=3, numerics=name == "numerics")
        model.load_state_dict(state)
        opt = T_optim.make_optimizer("Adam", model.parameters(), lr=1e-3, weight_decay=1e-4)
        step = T_step.make_train_step(model, opt, seqn=3, **kw)
        metrics, grads = [], []
        for batch in batches:
            metrics.append(step(batch))
            grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        out[name] = {"metrics": metrics, "grads": grads,
                     "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    return out


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_probes_leave_the_train_step_bitwise(steps):
    plain, probed = steps["plain"], steps["numerics"]
    for a, b in zip(plain["metrics"], probed["metrics"]):
        for key in ("loss", "loss_per_window", "grad_norm", "last_pred"):
            assert torch.equal(_bits(a[key]), _bits(b[key])), key
    for ga, gb in zip(plain["grads"], probed["grads"]):
        assert all(torch.equal(_bits(ga[n]), _bits(gb[n])) for n in ga)
    assert all(torch.equal(_bits(plain["params"][n]), _bits(probed["params"][n]))
               for n in plain["params"])
    num = probed["metrics"][0]["numerics"]
    assert set(num) == set(T_obs_numerics.TAG_ORDER)
    count = T_numerics.STAT_FIELDS.index("count")
    # the DCN taps fire twice a window, three windows a step, on the
    # bottleneck (H, W padded to multiples of 8, over 8; 8 * basech channels)
    assert float(num["dcn_out"][count]) == 6 * B * (16 // 8) * (24 // 8) * 32
    assert float(num["loss"][count]) == L - 3 + 1


def test_remat_step_matches_the_plain_step(steps):
    plain, remat = steps["plain"], steps["remat"]
    for a, b in zip(plain["metrics"], remat["metrics"]):
        for key in ("loss", "loss_per_window", "grad_norm", "last_pred"):
            np.testing.assert_allclose(b[key].numpy(), a[key].numpy(), rtol=1e-5, atol=1e-6)
    for ga, gb in zip(plain["grads"], remat["grads"]):
        for n in ga:
            np.testing.assert_allclose(gb[n].numpy(), ga[n].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=n)
    for n, p in plain["params"].items():
        np.testing.assert_allclose(remat["params"][n].numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


# -- the recovery machinery ------------------------------------------------


def _under_sinks(tmp_path, fn_port, fn_ref):
    """Run ``fn_port`` under a port sink and ``fn_ref`` under a reference
    sink; returns (port result, ref result, port events, ref events)."""
    results = []
    for name, sink_cls, set_active, fn in (("port", TelemetrySink, set_active_sink, fn_port),
                                           ("ref", RefSink, ref_set_active_sink, fn_ref)):
        path = tmp_path / f"{name}.jsonl"
        sink = sink_cls(str(path))
        prev = set_active(sink)
        try:
            results.append(fn())
        finally:
            set_active(prev)
            sink.close()
    return results[0], results[1], _events(tmp_path / "port.jsonl"), _events(
        tmp_path / "ref.jsonl")


@pytest.mark.parametrize("budget", [0, 1, 2])
def test_anomaly_guard_decides_and_reports_as_the_reference(tmp_path, probed, budget):
    poisoned = {t: v.copy() for t, v in probed["got"].items()}
    poisoned["enc1"][T_numerics.STAT_FIELDS.index("nonfinite")] = 1.0
    trace = [([1.0], None), ([float("nan")], poisoned), ([2.0], None), ([float("inf")], None),
             ([float("nan")], poisoned), ([float("nan")], None), ([3.0], None)]

    def drive(guard_cls, signal_cls):
        guard = guard_cls(budget)
        decisions = []
        for i, (losses, num) in enumerate(trace):
            try:
                decisions.append(guard.check(losses, i, fault_id=f"f{i}", numerics=num))
            except signal_cls as rb:
                decisions.append(("rollback", rb.at_iteration, rb.bad_steps, rb.fault_id,
                                  rb.bad_tag))
                guard.consecutive_bad = 0
        return decisions, guard.skipped_iterations, guard.rollbacks, guard.last_bad_tag

    got, want, got_ev, want_ev = _under_sinks(
        tmp_path, lambda: drive(T_recovery.AnomalyGuard, T_recovery.RollbackSignal),
        lambda: drive(J_recovery.AnomalyGuard, J_recovery.RollbackSignal))
    assert got == want
    assert got_ev == want_ev
    # a budget of 0 rolls back at every bad step and skips none
    assert len(want_ev) == (0 if budget == 0 else sum(d is False for d in want[0]))


@pytest.mark.parametrize("failures,retries", [(0, 1), (1, 1), (2, 3), (3, 2)])
def test_retry_with_backoff_matches_reference(tmp_path, failures, retries):
    def drive(retry):
        left = [failures]
        sleeps = []

        def fn():
            if left[0]:
                left[0] -= 1
                raise ValueError("boom")
            return "done"

        try:
            out = retry(fn, retries=retries, backoff_s=0.05, site="ckpt_commit",
                        event="recovery_ckpt_retry", sleep=sleeps.append, iteration=8)
        except ValueError as e:
            out = repr(e)
        return out, sleeps

    got, want, got_ev, want_ev = _under_sinks(
        tmp_path, lambda: drive(T_recovery.retry_with_backoff),
        lambda: drive(J_recovery.retry_with_backoff))
    assert got == want
    assert got_ev == want_ev and len(got_ev) == min(failures, retries)


def test_validate_restored_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    state = {"params/a": rng.standard_normal((3, 4)).astype(np.float32),
             "params/b": rng.standard_normal(5).astype(np.float32),
             "optimizer/count": np.asarray(7)}
    cases = {
        "ok": state,
        "changed": {**state, "params/b": state["params/b"] + 1},
        "nonfinite": {**state, "params/a": np.full((3, 4), np.nan, np.float32)},
    }
    for pkg in (T_recovery, J_recovery):
        pkg.write_digest(str(tmp_path), pkg.state_digest(state))
        verdicts = {k: pkg.validate_restored(str(tmp_path), v) for k, v in cases.items()}
        assert verdicts["ok"] == (True, "ok")
        assert verdicts["changed"][0] is False and verdicts["changed"][1].startswith(
            "digest mismatch")
        assert verdicts["nonfinite"] == (False, "non-finite leaf values")
        assert pkg.read_digest(str(tmp_path / "missing")) is None


@pytest.fixture(scope="module")
def fallback(tmp_path_factory):
    """Two committed checkpoints in each package; the newest truncated by a
    ``ckpt_restore`` fault, restored with fallback."""
    from esr_tpu.config.build import build_optimizer as j_build_optimizer
    from esr_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
    from esr_tpu.training.train_step import TrainState

    config = T_chaos.train_config("unused", basech=2)
    plan = [("ckpt_restore", 0, "truncate")]
    root = tmp_path_factory.mktemp("fallback")
    # the port
    resolve_device("cpu")
    model = DeepRecurrNet(inch=2, basech=2, num_frame=3)
    opt = T_optim.make_optimizer("Adam", model.parameters(), lr=1e-3)
    for it in (3, 7):
        save_checkpoint(str(root / "port"), model, opt, config, it, 0.5)
        os.utime(root / "port" / f"checkpoint-iteration{it}" / "meta.json", (it, it))
    port_digest_ok = T_recovery.validate_restored(
        str(root / "port" / "checkpoint-iteration7"),
        restore_state(str(root / "port" / "checkpoint-iteration7")))
    sink = TelemetrySink(str(root / "port.jsonl"))
    prev = set_active_sink(sink)
    try:
        with installed(FaultPlan([FaultSpec(*p) for p in plan])):
            port = T_recovery.restore_with_fallback(str(root / "port"), model, opt, config)
    finally:
        set_active_sink(prev)
        sink.close()
    # the reference
    ref = FlaxNet(inch=2, basech=2, num_frame=3)
    x = np.zeros((1, 3, 16, 16, 2), np.float32)
    j_opt, _ = j_build_optimizer(config["optimizer"], config.get("lr_scheduler"), None)
    # the values are the template's own: a shape trace is enough
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0), x, ref.init_states(1, 16, 16))
    template = TrainState.create(
        jax.tree.map(lambda a: np.full(a.shape, 0.25, a.dtype), shapes), j_opt)
    for it in (3, 7):
        j_save_checkpoint(str(root / "ref"), template, config, it, 0.5)
        os.utime(root / "ref" / f"checkpoint-iteration{it}" / "meta.yml", (it, it))
    sink = RefSink(str(root / "ref.jsonl"))
    prev = ref_set_active_sink(sink)
    try:
        with ref_installed(RefFaultPlan([RefFaultSpec(*p) for p in plan])):
            _, *ref_out = J_recovery.restore_with_fallback(str(root / "ref"), template, config)
    finally:
        ref_set_active_sink(prev)
        sink.close()
    return {"port": port, "ref": ref_out, "digest_ok": port_digest_ok,
            "port_events": _events(root / "port.jsonl", prefix=""),
            "ref_events": _events(root / "ref.jsonl", prefix="")}


def test_restore_with_fallback_matches_reference(fallback):
    assert fallback["digest_ok"] == (True, "ok")
    (start, best, path), (ref_start, ref_best, ref_path) = fallback["port"], fallback["ref"]
    assert (start, best) == (ref_start, ref_best) == (4, 0.5)
    assert Path(path).name == Path(ref_path).name == "checkpoint-iteration3"

    def shape(events):
        # the same events in the same order; the paths and the loader's
        # error text are each package's own
        return [(e["name"], e.get("site"), e.get("kind"), e.get("attempt"), e.get("remaining"),
                 Path(e["path"]).name if e.get("path") else None) for e in events]

    assert shape(fallback["port_events"]) == shape(fallback["ref_events"])
    assert [e["name"] for e in fallback["port_events"]] == ["fault_injected",
                                                           "recovery_restore_fallback"]


# -- a port training run with the runtime on --------------------------------

RUNTIME = [
    "trainer;tensorboard=false", "trainer;vis;enabled=false", "model;args;basech=4",
    "train_dataloader;batch_size=2", "valid_dataloader;batch_size=2",
    "trainer;iteration_based_train;iterations=4",
    "trainer;iteration_based_train;valid_step=2",
    "trainer;iteration_based_train;save_period=2",
    "trainer;iteration_based_train;train_log_step=1",
    "trainer;k_steps=1",  # one attribution record a step
    "trainer;numerics=true", "trainer;live_telemetry=0", "trainer;profile_steps=2",
    "trainer;max_bad_steps=1",
] + [f"{block};dataset;{k}={v}" for block in ("train_dataloader", "valid_dataloader")
     for k, v in (("ori_scale", "down8"), ("window", 512), ("sliding_window", 256),
                  ("sequence;sequence_length", 5))]


def _run_config(out, corpus, extra=(), runid="run0"):
    overrides = RUNTIME + [
        f"trainer;output_path={out}",
        f"train_dataloader;path_to_datalist_txt={corpus / 'datalist2.txt'}",
        f"valid_dataloader;path_to_datalist_txt={corpus / 'datalist1.txt'}", *extra]
    return T_parser.RunConfig.from_args(str(REPO / "configs" / "train_esr_2x.yml"), overrides,
                                        runid=runid, seed=5)


@pytest.fixture(scope="module")
def runtime_run(shared_corpus_dir, tmp_path_factory):
    """The flagship config cut to a tiny size, trained 4 iterations on the
    CPU with telemetry, probes, the live plane, a 2-step profile and the
    anomaly guard on; ``/metrics`` is read during step 2."""
    out = tmp_path_factory.mktemp("torch_runtime")
    run = _run_config(out, shared_corpus_dir)
    trainer = Trainer(run, device="cpu")
    step, scraped = trainer.train_step, {}

    def scraping_step(batch):
        if len(scraped) == 0 and trainer.live_plane is not None:
            url = f"http://127.0.0.1:{trainer.live_plane.port}/metrics"
            with urllib.request.urlopen(url, timeout=10) as r:
                scraped["status"], scraped["body"] = r.status, r.read().decode()
        return step(batch)

    trainer.train_step = scraping_step
    result = trainer.train()
    bf16 = Trainer(_run_config(out, shared_corpus_dir, ["trainer;transfer_dtype=bf16"],
                               runid="bf16"), device="cpu")
    return {"run": run, "trainer": trainer, "result": result, "scraped": scraped,
            "telemetry": Path(run.log_dir) / "telemetry.jsonl", "bf16": bf16}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_training_run_writes_the_reference_telemetry(runtime_run):
    recs = _records(runtime_run["telemetry"])
    kinds = {}
    for r in recs:
        kinds.setdefault(r["type"], []).append(r)
    assert recs[0]["type"] == "manifest" and recs[-1]["name"] == "train_end"
    assert recs[-1]["completed"] is True and recs[-1]["iterations"] == 4
    attribution = kinds["attribution"]
    assert [a["first_iteration"] for a in attribution] == [0, 1, 2, 3]
    spans = {s["name"] for s in kinds["span"]}
    assert {"train_run", "super_step", "data_wait", "dispatch", "device_step",
            "metric_readback", "checkpoint", "validate", "stage_megabatch"} <= spans
    tags = {r["name"] for r in kinds["numerics"]}
    assert tags == set(T_obs_numerics.TAG_ORDER)
    assert all(r["finite_frac"] == 1.0 for r in kinds["numerics"])
    events = {r["name"] for r in kinds["event"]}
    assert {"live_telemetry", "profiler_capture", "prefetch_close",
            "device_watermark_unavailable"} <= events
    metrics = {r["name"] for r in kinds["metric"]}
    assert {"train_loss/train", "valid_loss"} <= metrics
    assert runtime_run["scraped"]["status"] == 200
    assert "esr_" in runtime_run["scraped"]["body"]


def test_both_reporters_read_the_port_training_run(runtime_run):
    path = str(runtime_run["telemetry"])
    ref, ref_code = J_report.report_file(path, slo_path=str(REPO / "configs" / "slo.yml"))
    port, port_code = T_report.report_file(path, slo_path=str(REPO / "configs" / "slo.yml"))
    assert sorted(port["report"]) == sorted(ref["report"])
    for key in ("goodput", "spans", "numerics", "faults", "traces", "events"):
        assert port["report"][key] == ref["report"][key], key
    assert ref["report"]["goodput"]["source"] == "attribution"
    assert ref["report"]["numerics"]["tags"].keys() == set(T_obs_numerics.TAG_ORDER)
    assert ref_code == port_code == 0


def test_chrome_trace_equals_reference(runtime_run, tmp_path):
    path = str(runtime_run["telemetry"])
    manifest, records, torn = T_export.read_telemetry(path)
    ref_manifest, ref_records, ref_torn = J_export.read_telemetry(path)
    assert (manifest, records, torn) == (ref_manifest, ref_records, ref_torn)
    got = T_export.to_chrome_trace(records, manifest)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(
        J_export.to_chrome_trace(ref_records, ref_manifest)))
    stats = T_export.export_file(path, str(tmp_path / "trace.json"))
    assert stats["events"] == len(got["traceEvents"]) and stats["torn_lines"] == 0


def test_profile_steps_writes_a_trace_and_a_capture_event(runtime_run):
    trainer = runtime_run["trainer"]
    (cap,) = [r for r in _records(runtime_run["telemetry"]) if r["name"] == "profiler_capture"]
    assert cap["ok"] is True and cap["steps"] == 2 and cap["steps_covered"] == 2
    assert cap["site"] == "train" and cap["dir"] == trainer.trace_dir
    with open(cap["file"]) as f:
        trace = json.load(f)
    assert any(e.get("name") == "aten::conv2d" for e in trace["traceEvents"])


def test_transfer_bf16_rounds_on_the_host_as_the_reference(runtime_run):
    trainer = runtime_run["bf16"]
    batch = next(iter(trainer.train_loader))
    sel = trainer._host_select(batch, for_train=True)
    for name, key in (("inp", "inp_scaled_cnt"), ("gt", "gt_cnt")):
        assert sel[name].dtype == torch.bfloat16
        want = np.asarray(batch[key]).astype(ml_dtypes.bfloat16).view(np.int16)
        np.testing.assert_array_equal(sel[name].view(torch.int16).numpy(), want)
    # on the device the batch is widened to f32; validation ships f32
    staged = trainer._stage(batch, for_train=True)
    assert staged["inp"].dtype == torch.float32
    assert torch.equal(staged["inp"], sel["inp"].float())
    assert trainer._stage(batch)["inp"].dtype == torch.float32
    assert torch.equal(trainer._stage(batch)["gt"], torch.from_numpy(batch["gt_cnt"]))


@pytest.fixture(scope="module")
def checkpoint_twins(shared_corpus_dir, tmp_path_factory):
    """The run of :func:`runtime_run` without its observers (live plane,
    profiler, probes), as the flagship writes it (``async_checkpoint:
    true``) and with ``async_checkpoint`` off; the async run records its
    barriers (the caller, ``raise_error``) and, after each save, whether
    the run-start snapshot is still held."""
    import sys

    out = tmp_path_factory.mktemp("torch_ckpt_twins")
    quiet = ["trainer;live_telemetry=false", "trainer;profile_steps=0",
             "trainer;numerics=false"]
    runs = {}
    for name, extra in (("async", []), ("sync", ["trainer;async_checkpoint=false"])):
        run = _run_config(out, shared_corpus_dir, quiet + extra, runid=name)
        trainer = Trainer(run, device="cpu")
        barriers, held = [], []
        if trainer._async_ckpt is not None:
            wait = trainer._async_ckpt.wait

            def recorded_wait(raise_error=True, timeout=None, wait=wait):
                barriers.append((sys._getframe(1).f_code.co_name, raise_error))
                return wait(raise_error, timeout)

            trainer._async_ckpt.wait = recorded_wait
        save = trainer._save

        def recorded_save(iteration, best, save=save, trainer=trainer, held=held):
            save(iteration, best)
            held.append((iteration, trainer._init_state is not None))

        trainer._save = recorded_save
        trainer.train()
        runs[name] = {"run": run, "trainer": trainer, "barriers": barriers, "held": held}
    return runs


def test_async_checkpoints_are_the_sync_ones_and_barriered_as_the_reference(
        checkpoint_twins):
    """``async_checkpoint: true`` commits on the writer thread what the sync
    path commits inline: every checkpoint's digest and marker, and the
    restored state bitwise. The barriers are the reference's: one in each
    save, the final commit's inside the run (raising), the teardown's
    (logging); the run-start snapshot is freed once a commit has landed."""
    a, s = checkpoint_twins["async"], checkpoint_twins["sync"]
    assert a["trainer"]._async_ckpt is not None and s["trainer"]._async_ckpt is None
    assert a["trainer"]._async_ckpt.commits == 2 and not a["trainer"]._async_ckpt.in_flight
    assert a["barriers"] == [("save", True), ("save", True), ("train", True),
                             ("train", False)]
    assert a["held"] == [(2, True), (3, False)] and s["held"] == [(2, False), (3, False)]
    adir, sdir = Path(a["run"].save_dir), Path(s["run"].save_dir)
    names = sorted(p.name for p in adir.iterdir() if p.is_dir())
    assert names == sorted(p.name for p in sdir.iterdir() if p.is_dir()) == [
        "checkpoint-iteration2", "checkpoint-iteration3", "model_best_until_iteration2"]
    for name in names:
        for f in ("digest.json", "meta.json"):
            assert (adir / name / f).read_bytes() == (sdir / name / f).read_bytes(), (name, f)
        got, want = restore_state(str(adir / name)), restore_state(str(sdir / name))
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
    spans = [r for r in _records(Path(a["run"].log_dir) / "telemetry.jsonl")
             if r["type"] == "span"]
    snaps = [r for r in spans if r["name"] == "checkpoint_snapshot"]
    commits = [r for r in spans if r["name"] == "checkpoint_commit"]
    assert [r["iteration"] for r in snaps] == [r["iteration"] for r in commits] == [2, 3]
    assert {r["thread"] for r in commits} == {"ckpt-commit"}
    assert "ckpt-commit" not in {r["thread"] for r in snaps}
    # each commit carries the trace of the group that took its snapshot
    assert [r["trace_id"] for r in commits] == [r["trace_id"] for r in snaps]
    assert not any(r["name"].startswith("checkpoint_")
                   for r in _records(Path(s["run"].log_dir) / "telemetry.jsonl"))


def test_rollback_restores_after_the_commit_in_flight_lands(runtime_run, tmp_path,
                                                           monkeypatch):
    """The rollback's barrier: with a commit held open on the writer, the
    rollback waits for it and restores what it committed (without the
    barrier no checkpoint exists yet, and the run-start state would be
    restored)."""
    import threading

    from esr_tpu_torch.resilience.recovery import RollbackSignal
    from esr_tpu_torch.training import async_checkpoint as T_async

    trainer = runtime_run["bf16"]  # built with the guard and the async writer, never run
    ck = trainer._async_ckpt
    assert ck is not None and trainer._guard is not None and trainer._init_state is not None
    monkeypatch.setattr(trainer.run, "save_dir", str(tmp_path / "models"))
    release, commit = threading.Event(), T_async.commit_checkpoint

    def held_open(*args, **kwargs):
        release.wait(timeout=60)
        return commit(*args, **kwargs)

    monkeypatch.setattr(T_async, "commit_checkpoint", held_open)
    want = host_state(*snapshot_state(trainer.model, trainer.optimizer))
    ck.save(trainer.run.save_dir, trainer.model, trainer.optimizer, trainer.run.config, 41,
            trainer.mnt_best)
    assert ck.in_flight and find_latest_checkpoint(str(tmp_path)) is None
    timer = threading.Timer(0.2, release.set)
    timer.start()
    try:
        start = trainer._perform_rollback(RollbackSignal(at_iteration=43, bad_steps=2))
    finally:
        timer.cancel()
        release.set()
    assert start == 42 and ck.commits == 1 and not ck.in_flight
    assert find_latest_checkpoint(str(tmp_path)) == str(
        tmp_path / "models" / "checkpoint-iteration41")
    got = host_state(*snapshot_state(trainer.model, trainer.optimizer))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("extra,error", [
    (["trainer;transfer_dtype=bf16", "trainer;device_rasterize=true"], "transfer_dtype=bf16"),
    (["trainer;profile;enabled=true"], "mutually exclusive"),
    (["trainer;telemetry=false"], "requires trainer.telemetry"),
    (["trainer;transfer_dtype=f16"], "unknown transfer_dtype"),
])
def test_runtime_keys_raise_the_reference_errors(shared_corpus_dir, tmp_path, extra, error):
    run = T_parser.RunConfig.from_args(
        str(REPO / "configs" / "train_esr_2x.yml"),
        RUNTIME + [f"trainer;output_path={tmp_path}",
                   f"train_dataloader;path_to_datalist_txt={shared_corpus_dir / 'datalist1.txt'}",
                   f"valid_dataloader;path_to_datalist_txt={shared_corpus_dir / 'datalist1.txt'}",
                   *extra], runid="run0", seed=5, make_dirs=False)
    with pytest.raises(ValueError, match=error):
        Trainer(run, device="cpu")


# -- asynchronous checkpointing ----------------------------------------------


def _take_step(model, opt, seed):
    """One optimizer update from seeded gradients: it changes the
    parameters and Adam's moments in place."""
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()


@pytest.fixture
def ckpt_setup():
    """A tiny model and an Adam optimizer one update in, the checkpoint
    config, and the host state they hold now."""
    resolve_device("cpu")
    torch.manual_seed(0)
    model = DeepRecurrNet(inch=2, basech=2, num_frame=3)
    opt = T_optim.make_optimizer("Adam", model.parameters(), lr=1e-3, weight_decay=1e-4)
    _take_step(model, opt, 0)
    return model, opt, T_chaos.train_config("unused", basech=2)


def _state_now(model, opt):
    return host_state(*snapshot_state(model, opt))


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_async_save_restores_bitwise_the_sync_save(tmp_path, ckpt_setup):
    model, opt, config = ckpt_setup
    want = _state_now(model, opt)
    save_checkpoint(str(tmp_path / "sync"), model, opt, config, 5, 0.25)
    ck = AsyncCheckpointer()
    blocked = ck.save(str(tmp_path / "async"), model, opt, config, 5, 0.25)
    # the next update changes the live tensors while the commit may still run
    _take_step(model, opt, 1)
    ck.wait(timeout=60)
    assert ck.commits == 1 and blocked >= 0 and ck.last_commit_s > 0 and not ck.in_flight
    a = tmp_path / "async" / "checkpoint-iteration5"
    s = tmp_path / "sync" / "checkpoint-iteration5"
    for name in ("digest.json", "meta.json"):
        assert (a / name).read_bytes() == (s / name).read_bytes(), name
    _assert_state_equal(restore_state(str(a)), want)
    _assert_state_equal(restore_state(str(s)), want)
    assert T_recovery.validate_restored(str(a), restore_state(str(a))) == (True, "ok")


def test_async_torn_commit_is_invisible_and_the_prior_restores_bitwise(tmp_path, ckpt_setup):
    model, opt, config = ckpt_setup
    root = tmp_path / "ckpt"
    ck = AsyncCheckpointer(commit_retries=0)
    ck.save(str(root), model, opt, config, 3, 0.5)
    ck.wait(timeout=60)
    prior = _state_now(model, opt)
    _take_step(model, opt, 1)
    with installed(FaultPlan([FaultSpec("ckpt_commit", 7, "torn")])):
        ck.save(str(root), model, opt, config, 7, 0.5)
        with pytest.raises(AsyncCheckpointError, match="torn"):
            ck.wait(timeout=60)
    torn = root / "checkpoint-iteration7"
    assert (torn / "params.npz").is_file() and not (torn / "meta.json").exists()
    assert find_latest_checkpoint(str(root)) == str(root / "checkpoint-iteration3")
    _assert_state_equal(restore_state(str(root / "checkpoint-iteration3")), prior)
    # the trainer's restore lands on it too, bitwise
    torch.manual_seed(1)
    fresh = DeepRecurrNet(inch=2, basech=2, num_frame=3)
    fresh_opt = T_optim.make_optimizer("Adam", fresh.parameters(), lr=1e-3, weight_decay=1e-4)
    start, _, path = T_recovery.restore_with_fallback(str(root), fresh, fresh_opt, config)
    assert (start, Path(path).name) == (4, "checkpoint-iteration3")
    _assert_state_equal(_state_now(fresh, fresh_opt), prior)


def test_async_barrier_allows_one_commit_in_flight(tmp_path, ckpt_setup, monkeypatch):
    import threading

    from esr_tpu_torch.training import async_checkpoint as T_async

    model, opt, config = ckpt_setup
    root = tmp_path / "ckpt"
    release, entered = threading.Event(), threading.Semaphore(0)
    live, most, lock = [0], [0], threading.Lock()
    commit = T_async.commit_checkpoint

    def held_open(*args, **kwargs):
        with lock:
            live[0] += 1
            most[0] = max(most[0], live[0])
        entered.release()
        release.wait(timeout=60)
        try:
            return commit(*args, **kwargs)
        finally:
            with lock:
                live[0] -= 1

    monkeypatch.setattr(T_async, "commit_checkpoint", held_open)
    ck = AsyncCheckpointer()
    ck.save(str(root), model, opt, config, 1, 0.0)
    assert entered.acquire(timeout=60)
    second = threading.Thread(target=ck.save, args=(str(root), model, opt, config, 2, 0.0))
    second.start()
    # the second save waits at its barrier: its commit cannot start
    assert not entered.acquire(timeout=0.5)
    assert second.is_alive() and ck.in_flight
    assert not (root / "checkpoint-iteration1" / "meta.json").exists()
    release.set()
    second.join(timeout=60)
    assert not second.is_alive()
    ck.wait(timeout=60)
    assert most[0] == 1 and ck.commits == 2
    assert find_latest_checkpoint(str(root)) == str(root / "checkpoint-iteration2")


def test_async_garbage_meta_falls_back_to_the_prior_commit(tmp_path, ckpt_setup):
    model, opt, config = ckpt_setup
    root = tmp_path / "ckpt"
    ck = AsyncCheckpointer()
    ck.save(str(root), model, opt, config, 1, 0.0)
    prior = _state_now(model, opt)
    _take_step(model, opt, 1)
    ck.save(str(root), model, opt, config, 2, 0.0)
    ck.wait(timeout=60)
    (root / "checkpoint-iteration2" / "meta.json").write_text("{not json")
    assert find_latest_checkpoint(str(root)) == str(root / "checkpoint-iteration1")
    _assert_state_equal(restore_state(str(root / "checkpoint-iteration1")), prior)


def test_async_commit_retries_an_injected_fault_then_commits(tmp_path, ckpt_setup):
    model, opt, config = ckpt_setup
    root = tmp_path / "ckpt"
    sink = TelemetrySink(str(tmp_path / "telemetry.jsonl"))
    prev = set_active_sink(sink)
    try:
        with installed(FaultPlan([FaultSpec("ckpt_commit", 4, "fail")])):
            ck = AsyncCheckpointer(commit_retries=2, commit_backoff_s=0.01)
            ck.save(str(root), model, opt, config, 4, 0.0)
            ck.wait(timeout=60)
    finally:
        set_active_sink(prev)
        sink.close()
    assert ck.commits == 1
    assert find_latest_checkpoint(str(root)) == str(root / "checkpoint-iteration4")
    records = _records(tmp_path / "telemetry.jsonl")
    retries = [r for r in records if r["name"] == "recovery_ckpt_retry"]
    commits = [r for r in records if r["name"] == "checkpoint_commit"]
    assert [(r["attempt"], r["iteration"]) for r in retries] == [(1, 4)]
    assert len(commits) == 1 and commits[0]["type"] == "span"
    assert commits[0]["thread"] == "ckpt-commit" and commits[0]["iteration"] == 4


def test_async_failed_commit_raises_at_the_next_barrier(tmp_path, ckpt_setup):
    model, opt, config = ckpt_setup
    root = tmp_path / "ckpt"
    ck = AsyncCheckpointer(commit_retries=0)
    with installed(FaultPlan([FaultSpec("ckpt_commit", 2, "fail"),
                              FaultSpec("ckpt_commit", 3, "fail")])):
        ck.save(str(root), model, opt, config, 2, 0.0)
        # the next save's own barrier raises, before it snapshots
        with pytest.raises(AsyncCheckpointError, match="ckpt_commit"):
            ck.save(str(root), model, opt, config, 9, 0.0)
        assert not ck.in_flight and not (root / "checkpoint-iteration9").exists()
        # a teardown barrier logs the failure and does not raise
        ck.save(str(root), model, opt, config, 3, 0.0)
        ck.wait(raise_error=False, timeout=60)
    assert ck.commits == 0 and find_latest_checkpoint(str(root)) is None
    ck.save(str(root), model, opt, config, 4, 0.0)
    ck.wait(timeout=60)
    assert ck.commits == 1


# -- the chaos scenario ------------------------------------------------------


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    """The port's scenario (fast profile, CPU) and the reference's chaos
    train phase on the same seed."""
    out = tmp_path_factory.mktemp("torch_chaos")
    port = T_chaos.run_scenario(str(out / "port"), seed=0, fast=True, device="cpu")
    datalist = J_chaos.build_corpus(str(out / "ref" / "corpus"))
    ref = J_chaos._run_train(J_chaos.train_config(str(out / "ref"), datalist, basech=2),
                             "chaos", 0, J_chaos.build_train_plan(0))
    return {"port": port, "ref": ref}


def test_chaos_completes_and_rejoins_its_twin(chaos):
    s = chaos["port"]
    assert s["ok"], s["checks"]
    assert s["params_max_rel_diff"] <= 1e-5 and s["loss_series_max_rel_diff"] <= 1e-5
    assert s["loss_steps_compared"] >= T_chaos.ITERATIONS - 2
    assert s["faults"]["unrecovered"] == 0 and s["faults"]["injected"] == 8
    assert {"prefetch", "train_step", "ckpt_commit", "ckpt_restore",
            "serve_chunk"} == set(s["faults"]["sites"])
    assert s["restore"]["fell_back"]


def test_chaos_skips_and_rolls_back_as_the_reference(chaos):
    port, ref = chaos["port"]["chaos"], chaos["ref"]
    assert port["rollbacks"] == ref["rollbacks"] == 1
    assert port["skipped_iterations"] == ref["skipped_iterations"]
    assert port["last_bad_tag"] == ref["last_bad_tag"] == "head_out"


@pytest.mark.parametrize("phase", ["train", "serve"])
def test_chaos_telemetry_passes_the_chaos_slo(chaos, phase):
    s = chaos["port"]
    path = s["chaos"]["telemetry"] if phase == "train" else s["serve_telemetry"]
    slo = str(REPO / "configs" / "slo_chaos.yml")
    doc, code = T_report.report_file(path, slo_path=slo)
    ref_doc, ref_code = J_report.report_file(path, slo_path=slo)
    assert code == ref_code == 0
    assert doc["report"]["faults"] == ref_doc["report"]["faults"]
    assert doc["report"]["faults"]["unrecovered"] == 0


# -- calibrate_ranges: per-layer ranges off the stats probes -----------------

class _Traced:
    """The reference's model as ``calibrate_ranges`` uses it (``init``,
    ``apply(..., train=False, mutable=["numerics"])``, ``init_states``),
    each traced once: run op by op on the CPU they compile every op of the
    model on its own (~30 s)."""

    def __init__(self, module):
        self.init = jax.jit(module.init)
        self._probed = jax.jit(
            lambda p, x, s: module.apply(p, x, s, train=False, mutable=["numerics"]))
        self.init_states = module.init_states

    def apply(self, params, x, states, train, mutable):
        assert train is False and list(mutable) == ["numerics"]
        return self._probed(params, x, states)


def test_calibrate_ranges_matches_reference_on_the_same_weights_and_corpus():
    """The reference's ``calibrate_ranges`` (its weights from
    ``init(PRNGKey(seed + 1))``, its corpus from ``jax.random``) against
    the port's ``calibrate_ranges_on`` given those weights and that corpus:
    the same tag set, every range within 1e-5 relative (plus the 1e-6 of
    the reference's rounding to six decimals)."""
    from esr_tpu.config.quantize import calibrate_ranges as ref_calibrate
    from esr_tpu_torch.config.quantize import calibrate_ranges_on

    seed, hw, batch, frames, n = 3, 32, 1, 3, 2
    ref = _Traced(FlaxNet(inch=2, basech=2, num_frame=frames, numerics=True,
                          numerics_mode="stats"))
    want = ref_calibrate(ref, hw=hw, batch=batch, frames=frames, seed=seed, n_batches=n)
    x0 = jax.random.normal(jax.random.PRNGKey(seed), (batch, frames, hw, hw, 2), jnp.float32)
    params = ref.init(jax.random.PRNGKey(seed + 1), x0, ref.init_states(batch, hw, hw))
    corpus = [np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 2 + i),
                                           (batch, frames, hw, hw, 2), jnp.float32))
              for i in range(n)]
    port = DeepRecurrNet(inch=2, basech=2, num_frame=frames, numerics=True,
                         numerics_mode="stats")
    convert.load_flax_params(port, jax.tree.map(np.asarray, {"params": params["params"]}))
    got = calibrate_ranges_on(port, corpus, device="cpu")
    assert sorted(got) == sorted(want) and len(got) == 13
    for tag in want:
        np.testing.assert_allclose(got[tag], want[tag], rtol=1e-5, atol=1e-6, err_msg=tag)
    with pytest.raises(ValueError, match="probe-enabled"):
        calibrate_ranges_on(DeepRecurrNet(inch=2, basech=2), corpus, device="cpu")


def test_calibrate_ranges_is_deterministic_from_seed():
    """The default model and corpus come from ``seed`` alone (the caller's
    RNG untouched): the same seed gives the same ranges, another seed
    others; every tag's range is finite and non-negative."""
    from esr_tpu_torch.config.quantize import calibrate_ranges

    state = torch.random.get_rng_state()
    a = calibrate_ranges(basech=2, hw=16, seed=4, device="cpu")
    b = calibrate_ranges(basech=2, hw=16, seed=4, device="cpu")
    c = calibrate_ranges(basech=2, hw=16, seed=5, device="cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    assert a == b and a != c and len(a) == 13
    assert all(np.isfinite(v) and v >= 0.0 for v in a.values())
