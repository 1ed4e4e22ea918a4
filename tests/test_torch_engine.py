"""The port's streaming engine against the reference's, on the CPU.

- the lane packer (``LanePackedChunks``) chunk by chunk, bit for bit, and the
  activity statistics and bursty synthesis it reads;
- ``StreamingEngine`` at lanes 4 x chunk_windows 8 over six recordings of
  unequal length (lanes refill mid-run) against the JAX ``StreamingEngine``
  and against the port's own sequential harness, at rtol 1e-5 (the
  reference's own pin, ``tests/test_infer_engine.py``); the degenerate
  lanes 1 x chunk 1 schedule; chunking that cannot change a recording's
  metrics; the validation errors;
- the chunk function's masking (padded windows, reset by ``where``), lane
  state extract / inject, the device prefetcher;
- the sparse model (``dcn_sparse``) against the reference's, within PR 1's
  model envelope (atol 1e-5 + rtol 1e-4; measured ~1e-7);
- ``python -m esr_tpu_torch.infer`` on a checkpoint that asks for the
  engine;
- the AOT export (``inference/export.py``): the ``engine_chunk`` artifact at
  f32, bf16 and int8 and the forward artifact against the reference's own
  artifacts of the same checkpoint (f32 within 1e-5 * max(|ref|, 1), the
  rungs within the chunk tolerances below), each loaded chunk program
  bitwise the eager one, the refusals (program, device, weights); serving
  through the artifact bitwise the traced session, with evictions; the
  serving tier's refusals at load and ``AotRegistry``.

Measured on the CPU: engine vs harness and vs the JAX engine ~5e-7
relative at worst (the same f32 model, metrics summed in another order);
the f32 artifacts against the reference's: 3e-8 to 2e-6 absolute (printed
by the tests).
"""

import os

import h5py
import jax
import numpy as np
import pytest
import torch

from esr_tpu.data.loader import LanePackedChunks as RefPacker
from esr_tpu.data.loader import window_activity as ref_window_activity
from esr_tpu.data.np_encodings import tile_activity_np as ref_tile_activity
from esr_tpu.data.synthetic import write_synthetic_h5
from esr_tpu.inference.engine import StreamingEngine as RefEngine
from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
from esr_tpu.models.esr import STFusion as FlaxSTFusion
from esr_tpu_torch import infer as port_infer
from esr_tpu_torch.data.loader import DevicePrefetcher, LanePackedChunks, window_activity
from esr_tpu_torch.data.np_encodings import activity_fraction_np, tile_activity_np
from esr_tpu_torch.data.synthetic import make_synthetic_recording
from esr_tpu_torch.inference.checkpoint import save_checkpoint
from esr_tpu_torch.inference.engine import (
    METRIC_KEYS,
    ChunkProgram,
    StreamingEngine,
    extract_lane_state,
    inject_lane_state,
    lane_states,
    make_chunk_fn,
)
from esr_tpu_torch.inference.harness import InferenceRunner
from esr_tpu_torch.models import convert
from esr_tpu_torch.models.esr import DeepRecurrNet

DATASET_CFG = {
    "scale": 2, "ori_scale": "down8", "time_bins": 1, "mode": "events",
    "window": 1024, "sliding_window": 512, "need_gt_events": True,
    "need_gt_frame": False,
    "data_augment": {"enabled": False, "augment": [], "augment_prob": []},
    "sequence": {"sequence_length": 4, "seqn": 3, "step_size": None,
                 "pause": {"enabled": False}},
}
# unequal lengths (2 to 12 windows): at lanes 4 the last two refill mid-run
EVENTS = (2048, 6000, 1100, 2600, 1500, 3000)
RTOL = 1e-5
MODEL_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_engine")
    paths = []
    for i, ev in enumerate(EVENTS):
        p = str(tmp / f"rec{i}.h5")
        # six unequal lengths, which no shared corpus has
        write_synthetic_h5(p, (64, 64), base_events=ev, num_frames=6,  # esr: noqa(TX006)
                           seed=i)
        paths.append(p)
    return paths


def seeded_params(ref, h=16, w=16, seed=0):
    """Seeded draws on the reference's parameter tree (``jax.eval_shape`` of
    its init), the offset/mask conv nonzero, as in PR 1's model test."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, h, w, 2), np.float32), ref.init_states(1, h, w))

    def draw(leaf):
        bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.3
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return jax.tree.map(draw, shapes)


@pytest.fixture(scope="module")
def models():
    ref = FlaxNet(inch=2, basech=2, num_frame=3)
    params = seeded_params(ref)
    port = DeepRecurrNet(inch=2, basech=2, num_frame=3)
    convert.load_flax_params(port, params)
    return ref, params, port.eval()


@pytest.fixture(scope="module")
def seq_results(recordings, models):
    runner = InferenceRunner(models[2], 3, device="cpu")
    return [runner.run_recording(p, DATASET_CFG, report=False) for p in recordings]


@pytest.fixture(scope="module")
def engine_results(recordings, models):
    engine = StreamingEngine(models[2], 3, lanes=4, chunk_windows=8, device="cpu")
    results, names = engine.run_datalist(recordings, DATASET_CFG)
    return results, names, len(engine.chunk_seconds)


def _assert_parity(got, ref, rtol=RTOL):
    """Engine result == reference result in schema and values (``time`` is
    a wall clock: only its presence and sign)."""
    assert set(got) == set(ref)
    assert got["n_windows"] == ref["n_windows"]
    assert got["time"] > 0 and got["params"] == pytest.approx(ref["params"])
    for k in METRIC_KEYS + ("esr_rmse", "bicubic_rmse"):
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, err_msg=k)
    for k in ("ssim_delta_mean", "ssim_delta_std", "ssim_delta_pos_frac",
              "esr_ssim_std", "bicubic_ssim_std"):
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_activity_statistics_match_reference(recordings):
    rng = np.random.default_rng(0)
    counts = rng.poisson(0.05, (3, 21, 30, 2)).astype(np.float32)
    for tile in (4, 8):
        np.testing.assert_array_equal(tile_activity_np(counts[0], tile),
                                      ref_tile_activity(counts[0], tile))
        assert window_activity(counts, tile) == ref_window_activity(counts, tile)
    assert activity_fraction_np(np.zeros((0,))) == 0.0
    with pytest.raises(ValueError):
        tile_activity_np(counts[0], 0)


@pytest.mark.parametrize("burst_frac", [1.0, 0.35])
def test_synthetic_streams_equal_reference(tmp_path, burst_frac):
    """``make_synthetic_recording`` holds the streams and frames the
    reference's ``write_synthetic_h5`` writes for the same seed."""
    path = str(tmp_path / "r.h5")
    # the reference's file is what is compared: one tiny one per case
    write_synthetic_h5(path, (32, 48), base_events=500, num_frames=3,  # esr: noqa(TX001)
                       seed=5,
                       burst_frac=burst_frac)
    rec = make_synthetic_recording((32, 48), base_events=500, num_frames=3, seed=5,
                                   burst_frac=burst_frac)
    with h5py.File(path, "r") as f:
        for rung in ("ori", "down2", "down4", "down8", "down16"):
            stream = rec.stream(rung)
            for i, key in enumerate(("xs", "ys", "ts", "ps")):
                np.testing.assert_array_equal(stream.window(0, stream.num_events)[i],
                                              np.asarray(f[f"{rung}_events/{key}"][:],
                                                         np.float64))
        np.testing.assert_array_equal(rec.frame(2), f["ori_images/image000000002"][:])
    with pytest.raises(ValueError):
        make_synthetic_recording((8, 8), burst_frac=0.0)


def test_lane_packer_matches_reference_chunk_by_chunk(recordings):
    port = list(LanePackedChunks(recordings, DATASET_CFG, lanes=4, chunk_windows=8))
    ref = list(RefPacker(recordings, DATASET_CFG, lanes=4, chunk_windows=8))
    assert len(port) == len(ref) >= 2
    for a, b in zip(port, ref):
        for k in ("inp_scaled", "gt", "inp_mid", "valid"):
            np.testing.assert_array_equal(a["windows"][k], b["windows"][k])
        np.testing.assert_array_equal(a["activity"], b["activity"])
        np.testing.assert_array_equal(a["reset_keep"], b["reset_keep"])
        assert [m and (m["recording"], m["windows"]) for m in a["meta"]] == \
            [m and (m["recording"], m["windows"]) for m in b["meta"]]


def test_engine_matches_jax_engine_with_refill(recordings, models, engine_results):
    ref, params, _ = models
    results, names, n_chunks = engine_results
    assert n_chunks >= 2  # 6 recordings on 4 lanes: two refill mid-run
    ref_results, ref_names = RefEngine(ref, params, 3, lanes=4,
                                       chunk_windows=8).run_datalist(recordings, DATASET_CFG)
    assert names == ref_names == [os.path.basename(p) for p in recordings]
    for got, want in zip(results, ref_results):
        _assert_parity(got, want)


def test_engine_matches_port_harness_with_refill(engine_results, seq_results):
    results, _, _ = engine_results
    assert max(r["n_windows"] for r in results) > 8  # a recording spans chunks
    for got, want in zip(results, seq_results):
        _assert_parity(got, want)


def test_degenerate_single_lane_single_window_is_sequential(recordings, models, seq_results):
    engine = StreamingEngine(models[2], 3, lanes=1, chunk_windows=1,  # esr: noqa(TX001)
                             device="cpu")  # the port's engine builds no program
    results, _ = engine.run_datalist(recordings[-1:], DATASET_CFG)
    _assert_parity(results[0], seq_results[-1])


def test_chunking_does_not_change_a_recording(recordings, models):
    fine, _ = StreamingEngine(models[2], 3, lanes=1, chunk_windows=2,  # esr: noqa(TX001)
                              device="cpu").run_datalist(recordings[1:2], DATASET_CFG)
    coarse, _ = StreamingEngine(models[2], 3, lanes=1, chunk_windows=7,
                                device="cpu").run_datalist(recordings[1:2], DATASET_CFG)
    assert fine[0]["n_windows"] > 7
    for k in METRIC_KEYS:
        np.testing.assert_allclose(fine[0][k], coarse[0][k], rtol=RTOL, err_msg=k)


def test_validation_errors(recordings, models, tmp_path):
    port = models[2]
    with pytest.raises(ValueError, match="lanes"):
        StreamingEngine(port, lanes=0, device="cpu")  # esr: noqa(TX001) - raises
    with pytest.raises(ValueError, match="chunk_windows"):
        StreamingEngine(port, chunk_windows=0, device="cpu")
    # int8 quantizes at the seams: a compute dtype beside it is refused
    with pytest.raises(ValueError, match="compute_dtype"):
        make_chunk_fn(port, 1, 1, 16, 16, compute_dtype=torch.bfloat16, precision="int8")
    with pytest.raises(ValueError, match="unknown precision"):
        StreamingEngine(port, precision="int4", device="cpu")
    odd = str(tmp_path / "odd.h5")
    write_synthetic_h5(odd, (96, 96), base_events=1024, num_frames=6, seed=9)  # esr: noqa(TX001)
    with pytest.raises(ValueError, match="resolution"):
        list(LanePackedChunks([recordings[0], odd], DATASET_CFG, lanes=2, chunk_windows=2))
    with pytest.raises(ValueError, match="empty"):
        LanePackedChunks([], DATASET_CFG)


@pytest.fixture(scope="module")
def chunk_fn_2x2(models):
    """The port's chunk function at lanes 2 x chunk 2 on the 16x16 grid."""
    return make_chunk_fn(models[2], 2, 2, 16, 16)


def test_chunk_fn_masks_padding_and_resets_by_where(models, chunk_fn_2x2):
    """A padded window's non-finite metrics never reach a sum, and a lane
    reset zeroes a non-finite state (``where``, not a multiply)."""
    port, run = models[2], chunk_fn_2x2
    rng = np.random.default_rng(1)
    windows = {
        "inp_scaled": torch.from_numpy(rng.poisson(0.3, (2, 2, 3, 16, 16, 2)).astype(np.float32)),
        "gt": torch.from_numpy(rng.poisson(0.3, (2, 2, 16, 16, 2)).astype(np.float32)),
        "inp_mid": torch.from_numpy(rng.poisson(0.3, (2, 2, 8, 8, 2)).astype(np.float32)),
        "valid": torch.tensor([[1.0, 1.0], [1.0, 0.0]]),
    }
    windows["gt"][1, 1] = 0.0  # psnr of a zero GT is inf: masked by valid
    states = tuple(torch.full_like(z, float("nan")) for z in port.init_states(2, 16, 16))
    out_states, sums, stacked = run(states, torch.zeros(2), windows)
    assert all(bool(torch.isfinite(v).all()) for v in sums.values())
    assert sums["count"].tolist() == [2.0, 1.0]
    assert tuple(stacked["esr_ssim"].shape) == (2, 2)
    assert all(bool(torch.isfinite(z).all()) for z in out_states)
    with pytest.raises(ValueError, match="chunk of shape"):
        run(states, torch.zeros(2), {k: v[:1] for k, v in windows.items()})


def test_lane_state_extract_inject_is_bitwise(models):
    port = models[2]
    rng = np.random.default_rng(2)
    states = tuple(torch.from_numpy(rng.standard_normal(z.shape).astype(np.float32))
                   for z in port.init_states(3, 16, 16))
    host = extract_lane_state(states, 1)
    assert all(isinstance(h, np.ndarray) and h.shape == (2, 2, 16) for h in host)
    target = tuple(torch.zeros_like(z) for z in states)
    inject_lane_state(target, 2, host)
    for t, s in zip(target, states):
        assert torch.equal(t[2], s[1]) and not bool(t[:2].any())
    with pytest.raises(ValueError):
        inject_lane_state(target, 0, host[:1])


def test_device_prefetcher_keeps_order_and_raises():
    with DevicePrefetcher(range(5), lambda i: i * 10, depth=2) as pf:
        assert list(pf) == [(i, i * 10) for i in range(5)]

    def bad(i):
        if i == 2:
            raise KeyError("boom")
        return i

    with DevicePrefetcher(range(5), bad, depth=1) as pf:
        with pytest.raises(KeyError):
            list(pf)


def test_sparse_model_matches_jax_sparse_model(models):
    """``DeepRecurrNet(dcn_sparse=True)`` against the reference's, one
    window then a second; and ``STFusion._fuse`` on features whose image 1
    is all zero (its DCN masked off) against the reference's masked Pallas
    forward in interpret mode and its dense jnp path."""
    ref, params, _ = models
    sparse_ref = FlaxNet(inch=2, basech=2, num_frame=3, dcn_sparse=True)
    port = DeepRecurrNet(inch=2, basech=2, num_frame=3, dcn_sparse=True).eval()
    convert.load_flax_params(port, params)
    rng = np.random.default_rng(3)
    rs, ts = sparse_ref.init_states(2, 16, 16), port.init_states(2, 16, 16)
    for _ in range(2):
        x = rng.poisson(0.5, (2, 3, 16, 16, 2)).astype(np.float32)
        ro, rs = sparse_ref.apply(params, x, rs)
        with torch.no_grad():
            to, ts = port(torch.from_numpy(x), ts, activity=torch.ones(2))
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), **MODEL_TOL)
        for r, t in zip(rs, ts):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), **MODEL_TOL)

    f0 = rng.standard_normal((3, 2, 2, 16)).astype(np.float32)
    f1 = rng.standard_normal((3, 2, 2, 16)).astype(np.float32)
    f0[1] = 0.0
    sf = {"params": params["params"]["spacetime_fuse"]}
    with torch.no_grad():
        to = port.spacetime_fuse._fuse(torch.from_numpy(f0).permute(0, 3, 1, 2),
                                       torch.from_numpy(f1).permute(0, 3, 1, 2))
    for impl in (None, "pallas"):
        mod = FlaxSTFusion(channels=16, dcn_impl_fwd=impl, dcn_sparse=True)
        ro = mod.apply(sf, f0, f1, False, method=FlaxSTFusion._fuse)
        np.testing.assert_allclose(to.permute(0, 2, 3, 1).numpy(), np.asarray(ro), **MODEL_TOL)


def test_infer_entry_point_runs_the_engine(recordings, models, seq_results, tmp_path):
    """A checkpoint whose config sets ``inference.engine`` (the flagship's)
    runs the engine through ``python -m esr_tpu_torch.infer``; its reports
    match the sequential harness's."""
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), models[1], {
        "model": {"name": "DeepRecurrNet", "args": {"inch": 2, "basech": 2, "num_frame": 3}},
        "trainer": {"precision": "f32"},
        "valid_dataloader": {"dataset": DATASET_CFG},
        "inference": {"engine": True, "lanes": 2, "chunk_windows": 3},
    })
    datalist = tmp_path / "list.txt"
    datalist.write_text("\n".join(recordings[:3]) + "\n")
    mean = port_infer.main([
        "--model_path", str(ckpt), "--data_list", str(datalist),
        "--output_path", str(tmp_path / "out"), "--device", "cpu", "--scale", "2",
        "--ori_scale", "down8", "--window", "1024", "--sliding_window", "512",
        "--seql", "4", "--no_need_gt_frame",
    ])
    assert (tmp_path / "out" / "inference_all.yml").exists()
    assert (tmp_path / "out" / "rec0.h5" / "inference.yml").exists()
    want = np.mean([r["esr_psnr"] for r in seq_results[:3]])
    np.testing.assert_allclose(mean["esr_psnr"], want, rtol=RTOL)
    assert mean["n_windows"] == sum(r["n_windows"] for r in seq_results[:3])


# -- the precision rungs of the chunk function -------------------------------
#
# ``make_chunk_fn`` at bf16 and at int8 against the reference's on the same
# windows and states (as tests/test_quantize.py:332 holds the reference's
# int8 chunk against its f32 twin): the per-lane metric sums within rtol
# 2e-2 at bf16 (measured 4.5e-3: two lanes of three windows, each sum
# carrying both sides' bf16 roundings) and 5e-4 at int8 (measured 5.7e-5),
# the bicubic sums rung-independent, and each rung's ESR PSNR per window
# within 1.0 dB of the f32 chunk's.
CHUNK_RTOL = {"bf16": 2e-2, "int8": 5e-4}


@pytest.fixture(scope="module")
def rung_chunks():
    import jax.numpy as jnp

    from esr_tpu.inference.engine import make_chunk_fn as ref_make_chunk_fn

    lanes, w, hw = 2, 3, 16
    ref = FlaxNet(inch=2, basech=4, num_frame=3, dcn_impl_fwd="pallas")
    params = seeded_params(ref, seed=5)
    port = DeepRecurrNet(inch=2, basech=4, num_frame=3)
    convert.load_flax_params(port, params)
    port.eval()
    rng = np.random.default_rng(0)
    windows = {
        "inp_scaled": rng.poisson(0.6, (w, lanes, 3, hw, hw, 2)).astype(np.float32),
        "inp_mid": rng.poisson(0.6, (w, lanes, hw, hw, 2)).astype(np.float32),
        "gt": rng.poisson(0.8, (w, lanes, hw, hw, 2)).astype(np.float32),
        "valid": np.ones((w, lanes), np.float32),
    }
    reset = np.ones(lanes, np.float32)
    out = {}
    for rung, dtype in (("f32", None), ("bf16", torch.bfloat16), ("int8", None)):
        jdt = jnp.bfloat16 if dtype is not None else None
        run = ref_make_chunk_fn(ref, lanes, w, hw, hw, compute_dtype=jdt, precision=rung)
        states = ref.init_states(lanes, hw, hw)
        if jdt is not None:
            states = jax.tree.map(lambda z: z.astype(jdt), states)
        _, ref_sums, _ = run(params, states, jnp.asarray(reset),
                             {k: jnp.asarray(v) for k, v in windows.items()})
        prun = make_chunk_fn(port, lanes, w, hw, hw, compute_dtype=dtype, precision=rung)
        pstates = lane_states(port, lanes, hw, hw, torch.device("cpu"), dtype)
        new_states, sums, _ = prun(pstates, torch.from_numpy(reset),
                                   {k: torch.from_numpy(v) for k, v in windows.items()})
        assert all(z.dtype == (dtype or torch.float32) for z in new_states)
        out[rung] = {"ref": {k: np.asarray(v) for k, v in ref_sums.items()},
                     "port": {k: v.numpy() for k, v in sums.items()}, "w": w}
    return out


@pytest.mark.parametrize("rung", ["bf16", "int8"])
def test_chunk_fn_rung_matches_reference_and_tracks_f32(rung_chunks, rung):
    got, ref = rung_chunks[rung]["port"], rung_chunks[rung]["ref"]
    f32 = rung_chunks["f32"]["port"]
    w = rung_chunks[rung]["w"]
    for k in METRIC_KEYS:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], ref[k], rtol=CHUNK_RTOL[rung], err_msg=k)
    for k in ("bicubic_psnr", "bicubic_ssim"):
        np.testing.assert_allclose(got[k], f32[k], rtol=1e-6, err_msg=k)
    assert not np.array_equal(got["esr_mse"], f32["esr_mse"])
    assert (np.abs(got["esr_psnr"] - f32["esr_psnr"]) / w).max() <= 1.0


# -- the AOT export: artifacts against the reference's, and against eager ----

AOT_LANES, AOT_W, AOT_HW = 2, 2, 16
AOT_CONFIG = {
    "experiment": "torch_aot",
    "model": {"name": "DeepRecurrNet", "args": {"inch": 2, "basech": 2, "num_frame": 3}},
    "optimizer": {"name": "Adam", "args": {"lr": 1e-3, "weight_decay": 1e-4, "amsgrad": True}},
    "lr_scheduler": {"name": "ExponentialLR", "args": {"gamma": 0.95}},
    "trainer": {"iteration_based_train": {"enabled": True, "iterations": 1}},
}


def _f32_close(got, ref, what):
    """``|got - ref| <= 1e-5 * max(|ref|, 1)`` over the tensor; the error is
    printed."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    limit = 1e-5 * max(float(np.abs(ref).max()) if ref.size else 0.0, 1.0)
    print(f"{what}: max abs err {err:.3e} (limit {limit:.3e})")
    assert err <= limit, what


def _aot_windows(seed=7):
    rng = np.random.default_rng(seed)
    w, b, hw = AOT_W, AOT_LANES, AOT_HW
    return {
        "inp_scaled": rng.poisson(0.6, (w, b, 3, hw, hw, 2)).astype(np.float32),
        "gt": rng.poisson(0.8, (w, b, hw, hw, 2)).astype(np.float32),
        "inp_mid": rng.poisson(0.6, (w, b, hw // 2, hw // 2, 2)).astype(np.float32),
        "valid": np.ones((w, b), np.float32),
    }


@pytest.fixture(scope="module")
def aot_artifacts(models, tmp_path_factory):
    """One checkpoint of the seeded weights in each package's format, and
    each package's ``engine_chunk`` artifact of it at every rung (lanes 2 x
    chunk 2 on the 16x16 GT grid, the CPU), through ``export_checkpoint``;
    the port's loaded once per rung with the port model's weights put in
    (the serving loader's path)."""
    from esr_tpu.config.build import build_optimizer
    from esr_tpu.inference.export import export_checkpoint as ref_export_checkpoint
    from esr_tpu.training import checkpoint as ref_ckpt
    from esr_tpu.training.train_step import TrainState
    from esr_tpu_torch.inference.export import export_checkpoint, load_exported_model

    _, params, _ = models
    tmp = tmp_path_factory.mktemp("torch_aot")
    opt, _ = build_optimizer(AOT_CONFIG["optimizer"], AOT_CONFIG["lr_scheduler"], 4000)
    config = dict(AOT_CONFIG, trainer=dict(AOT_CONFIG["trainer"], output_path=str(tmp / "ref")))
    ref_dir = ref_ckpt.save_checkpoint(str(tmp / "ref"), TrainState.create(params, opt),
                                       config, 0, 0.0)
    port_dir = str(tmp / "port")
    save_checkpoint(port_dir, params, AOT_CONFIG)
    out = {"ref_dir": ref_dir, "port_dir": port_dir, "port": {}, "ref": {}, "loaded": {}}
    for rung in RUNGS:
        kw = dict(batch=AOT_LANES, height=AOT_HW, width=AOT_HW, program="engine_chunk",
                  chunk_windows=AOT_W, scale=2, precision=rung)
        out["port"][rung] = export_checkpoint(port_dir, str(tmp / f"port.{rung}.pt2"),
                                              device="cpu", **kw)
        out["ref"][rung] = ref_export_checkpoint(ref_dir, str(tmp / f"ref.{rung}.stablehlo"),
                                                 platforms=("cpu",), **kw)
        out["loaded"][rung] = load_exported_model(out["port"][rung], device="cpu",
                                                  model=models[2])
    return out


RUNGS = ("f32", "bf16", "int8")


def _port_chunk_inputs(rung, windows):
    dtype = torch.bfloat16 if rung == "bf16" else None
    model = DeepRecurrNet(inch=2, basech=2, num_frame=3)
    states = lane_states(model, AOT_LANES, AOT_HW, AOT_HW, torch.device("cpu"), dtype)
    return states, torch.ones(AOT_LANES), {k: torch.from_numpy(v) for k, v in windows.items()}


@pytest.mark.parametrize("rung", RUNGS)
def test_engine_chunk_artifact_matches_jax_artifact(models, aot_artifacts, rung):
    """The port's ``engine_chunk`` artifact, loaded back, against the
    reference's ``export_checkpoint(program='engine_chunk',
    platforms=('cpu',))`` on the same seeded chunk: f32 within 1e-5 *
    max(|ref|, 1) (sums, SSIM pairs, states), bf16 and int8 within the
    rungs' chunk tolerances; both sidecars record the same geometry and
    rung."""
    import jax.numpy as jnp

    from esr_tpu.inference.export import load_exported_model as ref_load

    ref_fn, ref_side = ref_load(aot_artifacts["ref"][rung])
    fn, side = aot_artifacts["loaded"][rung]
    for key in ("program", "lanes", "chunk_windows", "gt_hw", "lr_hw", "seqn", "precision"):
        assert side[key] == ref_side[key], key
    assert side["device"] == "cpu" and ref_side["platforms"] == ["cpu"]
    windows = _aot_windows()
    states, reset, win = _port_chunk_inputs(rung, windows)
    ref_states = jax.tree.map(lambda z: jnp.asarray(z.float().numpy(), z_dtype(rung)),
                              tuple(states))
    got = fn(states, reset, win)
    want = ref_fn(models[1], ref_states, jnp.asarray(reset.numpy()),
                  {k: jnp.asarray(v) for k, v in windows.items()})
    (g_states, g_sums, g_stacked), (r_states, r_sums, r_stacked) = got, want
    if rung == "f32":
        for k in METRIC_KEYS + ("count",):
            _f32_close(g_sums[k].numpy(), r_sums[k], f"f32 sums {k}")
        for k in g_stacked:
            _f32_close(g_stacked[k].numpy(), r_stacked[k], f"f32 stacked {k}")
        for i, (a, b) in enumerate(zip(g_states, r_states)):
            _f32_close(a.numpy(), b, f"f32 state {i}")
        return
    assert all(z.dtype == (torch.bfloat16 if rung == "bf16" else torch.float32)
               for z in g_states)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(g_sums[k].numpy(), np.asarray(r_sums[k]),
                                   rtol=CHUNK_RTOL[rung], err_msg=k)


def z_dtype(rung):
    import jax.numpy as jnp

    return jnp.bfloat16 if rung == "bf16" else jnp.float32


@pytest.mark.parametrize("rung", RUNGS)
def test_loaded_chunk_program_is_the_eager_chunk_function(models, aot_artifacts, rung):
    """The loaded artifact, with the serving model's weights put in, is the
    eager chunk function bitwise (states, sums, SSIM pairs) at every rung;
    its graph holds the port's ops (the forward DCN; K1 and K2 at int8),
    not their plain versions."""
    dtype = torch.bfloat16 if rung == "bf16" else None
    windows = _aot_windows(seed=8)
    eager = ChunkProgram(models[2], AOT_LANES, AOT_W, AOT_HW, AOT_HW, dtype, rung)
    want = eager(*_port_chunk_inputs(rung, windows))
    fn, _ = aot_artifacts["loaded"][rung]
    got = fn(*_port_chunk_inputs(rung, windows))
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ops = {str(n.target) for n in fn.graph.nodes if n.op == "call_function"}
    mine = {o for o in ops if o.startswith("esr_tpu_torch.")}
    expected = {"esr_tpu_torch.dcn_fwd.default"}
    if rung == "int8":
        expected |= {"esr_tpu_torch.int8_conv.default",
                     "esr_tpu_torch.quantize_per_tensor.default"}
    assert mine == expected


def test_forward_artifact_matches_jax_artifact(models, tmp_path):
    """``save_exported_model`` / ``load_exported_model`` of one forward
    against the reference's ``load_exported(export_forward(...,
    platforms=('cpu',)))`` on the same seeded window and states: output and
    states within 1e-5 * max(|ref|, 1), run on the weights the artifact
    carries; the sidecar holds the reference's keys with ``device`` for
    ``platforms``."""
    from esr_tpu.inference.export import export_forward as ref_export_forward
    from esr_tpu.inference.export import load_exported as ref_load_exported
    from esr_tpu_torch.inference.export import load_exported_model, save_exported_model

    ref, params, port = models
    rng = np.random.default_rng(9)
    x = rng.poisson(0.5, (1, 3, 16, 16, 2)).astype(np.float32)
    states = tuple(rng.standard_normal((1, 2, 2, 16)).astype(np.float32) for _ in range(2))
    path = save_exported_model(str(tmp_path / "fwd.pt2"), port, torch.from_numpy(x),
                               tuple(torch.from_numpy(s) for s in states), device="cpu")
    fn, side = load_exported_model(path, device="cpu")
    assert {"model", "config", "input", "states"} <= set(side) and side["device"] == "cpu"
    y, new_states = fn(torch.from_numpy(x), tuple(torch.from_numpy(s) for s in states))
    ref_fn = ref_load_exported(ref_export_forward(ref, params, x, states, platforms=("cpu",)))
    ry, r_states = ref_fn(params, x, states)
    _f32_close(y.numpy(), ry, "forward output")
    for i, (a, b) in enumerate(zip(new_states, r_states)):
        _f32_close(a.numpy(), b, f"forward state {i}")


def test_export_refusals(models, aot_artifacts, tmp_path):
    """An unknown program (the reference's message), an artifact loaded for
    another device than it was exported for (the sidecar's ``device``), and
    a serving model whose weights do not fit the artifact's are refused."""
    import json
    import shutil

    from esr_tpu.inference.export import export_checkpoint as ref_export_checkpoint
    from esr_tpu_torch.inference.export import export_checkpoint, load_exported_model

    with pytest.raises(ValueError) as port_err:
        export_checkpoint(aot_artifacts["port_dir"], str(tmp_path / "x"), program="train",
                          device="cpu")
    with pytest.raises(ValueError) as ref_err:
        ref_export_checkpoint(aot_artifacts["ref_dir"], str(tmp_path / "y"), program="train",
                              platforms=("cpu",))
    assert str(port_err.value) == str(ref_err.value)
    cuda_art = str(tmp_path / "cuda.pt2")
    shutil.copy(aot_artifacts["port"]["f32"], cuda_art)
    side = json.loads(open(aot_artifacts["port"]["f32"] + ".json").read())
    with open(cuda_art + ".json", "w") as f:
        json.dump(dict(side, device="cuda"), f)
    with pytest.raises(ValueError, match="exported for device 'cuda'"):
        load_exported_model(cuda_art, device="cpu")
    wider = DeepRecurrNet(inch=2, basech=4, num_frame=3)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_exported_model(aot_artifacts["port"]["f32"], device="cpu", model=wider)


# -- serving through the artifacts --------------------------------------------

def _aot_engine(models, w=AOT_W, lanes=AOT_LANES, **kw):
    from esr_tpu_torch.serving.scheduler import RequestClass
    from esr_tpu_torch.serving.server import ServingEngine

    return ServingEngine(models[2], DATASET_CFG, lanes=lanes,
                         classes={"only": RequestClass("only", chunk_windows=w)},
                         default_class="only", device="cpu", **kw)


def test_aot_serving_matches_traced(recordings, models, aot_artifacts):
    """The reference's ``test_aot_serving_matches_traced`` (tests/
    test_serving.py), bitwise: three streams on two lanes with quantum 1
    (each evicted and resumed) served through the f32 artifact give every
    request's metrics, windows and preemptions and the final lane states of
    the traced session; the artifact was loaded once, with the engine's
    weights."""
    def serve(aot):
        srv = _aot_engine(models, preempt_quantum=1,  # esr: noqa(TX001) - two sessions
                          aot_programs={AOT_W: aot_artifacts["port"]["f32"]} if aot else None)
        rids = [srv.submit(p) for p in recordings[:3]]
        srv.run()
        return srv, [srv.report(r) for r in rids]

    traced, want = serve(False)
    aot, got = serve(True)
    assert list(aot.program_seconds) == [AOT_W] and aot._aot_paths
    assert sum(r["preemptions"] for r in got) > 0
    for a, t in zip(got, want):
        assert a["completed"] and a["n_windows"] == t["n_windows"] > 0
        assert a["preemptions"] == t["preemptions"]
        for k in METRIC_KEYS:
            assert a[k] == t[k], k
    assert all(torch.equal(a, b) for a, b in zip(aot._states, traced._states))


def test_aot_serving_refusals(models, aot_artifacts, tmp_path):
    """The reference's refusals at load (tests/test_serving.py:478,
    test_precision_ladder.py:361, test_quantize.py:263): a depth with no
    artifact (``KeyError`` naming it), another rung either way, another
    ``(lanes, chunk_windows)``, another grid, another device; and the
    registry: the geometry's map, a missing depth, an empty directory, a
    replica that resolves its depths through it."""
    import json
    import shutil

    from esr_tpu_torch.serving.replica import AotRegistry, Replica

    f32, int8 = aot_artifacts["port"]["f32"], aot_artifacts["port"]["int8"]
    grids = ((8, 8), (16, 16))

    def program(w=AOT_W, **kw):
        srv = _aot_engine(models, w=w, **kw)  # esr: noqa(TX001) - never dispatches
        srv._resolutions = grids
        return srv

    with pytest.raises(KeyError, match="chunk_windows=4"):
        program(w=4, aot_programs={AOT_W: f32})._program(4)
    with pytest.raises(ValueError, match="precision='f32'"):
        program(aot_programs={AOT_W: f32}, precision="int8")._program(AOT_W)
    with pytest.raises(ValueError, match="precision='int8'"):
        program(aot_programs={AOT_W: int8})._program(AOT_W)
    with pytest.raises(ValueError, match=r"\(lanes, chunk_windows\)=\(2, 2\)"):
        program(lanes=1, aot_programs={AOT_W: f32})._program(AOT_W)
    srv = program(aot_programs={AOT_W: f32})
    srv._resolutions = ((16, 16), (32, 32))
    with pytest.raises(ValueError, match="geometry"):
        srv._program(AOT_W)
    reg_dir = tmp_path / "registry"
    reg_dir.mkdir()
    art = str(reg_dir / "chunk_program.w2.pt2")
    shutil.copy(f32, art)
    side = json.loads(open(f32 + ".json").read())
    with open(art + ".json", "w") as f:
        json.dump(dict(side, device="cuda"), f)
    with pytest.raises(ValueError, match="exported for device 'cuda'"):
        program(aot_programs={AOT_W: art})._program(AOT_W)
    with open(art + ".json", "w") as f:
        json.dump(side, f)
    registry = AotRegistry(str(reg_dir))
    assert registry.programs_for(AOT_LANES, (AOT_W,), gt_hw=(16, 16), lr_hw=(8, 8),
                                 seqn=3) == {AOT_W: art}
    with pytest.raises(ValueError, match=r"no artifact for chunk_windows=\[4\]"):
        registry.programs_for(AOT_LANES, (AOT_W, 4))
    with pytest.raises(ValueError, match="no artifact"):
        registry.programs_for(AOT_LANES, (AOT_W,), gt_hw=(32, 32))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="holds no artifact"):
        AotRegistry(str(tmp_path / "empty"))
    from esr_tpu_torch.serving.scheduler import RequestClass

    rep = Replica("r0", models[2], DATASET_CFG, str(tmp_path / "tel.jsonl"),
                  classes={"only": RequestClass("only", chunk_windows=AOT_W)},
                  default_class="only", lanes=AOT_LANES, aot_registry=registry,
                  device="cpu").start()
    try:
        assert rep.engine._aot_paths == {AOT_W: art}
    finally:
        rep.close()
