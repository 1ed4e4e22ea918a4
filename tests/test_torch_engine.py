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
  engine.

Measured on the CPU: engine vs harness and vs the JAX engine ~5e-7
relative at worst (the same f32 model, metrics summed in another order).
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
    StreamingEngine,
    extract_lane_state,
    inject_lane_state,
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
    with pytest.raises(NotImplementedError):
        make_chunk_fn(port, 1, 1, 16, 16, precision="int8")
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
