"""The port's host side against the JAX package's, on the CPU: the
checkpoint exporter (an ``esr_tpu`` Orbax checkpoint evaluated by the
port), the metric writer's records, the 2D visualizations and the PNG
writer, the native host kernels, process loader workers, and device
rasterization (the encoder and one train step on it).

Tolerances: the exported model's forward rtol 1e-5 + atol 1e-6 (the same
f32 model in another framework, measured ~1e-7); everything else is
bitwise (integer counts, uint8 images, identical batches).
"""

import json
import os
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from esr_tpu import native as ref_native
from esr_tpu.config.build import build_optimizer as j_build_optimizer
from esr_tpu.data import np_encodings as ref_enc
from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
from esr_tpu.ops.encodings import make_device_encoder as j_make_device_encoder
from esr_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from esr_tpu.training.train_step import TrainState
from esr_tpu.utils import vis_events as ref_vis
from esr_tpu.utils.writer import MetricWriter as RefWriter
from esr_tpu_torch import native
from esr_tpu_torch.config import parser as T_parser
from esr_tpu_torch.data import np_encodings as NE
from esr_tpu_torch.data.loader import ConcatSequenceDataset, SequenceLoader
from esr_tpu_torch.inference.checkpoint import load_checkpoint
from esr_tpu_torch.ops.encodings import make_device_encoder, tile_activity
from esr_tpu_torch.training.trainer import Trainer, resolve_device_rasterize
from esr_tpu_torch.utils import vis_events as vis
from esr_tpu_torch.utils.writer import MetricWriter

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import export_torch_checkpoint  # noqa: E402

FLAGSHIP = REPO / "configs" / "train_esr_2x.yml"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work in one intra-op thread: at these sizes a
    thread team gains nothing, and beside other busy processes its
    spinning workers slow every op by orders of magnitude (the trainer runs of
    this module most of all)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the checkpoint exporter ------------------------------------------------

@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A seeded basech-4 state saved by ``esr_tpu``, exported, and loaded by
    the port."""
    root = tmp_path_factory.mktemp("export")
    with open(FLAGSHIP) as f:
        config = yaml.safe_load(f)
    config["model"]["args"]["basech"] = 4
    model = FlaxNet(**config["model"]["args"])
    x = np.zeros((1, 3, 16, 16, 2), np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, model.init_states(1, 16, 16))
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda s: jnp.asarray(rng.uniform(-0.3, 0.3, s.shape).astype(np.float32)
                              / np.sqrt(max(np.prod(s.shape[:-1]), 1))), shapes)
    optimizer, _ = j_build_optimizer(config["optimizer"], config.get("lr_scheduler"),
                                     config["trainer"]["iteration_based_train"]["lr_change_rate"])
    src = j_save_checkpoint(str(root / "ckpt"), TrainState.create(params, optimizer), config,
                            iteration=7, monitor_best=0.25)
    dst = export_torch_checkpoint.main([src, str(root / "torch")])
    port, port_config = load_checkpoint(dst)
    return {"root": root, "src": src, "dst": dst, "model": model, "params": params,
            "config": config, "port": port, "port_config": port_config}


def test_exported_checkpoint_evaluates_as_the_jax_model(exported):
    assert sorted(os.listdir(exported["dst"])) == ["config.json", "params.npz"]
    assert exported["port_config"] == json.loads(json.dumps(exported["config"]))
    rng = np.random.default_rng(4)
    inp = rng.poisson(0.5, (2, 3, 24, 32, 2)).astype(np.float32)
    model = exported["model"]
    want, want_states = model.apply(exported["params"], jnp.asarray(inp),
                                     model.init_states(2, 24, 32))
    port = exported["port"].eval()
    with torch.no_grad():
        got, got_states = port(torch.from_numpy(inp), port.init_states(2, 24, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for g, w in zip(jax.tree.leaves(got_states), jax.tree.leaves(want_states)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_exporter_refuses_an_uncommitted_checkpoint(exported):
    torn = exported["root"] / "torn"
    shutil.copytree(os.path.join(exported["src"], "state"), torn / "state")
    with pytest.raises(ValueError, match="commit marker"):
        export_torch_checkpoint.export(str(torn), str(exported["root"] / "never"))
    assert not (exported["root"] / "never").exists()


# -- the metric writer ------------------------------------------------------

def _drive(writer):
    writer.set_step(0)
    writer.add_scalar("train_loss", 0.5)
    writer.set_step(1)
    writer.add_scalar("train_loss", 0.25)
    writer.add_scalar("learning_rate", 1e-3)
    writer.add_image("train_gt_events_cnt", np.zeros((4, 5, 3), np.uint8))
    writer.set_step(3, mode="valid")
    writer.add_scalar("stamp_valid_loss", 2.0, step=1)
    writer.add_image("frame", np.zeros((4, 5), np.uint8), step=9)
    writer.close()


def test_writer_records_equal_the_reference(tmp_path):
    _drive(RefWriter(str(tmp_path / "ref"), enable_tensorboard=False, sink=False))
    _drive(MetricWriter(str(tmp_path / "port"), enable_tensorboard=False))
    lines = {}
    for side in ("ref", "port"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            lines[side] = [json.loads(line) for line in f]
    assert len(lines["port"]) == len(lines["ref"]) == 8
    for a, b in zip(lines["port"], lines["ref"]):
        if a["tag"].startswith("steps_per_sec/"):
            assert a["value"] > 0 and b["value"] > 0
            a, b = dict(a, value=None), dict(b, value=None)
        assert a == b


# -- the 2D visualizations and the PNG writer -------------------------------

@pytest.fixture(scope="module")
def counts():
    rng = np.random.default_rng(5)
    cnt = rng.poisson(0.7, (23, 31, 2)).astype(np.float32)
    cnt[3:9, 4:12] = 0
    return cnt


@pytest.mark.parametrize("scheme", ["green_red", "blue_red", "gray"])
@pytest.mark.parametrize("black", [True, False])
@pytest.mark.parametrize("norm", [True, False])
def test_render_event_cnt_is_bitwise_the_reference(counts, scheme, black, norm):
    got = vis.render_event_cnt(counts, scheme, black, norm)
    want = ref_vis.render_event_cnt(counts, scheme, black, norm)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_other_renders_are_bitwise_the_reference():
    rng = np.random.default_rng(6)
    ev = np.stack([rng.integers(-2, 20, 300), rng.integers(-2, 14, 300),
                   np.sort(rng.random(300)), rng.choice([-1, 1], 300)], 1).astype(np.float32)
    np.testing.assert_array_equal(vis.render_event_list(ev, (12, 18)),
                                  ref_vis.render_event_list(ev, (12, 18)))
    stack = rng.normal(0, 6, (9, 11, 6)).astype(np.float32)
    np.testing.assert_array_equal(vis.render_event_stack(stack), ref_vis.render_event_stack(stack))
    for frame in (rng.random((9, 11, 1)).astype(np.float32),
                  rng.integers(0, 255, (9, 11), dtype=np.uint8)):
        np.testing.assert_array_equal(vis.render_frame(frame), ref_vis.render_frame(frame))


@pytest.mark.parametrize("view", ["rgb", "gray"])
def test_png_decodes_to_the_array_and_to_the_references_file(counts, tmp_path, view):
    img = vis.render_event_cnt(counts, "gray" if view == "gray" else "green_red")
    port_png, ref_png = str(tmp_path / "port.png"), str(tmp_path / "ref.png")
    if view == "gray":
        vis.EventVisualizer().plot_frame(img, is_save=True, path=port_png)
    else:
        vis.save_image(port_png, img)
    ref_vis.save_image(ref_png, img)
    got = cv2.imread(port_png, cv2.IMREAD_UNCHANGED)
    want = img if view == "gray" else img[:, :, ::-1]  # cv2 decodes to BGR
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cv2.imread(ref_png, cv2.IMREAD_UNCHANGED))
    # a well-formed chunk stream: IHDR's CRC checks
    data = Path(port_png).read_bytes()
    length, = struct.unpack(">I", data[8:12])
    assert struct.unpack(">I", data[16 + length:20 + length])[0] == zlib.crc32(data[12:16 + length])


# -- the native host kernels --------------------------------------------------

@pytest.fixture(scope="module")
def host_kernels():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native host kernels cannot be built")
    if not native.available():
        pytest.fail(f"g++ is present but the build failed:\n{native.LIBRARY.build_log}")
    return native


@pytest.fixture(scope="module")
def events():
    rng = np.random.default_rng(7)
    n = 4000
    return dict(xs=(rng.random(n) * 44 - 2).astype(np.float32),
                ys=(rng.random(n) * 30 - 2).astype(np.float32),
                ts=np.sort(rng.random(n)).astype(np.float32),
                ps=rng.choice([-1.0, 1.0], n).astype(np.float32))


def test_native_bindings_are_bitwise_numpy_and_the_reference(host_kernels, events, monkeypatch):
    xs, ys, ts, ps = (events[k] for k in ("xs", "ys", "ts", "ps"))
    size = (26, 40)
    xn, yn = xs / 44, ys / 30
    offsets = np.array([0, 1000, 1000, 2500, 4000])
    got = {
        "counts": host_kernels.rasterize_counts(xs, ys, ps, size),
        "stack": host_kernels.rasterize_stack(xs, ys, ts, ps, 5, size),
        "rescatter": host_kernels.rescatter_counts(xn, yn, ps, size),
        "batch": host_kernels.rasterize_counts_batch(xs, ys, ps, offsets, size),
    }
    twins = {
        "counts": NE.channels_numpy(xs, ys, ps, size),
        "stack": NE.stack_numpy(xs, ys, ts, ps, 5, size),
        "rescatter": NE.channels_numpy(xn * size[1], yn * size[0], ps, size),
        "batch": np.stack([NE.channels_numpy(xs[a:b], ys[a:b], ps[a:b], size)
                           for a, b in zip(offsets[:-1], offsets[1:])]),
    }
    monkeypatch.delenv("ESR_TPU_NATIVE", raising=False)
    ref = {
        "counts": ref_native.rasterize_counts(xs, ys, ps, size),
        "stack": ref_native.rasterize_stack(xs, ys, ts, ps, 5, size),
        "rescatter": ref_native.rescatter_counts(xn, yn, ps, size),
        "batch": ref_native.rasterize_counts_batch(xs, ys, ps, offsets, size),
    }
    for k, v in got.items():
        assert v.dtype == np.float32 and v.sum() > 0, k
        np.testing.assert_array_equal(v, twins[k], err_msg=k)
        if ref[k] is not None:  # the reference's own build may be unavailable
            np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_encoders_take_native_first_and_count_each_route(host_kernels, events, monkeypatch):
    xs, ys, ts, ps = (events[k] for k in ("xs", "ys", "ts", "ps"))
    NE.ROUTES.reset()
    a = NE.events_to_channels_np(xs, ys, ps, (26, 40))
    s = NE.events_to_stack_np(xs, ys, ts, ps, 3, (26, 40))
    assert NE.ROUTES.snapshot() == {"native": 2, "numpy": 0}
    monkeypatch.setenv("ESR_TPU_NATIVE", "0")
    assert native.rasterize_counts(xs, ys, ps, (26, 40)) is None
    b = NE.events_to_channels_np(xs, ys, ps, (26, 40))
    t = NE.events_to_stack_np(xs, ys, ts, ps, 3, (26, 40))
    assert NE.ROUTES.snapshot() == {"native": 2, "numpy": 2}
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(s, t)
    np.testing.assert_array_equal(t, ref_enc.events_to_stack_np(xs, ys, ts, ps, 3, (26, 40)))


# -- process loader workers ----------------------------------------------------

LOADER_DATA = {
    "scale": 2, "ori_scale": "down8", "time_bins": 1, "mode": "events",
    "window": 512, "sliding_window": 256, "need_gt_events": True, "need_gt_frame": False,
    "data_augment": {"enabled": True, "augment": ["Horizontal", "Vertical", "Polarity"],
                     "augment_prob": [0.5, 0.5, 0.5]},
    "sequence": {"sequence_length": 4, "seqn": 3, "step_size": None,
                 "pause": {"enabled": False}},
    "item_keys": ["inp_cnt", "inp_scaled_cnt", "gt_cnt", "inp_norm_events"],
}


@pytest.fixture(scope="module")
def worker_epochs(shared_corpus_dir):
    """Two epochs of the same loader in-process and with 2 spawned workers."""
    recs = [str(shared_corpus_dir / f"rec{i}.h5") for i in range(2)]
    shm = Path("/dev/shm")
    before = set(shm.glob("psm_*")) if shm.is_dir() else set()
    out = {}
    for workers in (0, 2):
        loader = SequenceLoader(ConcatSequenceDataset(recs, LOADER_DATA), batch_size=3,
                                seed=11, num_workers=workers)
        try:
            out[workers] = []
            for epoch in range(2):
                loader.set_epoch(epoch)
                out[workers].append(list(loader))
            # an iteration left after one batch: the blocks of the batches
            # still in flight are unlinked, not leaked
            it = iter(loader)
            next(it)
            it.close()
        finally:
            loader.close()
        assert loader._pool is None
    leaked = (set(shm.glob("psm_*")) - before) if shm.is_dir() else set()
    return out, recs, leaked


def test_process_workers_give_the_in_process_batches(worker_epochs):
    epochs, _, leaked = worker_epochs
    assert not leaked
    for e0, e2 in zip(epochs[0], epochs[2]):
        assert len(e0) == len(e2) > 1
        for a, b in zip(e0, e2):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the two epochs differ (shuffle and augmentation seeds)
    assert not np.array_equal(epochs[0][0][0]["gt_cnt"], epochs[0][1][0]["gt_cnt"])


def test_workers_refuse_the_stateful_hot_filter(worker_epochs):
    _, recs, _ = worker_epochs
    dataset = ConcatSequenceDataset(recs, LOADER_DATA)
    dataset.config = {**LOADER_DATA, "hot_filter": {"enabled": True}}
    with pytest.raises(ValueError, match="hot_filter"):
        SequenceLoader(dataset, batch_size=2, num_workers=2)
    SequenceLoader(dataset, batch_size=2, num_workers=0)


# -- device rasterization ----------------------------------------------------

@pytest.mark.parametrize("augment", [False, True])
def test_raw_event_and_frame_items_are_bitwise_the_reference(shared_corpus_dir, augment):
    """The fixed-capacity raw event windows and the GT frame at the
    reference's capacity, layout and augmentation."""
    from esr_tpu.data.dataset import EventWindowDataset as RefDataset
    from esr_tpu_torch.data.dataset import ITEM_KEYS, EventWindowDataset

    KNOWN_KEYS = ITEM_KEYS + ("gt_img", "inp_norm_events", "inp_events_valid",
                              "gt_raw_events", "gt_events_valid")
    cfg = {**LOADER_DATA, "need_gt_frame": True, "item_keys": list(KNOWN_KEYS)}
    if not augment:
        cfg["data_augment"] = {"enabled": False, "augment": [], "augment_prob": []}
    rec = str(shared_corpus_dir / "rec1.h5")
    ref, port = RefDataset(rec, cfg), EventWindowDataset(rec, cfg)
    for i in (0, len(ref) // 2, len(ref) - 1):
        for seed in (0, 1, 2):
            a, b = port.get_item(i, seed=seed), ref.get_item(i, seed=seed)
            assert sorted(a) == sorted(b) == sorted(KNOWN_KEYS)
            assert a["inp_norm_events"].shape == (512, 4)
            assert a["gt_raw_events"].shape == (4 * 512, 4)
            for k in a:
                assert a[k].dtype == b[k].dtype == np.float32, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- every dataset option and item key (A16) ---------------------------------

OPTIONS_DATA = {
    **LOADER_DATA, "need_gt_frame": True, "time_bins": 3, "item_keys": None,
    "add_noise": {"enabled": True, "noise_level": 0.1},
    "hot_filter": {"enabled": True, "max_px": 20, "min_obvs": 2, "max_rate": 0.3},
    "custom_resolution": (20, 24), "activity": {"tile": 4},
}
CUSTOM_KEYS = ("inp_custom_cnt", "inp_custom_scaled_cnt", "inp_custom_down_cnt",
               "inp_custom_down_scaled_cnt", "gt_custom_cnt")


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("variant", ["defaults", "options", "inclusive", "frame_mode"])
def test_every_item_key_is_bitwise_the_reference(shared_corpus_dir, monkeypatch, route,
                                                 variant):
    """The default key set is the reference's ``ALL_KEYS``; with noise, the
    hot filter (stateful: the items are built in one order on both sides),
    a custom resolution, the activity tile, three time bins, the inclusive
    binning and the frame mode, every item (the five ``*_custom_*`` ones
    too) is bitwise the reference's for several seeds, on the native and
    on the numpy route."""
    from esr_tpu.data.dataset import EventWindowDataset as RefDataset
    from esr_tpu_torch.data.dataset import ALL_KEYS, EventWindowDataset

    monkeypatch.setenv("ESR_TPU_NATIVE", "1" if route == "native" else "0")
    cfg = {"defaults": {**LOADER_DATA, "need_gt_frame": True, "item_keys": None},
           "options": OPTIONS_DATA,
           "inclusive": {**OPTIONS_DATA, "stack_binning": "inclusive"},
           "frame_mode": {**OPTIONS_DATA, "mode": "frame", "window": 512,
                          "sliding_window": 0}}[variant]
    rec = str(shared_corpus_dir / "rec1.h5")
    ref, port = RefDataset(rec, cfg), EventWindowDataset(rec, cfg)
    assert port.item_keys == ALL_KEYS == RefDataset.ALL_KEYS
    assert len(port) == len(ref) > 1
    NE.ROUTES.reset()
    want_keys = sorted(ALL_KEYS + (CUSTOM_KEYS if variant != "defaults" else ()))
    for i in range(len(ref)):
        for seed in (0, 1, 6):
            a, b = port.get_item(i, seed=seed), ref.get_item(i, seed=seed)
            assert sorted(a) == sorted(b) == want_keys
            for k in a:
                assert a[k].dtype == b[k].dtype == np.float32, k
                assert a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), (i, k)
    routes = NE.ROUTES.snapshot()
    assert routes["native" if route == "native" else "numpy"] > 0
    if route == "numpy":
        assert routes["native"] == 0
    if variant != "defaults":
        assert a["inp_norm_events"].shape == (512 + 51, 4)


def test_hot_filter_over_a_sequence_of_items_is_the_references():
    """``tests/test_hot_filter.py``'s cases on both filters: the mask's
    ``min_obvs`` and threshold, the ``max_px`` cap, a persistent pixel
    dropped after enough windows, and the state over a sequence of random
    windows bitwise the reference's."""
    from esr_tpu.data.hot_filter import HotPixelFilter as RefFilter
    from esr_tpu.data.hot_filter import hot_mask_from_rate as ref_mask
    from esr_tpu_torch.data.hot_filter import HotPixelFilter, hot_mask_from_rate

    rate = np.zeros((4, 4))
    rate[1, 2] = 0.95
    assert hot_mask_from_rate(rate.copy(), idx=3, min_obvs=5).min() == 1.0
    m = hot_mask_from_rate(rate.copy(), idx=10, min_obvs=5, max_rate=0.8)
    assert m[1, 2] == 0.0 and m.sum() == 15
    full = np.full((3, 3), 0.9)
    assert (hot_mask_from_rate(full.copy(), idx=10, min_obvs=5, max_px=4) == 0).sum() == 4
    for args in ((rate, 10, 100, 5, 0.8), (full, 10, 4, 5, 0.8), (full, 3, 4, 5, 0.8)):
        np.testing.assert_array_equal(hot_mask_from_rate(args[0].copy(), *args[1:]),
                                      ref_mask(args[0].copy(), *args[1:]))
    cfg = {"max_px": 10, "min_obvs": 3, "max_rate": 0.8}
    port, ref = HotPixelFilter((8, 8), cfg), RefFilter((8, 8), cfg)
    for i in range(6):
        ev = np.array([[3.0, float(i % 8)], [2.0, float((i + 1) % 8)],
                       [0.1 * i, 0.1 * i + 0.05], [1.0, -1.0]])
        out = port.filter_events(ev)
        np.testing.assert_array_equal(out, ref.filter_events(ev))
    assert out.shape[1] == 1 and (out[0, 0], out[1, 0]) != (3.0, 2.0)
    rng = np.random.default_rng(0)
    cfg = {"max_px": 6, "min_obvs": 2, "max_rate": 0.4}
    port, ref = HotPixelFilter((12, 10), cfg), RefFilter((12, 10), cfg)
    for i in range(12):
        n = int(rng.integers(0, 40))
        ev = np.stack([rng.integers(-1, 11, n), rng.integers(-1, 13, n), np.sort(rng.random(n)),
                       rng.choice([-1.0, 1.0], n)]).astype(np.float64)
        ev[:, : n // 3] = [[4.0], [5.0], [0.0], [1.0]]  # a hot pixel
        np.testing.assert_array_equal(port.filter_events(ev), ref.filter_events(ev))
        np.testing.assert_array_equal(port.hot_events, ref.hot_events)
    assert port.hot_idx == ref.hot_idx == 12


@pytest.mark.parametrize("num_bins", [1, 3, 5])
def test_voxel_and_inclusive_stacks_are_the_references(num_bins):
    """``events_to_voxel_np`` and the inclusive binning (boundary events in
    both bins, the degenerate-window guard) bitwise the reference's; the
    half-open binning stays the default."""
    rng = np.random.default_rng(num_bins)
    for n in (0, 3, 4, 200):
        xs = rng.integers(-1, 18, n).astype(np.float32)
        ys = rng.integers(-1, 14, n).astype(np.float32)
        ts = np.sort(rng.random(n)).astype(np.float32)
        if n > 10:
            ts[n // 2: n // 2 + 5] = ts[n // 2]  # ties on a possible edge
        ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
        tnorm = (ts - ts[0]) / (ts[-1] - ts[0] + 1e-6) if n else ts
        np.testing.assert_array_equal(NE.events_to_voxel_np(xs, ys, tnorm, ps, num_bins, (13, 17)),
                                      ref_enc.events_to_voxel_np(xs, ys, tnorm, ps, num_bins,
                                                                 (13, 17)))
        for binning in ("inclusive", "half_open"):
            np.testing.assert_array_equal(
                NE.events_to_stack_np(xs, ys, ts, ps, num_bins, (13, 17), binning=binning),
                ref_enc.events_to_stack_np(xs, ys, ts, ps, num_bins, (13, 17), binning=binning))
        cnt, act = NE.events_to_channels_activity_np(xs, ys, ps, (13, 17), tile=4)
        want = ref_enc.events_to_channels_activity_np(xs, ys, ps, (13, 17), tile=4)
        np.testing.assert_array_equal(cnt, want[0])
        np.testing.assert_array_equal(act, want[1])
    with pytest.raises(ValueError, match="binning"):
        NE.events_to_stack_np(xs, ys, ts, ps, num_bins, (13, 17), binning="closed")


def test_noise_fills_device_rasterization_capacity(shared_corpus_dir):
    """With ``add_noise`` the raw input window holds the events plus the
    noise budget (the reference's capacity), and the device encoder gives
    the host's ``inp_scaled_cnt``, noise included, bitwise."""
    from esr_tpu.data.dataset import EventWindowDataset as RefDataset
    from esr_tpu_torch.data.dataset import EventWindowDataset

    cfg = {**LOADER_DATA, "add_noise": {"enabled": True, "noise_level": 0.25},
           "item_keys": ["inp_scaled_cnt", "gt_cnt", "inp_norm_events", "inp_events_valid",
                         "gt_raw_events", "gt_events_valid"]}
    rec = str(shared_corpus_dir / "rec1.h5")
    port, ref = EventWindowDataset(rec, cfg), RefDataset(rec, cfg)
    assert port.inp_event_capacity == ref.inp_event_capacity == 512 + 128
    encode = make_device_encoder(port.gt_resolution)
    for i in (0, len(port) - 1):
        item = port.get_item(i, seed=i)
        want = ref.get_item(i, seed=i)
        for k in item:
            np.testing.assert_array_equal(item[k], want[k], err_msg=k)
        assert item["inp_events_valid"].sum() > 128  # the window and its noise
        dense = encode({
            "inp_events": torch.from_numpy(item["inp_norm_events"])[None, None],
            "inp_valid": torch.from_numpy(item["inp_events_valid"])[None, None],
            "gt_events": torch.from_numpy(item["gt_raw_events"])[None, None],
            "gt_valid": torch.from_numpy(item["gt_events_valid"])[None, None]})
        np.testing.assert_array_equal(dense["inp"][0, 0].numpy(), item["inp_scaled_cnt"])
        np.testing.assert_array_equal(dense["gt"][0, 0].numpy(), item["gt_cnt"])


def test_device_encoder_is_bitwise_the_host_and_jax():
    rng = np.random.default_rng(8)
    b, length, n, ng, kh, kw = 2, 3, 300, 900, 16, 24
    inp = np.zeros((b, length, n, 4), np.float32)
    inp[..., 0], inp[..., 1] = rng.random((b, length, n)), rng.random((b, length, n))
    inp[..., 3] = rng.choice([-1, 1], (b, length, n))
    gt = np.zeros((b, length, ng, 4), np.float32)
    gt[..., 0] = np.floor(rng.random((b, length, ng)) * (kw + 2) - 1)
    gt[..., 1] = np.floor(rng.random((b, length, ng)) * (kh + 2) - 1)
    gt[..., 3] = rng.choice([-1, 1], (b, length, ng))
    batch = {"inp_events": inp, "inp_valid": (rng.random((b, length, n)) < 0.8).astype(np.float32),
             "gt_events": gt, "gt_valid": (rng.random((b, length, ng)) < 0.7).astype(np.float32)}
    got = make_device_encoder((kh, kw))({k: torch.from_numpy(v) for k, v in batch.items()})
    want = jax.jit(j_make_device_encoder((kh, kw)))(batch)
    for key, ev_key, valid_key, scaled in (("inp", "inp_events", "inp_valid", True),
                                           ("gt", "gt_events", "gt_valid", False)):
        assert got[key].shape == (b, length, kh, kw, 2)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        for i in range(b):
            for j in range(length):
                e = batch[ev_key][i, j][batch[valid_key][i, j] > 0]
                xs, ys = (np.floor(e[:, 0] * kw), np.floor(e[:, 1] * kh)) if scaled else \
                    (e[:, 0], e[:, 1])
                np.testing.assert_array_equal(got[key][i, j].numpy(),
                                              NE.channels_numpy(xs, ys, e[:, 3], (kh, kw)))
    np.testing.assert_array_equal(tile_activity(got["inp"][0, 0], 8).numpy(),
                                  NE.tile_activity_np(got["inp"][0, 0].numpy(), 8))


TINY = [
    "model;args;basech=4", "train_dataloader;batch_size=2", "valid_dataloader;batch_size=2",
    "trainer;iteration_based_train;iterations=1",
] + [f"{block};dataset;{k}={v}" for block in ("train_dataloader", "valid_dataloader")
     for k, v in (("ori_scale", "down8"), ("window", 512), ("sliding_window", 256),
                  ("sequence;sequence_length", 5))]


@pytest.fixture(scope="module")
def rasterized_steps(shared_corpus_dir, tmp_path_factory):
    """The flagship config, tiny, host-rasterized and device-rasterized from
    the same seed: the first batch's dense streams and one train step each."""
    out = tmp_path_factory.mktemp("device_rasterize")
    datalist = shared_corpus_dir / "datalist2.txt"
    result = {}
    for route, extra in (("host", []), ("device", ["trainer;device_rasterize=true"])):
        run = T_parser.RunConfig.from_args(
            str(FLAGSHIP), TINY + extra + [
                f"trainer;output_path={out / route}",
                f"train_dataloader;path_to_datalist_txt={datalist}",
                f"valid_dataloader;path_to_datalist_txt={datalist}"],
            runid="run0", seed=5)
        trainer = Trainer(run, device="cpu")
        batch = next(iter(trainer.train_loader))
        sel = trainer._select(batch)
        metrics = trainer.train_step(sel)
        result[route] = {"trainer": trainer, "batch": batch, "sel": sel, "metrics": metrics}
    return result


def test_device_rasterized_step_equals_the_host_step(rasterized_steps):
    host, dev = rasterized_steps["host"], rasterized_steps["device"]
    assert dev["trainer"].device_rasterize and not host["trainer"].device_rasterize
    assert "inp_norm_events" in dev["batch"] and "inp_norm_events" not in host["batch"]
    for k in ("inp", "gt"):
        np.testing.assert_array_equal(dev["sel"][k].numpy(), host["sel"][k].numpy())
    for k in ("loss", "loss_per_window", "grad_norm", "last_pred"):
        np.testing.assert_array_equal(dev["metrics"][k].numpy(), host["metrics"][k].numpy())


@pytest.mark.parametrize("encode", [None, "host", "device"])
@pytest.mark.parametrize("explicit", [None, False, True])
def test_device_rasterize_contradiction_rule(encode, explicit):
    config = {"trainer": {} if explicit is None else {"device_rasterize": explicit},
              "train_dataloader": {"dataset": {} if encode is None else {"encode": encode}}}
    if encode is not None and explicit is not None and explicit != (encode == "device"):
        with pytest.raises(ValueError, match="contradicts"):
            resolve_device_rasterize(config)
    else:
        want = (encode == "device") if encode is not None else bool(explicit)
        assert resolve_device_rasterize(config) is want
    config["train_dataloader"]["dataset"]["encode"] = "gpu"
    with pytest.raises(ValueError, match="unknown dataset encode"):
        resolve_device_rasterize(config)


def test_export_cli_runs_as_a_script(exported):
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "export_torch_checkpoint.py"),
                           exported["src"], str(exported["root"] / "cli")],
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    assert sorted(os.listdir(exported["root"] / "cli")) == ["config.json", "params.npz"]
