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


@pytest.mark.parametrize("norm", ["BN", "IN"])
def test_exported_norm_checkpoint_carries_the_running_stats(tmp_path, norm):
    """``configs/train_srunet_2x.yml``'s model with ``norm``, saved by
    ``esr_tpu`` with its running statistics drawn away from their defaults,
    exported: ``params.npz`` holds the ``batch_stats`` collection under the
    flax names, and the port evaluates with them as the reference does."""
    from esr_tpu.models.registry import get_model as j_get_model

    with open(REPO / "configs" / "train_srunet_2x.yml") as f:
        config = yaml.safe_load(f)
    config["model"]["args"].update(base_num_channels=2, num_encoders=2, norm=norm)
    model = j_get_model(config["model"]["name"], **config["model"]["args"])
    x = np.zeros((1, 3, 16, 16, 2), np.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x, model.init_states(1, 16, 16))
    rng = np.random.default_rng(6)

    def draw(path, s):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return jnp.asarray(rng.uniform(0.5, 1.5, s.shape).astype(np.float32))
        return jnp.asarray(rng.uniform(-0.3, 0.3, s.shape).astype(np.float32)
                           / np.sqrt(max(np.prod(s.shape[:-1]), 1)))

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    optimizer, _ = j_build_optimizer(config["optimizer"], config.get("lr_scheduler"),
                                     config["trainer"]["iteration_based_train"]["lr_change_rate"])
    src = j_save_checkpoint(str(tmp_path / "ckpt"), TrainState.create(variables, optimizer),
                            config, iteration=3, monitor_best=0.5)
    dst = export_torch_checkpoint.main([src, str(tmp_path / "torch")])
    with np.load(os.path.join(dst, "params.npz")) as npz:
        stats = [k for k in npz.files if k.startswith("batch_stats/")]
    assert stats and all(f"/TorchBatchNorm_0/" in k or "/TorchInstanceNorm_0/" in k
                         for k in stats)
    port, _ = load_checkpoint(dst)
    inp = rng.poisson(0.5, (2, 3, 16, 16, 2)).astype(np.float32)
    want, _ = model.apply(variables, jnp.asarray(inp), model.init_states(2, 16, 16))
    with torch.no_grad():
        got, _ = port.eval()(torch.from_numpy(inp), port.init_states(2, 16, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


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


# -- the offline tools: the simulator and its cv2-free resize, the
# packagers, the datalists, the HDF5 tools, the timers, Super-SloMo ------
#
# Everything here is numpy and must be bitwise the reference's (frames,
# event lists, files, splits); Super-SloMo is float: atol 1e-4 + rtol 1e-4
# on outputs and input gradients (measured <= 2e-6 on values of order 1:
# the same f32 convolutions summed in another order, 26 of them deep).

import h5py  # noqa: E402

from esr_tpu import tools as ref_tools  # noqa: E402
from esr_tpu.tools import datalist as ref_datalist  # noqa: E402
from esr_tpu.tools import h5_tools as ref_h5  # noqa: E402
from esr_tpu.tools import simulate as ref_sim  # noqa: E402
from esr_tpu.tools import upsampling as ref_up  # noqa: E402
from esr_tpu.utils import timers as ref_timers  # noqa: E402
from esr_tpu_torch import tools as T_tools  # noqa: E402
from esr_tpu_torch import utils as T_utils  # noqa: E402
from esr_tpu_torch.data.records import H5Recording  # noqa: E402
from esr_tpu_torch.tools import datalist as T_datalist  # noqa: E402
from esr_tpu_torch.tools import h5_tools as T_h5  # noqa: E402
from esr_tpu_torch.tools import simulate as T_sim  # noqa: E402
from esr_tpu_torch.tools import upsampling as T_up  # noqa: E402
from esr_tpu_torch.utils import timers as T_timers  # noqa: E402

RUNG_FACTORS = (1, 2, 4, 8, 16)


@pytest.mark.parametrize("size", [(512, 512), (720, 1280)])
def test_resize_cubic_is_cv2_at_every_rung(size):
    """The simulator's per-rung downscale, bitwise ``cv2.resize(INTER_CUBIC)``
    on uint8 frames: a rendered scene frame, noise, and a colour frame."""
    h, w = size
    rng = np.random.default_rng(0)
    frames, _ = T_sim.render_scene_frames(1, 2, h, w)
    for img in (frames[1], rng.integers(0, 256, (h, w), dtype=np.uint8),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8)):
        for f in RUNG_FACTORS:
            dsize = (round(w / f), round(h / f))
            np.testing.assert_array_equal(
                T_sim.resize_cubic(img, dsize),
                cv2.resize(img, dsize, interpolation=cv2.INTER_CUBIC), err_msg=str((size, f)))


def test_resize_cubic_at_odd_sizes_is_opencvs_own_arithmetic():
    """Odd sizes, non-integer ratios and upscales, against OpenCV's own
    resize. A build with IPP (this wheel) hands non-integer ratios to IPP's
    float resize instead, which is CPU-dispatched: the comparison turns IPP
    off. IPP's own result differs from OpenCV's by at most one grey level
    (on ~4% of these pixels on an x86-64 build; the share depends on the
    CPU IPP dispatches to, so only the one level is held)."""
    rng = np.random.default_rng(1)
    cases = []
    for (h, w) in [(37, 53), (101, 77), (513, 517), (45, 80), (7, 5)]:
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        smooth = cv2.GaussianBlur(img, (7, 7), 2)
        for x in (img, smooth):
            for f in (2, 3, 4, 8, 16):
                cases.append((x, (max(1, round(w / f)), max(1, round(h / f)))))
            cases += [(x, (2 * w + 1, 2 * h - 1)), (x, (w + 3, h + 5))]
    assert cv2.ipp.useIPP()
    with_ipp = [cv2.resize(x, d, interpolation=cv2.INTER_CUBIC) for x, d in cases]
    cv2.ipp.setUseIPP(False)
    try:
        for x, d in cases:
            np.testing.assert_array_equal(T_sim.resize_cubic(x, d),
                                          cv2.resize(x, d, interpolation=cv2.INTER_CUBIC))
    finally:
        cv2.ipp.setUseIPP(True)
    diff = [np.abs(T_sim.resize_cubic(x, d).astype(int) - y.astype(int))
            for (x, d), y in zip(cases, with_ipp)]
    assert max(int(d.max()) for d in diff) <= 1
    with pytest.raises(TypeError, match="uint8"):
        T_sim.resize_cubic(np.zeros((4, 4), np.float32), (2, 2))


def test_png_reader_and_generate_from_folder_without_cv2(tmp_path):
    rng = np.random.default_rng(2)
    frames = [cv2.GaussianBlur(rng.integers(0, 256, (33, 47), dtype=np.uint8), (5, 5), 1.5)
              for _ in range(4)]
    for i, img in enumerate(frames):
        cv2.imwrite(str(tmp_path / f"f{i:03d}.png"), img, [cv2.IMWRITE_PNG_COMPRESSION, 3 * i])
        np.testing.assert_array_equal(T_sim.read_png_gray8(str(tmp_path / f"f{i:03d}.png")),
                                      cv2.imread(str(tmp_path / f"f{i:03d}.png"),
                                                 cv2.IMREAD_GRAYSCALE))
    stamps = tmp_path / "ts.txt"
    stamps.write_text("\n".join(str(0.05 * i) for i in range(4)))
    want = ref_sim.EventSimulator(0.2, 0.25).generate_from_folder(str(tmp_path), str(stamps))
    got = T_sim.EventSimulator(0.2, 0.25).generate_from_folder(str(tmp_path), str(stamps))
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    cv2.imwrite(str(tmp_path / "g.jpg"), frames[0])
    with pytest.raises(ValueError, match="cv2"):
        T_sim.read_png_gray8(str(tmp_path / "g.jpg"))
    cv2.imwrite(str(tmp_path / "c.png"), np.stack([frames[0]] * 3, -1))
    with pytest.raises(ValueError, match="cv2"):
        T_sim.read_png_gray8(str(tmp_path / "c.png"))


def test_scene_renderers_and_simulator_are_the_references_bitwise():
    for got, want in ((T_sim.render_scene_frames(3, 4, 48, 80, disc_radius_scale=0.3),
                       ref_sim.render_scene_frames(3, 4, 48, 80, disc_radius_scale=0.3)),
                      (T_sim.render_natural_frames(4, 3, 40, 64, n_leaves=300),
                       ref_sim.render_natural_frames(4, 3, 40, 64, n_leaves=300))):
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[1], want[1])
    frames, ts = ref_sim.render_scene_frames(5, 5, 40, 56, disc_radius_scale=0.3)
    for cfg in ({}, {"use_log": False, "log_eps": 1e-2}):
        args = dict(cp=0.15, cn=0.2, refractory_period=0.01, **cfg)
        ev = T_sim.EventSimulator(**args).generate_from_frames(frames, ts)
        assert len(ev) > 100
        np.testing.assert_array_equal(ev, ref_sim.EventSimulator(**args).generate_from_frames(
            frames, ts))
    for seed in range(3):
        assert T_sim.sample_contrast_thresholds(rng=np.random.default_rng(seed)) == \
            ref_sim.sample_contrast_thresholds(rng=np.random.default_rng(seed))
    assert T_sim.DEFAULT_SIM_CONFIG == ref_sim.DEFAULT_SIM_CONFIG


def _read_h5_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        out["/attrs"] = {k: np.asarray(v).tolist() for k, v in f.attrs.items()}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()], {k: np.asarray(v).tolist() for k, v in obj.attrs.items()})

        f.visititems(visit)
    return out


def _assert_same_h5(a, b):
    ta, tb = _read_h5_tree(a), _read_h5_tree(b)
    assert sorted(ta) == sorted(tb)
    assert ta["/attrs"] == tb["/attrs"]
    for k in ta:
        if k != "/attrs":
            np.testing.assert_array_equal(ta[k][0], tb[k][0], err_msg=k)
            assert ta[k][1] == tb[k][1], k


def test_simulate_ladder_recording_is_the_references_h5(tmp_path):
    """The port's ladder HDF5 is the reference's file, and its in-memory
    recording reads back the same windows, frames and sensor size."""
    frames, ts = ref_sim.render_scene_frames(7, 4, 128, 96, disc_radius_scale=0.4)
    # the two packages' writers on the same frames: the comparison is on them
    want = ref_sim.simulate_ladder_recording(frames, ts, str(tmp_path / "ref.h5"),  # esr: noqa(TX006)
                                             seed=3)
    got = T_sim.simulate_ladder_recording(frames, ts, str(tmp_path / "port.h5"),  # esr: noqa(TX006)
                                          seed=3)
    assert got == want
    _assert_same_h5(tmp_path / "port.h5", tmp_path / "ref.h5")
    memory, cpcn = T_sim.simulate_memory_recording(frames, ts, seed=3, name="m")
    assert cpcn == want
    ref = H5Recording(str(tmp_path / "ref.h5"))
    assert memory.sensor_resolution == ref.sensor_resolution == (128, 96)
    for rung in T_sim.DEFAULT_RUNGS:
        a, b = memory.stream(rung), ref.stream(rung)
        assert a.num_events > 0
        np.testing.assert_array_equal(a.window(0, a.num_events), b.window(0, b.num_events))
    np.testing.assert_array_equal(memory.frame_ts, ref.frame_ts)
    for k in range(memory.num_frames):
        np.testing.assert_array_equal(memory.frame(k), ref.frame(k))


def test_packagers_and_eventzoom_write_the_references_files(tmp_path):
    rng = np.random.default_rng(8)
    for root, mod in (("ref", ref_tools.packagers), ("port", T_tools.packagers)):
        d = tmp_path / root
        d.mkdir()
        with mod.H5Packager(str(d / "single.h5")) as pk:
            ev = np.random.default_rng(9).random((50, 4))
            pk.package_events(ev[:, 0] * 10, ev[:, 1] * 8, np.sort(ev[:, 2]), ev[:, 3] > 0.5)
            pk.package_image(np.full((8, 10), 7, np.uint8), 0.3)
            pk.package_image(np.zeros((8, 10, 3), np.uint8), 0.6)
            pk.package_flow(np.ones((2, 8, 10)), 0.5)
            pk.add_metadata(20, 30, 0.0, 1.0, (8, 10))
        with mod.H5LadderPackager(str(d / "ladder.h5"), rungs=("ori", "down2")) as pk:
            pk.package_events("ori", [1, 2], [3, 4], [0.1, 0.2], [1.0, -1.0])
            pk.package_events("down2", [], [], [], [])
            pk.package_image("ori", np.eye(4, dtype=np.uint8), 0.15)
            pk.add_metadata((4, 4))
            with pytest.raises(KeyError):
                pk.package_events("down4", [1], [1], [0.1], [1.0])
        txt = tmp_path / "zoom" / "data"
        for sub, n in (("ev_hr", 40), ("ev_lr_1", 20), ("ev_llr_1", 10)):
            (txt / sub).mkdir(parents=True, exist_ok=True)
            rows = np.stack([np.sort(rng.random(n)), rng.integers(0, 9, n), rng.integers(0, 7, n),
                             rng.integers(0, 2, n)], 1) if root == "ref" else None
            if rows is not None:
                np.savetxt(txt / sub / "seq.txt", rows, header="t x y p", comments="")
        assert getattr(T_sim if root == "port" else ref_sim, "convert_eventzoom")(
            str(tmp_path / "zoom"), str(d / "zoom")) == 1
    for name in ("single.h5", "ladder.h5", "zoom/seq.h5"):
        _assert_same_h5(tmp_path / "port" / name, tmp_path / "ref" / name)
    np.testing.assert_array_equal(
        T_sim.read_txt_events(str(tmp_path / "zoom/data/ev_hr/seq.txt")),
        ref_sim.read_txt_events(str(tmp_path / "zoom/data/ev_hr/seq.txt")))


def test_datalist_modes_and_cli_are_the_references(tmp_path, monkeypatch):
    data, valid = tmp_path / "data", tmp_path / "valid"
    for d, n in ((data, 9), (valid, 5)):
        d.mkdir()
        for i in range(n):
            (d / f"r{i:02d}.h5").write_bytes(b"")
    cases = [dict(mode=0), dict(mode=0, num=4), dict(mode=1, num=4, valid_num=3),
             dict(mode=2, portion=0.7), dict(mode=3, num=5, valid_num=2,
                                             valid_data_path=str(valid))]
    for kw in cases:
        for seed in (123, 7):
            assert T_datalist.generate_datalist(str(data), seed=seed, **kw) == \
                ref_datalist.generate_datalist(str(data), seed=seed, **kw)
    with pytest.raises(ValueError):
        T_datalist.generate_datalist(str(data), 4)
    for root, main in (("ref", ref_datalist.main), ("port", T_datalist.main)):
        monkeypatch.setattr(sys, "argv", ["datalist", "--data_path", str(data), "--mode", "1",
                                          "--num", "5", "--valid_num", "2", "--out_dir",
                                          str(tmp_path / root)])
        main()
    for name in ("train.txt", "valid.txt"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "ref" / name).read_text()
    assert T_tools.generate_datalist is T_datalist.generate_datalist


class _Stamp:
    def __init__(self, t):
        self.secs = int(t)
        self.nsecs = int(round((t - int(t)) * 1e9))


class _Msg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _fake_rosbag(messages):
    """A ``rosbag`` module whose ``Bag(path, "r")`` yields ``messages``."""
    import types

    class Bag:
        def __init__(self, path, mode="r"):
            assert os.path.exists(path)

        def read_messages(self):
            yield from messages

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    mod = types.ModuleType("rosbag")
    mod.Bag = Bag
    return mod


def _bag_messages():
    rng = np.random.default_rng(7)
    msgs = []
    for dt, enc in ((0.05, "mono8"), (0.25, "rgb8")):
        ch = 1 if enc == "mono8" else 3
        img = rng.integers(0, 255, size=(8, 12 * ch), dtype=np.uint8)
        msgs.append(("/cam/image", _Msg(header=_Msg(stamp=_Stamp(100 + dt)), height=8,
                                        width=12, step=12 * ch, encoding=enc,
                                        data=img.tobytes()), 100 + dt))
    for k in range(3):
        evs = [_Msg(x=int(rng.integers(0, 12)), y=int(rng.integers(0, 8)),
                    ts=_Stamp(100 + 0.1 * k + 0.1 * j / 40), polarity=bool(j % 2))
               for j in range(40)]
        msgs.append(("/dvs/events", _Msg(events=evs), 100 + 0.1 * k))
    msgs.append(("/flow", _Msg(header=_Msg(stamp=_Stamp(100.15)),
                               flow_x=rng.standard_normal(96).astype(np.float32),
                               flow_y=rng.standard_normal(96).astype(np.float32),
                               height=8, width=12), 100.15))
    return sorted(msgs, key=lambda m: m[2])


def test_h5_tools_round_trips_are_the_references(tmp_path, monkeypatch):
    rng = np.random.default_rng(10)
    txt = tmp_path / "ev.txt"
    rows = np.stack([np.sort(rng.random(250)) + 5, rng.integers(0, 30, 250),
                     rng.integers(0, 20, 250), rng.integers(0, 2, 250)], 1)
    np.savetxt(txt, rows, header="30 20", comments="")
    monkeypatch.setitem(sys.modules, "rosbag", _fake_rosbag(_bag_messages()))
    (tmp_path / "rec.bag").write_bytes(b"fake")
    frames_dir = tmp_path / "frames" / "seq"
    frames_dir.mkdir(parents=True)
    for i, shape in enumerate([(6, 9), (6, 9), (9, 6)]):
        cv2.imwrite(str(frames_dir / f"{i}.png"), np.full(shape, 40 * i, np.uint8))
    for root, mod in (("ref", ref_h5), ("port", T_h5)):
        d = tmp_path / root
        d.mkdir()
        assert mod.extract_txt_to_h5(str(txt), str(d / "txt.h5"), zero_timestamps=True,
                                     chunksize=64) == (int(rows[:, 3].sum()),
                                                       int(250 - rows[:, 3].sum()))
        mod.add_hdf5_attribute(mod.get_filepaths(str(d)), "events", "note", 3)
        mod.h5_to_memmap(str(d / "txt.h5"), str(d / "mm"))
        stats = mod.extract_rosbag_to_h5(str(tmp_path / "rec.bag"), str(d / "bag.h5"),
                                         image_topic="/cam/image", flow_topic="/flow",
                                         zero_timestamps=True)
        assert stats["num_pos"] == stats["num_neg"] == 60
        mod.extract_rosbags_to_h5([str(tmp_path / "rec.bag")], str(d / "bags"),
                                  start_time=100.1, end_time=100.2)
        assert mod.events_to_ply(rows[:, [1, 2, 0, 3]] * [1, 1, 1, 2] - [0, 0, 0, 1], (20, 30),
                                 str(d / "ev.ply")) == 250
        mod.events_to_ply(rows[:5, [1, 2, 0, 3]], (20, 30), str(d / "ev_text.ply"), text=True)
    for name in ("txt.h5", "bag.h5", "bags/rec.h5"):
        _assert_same_h5(tmp_path / "port" / name, tmp_path / "ref" / name)
    for name in ("ev.ply", "ev_text.ply", "mm/memmap/t.npy", "mm/memmap/xy.npy",
                 "mm/memmap/p.npy", "mm/memmap/metadata.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    got = T_h5.read_memmap(str(tmp_path / "port" / "mm" / "memmap"), return_events=True)
    want = ref_h5.read_memmap(str(tmp_path / "ref" / "mm" / "memmap"), return_events=True)
    for k in ("t", "xy", "p", "num_events", "t0", "metadata"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    bag = str(tmp_path / "port" / "bag.h5")
    assert T_h5.read_h5_summary(bag) == ref_h5.read_h5_summary(bag)
    np.testing.assert_array_equal(T_h5.read_h5_events(bag), ref_h5.read_h5_events(bag))
    assert T_h5.validate_frame_sizes(str(tmp_path / "frames"), (6, 9), "*.png") == \
        ref_h5.validate_frame_sizes(str(tmp_path / "frames"), (6, 9), "*.png") == \
        {"portrait": [str(frames_dir)], "mismatched": [str(frames_dir)], "unreadable": []}
    monkeypatch.delitem(sys.modules, "rosbag")
    monkeypatch.setattr(sys, "path", [p for p in sys.path if "ros" not in p])
    with pytest.raises(ImportError, match="rosbag"):
        T_h5.extract_rosbag_to_h5("in.bag", "out.h5")


def test_timers_record_and_report_as_the_reference(monkeypatch, capsys):
    for mod in (ref_timers, T_timers):
        monkeypatch.setattr(mod, "timing_stats", type(mod.timing_stats)(list))
        for _ in range(3):
            with mod.Timer("step") as t:
                pass
        assert t.interval >= 0 and len(mod.timing_stats["step"]) == 3
        mod.timing_stats["step"][:] = [0.5, 0.25, 0.75]
        mod.print_timing_info()
    ref_out, port_out = capsys.readouterr().out.split("== Timing statistics ==")[1:]
    assert ref_out == port_out and "step: 0.5000 s (3 samples)" in port_out
    assert T_utils.Timer is T_timers.Timer


@pytest.fixture(scope="module")
def slomo(tmp_path_factory):
    """The port's two Super-SloMo nets at seeded weights, saved as the
    converter's npz and loaded back by both packages."""
    torch.manual_seed(0)
    fc, at = T_up.flow_nets(3)
    path = str(tmp_path_factory.mktemp("slomo") / "slomo.npz")
    ckpt = path.replace(".npz", ".ckpt")
    torch.save({"state_dictFC": fc.state_dict(), "state_dictAT": at.state_dict()}, ckpt)
    T_up.convert_superslomo_checkpoint(ckpt, path)
    fc_state, at_state = T_up.load_superslomo_npz(path)
    fc.load_state_dict(fc_state)
    at.load_state_dict(at_state)
    return fc.eval(), at.eval(), ref_up.load_superslomo_npz(path), path


def test_superslomo_interpolation_matches_reference(slomo):
    fc, at, (jfc, jat), path = slomo
    rng = np.random.default_rng(11)
    i0, i1 = (rng.random((1, 32, 64, 3)).astype(np.float32) for _ in range(2))
    t = 0.3
    want = ref_up.interpolate_frame(jfc, jat, jnp.asarray(i0), jnp.asarray(i1), t)
    x0 = torch.from_numpy(np.moveaxis(i0, -1, 1).copy()).requires_grad_(True)
    x1 = torch.from_numpy(np.moveaxis(i1, -1, 1).copy()).requires_grad_(True)
    got = T_up.interpolate_frame(fc, at, x0, x1, t)
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    w = rng.standard_normal(np.asarray(want).shape).astype(np.float32)
    (got * torch.from_numpy(np.moveaxis(w, -1, 1).copy())).sum().backward()
    g0, g1 = jax.grad(lambda a, b: jnp.sum(ref_up.interpolate_frame(jfc, jat, a, b, t) * w),
                      argnums=(0, 1))(jnp.asarray(i0), jnp.asarray(i1))
    for tg, jg in ((x0.grad, g0), (x1.grad, g1)):
        np.testing.assert_allclose(np.moveaxis(tg.numpy(), 1, -1), np.asarray(jg),
                                   atol=1e-4, rtol=1e-4)
    flow = rng.standard_normal((2, 9, 11, 2)).astype(np.float32)
    img = rng.random((2, 9, 11, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.moveaxis(T_up.backwarp(_nchw(img), _nchw(flow)).numpy(), 1, -1),
        np.asarray(ref_up.backwarp(jnp.asarray(img), jnp.asarray(flow))), atol=1e-5, rtol=1e-5)
    frames, stamps = T_up.upsample_adaptive(fc, at, x0.detach(), x1.detach(), 1.0, 2.0)
    ref_frames, ref_stamps = ref_up.upsample_adaptive(jfc, jat, jnp.asarray(i0),
                                                      jnp.asarray(i1), 1.0, 2.0)
    assert stamps == ref_stamps and len(frames) == len(ref_frames)
    for a, b in zip(frames, ref_frames):
        np.testing.assert_allclose(np.moveaxis(a, 0, -1), b, atol=1e-4, rtol=1e-4)
    data = dict(np.load(path))
    del data["at.up3.conv2.bias"]
    np.savez(path.replace(".npz", "_cut.npz"), **data)
    with pytest.raises(KeyError, match="at.up3.conv2.bias"):
        T_up.load_superslomo_npz(path.replace(".npz", "_cut.npz"))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


# -- the last views (pipeline_vis, the 3D renderers) and the run log --------


def _flows():
    """Seeded flows, a flow of one magnitude, zeros, and flows on the hue
    wheel's seams (atan2 at +-pi: hue exactly 0 and 1)."""
    rng = np.random.default_rng(4)
    fx, fy = rng.normal(size=(2, 13, 17))
    seams = np.array([[-1.0, -2.0, 3.0], [0.5, -0.0, 0.0]])
    return [(fx, fy), (np.ones((4, 4)), np.zeros((4, 4))), (np.zeros((3, 5)),) * 2,
            (seams, np.array([[0.0, 0.0, 0.0], [1.0, 0.0, -0.0]])),
            (fx.astype(np.float32), fy.astype(np.float32))]


def test_flow_to_image_and_hsv_are_the_references_bitwise():
    import matplotlib.colors

    from esr_tpu.utils import pipeline_vis as ref_pv
    from esr_tpu_torch.utils import pipeline_vis as pv

    for fx, fy in _flows():
        np.testing.assert_array_equal(pv.flow_to_image(fx, fy), ref_pv.flow_to_image(fx, fy))
    rng = np.random.default_rng(5)
    hsv = rng.random((7, 9, 3))
    hsv[0, :, 0] = np.linspace(0, 1, 9)  # every sextant and hue 1.0
    hsv[1, :, 1] = 0.0
    # f64 of 2 dims or more: what matplotlib takes under numpy 2 (its
    # np.array(copy=False) refuses an input it would have to copy)
    for arr in (hsv, hsv[0]):
        want = matplotlib.colors.hsv_to_rgb(arr)
        got = pv.hsv_to_rgb(arr)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    x = rng.normal(size=(10, 100))
    np.testing.assert_array_equal(pv.minmax_norm(x), ref_pv.minmax_norm(x))
    np.testing.assert_array_equal(pv.minmax_norm(np.ones((3, 3))),
                                  ref_pv.minmax_norm(np.ones((3, 3))))


def _pipeline_frames(rng):
    return [dict(inputs={"inp_cnt": rng.poisson(1.0, (1, 8, 9, 2)).astype(np.float32),
                         "inp_frames": rng.uniform(0, 255, (1, 2, 8, 9))},
                 flow=rng.normal(size=(1, 2, 8, 9)),
                 iwe=rng.poisson(1.0, (8, 9, 2)).astype(np.float32),
                 brightness=rng.normal(size=(1, 8, 9)))
            for _ in range(3)]


def test_pipeline_visualizer_renders_and_stores_as_the_reference(tmp_path):
    from esr_tpu.utils import pipeline_vis as ref_pv
    from esr_tpu_torch.utils import pipeline_vis as pv

    frames = _pipeline_frames(np.random.default_rng(6))
    for pair in (True, False):
        for f in frames:
            got = pv.PipelineVisualizer().render(**f, frames_pair=pair)
            want = ref_pv.PipelineVisualizer().render(**f, frames_pair=pair)
            assert list(got) == list(want) == ["events", "frames", "flow", "iwe",
                                               "brightness"]
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    trees = {}
    for name, mod in (("port", pv), ("ref", ref_pv)):
        root = tmp_path / name
        viz = mod.PipelineVisualizer(store_dir=str(root), color_scheme="blue_red")
        written = []
        for i, (seq, f) in enumerate(zip(("recA", "recB", "recA"), frames)):
            paths = viz.store(f["inputs"], f["flow"], f["iwe"] if i else None,
                              f["brightness"], seq, ts=0.25 * i)
            written.append({k: os.path.relpath(p, root) for k, p in paths.items()})
        viz.close()
        files = sorted(str(p.relative_to(root)) for p in root.rglob("*"))
        trees[name] = (written, files, {
            f: (p.read_text() if f.endswith(".txt") else
                cv2.imread(str(p), cv2.IMREAD_UNCHANGED))
            for f in files if (p := root / f).is_file()})
    (w_port, f_port, c_port), (w_ref, f_ref, c_ref) = trees["port"], trees["ref"]
    assert w_port == w_ref and f_port == f_ref
    assert "recA/flow/000000001.png" in f_port and "recB/iwe" in f_port
    for f in c_ref:
        if f.endswith(".txt"):
            assert c_port[f] == c_ref[f], f
        else:
            np.testing.assert_array_equal(c_port[f], c_ref[f], err_msg=f)


def _clouds():
    rng = np.random.default_rng(7)

    def cloud(n, res, t0):
        return np.stack([rng.integers(0, res[1], n).astype(np.float32),
                         rng.integers(0, res[0], n).astype(np.float32),
                         np.sort(rng.uniform(t0, t0 + 0.1, n)).astype(np.float32),
                         rng.choice([-1.0, 1.0], n).astype(np.float32)], axis=1)

    frame = (rng.random((16, 16)) * 255).astype(np.uint8)
    return cloud, frame


def test_event_3d_views_are_the_references_pixels(tmp_path):
    from PIL import Image, ImageSequence

    cloud, frame = _clouds()
    ev, gt = cloud(60, (8, 8), 0.0), cloud(150, (16, 16), 0.0)
    for args in ((ev, (8, 8)), (ev, (8, 8), gt, (16, 16)), (ev[:0], (8, 8))):
        got = vis.render_event_3d(*args, dpi=40)
        want = ref_vis.render_event_3d(*args, dpi=40)
        assert got.dtype == np.uint8 and got.ndim == 3
        np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "view.png")
    img = vis.EventVisualizer().plot_event_3d(ev, (8, 8), gt, (16, 16), is_save=True,
                                              path=path)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)
    windows = [(ev, gt, frame), (cloud(60, (8, 8), 0.1), None, None),
               (cloud(60, (8, 8), 0.2), cloud(150, (16, 16), 0.2))]
    movies = []
    for name, fn in (("port", vis.EventVisualizer().plot_event_3d_animation),
                     ("ref", ref_vis.EventVisualizer().plot_event_3d_animation)):
        out = fn(windows, (8, 8), str(tmp_path / f"{name}.mp4"), gt_resolution=(16, 16),
                 fps=5, view=3)
        with Image.open(out) as im:
            movies.append((os.path.basename(out)[len(name):],
                           [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]))
    (ext_p, port), (ext_r, ref) = movies
    assert ext_p == ext_r and len(port) == len(ref) == 3
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="no windows"):
        vis.animate_event_3d([], (8, 8), str(tmp_path / "empty.gif"))
    assert vis.VIEW_PRESETS == ref_vis.VIEW_PRESETS


def test_export_event_cloud_writes_the_references_ply(tmp_path):
    cloud, _ = _clouds()
    ev = cloud(500, (20, 30), 0.3)
    n = vis.export_event_cloud(ev, (20, 30), str(tmp_path / "port.ply"))
    assert n == ref_vis.export_event_cloud(ev, (20, 30), str(tmp_path / "ref.ply")) == 500
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()


def test_run_config_writes_the_references_run_log(tmp_path):
    """C11: a RunConfig sets up the logging as the reference's does: a
    message-only console, ``<log_dir>/info.txt`` in the reference's format,
    a non-main rank at WARNING on both, and a second call replaces the
    handlers rather than adding to them."""
    import logging
    import re

    from esr_tpu.config import parser as J_parser

    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    lines = {}
    try:
        for name, mod in (("port", T_parser), ("ref", J_parser)):
            cfg = {"experiment": "exp", "trainer": {"output_path": str(tmp_path / name)}}
            run = mod.RunConfig(cfg, runid="r0")
            logging.getLogger("esr_tpu_torch.runlog").info("an info line %d", 7)
            logging.getLogger("esr_tpu_torch.runlog").debug("a debug line")
            levels = [(type(h).__name__, h.level, getattr(h.formatter, "_fmt", None))
                      for h in root.handlers]
            mod.RunConfig(cfg, runid="r0", is_main=False)
            logging.getLogger("esr_tpu_torch.runlog").info("an info line a rank drops")
            logging.getLogger("esr_tpu_torch.runlog").warning("a warning line")
            others = [(type(h).__name__, h.level) for h in root.handlers]
            for h in root.handlers:
                h.flush()
            text = (Path(run.log_dir) / "info.txt").read_text()
            lines[name] = (levels, others, root.level,
                           [re.sub(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} - ", "", line)
                            for line in text.splitlines()])
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])
    assert lines["port"] == lines["ref"]
    levels, others, root_level, text = lines["port"]
    assert levels == [("StreamHandler", logging.INFO, "%(message)s"),
                      ("RotatingFileHandler", logging.DEBUG,
                       "%(asctime)s - %(name)s - %(levelname)s - %(message)s")]
    assert others == [("StreamHandler", logging.WARNING),
                      ("RotatingFileHandler", logging.WARNING)]
    assert root_level == logging.INFO
    assert text == ["esr_tpu_torch.runlog - INFO - an info line 7",
                    "esr_tpu_torch.runlog - WARNING - a warning line"]
