"""The port's sequential evaluation against the reference's, end to end on
the CPU: one recording of the shared corpus through both
``InferenceRunner.run_recording``s with the same weights, the data path's
items bit for bit, the YAML reports, the PNG views (the reference's tree,
every file decoding to the reference's pixels), and the port's ``infer``
entry point on a port checkpoint.

Metric tolerance: rtol 1e-4 + atol 1e-6 (measured ~1e-7 relative: the same
f32 model and metrics summed in another order). ``time`` is a wall clock
and is only checked for presence. The second shipped recipe's model
(``SRUNetRecurrentSeq``) is evaluated the same way from a port checkpoint,
through the harness and through the streaming engine (engine vs harness
rtol 1e-5). At the bf16 and int8 rungs the flagship and the UNet family
are held window by window (each prediction's and state's dtype and value)
against the reference's harness, and at bf16 every module's output dtype
against the reference's (C8).
"""

import logging
import os
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from esr_tpu.data.dataset import EventWindowDataset as RefDataset
from esr_tpu.inference.harness import InferenceRunner as RefRunner
from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
from esr_tpu.models.registry import get_model as j_get_model
from esr_tpu_torch import infer as port_infer
from esr_tpu_torch.data.dataset import EventWindowDataset
from esr_tpu_torch.inference.checkpoint import save_checkpoint
from esr_tpu_torch.inference.engine import StreamingEngine
from esr_tpu_torch.inference.harness import IMG_DIRS, InferenceRunner, run_inference
from esr_tpu_torch.models import convert
from esr_tpu_torch.models.esr import DeepRecurrNet

DATASET = {
    "scale": 2, "ori_scale": "down8", "time_bins": 1, "mode": "events",
    "window": 512, "sliding_window": 256, "need_gt_events": True,
    "need_gt_frame": False,
    "data_augment": {"enabled": False, "augment": [], "augment_prob": []},
    "sequence": {"sequence_length": 4, "seqn": 3, "step_size": None,
                 "pause": {"enabled": False}},
}
METRICS = ["esr_l1", "esr_mse", "esr_ssim", "esr_psnr", "esr_rmse",
           "bicubic_l1", "bicubic_mse", "bicubic_ssim", "bicubic_psnr",
           "bicubic_rmse", "params", "n_windows", "ssim_delta_mean",
           "ssim_delta_pos_frac", "ssim_delta_std", "esr_ssim_std",
           "bicubic_ssim_std"]
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The module's torch work in one intra-op thread: at these sizes a
    thread team gains nothing, and beside other busy processes its
    spinning workers slow every op by orders of magnitude (the harness
    and engine runs of this module most of all)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(shared_corpus_dir, tmp_path_factory):
    """Both harnesses over rec0.h5 with the same seeded weights."""
    out = tmp_path_factory.mktemp("torch_infer")
    rec = str(shared_corpus_dir / "rec0.h5")
    ref = FlaxNet(inch=2, basech=2, num_frame=3)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, 16, 16, 2), np.float32),
                            ref.init_states(1, 16, 16))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32)
        / np.sqrt(max(np.prod(s.shape[:-1]), 1)), shapes)
    port = DeepRecurrNet(inch=2, basech=2, num_frame=3)
    convert.load_flax_params(port, params)
    ref_result = RefRunner(ref, params, 3).run_recording(rec, DATASET, str(out / "ref"),
                                                         save_images=True)
    port_result = InferenceRunner(port, 3, device="cpu").run_recording(
        rec, DATASET, str(out / "port"), save_images=True)
    return {"rec": rec, "out": out, "params": params,
            "ref": ref_result, "port": port_result}


def test_report_keys_identical(runs):
    assert sorted(runs["port"]) == sorted(runs["ref"])
    assert runs["port"]["n_windows"] >= 3
    assert runs["port"]["time"] > 0


@pytest.mark.parametrize("key", METRICS)
def test_metric_matches_reference(runs, key):
    np.testing.assert_allclose(runs["port"][key], runs["ref"][key], **TOL)


def test_yaml_reports_parse_to_the_same_structure(runs):
    def load(side):
        with open(runs["out"] / side / "inference.yml") as f:
            return yaml.safe_load(f)

    ref, port = load("ref"), load("port")
    assert list(port) == list(ref)
    assert port["info"] == ref["info"]
    assert port["eval_dataset_config"] == ref["eval_dataset_config"]
    assert sorted(port["evaluation results"]) == sorted(ref["evaluation results"])
    for k in METRICS:
        np.testing.assert_allclose(port["evaluation results"][k],
                                   ref["evaluation results"][k], **TOL)


@pytest.mark.parametrize("mode,window,sliding", [("events", 512, 256),
                                                 ("time", 0.2, 0.1),
                                                 ("frame", 0, 0)])
def test_dataset_items_match_reference(runs, mode, window, sliding):
    cfg = {**DATASET, "mode": mode, "window": window, "sliding_window": sliding,
           "item_keys": ["inp_cnt", "inp_scaled_cnt", "gt_cnt"]}
    ref = RefDataset(runs["rec"], cfg)
    port = EventWindowDataset(runs["rec"], cfg)
    assert len(port) == len(ref) > 1
    np.testing.assert_array_equal(port.event_indices, ref.event_indices)
    for i in (0, len(ref) - 1):
        a, b = port.get_item(i), ref.get_item(i, seed=0)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _png_tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.png"))


def test_png_views_are_the_references(runs):
    """The reference's directory tree and file names, and every PNG decodes
    to the reference's pixels (the views of one window render the same
    counts; the prediction rounds to the same integers)."""
    ref_root, port_root = runs["out"] / "ref", runs["out"] / "port"
    tree = _png_tree(ref_root)
    n = int(runs["ref"]["n_windows"])
    assert n >= 3 and len(tree) == 6 * n
    assert _png_tree(port_root) == tree
    assert {str(Path(t).parent) for t in tree} == {
        "img/gt_img", *(f"event_img/{d}" for d in IMG_DIRS)}
    for name in tree:
        want = cv2.imread(str(ref_root / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(cv2.imread(str(port_root / name), cv2.IMREAD_UNCHANGED),
                                      want, err_msg=name)


def test_infer_entry_point_on_a_port_checkpoint(runs):
    ckpt = runs["out"] / "ckpt"
    save_checkpoint(str(ckpt), runs["params"], {
        "model": {"name": "DeepRecurrNet",
                  "args": {"inch": 2, "basech": 2, "num_frame": 3}},
        "trainer": {"precision": "f32"},
        "valid_dataloader": {"dataset": DATASET},
        # the flagship config's engine request; --no_engine overrides it
        "inference": {"engine": True},
    })
    out = runs["out"] / "cli"
    mean = port_infer.main([
        "--model_path", str(ckpt), "--data_path", runs["rec"],
        "--output_path", str(out), "--device", "cpu", "--scale", "2",
        "--ori_scale", "down8", "--window", "512", "--sliding_window", "256",
        "--seql", "4", "--no_need_gt_frame", "--no_engine", "--save_images",
    ])
    name = os.path.basename(runs["rec"])
    assert _png_tree(out / name) == _png_tree(runs["out"] / "ref")
    with open(out / "inference_all.yml") as f:
        report = yaml.safe_load(f)
    assert set(report) == {"info", "breakdown results for each data",
                           "mean results for the whole data"}
    for k in ("esr_psnr", "esr_ssim", "bicubic_mse", "n_windows"):
        np.testing.assert_allclose(mean[k], runs["port"][k], **TOL)
        np.testing.assert_allclose(report["breakdown results for each data"][k][name],
                                   runs["port"][k], **TOL)


@pytest.mark.parametrize("request_", ["save_images", "engine", "config_engine",
                                      "bf16", "lpips", "augment", "dcn_impl_arg"])
def test_unported_requests_raise(runs, request_, caplog):
    """Each request that is not ported raises; ``save_images`` (the PNG
    views), the checkpoint's engine request with ``save_images`` (the
    engine warns and ignores it, as the reference's does), the bf16 rung
    (the engine's and ``run_inference``'s) and LPIPS (the seeded backbone,
    on the 32x32 GT grid of ``down4``, which AlexNet's pools need) are
    ported now, and their cases check that they work."""
    ckpt = runs["out"] / "ckpt_refusals"
    config = {"model": {"name": "DeepRecurrNet",
                        "args": {"inch": 2, "basech": 2, "num_frame": 3}}}
    if request_ == "config_engine":
        config["inference"] = {"engine": True}
    save_checkpoint(str(ckpt), runs["params"], config)
    if request_ == "dcn_impl_arg":
        # no model argument can take a run off the DCN kernel
        with pytest.raises(TypeError):
            DeepRecurrNet(inch=2, basech=2, num_frame=3, dcn_impl="plain")
        return
    port = DeepRecurrNet(inch=2, basech=2, num_frame=3)
    if request_ == "save_images":
        convert.load_flax_params(port, runs["params"])
        InferenceRunner(port, 3, device="cpu").run_recording(
            runs["rec"], DATASET, str(runs["out"] / "x"), save_images=True)
        assert _png_tree(runs["out"] / "x") == _png_tree(runs["out"] / "ref")
        return
    if request_ == "config_engine":
        with caplog.at_level(logging.WARNING):
            mean = run_inference(str(ckpt), [runs["rec"]], str(runs["out"] / "y"), DATASET,
                                 save_images=True, device="cpu")
        assert "--save_images ignored" in caplog.text
        assert not _png_tree(runs["out"] / "y") and np.isfinite(mean["esr_mse"])
        return
    if request_ == "engine":
        engine = StreamingEngine(port, 3, precision="bfloat16", device="cpu")
        assert (engine.precision, engine.compute_dtype) == ("bf16", torch.bfloat16)
        return
    if request_ == "bf16":
        mean = run_inference(str(ckpt), [runs["rec"]], str(runs["out"] / "y"), DATASET,
                             precision="bf16", device="cpu")
        assert np.isfinite(mean["esr_mse"])
        return
    if request_ == "lpips":
        mean = run_inference(str(ckpt), [runs["rec"]], str(runs["out"] / "lpips"),
                             {**DATASET, "ori_scale": "down4"},
                             allow_uncalibrated_lpips=True, device="cpu")
        assert all(np.isfinite(mean[k]) and mean[k] > 0 for k in LPIPS_KEYS)
        return
    with pytest.raises(NotImplementedError):
        # Horizontal/Vertical/Polarity are ported; an unknown mechanism
        # is refused rather than silently skipped
        cfg = {**DATASET, "data_augment": {"enabled": True,
                                           "augment": ["Horizontal", "Rotate"],
                                           "augment_prob": [0.5, 0.5]}}
        EventWindowDataset(runs["rec"], cfg)


# -- LPIPS at evaluation ------------------------------------------------------
#
# The three trunks on seeded weights (the reference's own parameter tree,
# its lin weights drawn at random, signs included) through multi_channel on
# 2-channel images: rtol 1e-5 (measured 2e-7). The harness with LPIPS
# against the reference's: the reference's harness passes its window
# unbatched to multi_channel, whose mean over axes (1, 2) then fails, so
# its LPIPS call is given the batch axis it drops (what the port's
# multi_channel does); the report within TOL (measured ~1e-7).

LPIPS_KEYS = ("esr_lpips", "bicubic_lpips")
LPIPS_NETS = ("alex", "vgg16", "squeeze")


def _lpips_state(net, seed):
    """A seeded torchvision-style ``features.*`` state dict of ``net``."""
    from esr_tpu.losses import lpips as R
    from esr_tpu_torch.losses.lpips import LPIPS

    trunk = LPIPS(net=net).trunk
    if net == "squeeze":
        convs = [("features.0", trunk.conv0)] + [
            (f"features.{li}.{m}", getattr(getattr(trunk, f"fire{i}"), m))
            for i, li in enumerate(R._SQUEEZE_FIRE_IDX)
            for m in ("squeeze", "expand1x1", "expand3x3")]
    else:
        idx = R._ALEX_CONV_IDX if net == "alex" else R._VGG_CONV_IDX
        convs = [(f"features.{li}", getattr(trunk, f"conv{i}")) for i, li in enumerate(idx)]
    rng = np.random.default_rng(seed)
    state = {}
    for key, conv in convs:
        fan_in = np.prod(conv.weight.shape[1:])
        state[f"{key}.weight"] = (rng.standard_normal(tuple(conv.weight.shape))
                                  / np.sqrt(fan_in)).astype(np.float32)
        state[f"{key}.bias"] = rng.uniform(-0.1, 0.1, conv.bias.shape[0]).astype(np.float32)
    return state


@pytest.mark.parametrize("net", LPIPS_NETS)
def test_lpips_trunks_match_reference(net):
    from esr_tpu.losses import lpips as R
    from esr_tpu_torch.losses import lpips as L

    params = jax.tree.map(np.asarray, R.load_lpips_params(allow_uncalibrated=True, net=net))
    rng = np.random.default_rng(4)
    for k in params["params"]:
        if k.startswith("lin"):
            params["params"][k] = rng.standard_normal(params["params"][k].shape).astype(
                np.float32)
    model = L.build_lpips(params, net)
    x, y = (rng.random((2, 34, 38, 2)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        got = [float(model.multi_channel(torch.from_numpy(x), torch.from_numpy(y))),
               float(model.multi_channel(torch.from_numpy(x[0]), torch.from_numpy(y[0]))),
               float(model.multi_channel(torch.from_numpy(x[..., :1].repeat(3, -1)),
                                         torch.from_numpy(y[..., :1].repeat(3, -1))))]
    ref = R.LPIPS(net=net)
    want = [float(ref.multi_channel(params, x, y)),
            float(ref.multi_channel(params, x[:1], y[:1])),
            float(ref.multi_channel(params, x[..., :1].repeat(3, -1),
                                    y[..., :1].repeat(3, -1)))]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert min(got) > 0
    # the port's own tree has the reference's structure and shapes
    own = L.load_lpips_params(allow_uncalibrated=True, net=net)
    assert (jax.tree.map(np.shape, own) == jax.tree.map(np.shape, params))


@pytest.mark.parametrize("net", LPIPS_NETS)
def test_lpips_backbone_loads_and_converts_as_the_reference(net, tmp_path):
    """A torchvision-layout backbone: the ``.pth`` converter writes the
    reference's npz, and the loaded trunk is bitwise the reference's."""
    from esr_tpu.losses import lpips as R
    from esr_tpu_torch.losses import lpips as L

    state = _lpips_state(net, 1)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, tmp_path / "b.pth")
    L.convert_backbone_pth(str(tmp_path / "b.pth"), str(tmp_path / "port.npz"), net)
    R.convert_backbone_pth(str(tmp_path / "b.pth"), str(tmp_path / "ref.npz"), net)
    got, want = L.load_backbone_npz(str(tmp_path / "port.npz")), R.load_backbone_npz(
        str(tmp_path / "ref.npz"))
    assert sorted(got) == sorted(want) == sorted(state)
    kw = dict(backbone_state=got, net=net, allow_uncalibrated=net != "alex")
    mine = L.load_lpips_params(**kw)["params"]
    theirs = jax.tree.map(np.asarray, R.load_lpips_params(**kw)["params"])
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_lpips_bundled_lin_weights_load():
    from esr_tpu.losses import lpips as R
    from esr_tpu_torch.losses import lpips as L

    assert L.LIN_WEIGHTS_FILE != R._LIN_WEIGHTS_FILE and "esr_tpu_torch" in L.LIN_WEIGHTS_FILE
    mine = L.load_lpips_params(allow_uncalibrated=True)["params"]
    theirs = R.load_lpips_params(allow_uncalibrated=True)["params"]
    for i, c in enumerate(L.NET_CHNS["alex"]):
        assert mine[f"lin{i}"].shape == (c,)
        np.testing.assert_array_equal(mine[f"lin{i}"], np.asarray(theirs[f"lin{i}"]))
        assert not np.allclose(mine[f"lin{i}"], 1.0 / c)


@pytest.mark.parametrize("case", ["no_backbone", "missing_lins", "no_lins"])
def test_lpips_uncalibrated_refusals_match_reference(case, tmp_path):
    from esr_tpu.losses import lpips as R
    from esr_tpu_torch.losses import lpips as L

    kw, err = {
        "no_backbone": ({}, ValueError),
        "missing_lins": ({"lin_npz_path": str(tmp_path / "nope.npz"),
                          "allow_uncalibrated": True}, FileNotFoundError),
        "no_lins": ({"net": "vgg", "backbone_state": _lpips_state("vgg16", 2)}, ValueError),
    }[case]
    with pytest.raises(err) as want:
        R.load_lpips_params(**kw)
    with pytest.raises(err) as got:
        L.load_lpips_params(**kw)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def lpips_runs(runs, tmp_path_factory):
    """The ``runs`` weights on the 32x32 GT grid, with LPIPS from a seeded
    alex backbone npz and the bundled lins: the reference's harness (its
    LPIPS call batched) and the port's ``run_inference``, and the port's
    with the seeded uncalibrated backbone."""
    from esr_tpu.losses import lpips as R

    out = tmp_path_factory.mktemp("torch_lpips")
    cfg = {**DATASET, "ori_scale": "down4"}
    np.savez(out / "alex.npz", **_lpips_state("alex", 3))
    lpips_params = R.load_lpips_params(backbone_state=R.load_backbone_npz(str(out / "alex.npz")))
    ref_lpips = R.LPIPS()
    ref_runner = RefRunner(FlaxNet(inch=2, basech=2, num_frame=3), runs["params"], 3,
                           lpips_model=ref_lpips, lpips_params=lpips_params)
    ref_runner.lpips = jax.jit(
        lambda a, b: ref_lpips.multi_channel(lpips_params, a[None], b[None]))
    ref = ref_runner.run_recording(runs["rec"], cfg)
    ckpt = out / "ckpt"
    save_checkpoint(str(ckpt), runs["params"], {
        "model": {"name": "DeepRecurrNet", "args": {"inch": 2, "basech": 2, "num_frame": 3}},
        "inference": {"engine": True}})
    name = os.path.basename(runs["rec"])
    port = {}
    for way, kw in (("npz", {"lpips_backbone_npz": str(out / "alex.npz")}),
                    ("seeded", {"allow_uncalibrated_lpips": True})):
        run_inference(str(ckpt), [runs["rec"]], str(out / way), cfg, engine=False,
                      device="cpu", **kw)
        with open(out / way / name / "inference.yml") as f:
            port[way] = yaml.safe_load(f)["evaluation results"]
    return {"ref": ref, "port": port, "ckpt": ckpt, "cfg": cfg, "out": out}


@pytest.mark.parametrize("way", ["npz", "seeded"])
def test_run_inference_with_lpips_gives_the_reference_report(lpips_runs, way):
    ref, got = lpips_runs["ref"], lpips_runs["port"][way]
    assert sorted(got) == sorted(ref) and set(LPIPS_KEYS) <= set(got)
    assert all(np.isfinite(got[k]) and got[k] > 0 for k in LPIPS_KEYS)
    keys = METRICS + list(LPIPS_KEYS) if way == "npz" else METRICS
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], **TOL, err_msg=k)


def test_engine_refuses_lpips(lpips_runs, runs):
    """The checkpoint asks for the engine; LPIPS there raises, as the
    reference's does."""
    with pytest.raises(ValueError, match="engine mode does not support LPIPS"):
        run_inference(str(lpips_runs["ckpt"]), [runs["rec"]],
                      str(lpips_runs["out"] / "engine"), lpips_runs["cfg"],
                      allow_uncalibrated_lpips=True, device="cpu")


def test_infer_entry_point_takes_the_lpips_flags(lpips_runs, runs):
    out = lpips_runs["out"] / "cli"
    mean = port_infer.main([
        "--model_path", str(lpips_runs["ckpt"]), "--data_path", runs["rec"],
        "--output_path", str(out), "--device", "cpu", "--scale", "2",
        "--ori_scale", "down4", "--window", "512", "--sliding_window", "256",
        "--seql", "4", "--no_need_gt_frame", "--no_engine",
        "--lpips_backbone", str(lpips_runs["out"] / "alex.npz"), "--lpips_net", "alex",
        "--allow_uncalibrated_lpips"])
    with open(out / "inference_all.yml") as f:
        report = yaml.safe_load(f)["mean results for the whole data"]
    for k in LPIPS_KEYS:
        np.testing.assert_allclose(mean[k], lpips_runs["ref"][k], **TOL)
        np.testing.assert_allclose(report[k], lpips_runs["ref"][k], **TOL)


@pytest.mark.gpu
def test_lpips_on_card_matches_its_cpu_run():
    """Each trunk on the card (f32, TF32 off: the port's numerics policy)
    within 1e-4 relative of the same module on the CPU, through
    multi_channel on 2-channel images, batched and not."""
    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.losses import lpips as L

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 8f runs the same check on the "
                    "H100)")
    dev = resolve_device("cuda")
    rng = np.random.default_rng(5)
    x, y = (torch.from_numpy(rng.random((2, 66, 70, 2)).astype(np.float32)) for _ in range(2))
    for net in LPIPS_NETS:
        params = L.load_lpips_params(allow_uncalibrated=True, net=net)
        cpu, card = L.build_lpips(params, net, "cpu"), L.build_lpips(params, net, dev)
        with torch.no_grad():
            for a, b in ((x, y), (x[0], y[0])):
                want = float(cpu.multi_channel(a, b))
                got = float(card.multi_channel(a.to(dev), b.to(dev)))
                assert abs(got - want) <= 1e-4 * abs(want), (net, got, want)


# -- the precision rungs through the sequential harness -----------------------
#
# A basech-4 model with seeded weights, both harnesses at each rung over the
# same recording; the reference's forward DCN runs its Pallas kernel
# (interpret mode), whose semantics the port follows at bf16 (an f32 DCN,
# the output back in bf16). Tolerances (measured on the CPU, then a margin):
# - int8: the seams are bitwise the reference's, but a 1-ulp difference in
#   an f32 layer upstream can move one round(x / scale) across a .5 and
#   change that output by a quantization step, so the model's metrics are
#   held at rtol 1e-4 (measured 6.7e-6 at worst, SSIM);
# - bf16: both sides round every layer to bf16, XLA and PyTorch at other
#   places inside fused elementwise chains; rtol 2e-4 (measured 2.2e-5);
# - and each rung against f32 by the reference's own bound: the ESR PSNR
#   within 1.0 dB (tests/test_quantize.py).
RUNG_RTOL = {"f32": 1e-4, "bf16": 2e-4, "int8": 1e-4}
RUNG_METRICS = ["esr_l1", "esr_mse", "esr_ssim", "esr_psnr", "bicubic_psnr", "n_windows"]
PSNR_DROP_DB = 1.0


@pytest.fixture(scope="module")
def rung_runs(runs):
    ref = FlaxNet(inch=2, basech=4, num_frame=3, dcn_impl_fwd="pallas")
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, 16, 16, 2), np.float32),
                            ref.init_states(1, 16, 16))
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda s: rng.uniform(-1.0, 1.0, s.shape).astype(np.float32)
        / np.sqrt(max(np.prod(s.shape[:-1]), 1)), shapes)
    port = DeepRecurrNet(inch=2, basech=4, num_frame=3)
    convert.load_flax_params(port, params)
    return {rung: _rung_pair(ref, params, port, rung, runs["rec"])
            for rung in ("f32", "bf16", "int8")}


def _rung_pair(ref, params, port, rung, rec):
    """Both harnesses at ``rung`` over ``rec``: each one's metric means and
    its per-window predictions, the prediction's dtype and the states'
    dtypes, as the forward returned them."""
    ref_runner = RefRunner(ref, params, 3, precision=rung)
    ref_fwd, ref_windows = ref_runner._fwd, []

    def ref_spy(p, x, states):
        pred, states = ref_fwd(p, x, states)
        ref_windows.append((np.asarray(pred.astype(jnp.float32)), str(pred.dtype),
                            [str(z.dtype) for z in jax.tree.leaves(states)]))
        return pred, states

    ref_runner._fwd = ref_spy
    port_runner = InferenceRunner(port, 3, device="cpu", precision=rung)
    port_fwd, port_windows = port_runner.forward, []

    def port_spy(x, states):
        pred, states = port_fwd(x, states)
        port_windows.append((pred.float().numpy(), str(pred.dtype).replace("torch.", ""),
                             [str(z.dtype).replace("torch.", "") for z in states]))
        return pred, states

    port_runner.forward = port_spy
    return {"ref": ref_runner.run_recording(rec, DATASET, report=False),
            "port": port_runner.run_recording(rec, DATASET, report=False),
            "ref_windows": ref_windows, "port_windows": port_windows}


# per-window predictions against the reference's: the dtypes equal, the
# values within tol * max(|ref|, 1). Measured on the CPU (as a share of
# that scale): bf16 1.0e-3 (the flagship; C8's f32 decoder on both sides)
# and 7.0e-3 (UNetRecurrentSeq's bf16 output, 0.0625 at 13.3: one bf16 ulp,
# which is at most 2**-7 of the scale; the bound allows two); int8 1.5e-3
# (one flagship window, a quantization step flipped by a 1-ulp difference
# upstream); f32 <= 2.3e-7.
WINDOW_TOL = {"f32": 1e-5, "bf16": 2.0 ** -6, "int8": 2.0 ** -7}


def _assert_windows(pair, rung):
    ref, got = pair["ref_windows"], pair["port_windows"]
    assert len(got) == len(ref) >= 3
    for i, ((rp, rdt, rst), (gp, gdt, gst)) in enumerate(zip(ref, got)):
        assert (gdt, gst) == (rdt, rst), (i, gdt, rdt, gst, rst)
        assert gp.shape == rp.shape
        limit = WINDOW_TOL[rung] * max(float(np.abs(rp).max()), 1.0)
        assert float(np.abs(gp - rp).max()) <= limit, (i, float(np.abs(gp - rp).max()), limit)


@pytest.mark.parametrize("rung", ["bf16", "int8"])
def test_harness_rung_windows_match_reference(rung_runs, rung):
    """Each window's prediction at the rung against the reference's: the
    same dtype (f32 at bf16 too: the decoder runs f32 from ``recon_0``'s
    resize on, C8), the same states' dtypes, the values within
    :data:`WINDOW_TOL`."""
    _assert_windows(rung_runs[rung], rung)
    assert rung_runs[rung]["port_windows"][0][1] == "float32"


@pytest.mark.parametrize("rung", ["bf16", "int8"])
def test_harness_rung_matches_reference(rung_runs, rung):
    port, ref = rung_runs[rung]["port"], rung_runs[rung]["ref"]
    assert sorted(port) == sorted(ref)
    for k in RUNG_METRICS:
        np.testing.assert_allclose(port[k], ref[k], rtol=RUNG_RTOL[rung], err_msg=k)
    # the rung is a real one, and stays within the reference's quality bound
    f32 = rung_runs["f32"]["port"]
    assert port["esr_mse"] != f32["esr_mse"]
    assert f32["esr_psnr"] - port["esr_psnr"] <= PSNR_DROP_DB
    np.testing.assert_allclose(port["bicubic_psnr"], f32["bicubic_psnr"], rtol=1e-6)


def test_precision_resolves_cli_over_checkpoint_over_f32(runs, tmp_path):
    """``run_inference`` resolves the rung as the reference does: the
    argument, else the checkpoint's ``trainer.precision``, else f32; a
    misspelled rung raises."""
    from esr_tpu_torch.inference import harness

    seen = []

    class Spy(InferenceRunner):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self.precision)

    config = {"model": {"name": "DeepRecurrNet",
                        "args": {"inch": 2, "basech": 2, "num_frame": 3}},
              "trainer": {"precision": "bfloat16"}}
    ckpt = tmp_path / "ckpt_bf16"
    save_checkpoint(str(ckpt), runs["params"], config)
    orig = harness.InferenceRunner
    harness.InferenceRunner = Spy
    try:
        for cli in (None, "w8a8", "fp32"):
            run_inference(str(ckpt), [runs["rec"]], str(tmp_path / "o"), DATASET,
                          precision=cli, engine=False, device="cpu")
        with pytest.raises(ValueError, match="unknown precision"):
            run_inference(str(ckpt), [runs["rec"]], str(tmp_path / "o"), DATASET,
                          precision="fp8", engine=False, device="cpu")
    finally:
        harness.InferenceRunner = orig
    assert seen == ["bf16", "int8", "f32"]


# -- the second shipped recipe's model (SRUNetRecurrentSeq) -----------------

SR_ARGS = {"num_frame": 3, "base_num_channels": 4, "num_encoders": 2,
           "num_residual_blocks": 1}
SR_METRICS = METRICS


@pytest.fixture(scope="module")
def srunet_runs(shared_corpus_dir, tmp_path_factory):
    """A seeded SRUNetRecurrentSeq saved as a port checkpoint, evaluated on
    rec0 and rec1 by the reference's harness and by the port's ``infer``
    entry point, once through the sequential harness and once through the
    engine (lanes 2 x chunk 2)."""
    out = tmp_path_factory.mktemp("torch_infer_srunet")
    recs = [str(shared_corpus_dir / f"rec{i}.h5") for i in (0, 1)]
    ref = j_get_model("SRUNetRecurrentSeq", **SR_ARGS)
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                            np.zeros((1, 3, 16, 16, 2), np.float32),
                            ref.init_states(1, 16, 16))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda s: rng.uniform(-1.0, 1.0, s.shape).astype(np.float32)
        / np.sqrt(max(np.prod(s.shape[:-1]), 1)), shapes)
    ref_results = [RefRunner(ref, params, 3).run_recording(r, DATASET, str(out / f"ref{i}"))
                   for i, r in enumerate(recs)]
    ckpt = out / "ckpt"
    save_checkpoint(str(ckpt), params, {
        "model": {"name": "SRUNetRecurrentSeq", "args": SR_ARGS},
        "trainer": {"precision": "f32"}, "valid_dataloader": {"dataset": DATASET}})
    datalist = out / "datalist.txt"
    datalist.write_text("\n".join(recs) + "\n")
    means = {}
    for way in ("no_engine", "engine"):
        means[way] = port_infer.main([
            "--model_path", str(ckpt), "--data_list", str(datalist),
            "--output_path", str(out / way), "--device", "cpu", "--scale", "2",
            "--ori_scale", "down8", "--window", "512", "--sliding_window", "256",
            "--seql", "4", "--no_need_gt_frame", f"--{way}", "--lanes", "2",
            "--chunk_windows", "2"])
    reports = {}
    for way in means:
        with open(out / way / "inference_all.yml") as f:
            reports[way] = yaml.safe_load(f)["breakdown results for each data"]
    return {"recs": recs, "ref": ref_results, "means": means, "reports": reports,
            "ckpt": ckpt}


@pytest.mark.parametrize("key", SR_METRICS)
def test_srunet_harness_matches_reference(srunet_runs, key):
    report = srunet_runs["reports"]["no_engine"]
    for rec, ref in zip(srunet_runs["recs"], srunet_runs["ref"]):
        np.testing.assert_allclose(report[key][os.path.basename(rec)], ref[key], **TOL)


@pytest.mark.parametrize("key", SR_METRICS)
def test_srunet_engine_matches_harness(srunet_runs, key):
    harness, engine = (srunet_runs["reports"][w] for w in ("no_engine", "engine"))
    for rec in srunet_runs["recs"]:
        name = os.path.basename(rec)
        np.testing.assert_allclose(engine[key][name], harness[key][name], rtol=1e-5,
                                   atol=1e-7)
    assert srunet_runs["means"]["engine"]["n_windows"] >= 3


# -- the UNet family at the bf16 and int8 rungs -----------------------------
#
# The second shipped recipe's model and UNetRecurrentSeq (transposed-conv
# decoders) at a narrow width (base 2, 2 encoders), seeded weights, both
# harnesses over rec0 at each rung: per-window predictions as
# ``test_harness_rung_windows_match_reference`` holds the flagship's, and the
# metric means within RUNG_RTOL plus UNET_RUNG_ATOL (the SSIM means sit near
# 0 under random weights: measured 9.5e-7 absolute, 3.4e-4 relative, at bf16
# through UNetRecurrentSeq's bf16 output; every other metric within 1.1e-6
# relative).
UNET_RUNG_MODELS = {
    "SRUNetRecurrentSeq": {"num_frame": 3, "base_num_channels": 2, "num_encoders": 2,
                           "num_residual_blocks": 1},
    "UNetRecurrentSeq": {"num_frame": 3, "base_num_channels": 2, "num_encoders": 2,
                         "num_residual_blocks": 1, "use_upsample_conv": False},
    # with norms: evaluation normalizes with the running statistics (drawn
    # positive for the variances), which cross the bridge as batch_stats;
    # at int8 the norms stay f32, as the reference's rung keeps them
    "SRUNetRecurrentSeq+BN": {"num_frame": 3, "base_num_channels": 2, "num_encoders": 2,
                              "num_residual_blocks": 1, "norm": "BN"},
    "UNetRecurrentSeq+IN": {"num_frame": 3, "base_num_channels": 2, "num_encoders": 2,
                            "num_residual_blocks": 1, "use_upsample_conv": False,
                            "norm": "IN"},
}
UNET_RUNG_ATOL = 1e-4


@pytest.fixture(scope="module")
def unet_rungs(runs):
    from esr_tpu_torch.models.registry import get_model

    out = {}
    for case, args in UNET_RUNG_MODELS.items():
        name = case.split("+")[0]
        ref = j_get_model(name, **args)
        shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0),
                                np.zeros((1, 3, 16, 16, 2), np.float32),
                                ref.init_states(1, 16, 16))
        rng = np.random.default_rng(2)

        def draw(path, s):
            if jax.tree_util.keystr(path).endswith("['var']"):
                return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
            return (rng.uniform(-1.0, 1.0, s.shape).astype(np.float32)
                    / np.sqrt(max(np.prod(s.shape[:-1]), 1)))

        params = jax.tree_util.tree_map_with_path(draw, shapes)
        port = get_model(name, **args)
        convert.load_flax_params(port, params)
        out[case] = {rung: _rung_pair(ref, params, port, rung, runs["rec"])
                     for rung in ("f32", "bf16", "int8")}
    return out


@pytest.mark.parametrize("rung", ["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(UNET_RUNG_MODELS))
def test_unet_family_rung_matches_reference(unet_rungs, name, rung):
    """A UNet-family model through the harness at the rung: each window's
    prediction and states (dtypes and values) and the metric means against
    the reference's; the rung is a real one and within 1.0 dB of f32."""
    pair = unet_rungs[name][rung]
    _assert_windows(pair, rung)
    port, ref = pair["port"], pair["ref"]
    assert sorted(port) == sorted(ref)
    for k in RUNG_METRICS:
        np.testing.assert_allclose(port[k], ref[k], rtol=RUNG_RTOL[rung], atol=UNET_RUNG_ATOL,
                                   err_msg=k)
    f32 = unet_rungs[name]["f32"]["port"]
    assert port["esr_mse"] != f32["esr_mse"]
    assert abs(f32["esr_psnr"] - port["esr_psnr"]) <= PSNR_DROP_DB
    states = pair["port_windows"][0][2]
    assert states == ["bfloat16" if rung == "bf16" else "float32"] * 4


@pytest.mark.parametrize("name", [k for k in sorted(UNET_RUNG_MODELS) if "+" in k])
def test_unet_norm_model_evaluates_as_the_reference_at_f32(unet_rungs, name):
    """A UNet-family model with norms through the harness at f32: each
    window within :data:`WINDOW_TOL` of the reference's, the metric means
    within RUNG_RTOL plus UNET_RUNG_ATOL."""
    pair = unet_rungs[name]["f32"]
    _assert_windows(pair, "f32")
    for k in RUNG_METRICS:
        np.testing.assert_allclose(pair["port"][k], pair["ref"][k], rtol=RUNG_RTOL["f32"],
                                   atol=UNET_RUNG_ATOL, err_msg=k)


def _layer_dtypes_ref(ref, params, x, states):
    """``{module path: output leaves' dtypes}`` of one bf16 forward of the
    reference (its intermediates' last call)."""
    import flax

    pb = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params)
    sb = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), states)
    apply = jax.jit(lambda p, a, z: ref.apply(p, a, z, capture_intermediates=True,
                                              mutable=["intermediates"]))
    _, inter = apply(pb, jnp.asarray(x).astype(jnp.bfloat16), sb)
    out = {}
    for path, v in flax.traverse_util.flatten_dict(inter["intermediates"]).items():
        out[".".join(path[:-1])] = [str(z.dtype) for z in jax.tree.leaves(v[-1])]
    return out


def _layer_dtypes_port(port, x, states):
    out, hooks = {}, []
    for name, mod in port.named_modules():
        hooks.append(mod.register_forward_hook(lambda m, a, o, name=name: out.__setitem__(
            name, [str(t.dtype).replace("torch.", "") for t in
                   torch.utils._pytree.tree_leaves(o) if isinstance(t, torch.Tensor)])))
    try:
        with torch.no_grad():
            port.to(torch.bfloat16)(torch.from_numpy(x).to(torch.bfloat16),
                                    tuple(torch.tensor(np.asarray(z), dtype=torch.bfloat16)
                                          for z in jax.tree.leaves(states)))
    finally:
        for h in hooks:
            h.remove()
    return out


# flax's auto-named submodules (a layer's conv, its norm wrapper, a cell):
# held only where the port has a module of the same path
FLAX_ONLY = ("Conv_", "ConvTranspose_", "Dense_", "_NormWrapper", "ConvLSTMCell_",
             "ConvGRUCell_", "ConvLayer_")


def _port_name(ref_name, port_names):
    """The port's module for a reference path: the same path, or with each
    ``name_i`` as ``name.i`` (``recon_0`` -> ``recon.0``) and a Sequential's
    ``layers`` (``feat_extract.ConvLayer_0`` -> ``feat_extract.layers.0``)."""
    import re

    for cand in (ref_name, re.sub(r"_(\d+)(?=\.|$)", r".\1", ref_name),
                 re.sub(r"\.ConvLayer_(\d+)$", r".layers.\1", ref_name)):
        if cand in port_names:
            return cand
    return None


@pytest.mark.parametrize("name", ["DeepRecurrNet", "SRUNetRecurrentSeq", "UNetRecurrentSeq"])
def test_bf16_layer_dtypes_match_reference(name):
    """C8, layer by layer: at bf16 every module of the flagship and of the
    UNet family returns the reference's dtypes (the encoders and recurrent
    states bf16; the decoders, the skips' upsamplers and what follows them
    f32; a transposed conv back in bf16). Every module the reference names
    (its flax paths, the weightless wrappers aside) is matched."""
    from esr_tpu_torch.models.registry import get_model

    if name == "DeepRecurrNet":
        args = {"inch": 2, "basech": 4, "num_frame": 3}
        ref, port = FlaxNet(**args), DeepRecurrNet(**args)
    else:
        args = UNET_RUNG_MODELS[name]
        ref, port = j_get_model(name, **args), get_model(name, **args)
    x = np.random.default_rng(0).standard_normal((1, 3, 16, 16, 2)).astype(np.float32)
    states = ref.init_states(1, 16, 16)
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda a: rng.uniform(-1.0, 1.0, a.shape).astype(np.float32)
        / np.sqrt(max(np.prod(a.shape[:-1]), 1)),
        jax.eval_shape(ref.init, jax.random.PRNGKey(0), x, states))
    convert.load_flax_params(port, params)
    want = _layer_dtypes_ref(ref, params, x, states)
    got = _layer_dtypes_port(port, x, states)
    matched = 0
    for ref_name, dtypes in want.items():
        port_name = _port_name(ref_name, got)
        if port_name is None and (ref_name == "model" or any(
                part.startswith(FLAX_ONLY) for part in ref_name.split("."))):
            # a flax submodule with no module of its own in the port, or the
            # adapter's wrapped model, which the port runs through its
            # encode / forward_nchw (its children are held)
            continue
        assert port_name is not None, ref_name
        assert got[port_name] == dtypes, (ref_name, got[port_name], dtypes)
        matched += 1
    assert matched == {"DeepRecurrNet": 32, "SRUNetRecurrentSeq": 12,
                       "UNetRecurrentSeq": 9}[name]
    top = got[""]
    assert top[0] == ("bfloat16" if name == "UNetRecurrentSeq" else "float32")
