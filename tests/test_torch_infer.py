"""The port's sequential evaluation against the reference's, end to end on
the CPU: one recording of the shared corpus through both
``InferenceRunner.run_recording``s with the same weights, the data path's
items bit for bit, the YAML reports, the PNG views (the reference's tree,
every file decoding to the reference's pixels), and the port's ``infer``
entry point on a port checkpoint.

Metric tolerance: rtol 1e-4 + atol 1e-6 (measured ~1e-7 relative: the same
f32 model and metrics summed in another order). ``time`` is a wall clock
and is only checked for presence.
"""

import logging
import os
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

from esr_tpu.data.dataset import EventWindowDataset as RefDataset
from esr_tpu.inference.harness import InferenceRunner as RefRunner
from esr_tpu.models.esr import DeepRecurrNet as FlaxNet
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
    engine warns and ignores it, as the reference's does) and the bf16 rung
    (the engine's and ``run_inference``'s) are ported now, and their cases
    check that they work."""
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
    with pytest.raises(NotImplementedError):
        if request_ == "augment":
            # Horizontal/Vertical/Polarity are ported; an unknown mechanism
            # is refused rather than silently skipped
            cfg = {**DATASET, "data_augment": {"enabled": True,
                                               "augment": ["Horizontal", "Rotate"],
                                               "augment_prob": [0.5, 0.5]}}
            EventWindowDataset(runs["rec"], cfg)
        else:
            run_inference(
                str(ckpt), [runs["rec"]], str(runs["out"] / "y"), DATASET,
                allow_uncalibrated_lpips=request_ == "lpips", device="cpu",
            )


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
    out = {}
    for rung in ("f32", "bf16", "int8"):
        out[rung] = {
            "ref": RefRunner(ref, params, 3, precision=rung).run_recording(
                runs["rec"], DATASET, report=False),
            "port": InferenceRunner(port, 3, device="cpu", precision=rung).run_recording(
                runs["rec"], DATASET, report=False),
        }
    return out


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
