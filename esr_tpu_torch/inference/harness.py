"""Sequential inference over recordings: ESR vs bicubic metrics + reports
(counterpart of ``esr_tpu/inference/harness.py``).

- One :class:`InferenceRunner` per model; recurrent state is reset ONCE per
  recording and persists across the whole stream.
- Each length-L sequence contributes its FIRST seqn-window
  (``inputs_seq[0]``); sequences are non-overlapping, batch 1, in order.
- Per window: esr_{l1,mse,ssim,psnr} against the GT count image of the
  middle frame, and the same for the bicubic-upsampled LR input; the
  forward's latency is timed up to ``torch.cuda.synchronize()``.
- The per-recording ``inference.yml`` and the datalist ``inference_all.yml``
  keep the reference's schema.
- ``save_images`` dumps each window's views as PNGs in the reference's
  layout under the recording's output directory:
  ``event_img/{lr,hr_scaled,hr_esr,hr_bicubic,hr_gt}_event_img/<window
  :09d>.png`` (``utils.vis_events.render_event_cnt``) and
  ``img/gt_img/<window:09d>.png`` (the GT frame).

:func:`run_inference` routes a datalist through the batched
:class:`esr_tpu_torch.inference.engine.StreamingEngine` when ``engine`` is
true, or when it is None and the checkpoint's ``inference.engine`` is
(the flagship's); ``lanes`` and ``chunk_windows`` default to the same
block, else 4 and 8. The reports and their schema are the same.

The engine dumps no PNGs: with ``save_images`` it warns and ignores it, as
the reference does. LPIPS is not ported (it raises ``NotImplementedError``).

The precision rung (``esr_tpu_torch.config.precision``) is resolved once:
the caller's ``precision`` > the checkpoint's ``trainer.precision`` > f32.
At bf16 the runner casts a copy of the model, the states and the inputs,
and upcasts each prediction to f32 before the resize and the metrics; at
int8 nothing is cast and the forward runs inside ``int8_scope()`` (the
seams quantize; ``esr_tpu_torch.config.quantize``).
"""

from __future__ import annotations

import copy
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from esr_tpu_torch.config.precision import compute_dtype_of, resolve_precision
from esr_tpu_torch.config.quantize import int8_scope
from esr_tpu_torch.data.dataset import ITEM_KEYS
from esr_tpu_torch.data.loader import InferenceSequenceLoader
from esr_tpu_torch.data.records import Recording, open_recording, recording_name
from esr_tpu_torch.device import DeviceLike, resolve_device, synchronize
from esr_tpu_torch.losses.restore import l1_metric, mse_metric, psnr_metric, ssim_metric
from esr_tpu_torch.ops.resize import interpolate
from esr_tpu_torch.utils.trackers import MetricTracker, YamlLogger
from esr_tpu_torch.utils.vis_events import render_event_cnt, render_frame, save_image

logger = logging.getLogger(__name__)

# the per-window views under <out_dir>/event_img/
IMG_DIRS = ("lr_event_img", "hr_scaled_event_img", "hr_esr_event_img",
            "hr_bicubic_event_img", "hr_gt_event_img")


def _num_params(model: torch.nn.Module) -> float:
    return sum(p.numel() for p in model.parameters()) / 1e6


def _metrics(pred, base, gt) -> Dict[str, torch.Tensor]:
    return {
        "esr_l1": l1_metric(pred, gt),
        "esr_mse": mse_metric(pred, gt),
        "esr_ssim": ssim_metric(pred, gt),
        "esr_psnr": psnr_metric(pred, gt),
        "bicubic_l1": l1_metric(base, gt),
        "bicubic_mse": mse_metric(base, gt),
        "bicubic_ssim": ssim_metric(base, gt),
        "bicubic_psnr": psnr_metric(base, gt),
    }


class InferenceRunner:
    """Sequential evaluation of one model at one precision rung (``None``:
    f32). The model is moved to the device; at bf16 the runner evaluates a
    bf16 copy of it."""

    def __init__(self, model: torch.nn.Module, seqn: int = 3, device: DeviceLike = None,
                 precision: Optional[str] = None):
        self.device = resolve_device(device)
        self.precision = resolve_precision(cli=precision)
        self.compute_dtype = compute_dtype_of(self.precision)
        self.model = model.to(self.device).eval()
        if self.compute_dtype is not None:
            self.model = copy.deepcopy(self.model).to(self.compute_dtype)
        self.seqn = seqn
        self.mid_idx = (seqn - 1) // 2

    def forward(self, inp: torch.Tensor, states):
        """One window at the runner's rung: ``(prediction, states)``."""
        if self.compute_dtype is not None:
            inp = inp.to(self.compute_dtype)
        if self.precision == "int8":
            with int8_scope():
                return self.model(inp, states)
        return self.model(inp, states)

    def run_recording(
        self,
        data_path,
        dataset_config: Dict,
        out_dir: Optional[str] = None,
        save_images: bool = False,
        report: bool = True,
    ) -> Dict[str, float]:
        """Stream one recording; returns the per-recording metric means.
        ``save_images`` (with an ``out_dir``) writes the PNG views."""
        recording = open_recording(data_path)
        img_dir = out_dir if save_images else None
        try:
            result = self._stream(recording, dataset_config, img_dir)
        finally:
            if recording is not data_path:  # opened here from a path
                recording.close()
        if report and out_dir is not None:
            _write_recording_report(out_dir, str(data_path), dataset_config, result)
        return result

    @torch.no_grad()
    def _stream(self, recording: Recording, dataset_config: Dict,
                img_dir: Optional[str] = None) -> Dict[str, float]:
        if img_dir is not None:
            for d in IMG_DIRS:
                os.makedirs(os.path.join(img_dir, "event_img", d), exist_ok=True)
            os.makedirs(os.path.join(img_dir, "img", "gt_img"), exist_ok=True)
            if dataset_config.get("item_keys") is None:
                # the GT frame beside the count images, as the reference's
                # loader builds it
                dataset_config = {**dataset_config, "item_keys": ITEM_KEYS + ("gt_img",)}
        loader = InferenceSequenceLoader(recording, dataset_config)
        kh, kw = loader.gt_resolution
        dev = self.device
        track = MetricTracker([
            "esr_l1", "esr_mse", "esr_ssim", "esr_psnr",
            "bicubic_l1", "bicubic_mse", "bicubic_ssim", "bicubic_psnr",
            "time", "params",
        ])
        track.update("params", _num_params(self.model))
        # state persists across the WHOLE recording
        states = self.model.init_states(1, kh, kw, device=dev)
        if self.compute_dtype is not None:
            states = tuple(z.to(self.compute_dtype) for z in states)
        ssim_samples: Dict[str, List[float]] = {"esr_ssim": [], "bicubic_ssim": []}
        # the metrics of window i are read back while window i+1 runs
        pending: deque = deque()

        def resolve(metrics: Dict[str, torch.Tensor]) -> None:
            for k, v in metrics.items():
                track.update(k, float(v))
                if k in ssim_samples:
                    ssim_samples[k].append(float(v))

        for i, batch in enumerate(loader):
            window = {k: v[:, : self.seqn] for k, v in batch.items()}  # inputs_seq[0]
            inp = torch.from_numpy(window["inp_scaled_cnt"]).to(dev)
            t0 = time.perf_counter()
            pred, states = self.forward(inp, states)
            # the metrics and the PNG views read f32, as at the f32 rung
            pred = pred.float()
            synchronize(dev)
            track.update("time", time.perf_counter() - t0)

            gt = torch.from_numpy(window["gt_cnt"][0, self.mid_idx]).to(dev)
            inp_cnt = torch.from_numpy(window["inp_cnt"][0, self.mid_idx]).to(dev)
            pred0 = pred[0]
            if tuple(pred0.shape[:2]) != (kh, kw):
                pred0 = interpolate(pred0, (kh, kw), "bicubic")
            bicubic = interpolate(inp_cnt, (kh, kw), "bicubic")
            pending.append(_metrics(pred0, bicubic, gt))
            if len(pending) > 1:
                resolve(pending.popleft())
            if img_dir is not None:
                _save_views(img_dir, i, window, self.mid_idx, pred0, bicubic, gt, inp_cnt)
        while pending:
            resolve(pending.popleft())

        result = track.result()
        _attach_rmse(result)
        _attach_ssim_window_stats(result, ssim_samples)
        return result


def _save_views(img_dir: str, i: int, window: Dict[str, np.ndarray], mid: int,
                pred, bicubic, gt, inp_cnt) -> None:
    """One window's PNGs, in the reference's layout and order."""
    views = {
        "lr_event_img": inp_cnt.cpu().numpy(),
        "hr_scaled_event_img": window["inp_scaled_cnt"][0, mid],
        "hr_esr_event_img": np.round(pred.cpu().numpy()),
        "hr_bicubic_event_img": bicubic.cpu().numpy(),
        "hr_gt_event_img": gt.cpu().numpy(),
    }
    for d, img in views.items():
        save_image(os.path.join(img_dir, "event_img", d, f"{i:09d}.png"), render_event_cnt(img))
    if "gt_img" in window:
        save_image(os.path.join(img_dir, "img", "gt_img", f"{i:09d}.png"),
                   render_frame(window["gt_img"][0, mid]))


def _attach_rmse(metrics: Dict[str, float]) -> None:
    """rmse = sqrt(aggregated mse), in place (not a mean of per-window sqrts)."""
    for side in ("esr", "bicubic"):
        if f"{side}_mse" in metrics:
            metrics[f"{side}_rmse"] = float(np.sqrt(metrics[f"{side}_mse"]))


def _attach_ssim_window_stats(result: Dict[str, float],
                              ssim_samples: Dict[str, List[float]]) -> None:
    """Window count + paired-SSIM-delta diagnostics, in place."""
    n_win = len(ssim_samples["esr_ssim"])
    result["n_windows"] = float(n_win)
    if n_win:
        delta = np.asarray(ssim_samples["esr_ssim"]) - np.asarray(ssim_samples["bicubic_ssim"])
        result["ssim_delta_mean"] = float(delta.mean())
        result["ssim_delta_pos_frac"] = float((delta > 0).mean())
        if n_win > 1:
            result["ssim_delta_std"] = float(delta.std(ddof=1))
            for k, vals in ssim_samples.items():
                result[f"{k}_std"] = float(np.std(vals, ddof=1))


def _write_recording_report(out_dir: str, data_path: str, dataset_config: Dict,
                            result: Dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with YamlLogger(os.path.join(out_dir, "inference.yml")) as yl:
        yl.log_info(f"inference on {data_path}")
        yl.log_dict(dataset_config, "eval_dataset_config")
        yl.log_dict(result, "evaluation results")


# window-level diagnostics: pooled by window count, not arithmetic-meaned
_WINDOW_DIAG_KEYS = frozenset({
    "n_windows", "esr_ssim_std", "bicubic_ssim_std",
    "ssim_delta_mean", "ssim_delta_std", "ssim_delta_pos_frac",
})


def aggregate_results(results: List[Dict[str, float]], names: List[str]):
    """Per-recording breakdown + datalist means; the paired SSIM delta is
    pooled over all windows from per-recording (mean, std, n)."""
    breakdown: Dict[str, Dict[str, float]] = defaultdict(dict)
    means: Dict[str, List[float]] = defaultdict(list)
    for name, entry in zip(names, results):
        for k, v in entry.items():
            breakdown[k][name] = v
            if k not in _WINDOW_DIAG_KEYS:
                means[k].append(v)
    agg = {k: float(np.mean(v)) for k, v in means.items()}
    _attach_rmse(agg)

    total_n = float(sum(r.get("n_windows", 0.0) for r in results))
    if total_n:
        agg["n_windows"] = total_n
        have = [r for r in results if r.get("n_windows") and "ssim_delta_mean" in r]
        if have:
            pooled_mean = sum(r["n_windows"] * r["ssim_delta_mean"] for r in have) / total_n
            agg["ssim_delta_mean"] = float(pooled_mean)
            agg["ssim_delta_pos_frac"] = float(sum(
                r["n_windows"] * r.get("ssim_delta_pos_frac", 0.0) for r in have
            ) / total_n)
            if total_n > 1:
                ss = sum(
                    (r["n_windows"] - 1) * r.get("ssim_delta_std", 0.0) ** 2
                    + r["n_windows"] * r["ssim_delta_mean"] ** 2
                    for r in have
                )
                var = (ss - total_n * pooled_mean ** 2) / (total_n - 1)
                agg["ssim_delta_std"] = float(np.sqrt(max(var, 0.0)))
    return dict(breakdown), agg


def run_inference(
    checkpoint_path: str,
    data_list: Sequence[str],
    output_path: str,
    dataset_config: Optional[Dict] = None,
    save_images: bool = False,
    lpips_backbone_npz: Optional[str] = None,
    allow_uncalibrated_lpips: bool = False,
    engine: Optional[bool] = None,
    precision: Optional[str] = None,
    device: DeviceLike = None,
    lanes: Optional[int] = None,
    chunk_windows: Optional[int] = None,
) -> Dict[str, float]:
    """Checkpoint -> model, datalist -> per-recording + mean reports under
    ``output_path``, through the sequential harness or the streaming engine
    (module docstring). Returns the datalist-mean metrics."""
    from esr_tpu_torch.inference.checkpoint import load_checkpoint

    if lpips_backbone_npz is not None or allow_uncalibrated_lpips:
        raise NotImplementedError("LPIPS is not ported yet (a later slice)")
    model, config = load_checkpoint(checkpoint_path)
    precision = resolve_precision(
        cli=precision, config=(config.get("trainer") or {}).get("precision"))
    inf_cfg = config.get("inference") or {}
    if engine is None:
        engine = bool(inf_cfg.get("engine", False))
    lanes = int(inf_cfg.get("lanes", 4) if lanes is None else lanes)
    chunk_windows = int(inf_cfg.get("chunk_windows", 8) if chunk_windows is None
                        else chunk_windows)
    if dataset_config is None:
        dataset_config = config["valid_dataloader"]["dataset"]
    seqn = int(dataset_config["sequence"].get("seqn", 3))
    ck_seqn = config["model"].get("args", {}).get("num_frame", 3)
    if ck_seqn != seqn:
        raise ValueError(f"checkpoint num_frame={ck_seqn} != dataloader seqn={seqn}")

    os.makedirs(output_path, exist_ok=True)
    if engine:
        if save_images:
            logger.warning("engine mode does not dump per-window images; "
                           "--save_images ignored (use sequential mode for PNGs)")
        from esr_tpu_torch.inference.engine import StreamingEngine

        eng = StreamingEngine(model, seqn, lanes=lanes, chunk_windows=chunk_windows,
                              precision=precision, device=device)
        results, names = eng.run_datalist(data_list, dataset_config)
        for result, name, data_path in zip(results, names, data_list):
            _write_recording_report(os.path.join(output_path, name), str(data_path),
                                    dataset_config, result)
    else:
        runner = InferenceRunner(model, seqn, device=device, precision=precision)
        results, names = [], []
        for data_path in data_list:
            name = recording_name(data_path)
            logger.info("processing %s", data_path)
            results.append(runner.run_recording(
                data_path, dataset_config, os.path.join(output_path, name),
                save_images=save_images,
            ))
            names.append(name)
    breakdown, mean = aggregate_results(results, names)
    with YamlLogger(os.path.join(output_path, "inference_all.yml")) as yl:
        yl.log_info(f"inference {checkpoint_path} on {list(data_list)}")
        yl.log_dict(breakdown, "breakdown results for each data")
        yl.log_dict(mean, "mean results for the whole data")
    return mean
