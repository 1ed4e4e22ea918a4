"""The training loop: iterations, validation, best-model
monitoring, early stop and checkpoints (counterpart of
``esr_tpu/training/trainer.py``, as the iteration-based loop and nothing
more).

- Each iteration runs one train step on one batch of ``batch_size``
  sequences (``training.train_step``); the loader turns its epoch over
  (``set_epoch``) when it runs out.
- Every ``train_log_step`` iterations the scalars (``train_loss``,
  ``train_mse_loss``, ``grad_norm``, ``lr``) go to the log and, one JSON
  object per line, to ``<log_dir>/train_log.jsonl``; running averages are
  kept in a ``MetricTracker``.
- The reference's metric writer (``utils.writer``) records every
  iteration's losses and ``steps_per_sec``, the learning rate every
  ``train_log_step`` iterations and the validation stamps, in
  ``<log_dir>/metrics.jsonl`` and, with ``tensorboard`` (on unless set
  false) and TensorBoard importable, in event files; with ``vis.enabled``
  every ``vis.train_img_writer_num``-th iteration renders the first
  sequence's middle window (LR, scaled and GT counts, the GT frame) and the
  prediction (``utils.vis_events``) to it. The views are built for that one
  sequence on the vis steps (the same window, seed and augmentation as the
  batch's), not for every sequence of every batch: the GT frame's resize
  alone costs about a batch build.
- ``device_rasterize`` (or the dataset's ``encode: device``, which wins;
  the two contradicting each other is an error, as in the reference): the
  loaders build fixed-capacity raw event windows and the batch is
  rasterized on the device (``training.train_step.make_device_rasterizer``),
  bitwise the host's count images.
- Every ``valid_step`` iterations a sequential pass over the validation
  loader (under ``torch.no_grad()``, so the DCN takes its forward kernel)
  gives ``valid_loss`` / ``valid_mse_loss``; ``monitor`` (``min
  valid_loss``) picks the best model and ``early_stop`` stops a run that
  stopped improving.
- Checkpoints every ``save_period``, on a new best, and at the end
  (``training.checkpoint``); ``-r <dir>|auto`` resumes, ``--reset``
  restarts the progress.

The trainer's config keys split three ways.

- Keys that only steer how XLA compiles or dispatches the reference's
  programs, and cannot change a number, are read and have these meanings
  here: ``k_steps`` (steps run one by one), ``train_lookahead`` (loss reads
  are deferred by at most this many steps; the port reads each step's
  scalars after it), ``compile_cache`` (nothing is compiled), and
  ``async_checkpoint`` (saves are synchronous), ``validate.fused`` /
  ``validate.chunk_windows`` (validation runs batch by batch),
  ``device_prefetch``, ``prefetch_join_timeout``, ``dispatch_retries``,
  ``prefetch_stall_timeout_s``, ``commit_retries`` / ``commit_backoff_s``
  (host->device copies are synchronous, nothing is retried) and
  ``telemetry`` (the port's scalars go to ``train_log.jsonl``).
- Keys that ask for what is not ported raise ``NotImplementedError`` naming
  the override that turns them off: ``precision`` bf16/int8, ``remat``,
  ``transfer_dtype`` bf16, ``numerics``, ``max_bad_steps``,
  ``live_telemetry``, ``profile`` / ``profile_steps``, and
  ``epoch_based_train``.
- The rest are the loop's own, above.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from esr_tpu_torch.config.build import build_model, build_optimizer, build_train_loader
from esr_tpu_torch.config.parser import RunConfig
from esr_tpu_torch.config.precision import resolve_precision
from esr_tpu_torch.data.loader import ConcatSequenceDataset
from esr_tpu_torch.device import DeviceLike, resolve_device
from esr_tpu_torch.training.checkpoint import (
    find_latest_checkpoint,
    resume_checkpoint,
    save_checkpoint,
)
from esr_tpu_torch.training.train_step import (
    make_device_rasterizer,
    make_eval_step,
    make_train_step,
)
from esr_tpu_torch.utils.trackers import MetricTracker
from esr_tpu_torch.utils.vis_events import render_event_cnt, render_frame
from esr_tpu_torch.utils.writer import MetricWriter

logger = logging.getLogger(__name__)

TRAIN_KEYS = ["inp_scaled_cnt", "gt_cnt"]
RAW_KEYS = ["inp_norm_events", "inp_events_valid", "gt_raw_events", "gt_events_valid"]
# what the visualizations read
VIS_KEYS = ["inp_cnt", "gt_img", "inp_scaled_cnt", "gt_cnt"]


def resolve_device_rasterize(config: Dict) -> bool:
    """``trainer.device_rasterize``, or the dataset's ``encode: host|device``
    when set, which is authoritative; the two contradicting each other is a
    config error (the reference's rule)."""
    explicit = config["trainer"].get("device_rasterize")
    encode = (config["train_dataloader"].get("dataset") or {}).get("encode")
    if encode not in (None, "host", "device"):
        raise ValueError(f"unknown dataset encode {encode!r} ('host' or 'device')")
    if encode is None:
        return bool(explicit)
    want = encode == "device"
    if explicit is not None and bool(explicit) != want:
        raise ValueError(f"dataset encode: {encode!r} contradicts "
                         f"trainer.device_rasterize: {explicit!r}")
    return want


def _refuse_unported(config: Dict) -> None:
    """Raise on trainer keys that ask for what the port does not do."""
    t = config["trainer"]
    precision = resolve_precision(config=t.get("precision"))
    if precision == "int8":
        # the reference's refusal (esr_tpu/training/trainer.py): training
        # needs float params and grads
        raise ValueError(
            "trainer.precision: int8 is not a training rung: int8 is post-training "
            "quantization for the inference and serving path (infer / serve "
            "--precision int8); train at f32")
    asks = []
    if precision != "f32":
        # bf16 training has no oracle while the reference's bf16 backward
        # seam is red (ROADMAP C3)
        asks.append(("precision", t["precision"], "trainer;precision=f32"))
    flags = [
        ("remat", t.get("remat", False), "trainer;remat=false"),
        ("numerics", t.get("numerics", False), "trainer;numerics=false"),
        ("profile.enabled", (t.get("profile") or {}).get("enabled", False),
         "trainer;profile;enabled=false"),
        ("profile_steps", t.get("profile_steps", 0), "trainer;profile_steps=0"),
        ("epoch_based_train.enabled", (t.get("epoch_based_train") or {}).get("enabled", False),
         "trainer;epoch_based_train;enabled=false"),
    ]
    asks += [(k, v, ov) for k, v, ov in flags if v]
    if t.get("transfer_dtype") not in (None, "f32", "auto"):
        asks.append(("transfer_dtype", t["transfer_dtype"], "trainer;transfer_dtype=f32"))
    if t.get("max_bad_steps") is not None:
        asks.append(("max_bad_steps", t["max_bad_steps"], "trainer;max_bad_steps=null"))
    live = t.get("live_telemetry")
    if live is not None and live is not False:  # 0 is a port, not off
        asks.append(("live_telemetry", live, "trainer;live_telemetry=false"))
    if asks:
        raise NotImplementedError(
            "not ported: " + "; ".join(
                f"trainer key {k}={v!r} (turn it off with -o \"{ov}\")" for k, v, ov in asks))


class Trainer:
    """``Trainer(run).train()``; ``device`` defaults to the card.
    ``train_recordings`` / ``valid_recordings`` (paths or in-memory
    recordings) replace the loaders' datalists when given."""

    def __init__(self, run: RunConfig, device: DeviceLike = None,
                 train_recordings: Optional[Sequence] = None,
                 valid_recordings: Optional[Sequence] = None):
        self.run = run
        config = run.config
        _refuse_unported(config)
        tcfg = config["trainer"]
        it_cfg = tcfg["iteration_based_train"]
        if not it_cfg.get("enabled", True):
            raise ValueError("iteration_based_train must be enabled")
        self.iterations = int(float(it_cfg["iterations"]))
        self.save_period = int(it_cfg.get("save_period", 10**9))
        self.train_log_step = int(it_cfg.get("train_log_step", 50))
        self.valid_step = int(it_cfg.get("valid_step", 1000))
        self.device = resolve_device(device)

        torch.manual_seed(run.seed)
        np.random.seed(run.seed)

        self.device_rasterize = resolve_device_rasterize(config)
        vis_cfg = tcfg.get("vis") or {}
        self.vis_enabled = bool(vis_cfg.get("enabled", False))
        self.train_vis_step = int(vis_cfg.get("train_img_writer_num", 20))
        self.tensorboard = bool(tcfg.get("tensorboard", True))
        stream_keys = RAW_KEYS if self.device_rasterize else TRAIN_KEYS

        def loader_cfg(block: Dict, keys) -> Dict:
            cfg = copy.deepcopy(block)
            cfg["dataset"].setdefault("item_keys", keys)
            cfg["dataset"].pop("encode", None)
            return cfg

        self.train_loader = build_train_loader(
            loader_cfg(config["train_dataloader"], stream_keys), seed=run.seed,
            recordings=train_recordings)
        self.valid_loader = None
        if config.get("valid_dataloader") is not None:
            self.valid_loader = build_train_loader(
                loader_cfg(config["valid_dataloader"], stream_keys), seed=run.seed,
                recordings=valid_recordings)
        self._rasterize = (make_device_rasterizer(self.train_loader.gt_resolution)
                           if self.device_rasterize else None)
        self.vis_dataset = None
        if self.vis_enabled:
            train_data = self.train_loader.dataset
            self.vis_dataset = ConcatSequenceDataset(
                train_data.recordings, {**train_data.config, "item_keys": VIS_KEYS})

        self.model = build_model(config["model"]).to(self.device)
        self.optimizer, self.schedule = build_optimizer(
            config["optimizer"], self.model.parameters(), config.get("lr_scheduler"),
            it_cfg.get("lr_change_rate"))
        self.seqn = int(config["train_dataloader"]["dataset"]["sequence"].get("seqn", 3))
        self.mid_idx = (self.seqn - 1) // 2
        self.train_step = make_train_step(self.model, self.optimizer, self.seqn)
        self.eval_step = make_eval_step(self.model, self.seqn)

        self.monitor = tcfg.get("monitor", "off")
        if self.monitor == "off":
            self.mnt_mode, self.mnt_metric, self.mnt_best = "off", None, 0.0
        else:
            self.mnt_mode, self.mnt_metric = self.monitor.split()
            if self.mnt_mode not in ("min", "max"):
                raise ValueError(f"monitor mode must be min or max, got {self.mnt_mode!r}")
            self.mnt_best = math.inf if self.mnt_mode == "min" else -math.inf
        self.early_stop = int(float(tcfg.get("early_stop", 10**9)))
        self.not_improved_count = 0
        self.train_metrics = MetricTracker(["train_mse_loss", "train_loss"])
        self.valid_metrics = MetricTracker(["valid_mse_loss", "valid_loss"])
        self.log_path = os.path.join(run.log_dir, "train_log.jsonl")
        # opened by train(), closed when it returns
        self.writer: Optional[MetricWriter] = None

        self.start_iteration = 0
        resume_path = run.resume
        if resume_path == "auto":
            resume_path = find_latest_checkpoint(os.path.dirname(run.save_dir))
            if resume_path is None:
                logger.info("auto-resume: no checkpoint found; fresh start")
        if resume_path is not None:
            self.start_iteration, best = resume_checkpoint(
                resume_path, self.model, self.optimizer, config, reset=run.reset)
            if best is not None:
                self.mnt_best = best

    def _select(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The streams the step reads, on the device (rasterized there from
        the raw event windows under ``device_rasterize``)."""
        if self._rasterize is not None:
            return self._rasterize({
                name: torch.from_numpy(batch[key]).to(self.device)
                for name, key in (("inp_events", "inp_norm_events"),
                                  ("inp_valid", "inp_events_valid"),
                                  ("gt_events", "gt_raw_events"),
                                  ("gt_valid", "gt_events_valid"))})
        return {"inp": torch.from_numpy(batch["inp_scaled_cnt"]).to(self.device),
                "gt": torch.from_numpy(batch["gt_cnt"]).to(self.device)}

    def _log_images(self, n: int, pred: np.ndarray) -> None:
        """The middle window of the first sequence of the epoch's ``n``-th
        batch: LR, scaled and GT counts, the prediction and the GT frame,
        rendered to the writer."""
        index, seed = self.train_loader.first_sequence(n)
        views = self.vis_dataset.get_item(index, seed=seed)[self.mid_idx]
        self.writer.add_image("train_inp_events_cnt", render_event_cnt(views["inp_cnt"]))
        self.writer.add_image("train_inp_scaled_events_cnt",
                              render_event_cnt(views["inp_scaled_cnt"]))
        self.writer.add_image("train_esr_events_cnt", render_event_cnt(np.round(pred)))
        self.writer.add_image("train_gt_events_cnt", render_event_cnt(views["gt_cnt"]))
        self.writer.add_image("train_gt_frame", render_frame(views["gt_img"]))

    def _log(self, record: Dict) -> None:
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _valid(self) -> Dict[str, float]:
        """A sequential pass over the validation loader."""
        self.valid_metrics.reset()
        for batch in self.valid_loader:
            out = self.eval_step(self._select(batch))
            self.valid_metrics.update("valid_loss", float(out["valid_loss"]))
            self.valid_metrics.update("valid_mse_loss", float(out["valid_mse_loss"]))
        return self.valid_metrics.result()

    def eval_model_performance(self, log: Dict[str, float]):
        """``(stop_training, best)`` from the monitored metric."""
        best = False
        stop = False
        if self.mnt_mode != "off":
            if self.mnt_metric not in log:
                logger.warning("Metric %r not found; ignoring this stamp.", self.mnt_metric)
            else:
                value = log[self.mnt_metric]
                improved = (value <= self.mnt_best if self.mnt_mode == "min"
                            else value >= self.mnt_best)
                if improved:
                    self.mnt_best = value
                    self.not_improved_count = 0
                    best = True
                else:
                    self.not_improved_count += 1
            if self.not_improved_count > self.early_stop:
                logger.info("Validation did not improve for %d stamps; stopping.",
                            self.early_stop)
                stop = True
        return stop, best

    def _save(self, iteration: int, best: bool) -> None:
        save_checkpoint(self.run.save_dir, self.model, self.optimizer, self.run.config,
                        iteration, self.mnt_best, save_best=best)

    def train(self) -> Dict[str, float]:
        """Run to ``iterations`` (or early stop); returns the final train
        log (running averages of ``train_loss`` / ``train_mse_loss``)."""
        if self.start_iteration >= self.iterations:
            logger.info("Run already complete (resumed at iteration %d of %d); "
                        "nothing to train.", self.start_iteration, self.iterations)
            return {}
        self.writer = MetricWriter(self.run.log_dir, logger, enable_tensorboard=self.tensorboard)
        self.train_metrics = MetricTracker(["train_mse_loss", "train_loss"], writer=self.writer)
        try:
            return self._train_loop()
        finally:
            self.writer.close()
            self.writer = self.train_metrics.writer = None
            for loader in (self.train_loader, self.valid_loader):
                if loader is not None:
                    loader.close()

    def _train_loop(self) -> Dict[str, float]:
        it = self.start_iteration
        epoch = 0
        valid_stamp = 1
        stop = False
        logger.info("Training: %d iterations, %d batches/epoch, on %s",
                    self.iterations, len(self.train_loader), self.device)
        while not stop:
            self.train_loader.set_epoch(epoch)
            n_batches = 0
            for batch in self.train_loader:
                n_batches += 1
                lr = self.optimizer.lr
                t0 = time.perf_counter()
                metrics = self.train_step(self._select(batch))
                loss = float(metrics["loss"])
                mse = float(metrics["loss_per_window"][-1])
                self.writer.set_step(it)
                self.train_metrics.update("train_mse_loss", mse)
                self.train_metrics.update("train_loss", loss)
                if it % self.train_log_step == 0:
                    self.writer.add_scalar("learning_rate", lr)
                    grad_norm = float(metrics["grad_norm"])
                    logger.info("Train Epoch: %d Iteration: %d/%d train_mse_loss: %.4e "
                                "train_loss: %.4e lr: %.4e", epoch + 1, it,
                                self.iterations, mse, loss, lr)
                    self._log({"iteration": it, "epoch": epoch, "train_loss": loss,
                               "train_mse_loss": mse, "grad_norm": grad_norm, "lr": lr,
                               "step_seconds": time.perf_counter() - t0})
                if self.vis_enabled and it % self.train_vis_step == 0:
                    self._log_images(n_batches - 1, metrics["last_pred"][0].cpu().numpy())
                best = False
                if self.valid_loader is not None and it % self.valid_step == 0 and it != 0:
                    val_log = self._valid()
                    logger.info("Valid stamp %d: %s", valid_stamp,
                                {k: round(v, 6) for k, v in val_log.items()})
                    self._log({"iteration": it, "valid_stamp": valid_stamp, **val_log})
                    for k, v in val_log.items():
                        self.writer.add_scalar(f"stamp_{k}", v, step=valid_stamp)
                    stop, best = self.eval_model_performance(val_log)
                    valid_stamp += 1
                    if stop:
                        break
                saved = (it % self.save_period == 0 and it != 0) or best
                if saved:
                    self._save(it, best)
                if it + 1 >= self.iterations:
                    logger.info("Training completes!")
                    if not saved:
                        self._save(it, False)
                    stop = True
                    break
                it += 1
            if n_batches == 0:
                raise ValueError("the train loader yields no batch: too few sequences "
                                 "for batch_size with drop_last")
            epoch += 1
        return self.train_metrics.result()
