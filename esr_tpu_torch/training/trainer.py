"""The training loop: iterations, validation, best-model monitoring,
early stop, checkpoints, and the runtime around them (counterpart of
``esr_tpu/training/trainer.py``, as the iteration-based loop).

- Each iteration runs one train step on one batch of ``batch_size``
  sequences (``training.train_step``); the loader turns its epoch over
  (``set_epoch``) when it runs out. The batches come in groups of
  ``k_steps`` (``data.loader.group_batches``; the epoch's tail is a shorter
  group), the reference's super-steps: a group's steps run one by one, and
  every cadence below is taken on the group. ``device_prefetch`` (default
  2) stages that many batches ahead on a ``DevicePrefetcher`` thread (0
  stages in the loop), one batch at a time whatever ``k_steps`` is.
- The group's scalars (losses, grad norms and, with ``numerics``, the
  probe stats) come to the host in one copy after its last step. Every
  ``train_log_step`` iterations they go to the log and to
  ``<log_dir>/train_log.jsonl`` (``step_seconds`` is the group's mean);
  running averages are kept in a ``MetricTracker``.
- The metric writer (``utils.writer``) records every iteration's losses
  and ``steps_per_sec``, the learning rate every ``train_log_step``
  iterations and the validation stamps, in ``<log_dir>/metrics.jsonl``
  and, with ``tensorboard`` (on unless set false) and TensorBoard
  importable, in event files; with ``vis.enabled`` a group that covers a
  ``vis.train_img_writer_num``-th iteration renders the first sequence of
  its last batch (middle window) and the group's last prediction
  (``utils.vis_events``).
- ``telemetry`` (on unless set false): a ``TelemetrySink`` at
  ``<log_dir>/telemetry.jsonl``, active for the length of ``train()``: the
  writer's and trackers' scalars, one ``attribution`` record per logged
  group (``obs.spans``: ``data_wait``, ``stage_megabatch``, ``dispatch``,
  ``device_step``, ``metric_readback``, ``checkpoint``, ``validate``,
  ``residual``) under a ``train_run`` trace, the prefetcher's health,
  fault and recovery events and ``train_end``. ``python -m
  esr_tpu_torch.obs report`` (or ``esr_tpu.obs``) reads it.
- ``live_telemetry`` (needs the sink): ``true`` or a port (0 an ephemeral
  one) or ``{port, slo, windows, rel_err, watermark_interval_s}`` serves
  ``/metrics``, ``/healthz``, ``/slo`` and ``/snapshot`` during the run
  and polls the card's memory into gauges (``obs.device.DeviceWatermark``).
- ``profile.enabled`` records the whole loop with ``torch.profiler``;
  ``profile_steps: N`` (``train.py --profile-steps``) only the first N
  steps, stamped as a ``profiler_capture`` event; both write Chrome traces
  to ``profile.trace_dir`` (default ``<log_dir>/profile``), and asking for
  both is an error.
- ``numerics``: the model's probe taps and the step's ``loss`` /
  ``grad_norm`` taps (``ops.numerics``), merged over the group, one
  ``numerics`` record per tag at the ``train_log_step`` cadence (stamped
  with the group's last iteration); they change no number.
- ``max_bad_steps`` (null: off) arms the anomaly guard
  (``resilience.recovery.AnomalyGuard``): a group with a non-finite loss is
  skipped, all its iterations (kept out of the trackers), and logged; after
  more than ``max_bad_steps`` bad groups in a row the trainer restores the
  last valid committed checkpoint (``restore_with_fallback``; the run-start
  state when none exists), fast-forwards the ``(seed, epoch)``-deterministic
  loader to it and replays, at most ``max_rollbacks`` times (default 2).
  The guard checks each group, as the reference checks each super-step.
- ``dispatch_retries`` (default 1) retries a failing step call,
  ``commit_retries`` / ``commit_backoff_s`` (2, 0.1 s) a failing
  checkpoint commit, and ``prefetch_stall_timeout_s`` arms the
  prefetcher's stall watchdog. The fault plane's ``train_step``,
  ``ckpt_commit`` and ``prefetch`` sites fire here (``resilience.faults``);
  ``train_step`` is keyed by the group's first iteration, and its
  ``dispatch_error`` raises at the group's first step.
- ``remat`` recomputes each window's forward in the backward
  (``torch.utils.checkpoint``): the same bits, less memory.
- ``transfer_dtype: bf16`` rounds the train batches to bf16 on the host
  and ships them as bf16 (widened to f32 on the card); validation stays
  f32; ``auto`` follows the precision rung (f32 here); it contradicts
  ``device_rasterize``.
- ``device_rasterize`` (or the dataset's ``encode: device``, which wins;
  the two contradicting each other is an error, as in the reference): the
  loaders build fixed-capacity raw event windows and the batch is
  rasterized on the device (``training.train_step.make_device_rasterizer``),
  bitwise the host's count images.
- After a group that covers a multiple of ``valid_step`` (not 0), a
  sequential pass over the validation loader (under ``torch.no_grad()``,
  so the DCN takes its forward kernel) gives ``valid_loss`` /
  ``valid_mse_loss``, logged with the group's last iteration; ``monitor``
  (``min valid_loss``) picks the best model and ``early_stop`` stops a run
  that stopped improving.
- Checkpoints after a group that covers a multiple of ``save_period``, on
  a new best, and at the end (``training.checkpoint``), each stamped with
  the group's last iteration: when ``iterations`` is not a multiple of
  ``k_steps`` the last group trains past it, and the final checkpoint
  records the true last iteration, as the reference's does. ``-r <dir>``
  resumes, ``-r auto`` resumes the newest committed checkpoint that
  validates (``restore_with_fallback``), ``--reset`` restarts the
  progress; a resume, like a rollback, starts at a group boundary.
- ``async_checkpoint`` (the flagship sets it): a save blocks only for the
  snapshot of the state to host memory (the ``checkpoint_snapshot`` span);
  the commit runs on a ``ckpt-commit`` writer thread
  (``training.async_checkpoint``, the ``checkpoint_commit`` span), one at
  a time. Barriers join it before the next snapshot, before a rollback's
  restore, after the final save (a failed commit fails the run there) and
  first in ``train()``'s teardown. The run-start rollback snapshot is
  freed once a commit has landed. Off, each save commits inline.

``k_steps`` changes numbers only through those cadences: the reference
runs a group as one compiled scan, the port runs its steps one by one (a
CUDA graph of the group is later work), so the losses are those of
``k_steps: 1``. Keys that only steer how XLA compiles or dispatches the
reference's programs, and cannot change a number, are read and mean here:
``train_lookahead`` (the port reads each group's scalars after it),
``compile_cache`` (nothing is compiled), ``validate.fused`` /
``validate.chunk_windows`` (validation runs batch by batch).

Refused: ``precision: bf16`` raises ``NotImplementedError`` naming the
override that turns it off (bf16 training has no oracle while the
reference's bf16 backward is red), ``precision: int8`` and
``epoch_based_train`` raise the reference's ``ValueError``.
"""

from __future__ import annotations

import contextlib
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
from esr_tpu_torch.data.loader import ConcatSequenceDataset, DevicePrefetcher, group_batches
from esr_tpu_torch.device import DeviceLike, resolve_device
from esr_tpu_torch.models import convert
from esr_tpu_torch.obs import trace
from esr_tpu_torch.obs.numerics import (
    NSTATS,
    merge_readback,
    order_tags,
    poison_tag,
    stats_fields,
)
from esr_tpu_torch.obs.spans import StepAttribution, instrument_dispatch
from esr_tpu_torch.resilience import faults as _faults
from esr_tpu_torch.resilience.recovery import (
    AnomalyGuard,
    RollbackSignal,
    emit_recovery,
    restore_with_fallback,
    retry_with_backoff,
)
from esr_tpu_torch.training.async_checkpoint import AsyncCheckpointer
from esr_tpu_torch.training.checkpoint import resume_checkpoint, save_checkpoint, snapshot_state
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

_END = object()


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
    """Raise on trainer keys the port refuses: the reference's
    ``ValueError`` for ``epoch_based_train`` and the int8 rung, and
    ``NotImplementedError`` for bf16 training."""
    t = config["trainer"]
    if (t.get("epoch_based_train") or {}).get("enabled", False):
        raise ValueError("epoch_based_train is not supported (legacy/broken in the "
                         "reference — SURVEY.md §2.1); use iteration_based_train")
    precision = resolve_precision(config=t.get("precision"))
    if precision == "int8":
        # the reference's refusal: training needs float params and grads
        raise ValueError(
            "trainer.precision: int8 is not a training rung: int8 is post-training "
            "quantization for the inference and serving path (infer / serve "
            "--precision int8); train at f32")
    if precision != "f32":
        # bf16 training has no oracle while the reference's bf16 backward
        # seam is red (ROADMAP C3)
        raise NotImplementedError(
            f"not ported: trainer key precision={t['precision']!r} (turn it off with "
            "-o \"trainer;precision=f32\")")


def _fast_forward_groups(source, n_iters: int):
    """The deterministic data fast-forward after a rollback: drop the
    epoch's leading groups covering ``n_iters`` trained iterations, so the
    replay sees the batches a fault-free run sees (the sampler and the
    augmentation seeds are ``(seed, epoch)``-deterministic)."""
    skipped = 0
    for group in source:
        if skipped < n_iters:
            skipped += len(group)
            if skipped > n_iters:
                logger.warning("rollback fast-forward overshot the checkpoint boundary "
                               "(%d skipped, %d targeted); resuming at the group boundary",
                               skipped, n_iters)
            continue
        yield group


def _group_items(groups):
    """Each batch of each group, in order, as ``(its place in the group, the
    group's length, the batch)``."""
    for group in groups:
        for j, batch in enumerate(group):
            yield j, len(group), batch


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

        # the reference's knobs that only steer XLA; read and range-checked
        self.k_steps = int(tcfg.get("k_steps", 1))
        if self.k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {self.k_steps}")
        self.train_lookahead = int(tcfg.get("train_lookahead", 2))
        if self.train_lookahead < 0:
            raise ValueError(f"train_lookahead must be >= 0, got {self.train_lookahead}")

        # resilience knobs
        self.max_bad_steps = tcfg.get("max_bad_steps", None)
        self._guard = (AnomalyGuard(int(self.max_bad_steps))
                       if self.max_bad_steps is not None else None)
        self.max_rollbacks = int(tcfg.get("max_rollbacks", 2))
        self.dispatch_retries = int(tcfg.get("dispatch_retries", 1))
        if self.dispatch_retries < 0:
            raise ValueError(f"dispatch_retries must be >= 0, got {self.dispatch_retries}")
        self.commit_retries = int(tcfg.get("commit_retries", 2))
        if self.commit_retries < 0:
            raise ValueError(f"commit_retries must be >= 0, got {self.commit_retries}")
        self.commit_backoff_s = float(tcfg.get("commit_backoff_s", 0.1))
        if self.commit_backoff_s <= 0:
            raise ValueError(f"commit_backoff_s must be > 0, got {self.commit_backoff_s}")
        self._async_ckpt = (AsyncCheckpointer(self.commit_retries, self.commit_backoff_s)
                            if bool(tcfg.get("async_checkpoint", False)) else None)
        self.prefetch_stall_timeout = tcfg.get("prefetch_stall_timeout_s", None)
        self.device_prefetch = int(tcfg.get("device_prefetch", 2))
        if self.device_prefetch < 0:
            raise ValueError(f"device_prefetch must be >= 0, got {self.device_prefetch}")
        self.prefetch_join_timeout = float(tcfg.get("prefetch_join_timeout", 5.0))
        if self.prefetch_join_timeout <= 0:
            raise ValueError(f"prefetch_join_timeout must be > 0, got "
                             f"{self.prefetch_join_timeout}")

        torch.manual_seed(run.seed)
        np.random.seed(run.seed)

        self.device_rasterize = resolve_device_rasterize(config)
        transfer = tcfg.get("transfer_dtype", None)
        if transfer not in (None, "f32", "bf16", "auto"):
            raise ValueError(f"unknown transfer_dtype {transfer!r}")
        if transfer == "auto":
            # follows the precision rung, which is f32 for training here
            transfer = "bf16" if resolve_precision(config=tcfg.get("precision")) == "bf16" \
                else "f32"
        self.transfer_dtype = torch.bfloat16 if transfer == "bf16" else None
        if self.transfer_dtype is not None and self.device_rasterize:
            raise ValueError("transfer_dtype=bf16 only applies to the count-map streams; "
                             "device_rasterize already ships compact integer event windows "
                             "— drop one of the two options")
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

        self.numerics = bool(tcfg.get("numerics", False))
        model_cfg = config["model"]
        if self.numerics:
            model_cfg = copy.deepcopy(model_cfg)
            model_cfg["args"] = {**(model_cfg.get("args") or {}), "numerics": True}
        self.model = build_model(model_cfg).to(self.device)
        self.optimizer, self.schedule = build_optimizer(
            config["optimizer"], self.model.parameters(), config.get("lr_scheduler"),
            it_cfg.get("lr_change_rate"))
        self.seqn = int(config["train_dataloader"]["dataset"]["sequence"].get("seqn", 3))
        self.mid_idx = (self.seqn - 1) // 2
        self.remat = bool(tcfg.get("remat", False))
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

        # the telemetry sink; train() activates it and its finally closes it
        self.sink = None
        if bool(tcfg.get("telemetry", True)):
            from esr_tpu_torch.obs import TelemetrySink, config_fingerprint, run_manifest

            self.sink = TelemetrySink(
                os.path.join(run.log_dir, "telemetry.jsonl"),
                manifest=run_manifest(config_fingerprint=config_fingerprint(config)))
        lt = tcfg.get("live_telemetry", False)
        self.live_cfg = None
        # identity checks: live_telemetry: 0 is an ephemeral port, not off
        if lt is not False and lt is not None:
            if self.sink is None:
                raise ValueError("trainer.live_telemetry requires trainer.telemetry (the live "
                                 "plane taps the JSONL sink's record stream)")
            if lt is True:
                lt = {}
            elif isinstance(lt, int) and not isinstance(lt, bool):
                lt = {"port": int(lt)}
            elif not isinstance(lt, dict):
                raise ValueError(f"trainer.live_telemetry must be bool, port int, or a "
                                 f"mapping, got {lt!r}")
            self.live_cfg = {
                "port": int(lt.get("port", 0)),
                "slo": lt.get("slo"),
                "windows": tuple(lt.get("windows", (60.0, 300.0))),
                "rel_err": float(lt.get("rel_err", 0.01)),
                "watermark_interval_s": float(lt.get("watermark_interval_s", 1.0)),
            }
        self.live_plane = None
        # False, not None, when telemetry is off: None would fall back to the
        # process-active sink of some other run
        self._own_sink = self.sink if self.sink is not None else False
        self.train_metrics = MetricTracker(["train_mse_loss", "train_loss"], sink=False)
        self.valid_metrics = MetricTracker(["valid_mse_loss", "valid_loss"],
                                           sink=self._own_sink)
        self.log_path = os.path.join(run.log_dir, "train_log.jsonl")
        # opened by train(), closed when it returns
        self.writer: Optional[MetricWriter] = None

        b = int(config["train_dataloader"]["batch_size"])
        self._attr = StepAttribution(sink=self.sink, batch_size=b, log_step=self.train_log_step)
        self._stage_spans: Dict[int, float] = {}
        self.train_step = instrument_dispatch(
            make_train_step(self.model, self.optimizer, self.seqn, remat=self.remat,
                            numerics=self.numerics), self._attr)

        self.profile_cfg = tcfg.get("profile") or {}
        self.profile_steps = int(tcfg.get("profile_steps", 0) or 0)
        if self.profile_steps < 0:
            raise ValueError(f"profile_steps must be >= 0, got {self.profile_steps}")
        if self.profile_steps and self.profile_cfg.get("enabled", False):
            raise ValueError("trainer.profile_steps and trainer.profile.enabled are mutually "
                             "exclusive (one profiler trace at a time)")
        self.trace_dir = (self.profile_cfg.get("trace_dir")
                          or os.path.join(run.log_dir, "profile"))

        self.start_iteration = 0
        resume_path = run.resume
        if resume_path == "auto":
            # the newest committed checkpoint that validates, falling back
            # past a torn or corrupted one
            self.start_iteration, best, found = restore_with_fallback(
                os.path.dirname(run.save_dir), self.model, self.optimizer, config,
                reset=run.reset)
            if found is None:
                logger.info("auto-resume: no checkpoint found; fresh start")
            elif best is not None:
                self.mnt_best = best
        elif resume_path is not None:
            self.start_iteration, best = resume_checkpoint(
                resume_path, self.model, self.optimizer, config, reset=run.reset)
            if best is not None:
                self.mnt_best = best
        # the rollback target of last resort (no committed checkpoint yet)
        self._init_state = (snapshot_state(self.model, self.optimizer)
                            if self._guard is not None else None)

    # -- batches -------------------------------------------------------------

    def _host_select(self, batch: Dict[str, np.ndarray], for_train: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """The streams the step reads, as host tensors: the raw event
        windows under ``device_rasterize``; else the count images, rounded
        to bf16 for a train batch under ``transfer_dtype: bf16``."""
        if self.device_rasterize:
            return {name: torch.from_numpy(batch[key])
                    for name, key in (("inp_events", "inp_norm_events"),
                                      ("inp_valid", "inp_events_valid"),
                                      ("gt_events", "gt_raw_events"),
                                      ("gt_valid", "gt_events_valid"))}
        sel = {"inp": torch.from_numpy(batch["inp_scaled_cnt"]),
               "gt": torch.from_numpy(batch["gt_cnt"])}
        if for_train and self.transfer_dtype is not None:
            sel = {k: v.to(self.transfer_dtype) for k, v in sel.items()}
        return sel

    def _stage(self, batch: Dict[str, np.ndarray], for_train: bool = False) -> Dict:
        """The host->device copy of a batch's streams (a bf16 transfer is
        widened to f32 on the card)."""
        return {k: v.to(self.device).float() if v.dtype == torch.bfloat16 else v.to(self.device)
                for k, v in self._host_select(batch, for_train).items()}

    def _finish(self, staged: Dict) -> Dict[str, torch.Tensor]:
        """A staged batch as the step's dense ``{"inp", "gt"}``."""
        return self._rasterize(staged) if self._rasterize is not None else staged

    def _select(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The dense batch the step reads, on the device (f32; rasterized
        there from the raw event windows under ``device_rasterize``)."""
        return self._finish(self._stage(batch))

    def _stage_item_timed(self, item) -> Dict:
        """The host->device copy of a :func:`_group_items` item's batch on
        the prefetcher's thread, its time parked for the step that consumes
        it (an overlapped span)."""
        t0 = time.monotonic()
        staged = self._stage(item[2], for_train=True)
        self._stage_spans[id(item)] = time.monotonic() - t0
        return staged

    def _take_staged(self, item, staged) -> Dict:
        """An item's staged batch: the prefetcher's (its time added as an
        overlapped span), else staged now."""
        if staged is None:
            with self._attr.measure("stage_megabatch"):
                return self._stage(item[2], for_train=True)
        self._attr.add("stage_megabatch", self._stage_spans.pop(id(item), 0.0),
                       overlapped=True)
        return staged

    def _readback(self, metrics: Sequence[Dict]) -> list:
        """The group's scalars and probe stats, one dict a step, stacked on
        the device and brought to the host in one copy."""
        tags = order_tags(metrics[0]["numerics"]) if "numerics" in metrics[0] else []
        parts, sizes = [], []
        for m in metrics:
            per_window = m["loss_per_window"].reshape(-1)
            parts += [m["loss"].reshape(1), m["grad_norm"].reshape(1), per_window]
            parts += [m["numerics"][t].reshape(-1) for t in tags]
            sizes.append(per_window.numel())
        host = torch.cat(parts).cpu().numpy()
        out, off = [], 0
        for nw in sizes:
            step = {"loss": float(host[off]), "grad_norm": float(host[off + 1]),
                    "loss_per_window": host[off + 2:off + 2 + nw]}
            off += 2 + nw
            if tags:
                step["numerics"] = {t: host[off + i * NSTATS: off + (i + 1) * NSTATS]
                                    for i, t in enumerate(tags)}
                off += len(tags) * NSTATS
            out.append(step)
        return out

    # -- logging -------------------------------------------------------------

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
        """A sequential pass over the validation loader (f32 batches)."""
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

    # -- resilience ----------------------------------------------------------

    def _save(self, iteration: int, best: bool) -> None:
        """A checkpoint: with ``async_checkpoint`` the snapshot here (the
        ``checkpoint_snapshot`` span) and the commit on the writer; else the
        commit inline. Either commit is retried ``commit_retries`` times
        (``recovery_ckpt_retry``)."""
        if self._async_ckpt is not None:
            snap_s = self._async_ckpt.save(self.run.save_dir, self.model, self.optimizer,
                                           self.run.config, iteration, self.mnt_best,
                                           save_best=best)
            if self.sink is not None:
                self.sink.span("checkpoint_snapshot", snap_s, iteration=int(iteration),
                               best=bool(best))
        else:
            retry_with_backoff(
                lambda: save_checkpoint(self.run.save_dir, self.model, self.optimizer,
                                        self.run.config, iteration, self.mnt_best,
                                        save_best=best),
                retries=self.commit_retries, backoff_s=self.commit_backoff_s,
                site="ckpt_commit", event="recovery_ckpt_retry", iteration=iteration)
        # once a commit has landed the run-start snapshot is dead weight
        if self._async_ckpt is None or self._async_ckpt.commits > 0:
            self._init_state = None

    def _dispatch(self, fn, batch, err_specs=()):
        """The step call, retried ``dispatch_retries`` times with the same
        batch (``recovery_dispatch_retry``); an injected ``dispatch_error``
        raises before the step runs."""
        if not err_specs and self.dispatch_retries == 0:
            return fn(batch)
        err = list(err_specs)

        def attempt():
            if err:
                raise _faults.InjectedFault(err.pop(0))
            return fn(batch)

        return retry_with_backoff(attempt, retries=self.dispatch_retries, backoff_s=0.05,
                                  site="train_step", event="recovery_dispatch_retry")

    def _perform_rollback(self, rb: RollbackSignal) -> int:
        """Restore the last valid committed checkpoint (or the run-start
        state) after the guard spent its bad-step budget; returns the
        iteration to replay from. ``max_rollbacks`` bounds the loop."""
        if self._guard.rollbacks > self.max_rollbacks:
            raise RuntimeError(f"anomaly guard rolled back {self._guard.rollbacks} times "
                               f"(budget {self.max_rollbacks}); training diverges "
                               "deterministically — refusing to loop") from rb
        if self._async_ckpt is not None:
            # a failed commit is no error here: the restore falls back past it
            self._async_ckpt.wait(raise_error=False)
        start_iter, best, path = restore_with_fallback(
            self.run.save_dir, self.model, self.optimizer, self.run.config)
        if path is None:
            if self._init_state is None:
                raise RuntimeError("rollback requested but no committed checkpoint and no "
                                   "run-start snapshot exists") from rb
            params, opt_state = self._init_state
            convert.load_flax_params(self.model, params)
            self.optimizer.load_state_dict(opt_state)
            start_iter, best = self.start_iteration, None
        if best is not None:
            self.mnt_best = best
        self.not_improved_count = 0
        self._guard.consecutive_bad = 0
        emit_recovery("recovery_rollback", site="train_step", fault_id=rb.fault_id,
                      from_iteration=rb.at_iteration, to_iteration=start_iter,
                      bad_steps=rb.bad_steps, checkpoint=path, bad_tag=rb.bad_tag)
        logger.warning("rolled back to iteration %d (checkpoint %s) after %d consecutive bad "
                       "super-steps (first offending tag: %s); replaying deterministically",
                       start_iter, path, rb.bad_steps, rb.bad_tag)
        return start_iter

    # -- the loop ------------------------------------------------------------

    def train(self) -> Dict[str, float]:
        """Run to ``iterations`` (or early stop); returns the final train
        log (running averages of ``train_loss`` / ``train_mse_loss``)."""
        if self.start_iteration >= self.iterations:
            logger.info("Run already complete (resumed at iteration %d of %d); "
                        "nothing to train.", self.start_iteration, self.iterations)
            if self.sink is not None:
                self.sink.close()
            for loader in (self.train_loader, self.valid_loader):
                if loader is not None:
                    loader.close()
            return {}
        if len(self.train_loader) == 0:
            raise ValueError("the train loader yields no batch: too few sequences "
                             "for batch_size with drop_last")
        from esr_tpu_torch.obs import active_sink, set_active_sink
        from esr_tpu_torch.obs.device import (
            DeviceWatermark,
            ProfilerCapture,
            start_trace,
            stop_trace,
        )

        self.writer = MetricWriter(self.run.log_dir, logger,
                                   enable_tensorboard=self.tensorboard, sink=self._own_sink)
        self.train_metrics = MetricTracker(["train_mse_loss", "train_loss"],
                                           writer=self.writer, sink=self._own_sink)
        cuda = self.device.type == "cuda"
        progress = {"iteration": self.start_iteration, "epoch": 0}
        completed = False
        run_span = live_watermark = profiler = whole_run = None
        try:
            if self.sink is not None:
                # inside the try, so the finally always deactivates it
                set_active_sink(self.sink)
                run_span = trace.begin("train_run", sink=self.sink, iterations=self.iterations,
                                       start_iteration=self.start_iteration,
                                       k_steps=self.k_steps)
                if self.live_cfg is not None:
                    from esr_tpu_torch.obs.http import start_live_plane

                    self.live_plane = start_live_plane(
                        self.sink, port=self.live_cfg["port"], slo_path=self.live_cfg["slo"],
                        windows=self.live_cfg["windows"], rel_err=self.live_cfg["rel_err"])
                    self.sink.event("live_telemetry", port=self.live_plane.port,
                                    slo=self.live_cfg["slo"])
                    live_watermark = DeviceWatermark(
                        sink=self.sink, interval_s=self.live_cfg["watermark_interval_s"],
                        device_index=self.device.index or 0).start()
            if self.profile_cfg.get("enabled", False):
                whole_run = start_trace(cuda)
            if self.profile_steps:
                profiler = ProfilerCapture(self.trace_dir, self.profile_steps, sink=self.sink,
                                           site="train", cuda=cuda)
                profiler.maybe_start()
            result = self._train_loop(progress, profiler)
            if self._async_ckpt is not None:
                # the final commit: a failed one fails the run here
                self._async_ckpt.wait()
            completed = True
            return result
        finally:
            if self._async_ckpt is not None:
                # no commit outlives the run or writes after the sink closes;
                # logged, not raised: the exception on its way owns the run
                self._async_ckpt.wait(raise_error=False)
            self._stage_spans.clear()
            if whole_run is not None:
                stop_trace(whole_run, self.trace_dir, "train")
            if profiler is not None:
                profiler.stop()
            if live_watermark is not None:
                live_watermark.stop()
            if self.live_plane is not None:
                self.live_plane.close()
                self.live_plane = None
            self.writer.close()
            self.writer = self.train_metrics.writer = None
            for loader in (self.train_loader, self.valid_loader):
                if loader is not None:
                    loader.close()
            if self.sink is not None:
                link = {}
                if run_span is not None:
                    # train_end stays the stream's last record
                    link = {"trace_id": run_span.trace_id, "parent_id": run_span.span_id}
                    run_span.end(completed=completed)
                self.sink.event("train_end", iterations=progress["iteration"],
                                epochs=progress["epoch"],
                                attribution_records=self._attr.emitted_records,
                                completed=completed, **link)
                if active_sink() is self.sink:
                    set_active_sink(None)
                self.sink.close()

    def _consume(self, first: int, epoch: int, n: int, lrs: Sequence[float], t0: float,
                 metrics: Sequence[Dict], bucket, nan_specs) -> None:
        """The group's readback (its one device->host copy, the end of its
        ``device_step`` span), the anomaly guard's check of the group, and
        the steps' records. ``n`` is the epoch's index of the group's last
        batch, ``lrs`` each step's learning rate, ``t0`` the group's start."""
        with self._attr.resolving(bucket):
            hosts = self._readback(metrics)
        r = len(hosts)
        covered = range(first, first + r)
        losses = [h["loss"] for h in hosts]
        mses = [float(h["loss_per_window"][-1]) for h in hosts]
        num_host = (merge_readback([h["numerics"] for h in hosts])
                    if "numerics" in hosts[0] else None)
        if nan_specs:
            # the injected train_step/nan_loss fault: the group's scalars go
            # non-finite (parameters untouched), and the loss tap with them
            losses = mses = [float("nan")] * r
            if num_host is not None:
                num_host = poison_tag(num_host, "loss")
        if self._guard is not None and not self._guard.check(
                losses, first, fault_id=nan_specs[0].fault_id if nan_specs else None,
                numerics=num_host):
            return  # skipped: kept out of the trackers, the writer and the log
        step_seconds = (time.perf_counter() - t0) / r
        for it, h, loss, mse, lr in zip(covered, hosts, losses, mses, lrs):
            self.writer.set_step(it)
            self.train_metrics.update("train_mse_loss", mse)
            self.train_metrics.update("train_loss", loss)
            if it % self.train_log_step == 0:
                self.writer.add_scalar("learning_rate", lr)
                logger.info("Train Epoch: %d Iteration: %d/%d train_mse_loss: %.4e "
                            "train_loss: %.4e lr: %.4e", epoch + 1, it, self.iterations, mse,
                            loss, lr)
                self._log({"iteration": it, "epoch": epoch, "train_loss": loss,
                           "train_mse_loss": mse, "grad_norm": h["grad_norm"], "lr": lr,
                           "step_seconds": step_seconds})
        if self.sink is not None and num_host is not None and any(
                it % self.train_log_step == 0 for it in covered):
            for tag in order_tags(num_host):
                self.sink.numerics(tag, stats_fields(num_host[tag]), step=covered[-1])
        if self.vis_enabled and any(it % self.train_vis_step == 0 for it in covered):
            self._log_images(n, metrics[-1]["last_pred"][0].cpu().numpy())

    def _train_loop(self, progress: Dict, profiler) -> Dict[str, float]:
        it = self.start_iteration
        epoch = 0
        valid_stamp = 1
        stop = False
        # the iteration each epoch started at, so a rollback re-enters the
        # right epoch and fast-forwards it
        epoch_starts: list = []
        ff_skip = 0
        logger.info("Training: %d iterations, %d batches/epoch, on %s",
                    self.iterations, len(self.train_loader), self.device)
        while not stop:
            self.train_loader.set_epoch(epoch)
            progress["epoch"] = epoch
            if not epoch_starts or epoch_starts[-1][0] != epoch:
                epoch_starts.append((epoch, it))
            rb_caught = None
            n_next = ff_skip  # the epoch's index of the next batch (vis)
            with contextlib.ExitStack() as stack:
                # the reference's super-steps: groups of k_steps batches
                source = group_batches(self.train_loader, self.k_steps)
                if ff_skip:
                    source = _fast_forward_groups(source, ff_skip)
                    ff_skip = 0
                # staged (and prefetched) one batch at a time, as with k_steps 1
                items = _group_items(source)
                if self.device_prefetch:
                    batches = stack.enter_context(DevicePrefetcher(
                        items, self._stage_item_timed, depth=self.device_prefetch,
                        join_timeout=self.prefetch_join_timeout,
                        stall_timeout=self.prefetch_stall_timeout))
                else:
                    batches = ((item, None) for item in items)
                pull = iter(batches)
                while True:
                    self._attr.begin()
                    with self._attr.measure("data_wait"):
                        pulled = next(pull, _END)
                    if pulled is _END:
                        self._attr.discard()
                        break
                    r = pulled[0][1]
                    n, n_next = n_next + r - 1, n_next + r
                    # every cadence is due when any iteration the group covers is
                    covered = range(it, it + r)
                    last = covered[-1]
                    try:
                        # the train_step fault site, keyed by the group's first
                        # iteration: nan_loss poisons the group's readback,
                        # dispatch_error raises at its first step (retried)
                        specs = _faults.fire("train_step", it)
                        nan_specs = [s for s in specs if s.kind == "nan_loss"]
                        err_specs = [s for s in specs if s.kind == "dispatch_error"]
                        lrs, metrics = [], []
                        t0 = time.perf_counter()
                        for j in range(r):
                            if j:
                                with self._attr.measure("data_wait"):
                                    pulled = next(pull)
                            batch = self._finish(self._take_staged(*pulled))
                            lrs.append(self.optimizer.lr)
                            step = self._dispatch(self.train_step, batch, err_specs)
                            if j < r - 1:
                                step.pop("last_pred", None)  # the vis frame is the last's
                            metrics.append(step)
                            err_specs = ()
                        self._attr.note(it, r)
                        progress["iteration"] = last + 1
                        self._consume(it, epoch, n, lrs, t0, metrics, self._attr.current,
                                      nan_specs)
                        if profiler is not None:
                            # after the readback: the capture holds the whole
                            # group, and writing the trace lands in no span
                            profiler.step(r)
                        best = False
                        if self.valid_loader is not None and any(
                                i % self.valid_step == 0 and i != 0 for i in covered):
                            with self._attr.measure("validate"):
                                val_log = self._valid()
                            logger.info("Valid stamp %d: %s", valid_stamp,
                                        {k: round(v, 6) for k, v in val_log.items()})
                            self._log({"iteration": last, "valid_stamp": valid_stamp,
                                       **val_log})
                            for k, v in val_log.items():
                                self.writer.add_scalar(f"stamp_{k}", v, step=valid_stamp)
                            stop, best = self.eval_model_performance(val_log)
                            valid_stamp += 1
                            if stop:
                                break
                        saved = any(i % self.save_period == 0 and i != 0
                                    for i in covered) or best
                        if saved:
                            with trace.adopt(self._attr.current_ctx()), \
                                    self._attr.measure("checkpoint"):
                                self._save(last, best)
                        if last + 1 >= self.iterations:
                            logger.info("Training completes!")
                            # the group's true last iteration, past
                            # `iterations` when the last group overshoots it
                            if not saved:
                                with trace.adopt(self._attr.current_ctx()), \
                                        self._attr.measure("checkpoint"):
                                    self._save(last, False)
                            stop = True
                            break
                        it = last + 1
                    except RollbackSignal as rb:
                        # unwind to the epoch level so the prefetcher stops,
                        # then restore and fast-forward below
                        rb_caught = rb
                        break
                    finally:
                        self._attr.close()
            if rb_caught is not None:
                resume_iter = self._perform_rollback(rb_caught)
                while len(epoch_starts) > 1 and epoch_starts[-1][1] > resume_iter:
                    epoch_starts.pop()
                epoch, ep_start = epoch_starts[-1]
                if resume_iter < ep_start:
                    logger.warning("rollback target iteration %d predates this run's data "
                                   "stream (started at %d); replaying from the stream start",
                                   resume_iter, ep_start)
                    resume_iter = ep_start
                ff_skip = resume_iter - ep_start
                it = resume_iter
                progress["iteration"] = it
                continue
            if not stop:
                epoch += 1
        return self.train_metrics.result()
