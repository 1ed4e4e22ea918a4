"""Windowed event dataset: one recording -> model-ready numpy dicts
(counterpart of ``esr_tpu/data/dataset.py``).

This slice covers evaluation: the three windowing modes (events / time /
frame), the scale^2*N GT event windowing, and the items the inference
harness reads (``inp_cnt``, ``inp_scaled_cnt``, ``gt_cnt``). Augmentation,
noise injection, the hot-pixel filter, sensor pauses and the other item
encodings belong to training and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from esr_tpu_torch.data import np_encodings as NE
from esr_tpu_torch.data.records import Recording, open_recording, resolve_scale_ladder

ITEM_KEYS = ("inp_cnt", "inp_scaled_cnt", "gt_cnt")


def _refuse_training_options(config: Dict) -> None:
    enabled = [
        name for name in ("data_augment", "add_noise", "hot_filter")
        if (config.get(name) or {}).get("enabled", False)
    ]
    if (config.get("sequence") or {}).get("pause", {}).get("enabled", False):
        enabled.append("sequence.pause")
    if config.get("custom_resolution") is not None:
        enabled.append("custom_resolution")
    extra = set(config.get("item_keys") or ITEM_KEYS) - set(ITEM_KEYS)
    if extra:
        enabled.append(f"item_keys {sorted(extra)}")
    if enabled:
        raise NotImplementedError(
            f"dataset options {enabled} belong to the training data path, "
            "which is not ported yet (the evaluation slice builds "
            f"{list(ITEM_KEYS)} only)"
        )


class EventWindowDataset:
    """One recording -> indexed event windows with their count images.

    ``config`` keeps the reference's dataset schema: scale, ori_scale, mode,
    window, sliding_window, need_gt_events, dataset_length, real_world_test.
    """

    def __init__(self, recording, config: Dict):
        _refuse_training_options(config)
        self.config = config
        self.recording: Recording = open_recording(recording)
        self.scale = int(config["scale"])
        self.need_gt_events = config.get("need_gt_events", False)
        ladder = resolve_scale_ladder(
            self.recording.sensor_resolution, self.scale, config["ori_scale"],
            need_gt_events=self.need_gt_events,
            real_world_test=config.get("real_world_test", False),
        )
        self.inp_resolution = ladder.inp_resolution
        self.gt_resolution = ladder.gt_resolution
        self.inp_stream = self.recording.stream(ladder.inp_prefix)
        self.gt_stream = (
            self.recording.stream(ladder.gt_prefix) if self.need_gt_events else None
        )
        self._compute_windows(config)

    def _compute_windows(self, config: Dict) -> None:
        """``[start, end)`` event indices per sample for the three modes."""
        mode = config["mode"]
        window = config["window"]
        sliding = config["sliding_window"]
        limit = config.get("dataset_length", None)
        n = self.inp_stream.num_events
        ts = self.inp_stream.ts

        if mode == "events":
            max_length = max(int(n / (window - sliding)), 0)
            length = min(limit, max_length) if limit is not None else max_length
            starts = (window - sliding) * np.arange(length, dtype=np.int64)
            ends = np.minimum(starts + window, n - 1)
        elif mode == "time":
            t0 = ts[0] if n else 0.0
            duration = (ts[-1] - ts[0]) if n else 0.0
            max_length = max(int(duration / (window - sliding)), 0)
            length = min(limit, max_length) if limit is not None else max_length
            # contiguous time blocks: each window ends where the next starts
            end_times = t0 + (window - sliding) * np.arange(length) + window
            ends = np.minimum(np.searchsorted(ts, end_times, side="left"), n - 1)
            starts = np.concatenate([[0], ends[:-1]]) if length else ends
        elif mode == "frame":
            frame_ts = self.recording.frame_ts
            max_length = len(frame_ts) - 1
            length = min(limit, max_length) if limit is not None else max_length
            ends = np.minimum(np.searchsorted(ts, frame_ts[:length], side="left"), n - 1)
            starts = np.concatenate([[0], ends[:-1]]) if length else ends
        else:
            raise ValueError(f"invalid data mode {mode!r}")

        if length <= 0:
            raise ValueError("windowing parameters lead to dataset length of zero")
        self.length = int(length)
        self.event_indices = np.stack([starts, ends], axis=1)
        if self.need_gt_events:
            self.gt_event_indices = np.stack(
                [self._gt_window(int(a), int(b)) for a, b in self.event_indices]
            )

    def _gt_window(self, idx0: int, idx1: int):
        """GT window = scale^2*N events from the time-aligned GT index."""
        num_gt = self.scale**2 * (idx1 - idx0)
        gt_idx0 = self.gt_stream.search(self.inp_stream.ts[idx0])
        gt_idx1 = gt_idx0 + num_gt
        n = self.gt_stream.num_events
        if gt_idx1 > n - 1:
            gt_idx1 = n - 1
            gt_idx0 = gt_idx1 - num_gt
        if gt_idx0 < 0:
            raise ValueError(f"GT window [{gt_idx0},{gt_idx1}) out of bounds 0..{n}")
        return gt_idx0, gt_idx1

    def __len__(self) -> int:
        return self.length

    @staticmethod
    def _format(events: np.ndarray) -> np.ndarray:
        """float32 ``[4, N]`` with ts normalized to [0, 1] within the window."""
        ev = events.astype(np.float32)
        if ev.shape[1]:
            ts = ev[2]
            ev[2] = (ts - ts[0]) / (ts[-1] - ts[0] + 1e-6)
        return ev

    def get_item(self, index: int) -> Dict[str, np.ndarray]:
        """Count images of one window, channel-last float32 ``[H, W, 2]``."""
        idx0, idx1 = (int(i) for i in self.event_indices[index])
        inp_ev = self._format(self.inp_stream.window(idx0, idx1))
        h, w = self.inp_resolution
        kh, kw = self.gt_resolution
        # the SR input: LR coordinates renormalized onto the HR grid
        xs = inp_ev[0] / w * kw
        ys = inp_ev[1] / h * kh
        if self.need_gt_events:
            g0, g1 = (int(i) for i in self.gt_event_indices[index])
            gt_ev = self._format(self.gt_stream.window(g0, g1))
        else:
            gt_ev = np.zeros((4, 0), np.float32)
        item = {
            "inp_cnt": NE.events_to_channels_np(inp_ev[0], inp_ev[1], inp_ev[3], (h, w)),
            "inp_scaled_cnt": NE.events_to_channels_np(xs, ys, inp_ev[3], (kh, kw)),
            "gt_cnt": NE.events_to_channels_np(gt_ev[0], gt_ev[1], gt_ev[3], (kh, kw)),
        }
        return {k: np.ascontiguousarray(v, np.float32) for k, v in item.items()}

    __getitem__ = get_item


class SequenceDataset:
    """Length-L sequences of consecutive windows (``step_size`` apart)."""

    def __init__(self, recording, config: Dict):
        self.config = config
        seq = config["sequence"]
        self.L = int(seq["sequence_length"])
        step = seq.get("step_size", None)
        self.step_size = int(step) if step is not None else self.L
        if self.L <= 0 or self.step_size <= 0:
            raise ValueError("sequence_length and step_size must be positive")
        self.dataset = EventWindowDataset(recording, config)
        if self.L >= len(self.dataset):
            self.length = 1
            self.L = len(self.dataset)
        else:
            self.length = (len(self.dataset) - self.L) // self.step_size + 1
        self.inp_resolution = self.dataset.inp_resolution
        self.gt_resolution = self.dataset.gt_resolution

    def __len__(self) -> int:
        return self.length

    def get_item(self, i: int) -> List[Dict[str, np.ndarray]]:
        if not 0 <= i < self.length:
            raise IndexError(i)
        j = i * self.step_size
        return [self.dataset.get_item(j + k) for k in range(self.L)]

    __getitem__ = get_item
