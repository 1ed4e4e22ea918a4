"""Windowed event dataset: one recording -> model-ready numpy dicts
(counterpart of ``esr_tpu/data/dataset.py``).

Covered: the three windowing modes (events / time / frame), the scale^2*N
GT event windowing, the seeded flip/polarity augmentation of the training
recipe, and the items the harness and the trainer read: by default the
count images ``inp_cnt``, ``inp_scaled_cnt`` and ``gt_cnt``; on request
(``item_keys``) also ``gt_img`` (the GT frame at the window's middle, for
the visualizations) and the fixed-capacity raw event windows of device
rasterization (``inp_norm_events`` / ``inp_events_valid``: ``[window, 4]``
rows (x/W, y/H, t, p) and their validity; ``gt_raw_events`` /
``gt_events_valid``: ``[scale^2 * window, 4]`` raw GT-grid rows). Noise
injection, the hot-pixel filter, sensor pauses, custom resolutions and the
other item encodings raise ``NotImplementedError``.

Augmentation makes the reference's draws exactly: each mechanism flips when
``random.Random(seed + i).random() < p`` (``i`` = 0, 1, 2 for Horizontal,
Vertical, Polarity), applied to the raw input and GT windows, so a seeded
item is bit for bit the reference's.
"""

from __future__ import annotations

import functools
import random
from typing import Dict, List, Optional

import numpy as np

from esr_tpu_torch.data import np_encodings as NE
from esr_tpu_torch.data.records import Recording, open_recording, resolve_scale_ladder

ITEM_KEYS = ("inp_cnt", "inp_scaled_cnt", "gt_cnt")
# every key get_item can build
KNOWN_KEYS = ITEM_KEYS + ("gt_img", "inp_norm_events", "inp_events_valid",
                          "gt_raw_events", "gt_events_valid")
AUGMENTS = ("Horizontal", "Vertical", "Polarity")


def _refuse_training_options(config: Dict) -> None:
    enabled = [
        name for name in ("add_noise", "hot_filter")
        if (config.get(name) or {}).get("enabled", False)
    ]
    augment = config.get("data_augment") or {}
    if augment.get("enabled", False):
        unknown = sorted(set(augment.get("augment", [])) - set(AUGMENTS))
        if unknown:
            enabled.append(f"data_augment mechanisms {unknown}")
    if (config.get("sequence") or {}).get("pause", {}).get("enabled", False):
        enabled.append("sequence.pause")
    if config.get("custom_resolution") is not None:
        enabled.append("custom_resolution")
    extra = set(config.get("item_keys") or ITEM_KEYS) - set(KNOWN_KEYS)
    if extra:
        enabled.append(f"item_keys {sorted(extra)}")
    if enabled:
        raise NotImplementedError(
            f"dataset options {enabled} are not ported (the port builds "
            f"{list(KNOWN_KEYS)} with {list(AUGMENTS)} augmentation)"
        )


@functools.lru_cache(maxsize=4096)
def _flip_coin(seed: int, prob: float) -> bool:
    """The reference's draw, ``random.seed(s); random.random() < p``, from a
    private generator (the process-global one would race with the loader's
    prefetch threads). Memoized: a sequence asks the same (seed, prob) for
    each of its L windows."""
    return random.Random(seed).random() < prob


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
        self.need_gt_frame = config.get("need_gt_frame", False)
        self.augment_cfg = config.get("data_augment") or {"enabled": False}
        self.item_keys = tuple(config.get("item_keys") or ITEM_KEYS)
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

    def _augment_events(self, events: np.ndarray, resolution, seed: int) -> np.ndarray:
        xs, ys, ts, ps = events
        for i, mechanism in enumerate(self.augment_cfg["augment"]):
            prob = self.augment_cfg["augment_prob"][i]
            if mechanism == "Horizontal" and _flip_coin(seed, prob):
                xs = resolution[1] - 1 - xs
            elif mechanism == "Vertical" and _flip_coin(seed + 1, prob):
                ys = resolution[0] - 1 - ys
            elif mechanism == "Polarity" and _flip_coin(seed + 2, prob):
                ps = ps * -1
        return np.stack([xs, ys, ts, ps])

    def _augment_frame(self, img: np.ndarray, seed: int) -> np.ndarray:
        for i, mechanism in enumerate(self.augment_cfg["augment"]):
            prob = self.augment_cfg["augment_prob"][i]
            if mechanism == "Horizontal" and _flip_coin(seed, prob):
                img = np.flip(img, 1)
            elif mechanism == "Vertical" and _flip_coin(seed + 1, prob):
                img = np.flip(img, 0)
        return img

    def _gt_img(self, idx0: int, idx1: int, seed: int) -> np.ndarray:
        """``[kH, kW, 1]``: the GT frame nearest after the window's middle
        event, in [0, 1], bicubic onto the GT grid; zeros without
        ``need_gt_frame``."""
        kh, kw = self.gt_resolution
        if not self.need_gt_frame:
            return np.zeros((kh, kw, 1), np.float32)
        t = self.inp_stream.ts[(idx0 + idx1) // 2]
        fi = int(np.clip(np.searchsorted(self.recording.frame_ts, t, side="left"),
                         0, self.recording.num_frames - 1))
        raw = self.recording.frame(fi)
        if self.augment_cfg.get("enabled", False):
            raw = self._augment_frame(raw, seed)
        return NE.interpolate_np(raw.astype(np.float32)[..., None] / 255.0, (kh, kw), "bicubic")

    @staticmethod
    def _padded(ev: np.ndarray, capacity: int):
        """``[4, N]`` events -> ``[capacity, 4]`` rows and ``[capacity]``
        validity (the static-shape feed of device rasterization)."""
        out = np.zeros((capacity, 4), np.float32)
        valid = np.zeros((capacity,), np.float32)
        n = min(ev.shape[1], capacity)
        if n:
            out[:n] = ev[:, :n].T
            valid[:n] = 1.0
        return out, valid

    def _window(self, stream, idx0: int, idx1: int, resolution, seed: int) -> np.ndarray:
        ev = stream.window(idx0, idx1)
        if self.augment_cfg.get("enabled", False):
            ev = self._augment_events(ev, resolution, seed)
        return self._format(ev)

    def get_item(self, index: int, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Count images of one window, channel-last float32 ``[H, W, 2]``.
        ``seed`` draws the augmentation (a random one when None)."""
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        idx0, idx1 = (int(i) for i in self.event_indices[index])
        inp_ev = self._window(self.inp_stream, idx0, idx1, self.inp_resolution, seed)
        h, w = self.inp_resolution
        kh, kw = self.gt_resolution
        # the SR input: LR coordinates renormalized onto the HR grid
        xs = inp_ev[0] / w * kw
        ys = inp_ev[1] / h * kh
        if self.need_gt_events:
            g0, g1 = (int(i) for i in self.gt_event_indices[index])
            gt_ev = self._window(self.gt_stream, g0, g1, self.gt_resolution, seed)
        else:
            gt_ev = np.zeros((4, 0), np.float32)
        window = int(self.config["window"])

        def norm_ev():
            ev = inp_ev.copy()
            ev[0] = inp_ev[0] / w
            ev[1] = inp_ev[1] / h
            return ev

        encoders = {
            "inp_cnt": lambda: NE.events_to_channels_np(
                inp_ev[0], inp_ev[1], inp_ev[3], (h, w)),
            "inp_scaled_cnt": lambda: NE.events_to_channels_np(xs, ys, inp_ev[3], (kh, kw)),
            "gt_cnt": lambda: NE.events_to_channels_np(
                gt_ev[0], gt_ev[1], gt_ev[3], (kh, kw)),
            "gt_img": lambda: self._gt_img(idx0, idx1, seed),
            "inp_norm_events": lambda: self._padded(norm_ev(), window)[0],
            "inp_events_valid": lambda: self._padded(inp_ev, window)[1],
            "gt_raw_events": lambda: self._padded(gt_ev, self.scale**2 * window)[0],
            "gt_events_valid": lambda: self._padded(gt_ev, self.scale**2 * window)[1],
        }
        return {k: np.ascontiguousarray(encoders[k](), np.float32) for k in self.item_keys}

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

    def get_item(self, i: int, seed: Optional[int] = None) -> List[Dict[str, np.ndarray]]:
        """The L windows of sequence ``i``, all augmented with one ``seed``
        (a random one when None), so flips agree across the sequence."""
        if not 0 <= i < self.length:
            raise IndexError(i)
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        j = i * self.step_size
        return [self.dataset.get_item(j + k, seed=seed) for k in range(self.L)]

    __getitem__ = get_item
