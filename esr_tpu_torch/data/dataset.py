"""Windowed event dataset: one recording -> model-ready numpy dicts
(counterpart of ``esr_tpu/data/dataset.py``).

The three windowing modes (events / time / frame), the scale^2*N GT event
windowing, and per item, in the reference's order: the input window, the
stateful hot-pixel filter (``hot_filter``), the seeded flip/polarity
augmentation, the timestamps normalized to [0, 1], then the injected noise
(``add_noise``). A sequence may stall (``sequence.pause``): a paused window
repeats the index with no events and no noise. Every key of
:data:`ALL_KEYS` can be built (the default set, as the reference's); a
caller names the ones it reads in ``item_keys`` and only those are built.
``custom_resolution`` adds the five bicubic ``*_custom_*`` items.

Augmentation makes the reference's draws exactly: each mechanism flips when
``random.Random(seed + i).random() < p`` (``i`` = 0, 1, 2 for Horizontal,
Vertical, Polarity); noise draws from ``default_rng(seed + 3)`` and pauses
from ``default_rng(seed ^ 0x5EED)``. So a seeded item, and a sequence with
its pauses, is bit for bit the reference's.
"""

from __future__ import annotations

import functools
import random
from typing import Callable, Dict, List, Optional

import numpy as np

from esr_tpu_torch.data import np_encodings as NE
from esr_tpu_torch.data.hot_filter import HotPixelFilter
from esr_tpu_torch.data.records import Recording, open_recording, resolve_scale_ladder

#: the count images the trainer and the harness read
ITEM_KEYS = ("inp_cnt", "inp_scaled_cnt", "gt_cnt")
#: every key get_item can build (the reference's item schema and the
#: fixed-capacity raw event windows of device rasterization); the default
ALL_KEYS = (
    "inp_stack", "inp_cnt",
    "inp_bicubic_cnt", "inp_bicubic_stack",
    "inp_near_cnt", "inp_near_stack",
    "inp_scaled_cnt", "inp_scaled_stack",
    "inp_activity",
    "inp_down_cnt", "inp_down_scaled_cnt",
    "gt_stack", "gt_cnt", "gt_img", "gt_inp_size_img", "frame",
    "inp_norm_events", "inp_events_valid",
    "gt_raw_events", "gt_events_valid",
)
#: the items ``custom_resolution`` resamples, and what they become
CUSTOM_SOURCES = ("inp_cnt", "inp_scaled_cnt", "inp_down_cnt", "inp_down_scaled_cnt", "gt_cnt")
AUGMENTS = ("Horizontal", "Vertical", "Polarity")


def _refuse_training_options(config: Dict) -> None:
    """Refuse an augment mechanism the reference does not define (it would
    skip it without a word)."""
    augment = config.get("data_augment") or {}
    if augment.get("enabled", False):
        unknown = sorted(set(augment.get("augment", [])) - set(AUGMENTS))
        if unknown:
            raise NotImplementedError(f"data_augment mechanisms {unknown} are not defined "
                                      f"(the mechanisms are {list(AUGMENTS)})")


@functools.lru_cache(maxsize=4096)
def _flip_coin(seed: int, prob: float) -> bool:
    """The reference's draw, ``random.seed(s); random.random() < p``, from a
    private generator (the process-global one would race with the loader's
    prefetch threads). Memoized: a sequence asks the same (seed, prob) for
    each of its L windows."""
    return random.Random(seed).random() < prob


def _resize(x: np.ndarray, size, mode: str) -> np.ndarray:
    """``[H, W, C]`` resize, ``align_corners=False``."""
    return NE.interpolate_np(x, tuple(size), mode)


class EventWindowDataset:
    """One recording -> indexed event windows and their encodings.

    ``config`` keeps the reference's dataset schema: scale, ori_scale,
    time_bins, stack_binning, mode, window, sliding_window, need_gt_events,
    need_gt_frame, data_augment, dataset_length, custom_resolution,
    add_noise, hot_filter, activity.tile, real_world_test, item_keys.
    """

    def __init__(self, recording, config: Dict):
        _refuse_training_options(config)
        self.config = config
        self.recording: Recording = open_recording(recording)
        self.scale = int(config["scale"])
        self.time_bins = int(config.get("time_bins", 1))
        self.stack_binning = config.get("stack_binning", "half_open")
        self.need_gt_events = config.get("need_gt_events", False)
        self.need_gt_frame = config.get("need_gt_frame", False)
        self.augment_cfg = config.get("data_augment") or {"enabled": False}
        self.add_noise = config.get("add_noise") or {"enabled": False}
        self.custom_resolution = config.get("custom_resolution", None)
        self.activity_tile = int((config.get("activity") or {}).get("tile", 8))
        self.item_keys = tuple(config.get("item_keys") or ALL_KEYS)
        if self.custom_resolution is not None:
            missing = [k for k in CUSTOM_SOURCES if k not in self.item_keys]
            if missing:
                raise ValueError(f"custom_resolution needs item_keys to include {missing}")
        ladder = resolve_scale_ladder(
            self.recording.sensor_resolution, self.scale, config["ori_scale"],
            need_gt_events=self.need_gt_events,
            real_world_test=config.get("real_world_test", False),
        )
        self.inp_resolution = ladder.inp_resolution
        self.gt_resolution = ladder.gt_resolution
        self.inp_down_resolution = ladder.inp_down_resolution
        self.inp_stream = self.recording.stream(ladder.inp_prefix)
        self.gt_stream = (
            self.recording.stream(ladder.gt_prefix) if self.need_gt_events else None
        )
        hot_cfg = config.get("hot_filter") or {"enabled": False}
        self.hot_filter = (HotPixelFilter(self.inp_resolution, hot_cfg)
                           if hot_cfg.get("enabled", False) else None)
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

    @property
    def inp_event_capacity(self) -> int:
        """Rows of ``inp_norm_events``: the window, plus the noise budget."""
        cap = int(self.config["window"])
        if self.add_noise.get("enabled", False):
            cap += int(cap * self.add_noise.get("noise_level", 0.0))
        return cap

    @property
    def gt_event_capacity(self) -> int:
        """Rows of ``gt_raw_events``: GT windows hold scale^2 x the input's."""
        return self.scale**2 * int(self.config["window"])

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

    @staticmethod
    def _noise_events(window: int, resolution, seed: int, noise_level: float) -> np.ndarray:
        """``int(window * noise_level)`` spurious events: x, y uniform on the
        grid, t = 1, p = +-1, drawn in f32 from ``default_rng(seed + 3)``."""
        n = int(window * noise_level)
        u = np.random.default_rng(seed + 3).random((4, n)).astype(np.float32)
        return np.stack([
            np.floor(u[0] * resolution[1]),
            np.floor(u[1] * resolution[0]),
            np.ones(n, np.float32),
            np.floor(u[3] * 2) * 2 - 1,
        ])

    def _input_events(self, idx0: int, idx1: int, seed: int, pause: bool) -> np.ndarray:
        """The input window ``[4, N]`` f32: filtered, augmented, formatted,
        then noised; no events at all when paused."""
        if pause:
            return np.zeros((4, 0), np.float32)
        ev = self.inp_stream.window(idx0, idx1)
        if self.hot_filter is not None:
            ev = self.hot_filter.filter_events(ev)
        if self.augment_cfg.get("enabled", False):
            ev = self._augment_events(ev, self.inp_resolution, seed)
        ev = self._format(ev)
        if self.add_noise.get("enabled", False):
            noise = self._noise_events(self.config["window"], self.inp_resolution, seed,
                                       self.add_noise["noise_level"])
            ev = np.concatenate([ev, noise], axis=1)
        return ev

    def _stack(self, ev: np.ndarray, resolution) -> np.ndarray:
        return NE.events_to_stack_np(ev[0], ev[1], ev[2], ev[3], self.time_bins,
                                     tuple(resolution), binning=self.stack_binning)

    @staticmethod
    def _normalized(ev: np.ndarray, resolution) -> np.ndarray:
        """x/W, y/H in [0, 1): the scale-free cloud re-scattered onto grids."""
        out = ev.copy()
        out[0] = ev[0] / resolution[1]
        out[1] = ev[1] / resolution[0]
        return out

    def _scaled(self, norm_ev: np.ndarray, resolution, kind: str) -> np.ndarray:
        """Normalized events re-scattered onto ``resolution`` as counts, a
        stack, or floored event coordinates."""
        xs = norm_ev[0] * resolution[1]
        ys = norm_ev[1] * resolution[0]
        if kind == "cnt":
            return NE.events_to_channels_np(xs, ys, norm_ev[3], tuple(resolution))
        if kind == "stack":
            return NE.events_to_stack_np(xs, ys, norm_ev[2], norm_ev[3], self.time_bins,
                                         tuple(resolution), binning=self.stack_binning)
        return np.stack([np.floor(xs), np.floor(ys), norm_ev[2], norm_ev[3]])

    def _unsupervised(self, norm_ev: np.ndarray):
        """The down-scaled self-supervision pair: events quantized onto the
        /scale grid, counts floor-divided by scale^2, on that grid and
        re-scattered onto the input's."""
        down = self._scaled(norm_ev, self.inp_down_resolution, "events")
        down_norm = self._normalized(down, self.inp_down_resolution)
        k2 = float(self.scale**2)
        return (np.floor_divide(self._scaled(down_norm, self.inp_down_resolution, "cnt"), k2),
                np.floor_divide(self._scaled(down_norm, self.inp_resolution, "cnt"), k2))

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

    def _frame_pair(self, idx0: int, idx1: int, seed: int):
        """The GT frame nearest after the window's middle event, in [0, 1],
        bicubic onto the GT grid and onto the input grid; zeros without
        ``need_gt_frame``."""
        kh, kw = self.gt_resolution
        h, w = self.inp_resolution
        if not self.need_gt_frame:
            return np.zeros((kh, kw, 1), np.float32), np.zeros((h, w, 1), np.float32)
        t = self.inp_stream.ts[(idx0 + idx1) // 2]
        fi = int(np.clip(np.searchsorted(self.recording.frame_ts, t, side="left"),
                         0, self.recording.num_frames - 1))
        raw = self.recording.frame(fi)
        if self.augment_cfg.get("enabled", False):
            raw = self._augment_frame(raw, seed)
        raw = raw.astype(np.float32)[..., None] / 255.0
        return _resize(raw, (kh, kw), "bicubic"), _resize(raw, (h, w), "bicubic")

    def _mode_frame(self, index: int, seed: int) -> np.ndarray:
        """In ``frame`` mode the window's own frame, bicubic onto the GT
        grid; zeros otherwise."""
        kh, kw = self.gt_resolution
        if self.config["mode"] != "frame":
            return np.zeros((kh, kw, 1), np.float32)
        raw = self.recording.frame(index).astype(np.float32)[..., None] / 255.0
        if self.augment_cfg.get("enabled", False):
            raw = self._augment_frame(raw, seed)
        return _resize(raw, (kh, kw), "bicubic")

    def get_item(self, index: int, pause: bool = False,
                 seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The ``item_keys`` of one window, channel-last float32: counts
        ``[H, W, 2]``, stacks ``[H, W, time_bins]``, frames ``[H, W, 1]``.
        ``seed`` draws the augmentation and the noise (a random one when
        None); ``pause`` gives the window no events."""
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        idx0, idx1 = (int(i) for i in self.event_indices[index])
        inp_ev = self._input_events(idx0, idx1, seed, pause)
        kh, kw = self.gt_resolution
        memo: Dict[Callable, object] = {}

        def shared(build: Callable) -> Callable:
            """An intermediate several keys read: built at most once."""
            def get():
                if build not in memo:
                    memo[build] = build()
                return memo[build]
            return get

        @shared
        def gt():
            if not self.need_gt_events:
                return np.zeros((4, 0), np.float32)
            g0, g1 = (int(i) for i in self.gt_event_indices[index])
            ev = self.gt_stream.window(g0, g1)
            if self.augment_cfg.get("enabled", False):
                ev = self._augment_events(ev, self.gt_resolution, seed)
            return self._format(ev)

        @shared
        def norm():
            return self._normalized(inp_ev, self.inp_resolution)

        @shared
        def cnt():
            return NE.events_to_channels_np(inp_ev[0], inp_ev[1], inp_ev[3],
                                            tuple(self.inp_resolution))

        @shared
        def stack():
            return self._stack(inp_ev, self.inp_resolution)

        @shared
        def scaled_cnt():
            return self._scaled(norm(), self.gt_resolution, "cnt")

        @shared
        def unsup():
            return self._unsupervised(norm())

        @shared
        def frames():
            return self._frame_pair(idx0, idx1, seed)

        @shared
        def inp_pad():
            return self._padded(norm(), self.inp_event_capacity)

        @shared
        def gt_pad():
            return self._padded(gt(), self.gt_event_capacity)

        builders = {
            "inp_stack": stack,
            "inp_cnt": cnt,
            "inp_bicubic_cnt": lambda: _resize(cnt(), (kh, kw), "bicubic"),
            "inp_bicubic_stack": lambda: _resize(stack(), (kh, kw), "bicubic"),
            "inp_near_cnt": lambda: _resize(cnt(), (kh, kw), "nearest"),
            "inp_near_stack": lambda: _resize(stack(), (kh, kw), "nearest"),
            "inp_scaled_cnt": scaled_cnt,
            "inp_scaled_stack": lambda: self._scaled(norm(), self.gt_resolution, "stack"),
            # a reduction of the model-input counts just built (the
            # device's events_to_channels_activity twin)
            "inp_activity": lambda: NE.tile_activity_np(scaled_cnt(), self.activity_tile),
            "inp_down_cnt": lambda: unsup()[0],
            "inp_down_scaled_cnt": lambda: unsup()[1],
            "gt_stack": lambda: self._stack(gt(), self.gt_resolution),
            "gt_cnt": lambda: NE.events_to_channels_np(gt()[0], gt()[1], gt()[3], (kh, kw)),
            "gt_img": lambda: frames()[0],
            "gt_inp_size_img": lambda: frames()[1],
            "frame": lambda: self._mode_frame(index, seed),
            "inp_norm_events": lambda: inp_pad()[0],
            "inp_events_valid": lambda: inp_pad()[1],
            "gt_raw_events": lambda: gt_pad()[0],
            "gt_events_valid": lambda: gt_pad()[1],
        }
        item = {k: builders[k]() for k in self.item_keys}
        if self.custom_resolution is not None:
            item.update(self._custom_items(item))
        return {k: np.ascontiguousarray(v, np.float32) for k, v in item.items()}

    def _custom_items(self, item: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Bicubic resamples at an arbitrary evaluation resolution, rounded
        back to integral counts."""
        ch, cw = self.custom_resolution
        k = self.scale
        out = {
            "inp_custom_cnt": _resize(item["inp_cnt"], (ch, cw), "bicubic"),
            "inp_custom_scaled_cnt": _resize(item["inp_scaled_cnt"], (ch * k, cw * k), "bicubic"),
            "inp_custom_down_cnt": _resize(item["inp_down_cnt"],
                                           (round(ch / k), round(cw / k)), "bicubic"),
            "inp_custom_down_scaled_cnt": _resize(item["inp_down_scaled_cnt"], (ch, cw),
                                                  "bicubic"),
            "gt_custom_cnt": _resize(item["gt_cnt"], (ch * k, cw * k), "bicubic"),
        }
        return {kk: np.round(vv) for kk, vv in out.items()}

    __getitem__ = get_item


class SequenceDataset:
    """Length-L sequences of consecutive windows (``step_size`` apart),
    with optional sensor pauses: a two-state chain (running / paused) that
    pauses with ``proba_pause_when_running`` and stays paused with
    ``proba_pause_when_paused``; a paused step repeats the window index
    with no events."""

    def __init__(self, recording, config: Dict):
        self.config = config
        seq = config["sequence"]
        self.L = int(seq["sequence_length"])
        step = seq.get("step_size", None)
        self.step_size = int(step) if step is not None else self.L
        if self.L <= 0 or self.step_size <= 0:
            raise ValueError("sequence_length and step_size must be positive")
        pause = seq.get("pause") or {"enabled": False}
        self.pause_enabled = bool(pause.get("enabled", False))
        self.p_pause_running = float(pause.get("proba_pause_when_running", 0.0))
        self.p_pause_paused = float(pause.get("proba_pause_when_paused", 0.0))
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
        """The L windows of sequence ``i``, all drawn with one ``seed`` (a
        random one when None), so flips agree across the sequence; the
        pause chain draws from ``default_rng(seed ^ 0x5EED)``."""
        if not 0 <= i < self.length:
            raise IndexError(i)
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        rng = np.random.default_rng(seed ^ 0x5EED)
        j = i * self.step_size
        sequence = [self.dataset.get_item(j, seed=seed)]
        k, paused = 0, False
        for _ in range(self.L - 1):
            if self.pause_enabled:
                paused = rng.random() < (self.p_pause_paused if paused else self.p_pause_running)
            if not paused:
                k += 1
            sequence.append(self.dataset.get_item(j + k, pause=paused, seed=seed))
        return sequence

    __getitem__ = get_item
