"""Event-recording storage: HDF5 reader + the resolution ladder
(counterpart of ``esr_tpu/data/records.py``).

Each recording stores the same scene at ``ori, down2, down4, down8, down16``
resolutions; ``(scale, ori_scale)`` pick which rung feeds the model and which
supervises it. Timestamps are cached once per stream and searched with
``np.searchsorted``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LADDER = {"ori": 1, "down2": 2, "down4": 4, "down8": 8, "down16": 16}


def _scaled(resolution: Sequence[int], factor: float) -> List[int]:
    return [round(i / factor) for i in resolution]


@dataclass(frozen=True)
class ScaleLadder:
    """Resolved resolutions + HDF5 group prefixes for one (scale, ori_scale)."""

    inp_resolution: Tuple[int, int]
    gt_resolution: Tuple[int, int]
    inp_down_resolution: Tuple[int, int]
    inp_prefix: str
    gt_prefix: Optional[str]


def resolve_scale_ladder(
    sensor_resolution: Sequence[int],
    scale: int,
    ori_scale: str,
    need_gt_events: bool = False,
    real_world_test: bool = False,
) -> ScaleLadder:
    """Pick the input and GT rungs: input at ``sensor/f`` (``f`` from
    ``ori_scale``), GT for ``scale``x SR at ``sensor/(f/scale)``."""
    if ori_scale not in LADDER:
        raise ValueError(f"unknown ori_scale {ori_scale!r}")
    f = LADDER[ori_scale]
    inp_resolution = tuple(_scaled(sensor_resolution, f))
    inp_down = tuple(round(i / scale) for i in inp_resolution)

    if real_world_test:
        # real-sensor capture: only the recorded down8 rung exists
        if ori_scale != "down8" or need_gt_events:
            raise ValueError("real_world_test requires ori_scale=down8 and no GT events")
        g = 8 // scale if scale in (2, 4, 8) else 1
        return ScaleLadder(inp_resolution, tuple(_scaled(sensor_resolution, g)),
                           inp_down, "down8_real", "down8_real")
    if not need_gt_events:
        return ScaleLadder(inp_resolution, tuple(i * scale for i in inp_resolution),
                           inp_down, ori_scale, ori_scale)
    if f % scale != 0:
        raise ValueError(f"scale {scale} incompatible with ori_scale {ori_scale}")
    g = f // scale
    return ScaleLadder(inp_resolution, tuple(_scaled(sensor_resolution, g)),
                       inp_down, ori_scale, "ori" if g == 1 else f"down{g}")


class EventStream:
    """One resolution rung. ``ts`` is cached; ``xs/ys/ps`` are sliced from
    the backing store (HDF5 dataset or numpy array) per window."""

    def __init__(self, xs, ys, ts: np.ndarray, ps):
        self._xs, self._ys, self._ps = xs, ys, ps
        self.ts = np.asarray(ts, np.float64)
        self.num_events = len(self.ts)

    def window(self, idx0: int, idx1: int) -> np.ndarray:
        """Events in ``[idx0, idx1)`` as a ``[4, N]`` float64 array (x,y,t,p)."""
        return np.stack([
            np.asarray(self._xs[idx0:idx1], np.float64),
            np.asarray(self._ys[idx0:idx1], np.float64),
            self.ts[idx0:idx1],
            np.asarray(self._ps[idx0:idx1], np.float64),
        ])

    def search(self, t: float) -> int:
        """Index of the first event with timestamp >= ``t``."""
        return int(np.searchsorted(self.ts, t, side="left"))


class Recording:
    """Event streams per ladder rung + optional frame images."""

    sensor_resolution: Tuple[int, int]

    def stream(self, prefix: str) -> EventStream:
        raise NotImplementedError

    @property
    def num_frames(self) -> int:
        return len(self.frame_ts)

    @property
    def frame_ts(self) -> np.ndarray:
        raise NotImplementedError

    def frame(self, index: int) -> np.ndarray:
        raise NotImplementedError

    def close(self) -> None:
        pass


class H5Recording(Recording):
    """The reference HDF5 layout: ``{prefix}_events/{xs,ys,ts,ps}`` groups,
    ``ori_images/image%09d`` frames with ``timestamp`` attrs and a
    ``sensor_resolution`` file attribute."""

    def __init__(self, path: str):
        import h5py

        self.path = path
        self._file = h5py.File(path, "r")
        self.sensor_resolution = tuple(
            int(i) for i in np.asarray(self._file.attrs["sensor_resolution"]).tolist()
        )
        self._streams: Dict[str, EventStream] = {}
        self._frame_ts: Optional[np.ndarray] = None
        self._frame_names: List[str] = []

    def stream(self, prefix: str) -> EventStream:
        if prefix not in self._streams:
            grp = self._file[f"{prefix}_events"]
            self._streams[prefix] = EventStream(grp["xs"], grp["ys"], grp["ts"][:], grp["ps"])
        return self._streams[prefix]

    @property
    def frame_ts(self) -> np.ndarray:
        if self._frame_ts is None:
            names = sorted(self._file["ori_images"]) if "ori_images" in self._file else []
            self._frame_names = names
            self._frame_ts = np.asarray(
                [self._file[f"ori_images/{n}"].attrs["timestamp"] for n in names],
                np.float64,
            )
        return self._frame_ts

    def frame(self, index: int) -> np.ndarray:
        if not len(self.frame_ts):
            raise ValueError(f"{self.path!r} has no packaged frames (ori_images)")
        return self._file[f"ori_images/{self._frame_names[index]}"][:]

    def close(self) -> None:
        self._file.close()


class MemoryRecording(Recording):
    """In-memory recording (synthetic data, no HDF5 round trip); ``name``
    stands for a file name in reports."""

    def __init__(
        self,
        sensor_resolution: Sequence[int],
        streams: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
        frames: Optional[Sequence[np.ndarray]] = None,
        frame_ts: Optional[Sequence[float]] = None,
        name: str = "memory",
    ):
        self.name = name
        self.sensor_resolution = tuple(int(i) for i in sensor_resolution)
        self._streams = {k: EventStream(*v) for k, v in streams.items()}
        self._frames = list(frames) if frames is not None else []
        self._frame_ts = np.asarray(frame_ts if frame_ts is not None else [], np.float64)

    def stream(self, prefix: str) -> EventStream:
        return self._streams[prefix]

    @property
    def frame_ts(self) -> np.ndarray:
        return self._frame_ts

    def frame(self, index: int) -> np.ndarray:
        return self._frames[index]


def open_recording(path_or_recording) -> Recording:
    if isinstance(path_or_recording, Recording):
        return path_or_recording
    if isinstance(path_or_recording, (str, os.PathLike)):
        return H5Recording(os.fspath(path_or_recording))
    raise TypeError(f"cannot open recording from {type(path_or_recording)!r}")


def recording_name(path_or_recording) -> str:
    """A recording's name in reports: a path's base name, or the in-memory
    recording's ``name``."""
    if isinstance(path_or_recording, (str, os.PathLike)):
        return os.path.basename(os.fspath(path_or_recording))
    return str(getattr(path_or_recording, "name", "memory"))
