"""HDF5 recording packagers, the framework's input format (the port's own
copy of ``esr_tpu/tools/packagers.py``; numpy only, ``h5py`` imported when
a packager opens a file):

- :class:`H5Packager`: the single-stream layout (``events/{xs,ys,ts,ps}``,
  ``images/image%09d``, flow, metadata attributes, ``event_idx``
  back-references);
- :class:`H5LadderPackager`: the multi-resolution layout the training
  pipeline reads (``{prefix}_events/...`` and ``{prefix}_images/...`` per
  ladder rung), one loop over ``rungs``.

Both append host-side to chunked, resizable datasets, so a stream of any
length packages in O(1) memory.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

DEFAULT_RUNGS = ("ori", "down2", "down4", "down8", "down16")


def _h5py():
    import h5py

    return h5py


class _EventGroup:
    """Resizable xs/ys/ts/ps datasets under one group."""

    def __init__(self, f, group: str):
        h5py = _h5py()
        self.dsets = {}
        for name, dt in (
            ("xs", np.int16), ("ys", np.int16),
            ("ts", np.float64), ("ps", np.float64),
        ):
            self.dsets[name] = f.create_dataset(
                f"{group}/{name}", (0,), dtype=np.dtype(dt),
                maxshape=(None,), chunks=True,
            )

    def append(self, xs, ys, ts, ps) -> None:
        for name, data in zip(("xs", "ys", "ts", "ps"), (xs, ys, ts, ps)):
            d = self.dsets[name]
            n = len(data)
            d.resize(d.shape[0] + n, axis=0)
            if n:
                d[-n:] = data


def _package_image(f, group: str, image, timestamp: float, idx: int) -> None:
    image = np.asarray(image)
    d = f.create_dataset(
        f"{group}/image{idx:09d}", data=image, dtype=np.dtype(np.uint8)
    )
    d.attrs["size"] = image.shape
    d.attrs["timestamp"] = timestamp
    d.attrs["type"] = (
        "greyscale" if image.ndim == 2 or image.shape[-1] == 1 else "color_bgr"
    )


def _add_event_indices(f, ts_path: str, image_groups: Iterable[str]) -> None:
    """Attach ``event_idx`` (index of the event preceding each image's
    timestamp) to every image, as the reference does (``:75-92``)."""
    if ts_path not in f:
        return
    ts = f[ts_path][:]
    for group in image_groups:
        if group not in f:
            continue
        for name in f[group]:
            img = f[f"{group}/{name}"]
            idx = int(np.searchsorted(ts, img.attrs["timestamp"]))
            img.attrs["event_idx"] = max(0, idx - 1)


class H5Packager:
    """Single-stream recording writer (reference ``hdf5_packager``, ``:37-117``)."""

    def __init__(self, output_path: str):
        self.f = _h5py().File(output_path, "w")
        self.events = _EventGroup(self.f, "events")
        self._num_images = 0
        self._num_flow = 0

    def package_events(self, xs, ys, ts, ps) -> None:
        self.events.append(xs, ys, ts, ps)

    def package_image(self, image, timestamp: float, img_idx: Optional[int] = None) -> None:
        idx = self._num_images if img_idx is None else img_idx
        _package_image(self.f, "images", image, timestamp, idx)
        self._num_images += 1

    def package_flow(self, flow, timestamp: float, flow_idx: Optional[int] = None) -> None:
        idx = self._num_flow if flow_idx is None else flow_idx
        flow = np.asarray(flow, np.float32)
        d = self.f.create_dataset(f"flow/flow{idx:09d}", data=flow)
        d.attrs["size"] = flow.shape
        d.attrs["timestamp"] = timestamp
        self._num_flow += 1

    def add_metadata(
        self,
        num_pos: int,
        num_neg: int,
        t0: float,
        tk: float,
        sensor_size: Sequence[int],
    ) -> None:
        a = self.f.attrs
        a["num_events"] = num_pos + num_neg
        a["num_pos"] = num_pos
        a["num_neg"] = num_neg
        a["duration"] = tk - t0
        a["t0"] = t0
        a["tk"] = tk
        a["num_imgs"] = self._num_images
        a["num_flow"] = self._num_flow
        a["sensor_resolution"] = np.asarray(sensor_size, np.int32)
        _add_event_indices(self.f, "events/ts", ("images", "flow"))

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class H5LadderPackager:
    """Multi-resolution recording writer — the training input format
    (reference ``hdf5_event_packager``, ``:119+``; read back by
    ``esr_tpu_torch.data.records.H5Recording``)."""

    def __init__(self, output_path: str, rungs: Sequence[str] = DEFAULT_RUNGS):
        self.f = _h5py().File(output_path, "w")
        self.rungs = tuple(rungs)
        self.groups: Dict[str, _EventGroup] = {
            r: _EventGroup(self.f, f"{r}_events") for r in self.rungs
        }
        self._img_counts: Dict[str, int] = {}

    def package_events(self, rung: str, xs, ys, ts, ps) -> None:
        if rung not in self.groups:
            raise KeyError(f"unknown rung {rung!r}; have {self.rungs}")
        self.groups[rung].append(xs, ys, ts, ps)

    def package_image(self, rung: str, image, timestamp: float, img_idx: Optional[int] = None) -> None:
        idx = self._img_counts.get(rung, 0) if img_idx is None else img_idx
        _package_image(self.f, f"{rung}_images", image, timestamp, idx)
        self._img_counts[rung] = self._img_counts.get(rung, 0) + 1

    def add_metadata(self, sensor_size: Sequence[int]) -> None:
        self.f.attrs["sensor_resolution"] = np.asarray(sensor_size, np.int32)
        for r in self.rungs:
            _add_event_indices(
                self.f, f"{r}_events/ts", (f"{r}_images",)
            )

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
