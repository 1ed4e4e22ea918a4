"""Small HDF5 maintenance tools (the port's own copy of
``esr_tpu/tools/h5_tools.py``; ``h5py``, ``rosbag`` and ``cv2`` are imported
only by the calls that need them):

- :func:`extract_txt_to_h5`: a ``t x y p`` event txt (an optional ``width
  height`` header row) -> single-stream HDF5 via
  :class:`~esr_tpu_torch.tools.packagers.H5Packager`, in chunks, so any
  length streams in O(chunk) memory;
- :func:`add_hdf5_attribute`: attribute editing over files, directories
  or list files;
- :func:`h5_to_memmap` / :func:`read_memmap`: events and frames as raw
  ``np.memmap`` arrays plus ``metadata.json``, and back;
- :func:`read_h5_summary`, :func:`read_h5_events`,
  :func:`read_h5_event_components`: whole-recording readers, the legacy
  ``events/x`` keys included;
- :func:`events_to_ply`: an event cloud as a binary (or ASCII) PLY point
  cloud, written without ``plyfile``;
- :func:`validate_frame_sizes`: a frame-directory check before packaging
  (8-bit greyscale PNGs are read without cv2);
- :func:`extract_rosbag_to_h5` / :func:`extract_rosbags_to_h5`: rosbag
  event, image and flow topics -> packaged HDF5, needing only a ``rosbag``
  reader (``Bag.read_messages()``); a clear ``ImportError`` without one.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from esr_tpu_torch.tools.packagers import H5Packager


def get_filepaths(path: str, extensions: Sequence[str] = (".h5", ".hdf")) -> List[str]:
    """Path / directory / list-file -> file list
    (``add_hdf5_attribute.py:13-26``)."""
    path = path.rstrip("/")
    if os.path.isdir(path):
        out: List[str] = []
        for ext in extensions:
            out += sorted(glob.glob(os.path.join(path, f"*{ext}")))
        return out
    if any(path.endswith(e) for e in extensions):
        return [path]
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def add_hdf5_attribute(
    paths: Sequence[str], group: str, name: str, value, dry_run: bool = False
) -> None:
    import h5py

    for p in paths:
        print(f"adding {p}/{group}[{name}]={value}")
        if dry_run:
            continue
        with h5py.File(p, "a") as f:
            target = f[group] if group else f
            target.attrs[name] = value


def extract_txt_to_h5(
    txt_path: str,
    output_path: str,
    zero_timestamps: bool = False,
    chunksize: int = 100_000,
    sensor_size: Optional[Tuple[int, int]] = None,
) -> Tuple[int, int]:
    """Stream a ``t x y p`` event txt into a single-stream HDF5.

    First line may carry ``width height``; polarity 0 is mapped to -1.
    Returns ``(num_pos, num_neg)``.
    """
    if sensor_size is None:
        try:
            with open(txt_path) as f:
                w, h = (int(v) for v in f.readline().split()[:2])
            sensor_size = (h, w)
        except Exception:
            sensor_size = None

    pk = H5Packager(output_path)
    num_pos = num_neg = 0
    t0 = None
    last_t = 0.0
    max_x = max_y = 0
    with open(txt_path) as f:
        f.readline()  # header
        while True:
            rows = []
            for _ in range(chunksize):
                line = f.readline()
                if not line:
                    break
                rows.append(line.split())
            if not rows:
                break
            arr = np.asarray(rows, np.float64)
            ts, xs, ys, ps = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
            ps = np.where(ps == 0, -1.0, np.sign(ps))
            if t0 is None:
                t0 = float(ts[0])
            if zero_timestamps:
                ts = ts - t0
            pk.package_events(
                xs.astype(np.int16), ys.astype(np.int16), ts, ps
            )
            num_pos += int((ps > 0).sum())
            num_neg += int((ps < 0).sum())
            last_t = float(ts[-1])
            max_x = max(max_x, int(xs.max()))
            max_y = max(max_y, int(ys.max()))
    if sensor_size is None:
        sensor_size = (max_y + 1, max_x + 1)
    pk.add_metadata(
        num_pos, num_neg, 0.0 if zero_timestamps else (t0 or 0.0), last_t,
        sensor_size,
    )
    pk.close()
    return num_pos, num_neg


def h5_to_memmap(h5_path: str, output_dir: str, overwrite: bool = True) -> str:
    """Export a single-stream recording as raw memmaps
    (``h5_to_memmap.py:63-134``): ``t.npy`` float64 [N,1], ``xy.npy`` int16
    [N,2], ``p.npy`` bool [N,1], per-image stacks + timestamps + event
    indices, and the file attrs as ``metadata.json``."""
    import h5py

    if os.path.exists(output_dir):
        if not overwrite:
            raise FileExistsError(output_dir)
        shutil.rmtree(output_dir)
    mmap_dir = os.path.join(output_dir, "memmap")
    os.makedirs(mmap_dir)

    with h5py.File(h5_path, "r") as f:
        n = f["events/ts"].shape[0]
        t = np.memmap(os.path.join(mmap_dir, "t.npy"), "float64", "w+", shape=(n, 1))
        xy = np.memmap(os.path.join(mmap_dir, "xy.npy"), "int16", "w+", shape=(n, 2))
        p = np.memmap(os.path.join(mmap_dir, "p.npy"), "bool", "w+", shape=(n, 1))
        t[:, 0] = f["events/ts"][:]
        xy[:, 0] = f["events/xs"][:]
        xy[:, 1] = f["events/ys"][:]
        p[:, 0] = np.asarray(f["events/ps"][:]) > 0
        t.flush(); xy.flush(); p.flush()

        images_shape = None
        if "images" in f:
            names = sorted(f["images"])
            if names:
                first = f[f"images/{names[0]}"]
                h, w = first.attrs["size"][:2]
                c = 1 if len(first.attrs["size"]) <= 2 else first.attrs["size"][2]
                images_shape = [len(names), int(h), int(w), int(c)]
                imgs = np.memmap(
                    os.path.join(mmap_dir, "images.npy"), "uint8", "w+",
                    shape=tuple(images_shape),
                )
                img_ts = np.memmap(
                    os.path.join(mmap_dir, "timestamps.npy"), "float64", "w+",
                    shape=(len(names), 1),
                )
                idxs = np.memmap(
                    os.path.join(mmap_dir, "image_event_indices.npy"),
                    "uint64", "w+", shape=(len(names), 1),
                )
                for i, name in enumerate(names):
                    d = f[f"images/{name}"]
                    imgs[i] = np.asarray(d[:]).reshape(int(h), int(w), int(c))
                    img_ts[i, 0] = d.attrs["timestamp"]
                    idxs[i, 0] = d.attrs.get("event_idx", 0)
                imgs.flush(); img_ts.flush(); idxs.flush()

        meta = {
            k: (v.tolist() if isinstance(v, np.ndarray) else
                v.item() if isinstance(v, np.generic) else v)
            for k, v in f.attrs.items()
        }
        meta["num_events"] = int(meta.get("num_events", n))
        if images_shape is not None:
            meta["images_shape"] = images_shape
    with open(os.path.join(mmap_dir, "metadata.json"), "w") as js:
        json.dump(meta, js)
    return mmap_dir


def read_h5_summary(h5_path: str) -> Dict:
    """Quick recording inspection (``read_events.py`` role): attrs + per-group
    event counts."""
    import h5py

    out: Dict = {"attrs": {}, "groups": {}}
    with h5py.File(h5_path, "r") as f:
        for k, v in f.attrs.items():
            out["attrs"][k] = v.tolist() if isinstance(v, np.ndarray) else v
        for key in f:
            if key.endswith("_events") or key == "events":
                out["groups"][key] = int(f[f"{key}/ts"].shape[0])
            elif key.endswith("images") or key == "images":
                out["groups"][key] = len(f[key])
    return out


def read_h5_event_components(
    h5_path: str, group: str = "events"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(xs, ys, ts, ps)`` for a whole recording, ``ps`` in {+1, -1};
    accepts both the current ``xs/ys/ts/ps`` keys and the legacy
    ``x/y/ts/p`` scheme (``read_events.py:68-75``)."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        if f"{group}/x" in f:  # legacy
            return (
                f[f"{group}/x"][:], f[f"{group}/y"][:], f[f"{group}/ts"][:],
                np.where(np.asarray(f[f"{group}/p"][:]) > 0, 1, -1),
            )
        return (
            f[f"{group}/xs"][:], f[f"{group}/ys"][:], f[f"{group}/ts"][:],
            np.where(np.asarray(f[f"{group}/ps"][:]) > 0, 1, -1),
        )


def read_h5_events(h5_path: str, group: str = "events") -> np.ndarray:
    """``[N, 4]`` ``(x, y, t, p)`` stack (``read_events.py:59-66``)."""
    xs, ys, ts, ps = read_h5_event_components(h5_path, group)
    return np.stack([xs, ys, ts, ps], axis=1).astype(np.float64)


def read_memmap(mmap_dir: str, return_events: bool = False) -> Dict:
    """Load a :func:`h5_to_memmap` directory back as (mem-mapped) arrays
    (role of ``read_events.py:read_memmap_events``, ``:10-57``).

    Shapes are recovered from the file sizes plus ``metadata.json`` (the
    arrays are raw memmaps, not ``.npy``-with-header). With
    ``return_events=False`` the event arrays stay memory-mapped."""
    with open(os.path.join(mmap_dir, "metadata.json")) as js:
        meta = json.load(js)
    n = os.path.getsize(os.path.join(mmap_dir, "t.npy")) // 8
    data: Dict = {"metadata": meta, "num_events": n, "path": mmap_dir}
    t = np.memmap(os.path.join(mmap_dir, "t.npy"), "float64", "r", shape=(n, 1))
    xy = np.memmap(os.path.join(mmap_dir, "xy.npy"), "int16", "r", shape=(n, 2))
    p = np.memmap(os.path.join(mmap_dir, "p.npy"), "bool", "r", shape=(n, 1))
    if return_events:
        data["t"], data["xy"], data["p"] = t[:], xy[:], p[:]
    else:
        data["t"], data["xy"], data["p"] = t, xy, p
    data["t0"] = float(t[0, 0]) if n else 0.0

    ts_path = os.path.join(mmap_dir, "timestamps.npy")
    if os.path.exists(ts_path):
        n_img = os.path.getsize(ts_path) // 8
        data["frame_stamps"] = np.memmap(ts_path, "float64", "r", shape=(n_img, 1))
        data["index"] = np.memmap(
            os.path.join(mmap_dir, "image_event_indices.npy"),
            "uint64", "r", shape=(n_img, 1),
        )
        img_path = os.path.join(mmap_dir, "images.npy")
        shape = meta.get("images_shape")
        if shape is None and os.path.exists(img_path):
            # pre-images_shape exports: frames were written at sensor size
            res = meta.get("sensor_resolution")
            if res is not None:
                h, w = int(res[0]), int(res[1])
                denom = n_img * h * w
                size = os.path.getsize(img_path)
                c = size // max(denom, 1)
                # only trust the inference when the file divides exactly —
                # frames not at sensor size (or a truncated file) would
                # otherwise make np.memmap raise instead of skipping images
                if c > 0 and c * denom == size:
                    shape = [n_img, h, w, c]
        if shape is not None and os.path.exists(img_path):
            data["images"] = np.memmap(
                img_path, "uint8", "r", shape=tuple(shape)
            )
    return data


def events_to_ply(
    events: np.ndarray,
    resolution: Tuple[int, int],
    output_path: str,
    text: bool = False,
) -> int:
    """Event cloud -> PLY point cloud (``hxy_events2ply.py:22-71``): vertices
    ``(x, y, z=t)`` with ``t`` min-max-normalized to the sensor height so the
    cloud is roughly cubic, colored red=positive / blue=negative. Written as
    binary-little-endian (or ASCII with ``text=True``) without ``plyfile``.

    ``events``: ``[N, 4]`` ``(x, y, t, p)``, ``p`` in {+1, -1}.
    Returns the number of vertices written.
    """
    events = np.asarray(events)
    n = len(events)
    xs = events[:, 0].astype("<f4")
    ys = events[:, 1].astype("<f4")
    ts = events[:, 2].astype(np.float64)
    ps = events[:, 3]
    if n:
        rng = ts.max() - ts.min()
        ts = (ts - ts.min()) / (rng if rng else 1.0) * resolution[0]

    vertices = np.empty(
        n,
        dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
               ("red", "u1"), ("green", "u1"), ("blue", "u1")],
    )
    vertices["x"] = xs
    vertices["y"] = ys
    vertices["z"] = ts.astype("<f4")
    vertices["red"] = np.where(ps > 0, 255, 0).astype("u1")
    vertices["green"] = 0
    vertices["blue"] = np.where(ps < 0, 255, 0).astype("u1")

    fmt = "ascii" if text else "binary_little_endian"
    header = (
        f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    with open(output_path, "wb") as f:
        f.write(header.encode("ascii"))
        if text:
            for v in vertices:
                f.write(
                    f"{v['x']:g} {v['y']:g} {v['z']:g} "
                    f"{v['red']} {v['green']} {v['blue']}\n".encode("ascii")
                )
        else:
            f.write(vertices.tobytes())
    return n


def _frame_size(path: str) -> Optional[Tuple[int, int]]:
    """A frame's (H, W), None when unreadable: an 8-bit greyscale PNG is
    read here, any other image through ``cv2.imread``."""
    from esr_tpu_torch.tools.simulate import read_png_gray8

    if path.lower().endswith(".png"):
        try:
            return read_png_gray8(path).shape[:2]
        except (ValueError, OSError, zlib.error):
            pass
    import cv2

    img = cv2.imread(path)
    return None if img is None else img.shape[:2]


def validate_frame_sizes(
    root: str, expected: Tuple[int, int] = (720, 1280), pattern: str = "*.jpg"
) -> Dict[str, List[str]]:
    """Frame-dataset sanity check (reference
    ``generate_dataset/test_size.py:11-20``): EVERY frame must be landscape
    and match ``expected`` (H, W); unreadable frames are flagged too.
    Returns ``{'portrait': [...], 'mismatched': [...], 'unreadable': [...]}``
    of offending sequence directories."""
    bad: Dict[str, List[str]] = {"portrait": [], "mismatched": [], "unreadable": []}
    for dirpath, _, _ in os.walk(root):
        frames = sorted(glob.glob(os.path.join(dirpath, pattern)))
        if not frames:
            continue
        flags = set()
        for fp in frames:
            size = _frame_size(fp)
            if size is None:
                flags.add("unreadable")
                continue
            h, w = size
            if h > w:
                flags.add("portrait")
            if (h, w) != tuple(expected):
                flags.add("mismatched")
        for k in flags:
            bad[k].append(dirpath)
    return bad


def _ros_stamp_to_float(stamp) -> float:
    """ROS ``Time`` -> float seconds (reference ``rosbag_to_h5.py:21-22``)."""
    return stamp.secs + stamp.nsecs / 1e9


def _decode_ros_image(msg, is_color: bool) -> np.ndarray:
    """Decode a ``sensor_msgs/Image`` without cv_bridge.

    The reference routes every frame through ``CvBridge().imgmsg_to_cv2``
    (``rosbag_to_h5.py:84-87``); this build decodes the raw buffer directly
    (mono8 / bgr8 / rgb8 cover event-camera bags) so the converter needs only
    ``rosbag`` itself, not the full ROS vision stack. Output matches the
    reference convention: ``mono8`` (H, W) unless ``is_color``, else ``bgr8``
    (H, W, 3).
    """
    enc = getattr(msg, "encoding", "mono8")
    buf = np.frombuffer(bytes(msg.data), np.uint8)

    def rows(channels: int) -> np.ndarray:
        # honor the row stride (sensor_msgs/Image.step — alignment padding
        # is common for widths that aren't a multiple of 4); cv_bridge does
        # the same. A missing/zero step means tightly packed.
        step = int(getattr(msg, "step", 0)) or msg.width * channels
        img = buf.reshape(msg.height, step)[:, : msg.width * channels]
        return img.reshape(msg.height, msg.width, channels)

    if enc == "mono8":
        img = rows(1)[..., 0]
        if is_color:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img
    if enc in ("bgr8", "rgb8"):
        img = rows(3)
        if enc == "rgb8":
            img = img[..., ::-1]  # reference output convention is bgr8
        if not is_color:
            # ITU-R BT.601 luma, same weights AND rounding as
            # cv_bridge/OpenCV (cvtColor rounds; truncation would differ
            # by 1 LSB on ~half of all pixels)
            b, g, r = img[..., 0], img[..., 1], img[..., 2]
            img = np.rint(
                0.114 * b + 0.587 * g + 0.299 * r
            ).astype(np.uint8)
        return img
    raise ValueError(f"unsupported image encoding {enc!r}")


def extract_rosbag_to_h5(
    rosbag_path: str,
    output_path: str,
    event_topic: str = "/dvs/events",
    image_topic: Optional[str] = None,
    flow_topic: Optional[str] = None,
    start_time: Optional[float] = None,
    end_time: Optional[float] = None,
    zero_timestamps: bool = False,
    is_color: bool = False,
    sensor_size: Optional[Tuple[int, int]] = None,
) -> Dict[str, float]:
    """Stream one rosbag's event/image/flow topics into the packaged h5.

    Rebuilds the reference converter
    (``generate_dataset/tools/rosbag_to_h5.py:44-144``) on
    :class:`~esr_tpu_torch.tools.packagers.H5Packager`: events are appended
    per-message (never buffered whole), images/flows are written as they
    arrive, and the final metadata records counts, t0/tk and the sensor
    resolution. Returns a stats dict
    ``{num_pos, num_neg, num_imgs, num_flow, t0, last_ts}``.

    Deliberate deviations from the reference, by behavior:

    - ``zero_timestamps`` + default ``start_time``: the reference sets
      ``start_time = first_ts`` (absolute) while comparing it against
      already-zeroed timestamps (``rosbag_to_h5.py:66-79,111-112``), which
      filters out every event; here the default window opens at the first
      observed timestamp in the SAME time base as the filter.
    - sensor-size inference from events grows as ``(max_y+1, max_x+1)``
      (coordinates are 0-based) instead of the reference's ``[max(xs),
      max(ys)]`` with transposed comparisons (``:135-136``).
    - images decode without cv_bridge (see :func:`_decode_ros_image`).

    Requires only the ``rosbag`` reader API: ``Bag.read_messages()`` yielding
    ``(topic, msg, t)`` — any module providing that duck-type works (the test
    suite injects a synthetic one).
    """
    try:
        import rosbag
    except ImportError as e:
        raise ImportError(
            "rosbag conversion needs the ROS python stack (rosbag); install "
            "ROS or convert offline with the reference tooling, then import "
            "the h5 here."
        ) from e

    from esr_tpu_torch.tools.packagers import H5Packager

    if not os.path.exists(rosbag_path):
        raise FileNotFoundError(rosbag_path)

    topics = (event_topic, image_topic, flow_topic)
    first_ts = None
    num_pos = num_neg = img_cnt = flow_cnt = 0
    last_ts = 0.0
    t0 = 0.0
    # An explicit sensor_size is authoritative (recorded as-is); otherwise
    # it is inferred and only ever GROWS per dimension.
    size_fixed = sensor_size is not None
    size = tuple(sensor_size) if size_fixed else None

    with H5Packager(output_path) as ep, rosbag.Bag(rosbag_path, "r") as bag:
        for topic, msg, _t in bag.read_messages():
            if topic not in topics:
                continue
            if first_ts is None:
                stamp = getattr(msg, "header", None)
                if stamp is not None:
                    first_ts = _ros_stamp_to_float(stamp.stamp)
                elif getattr(msg, "events", None):
                    first_ts = _ros_stamp_to_float(msg.events[0].ts)
                else:
                    continue  # header-less empty packet: no time base yet
                if start_time is None:
                    start_time = 0.0 if zero_timestamps else first_ts
                if end_time is None:
                    end_time = float("inf")
                t0 = start_time

            off = first_ts if zero_timestamps else 0.0

            if topic == image_topic:
                ts = _ros_stamp_to_float(msg.header.stamp) - off
                if start_time <= ts <= end_time:
                    image = _decode_ros_image(msg, is_color)
                    ep.package_image(image, ts, img_cnt)
                    if not size_fixed:
                        # same only-ever-grows rule as the event branch, so
                        # arrival order can never shrink the recorded size
                        ih, iw = image.shape[:2]
                        size = (ih, iw) if size is None else (
                            max(size[0], ih), max(size[1], iw)
                        )
                    img_cnt += 1
            elif topic == flow_topic:
                ts = _ros_stamp_to_float(msg.header.stamp) - off
                if start_time <= ts <= end_time:
                    flow_x = np.asarray(msg.flow_x, np.float32).reshape(
                        msg.height, msg.width
                    )
                    flow_y = np.asarray(msg.flow_y, np.float32).reshape(
                        msg.height, msg.width
                    )
                    ep.package_flow(
                        np.stack((flow_x, flow_y), axis=0), ts, flow_cnt
                    )
                    flow_cnt += 1
            elif topic == event_topic:
                xs, ys, ts_, ps = [], [], [], []
                for e in msg.events:
                    ts = _ros_stamp_to_float(e.ts) - off
                    if start_time <= ts <= end_time:
                        xs.append(e.x)
                        ys.append(e.y)
                        ts_.append(ts)
                        ps.append(1 if e.polarity else 0)
                        if e.polarity:
                            num_pos += 1
                        else:
                            num_neg += 1
                        last_ts = ts
                if xs:
                    if not size_fixed:
                        grown = (max(ys) + 1, max(xs) + 1)
                        size = grown if size is None else (
                            max(size[0], grown[0]), max(size[1], grown[1])
                        )
                    ep.package_events(xs, ys, ts_, ps)
                # events arrive time-ordered: once the last event in a
                # message is past the window, stop reading the bag
                # (reference ``:133-134`` returns without metadata; writing
                # the metadata for the collected prefix is strictly better)
                if msg.events and ts > end_time:
                    break
        if num_pos + num_neg == 0:
            # no event passed the window: tk would otherwise keep its 0.0
            # initializer and write a negative duration for t0 > 0 bags
            last_ts = t0
        ep.add_metadata(num_pos, num_neg, t0, last_ts, size or (0, 0))
    return {
        "num_pos": num_pos,
        "num_neg": num_neg,
        "num_imgs": img_cnt,
        "num_flow": flow_cnt,
        "t0": t0,
        "last_ts": last_ts,
        "sensor_size": size,
    }


def extract_rosbags_to_h5(
    rosbag_paths: Sequence[str], output_dir: str, **kwargs
) -> List[str]:
    """Batch driver (reference ``rosbag_to_h5.py:147-155``): one h5 per bag,
    named after the bag."""
    os.makedirs(output_dir, exist_ok=True)
    outs = []
    for path in rosbag_paths:
        bagname = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(output_dir, f"{bagname}.h5")
        extract_rosbag_to_h5(path, out_path, **kwargs)
        outs.append(out_path)
    return outs
