"""Event-camera simulation and dataset generation (counterpart of
``esr_tpu/tools/simulate.py``), numpy only.

:class:`EventSimulator` is the ESIM contrast-threshold model (per-pixel
log-intensity reference levels, linearly interpolated crossing times, a
refractory period); :func:`sample_contrast_thresholds` draws the
per-sequence thresholds. :func:`simulate_ladder_recording` writes the
multi-resolution training format through
:class:`esr_tpu_torch.tools.packagers.H5LadderPackager`;
:func:`simulate_memory_recording` builds the same recording in memory
(:class:`esr_tpu_torch.data.records.MemoryRecording`, what a machine
without ``h5py`` serves). :func:`convert_eventzoom` converts the EventZoom
txt dumps.

Neither ``cv2`` nor ``h5py`` is needed to simulate. Each rung's frames are
downscaled by :func:`resize_cubic`, OpenCV's own ``INTER_CUBIC`` for
``uint8`` images written out in numpy, bitwise ``cv2.resize``: the
simulator thresholds log intensities, so a resize one grey level off
makes other events. :func:`read_png_gray8` reads the 8-bit greyscale PNGs
of :meth:`EventSimulator.generate_from_folder`.
"""

from __future__ import annotations

import os
import struct
import zlib
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from esr_tpu_torch.data.records import MemoryRecording

DEFAULT_SIM_CONFIG = {
    "CT_range": (0.2, 0.5),
    "mu": 1.0,
    "sigma": 0.1,
    "min_CT": 0.01,
    "max_CT": 2.0,
    "refractory_period": 1e-4,
    "log_eps": 1e-3,
    "use_log": True,
}


def sample_contrast_thresholds(config: Dict = DEFAULT_SIM_CONFIG,
                               rng: Optional[np.random.Generator] = None
                               ) -> Tuple[float, float]:
    """One sequence's (Cp, Cn): Cp uniform in ``CT_range``, Cn = Cp times a
    normal draw, both clipped to [min_CT, max_CT]."""
    rng = rng or np.random.default_rng()
    cp = rng.uniform(*config["CT_range"])
    cn = rng.normal(config["mu"], config["sigma"]) * cp
    cp = float(np.clip(cp, config["min_CT"], config["max_CT"]))
    cn = float(np.clip(cn, config["min_CT"], config["max_CT"]))
    return cp, cn


# -- OpenCV's INTER_CUBIC for uint8, in numpy --------------------------------

_COEF_SCALE = 2048  # INTER_RESIZE_COEF_SCALE: 11 fractional bits
_VLANES = 8  # the vertical pass's SIMD width (int16 lanes of a 128-bit vector)


def _cubic_table(src_n: int, dst_n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per output index, the source index ``floor(f)`` and the four
    fixed-point cubic weights (A = -0.75), computed in float32 as OpenCV
    computes them and rounded to nearest even."""
    scale = 1.0 / (dst_n / src_n)
    f = ((np.arange(dst_n, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = (f - s.astype(np.float32)).astype(np.float32)
    a = np.float32(-0.75)
    one = np.float32(1.0)
    x1 = x + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    ox = one - x
    c2 = ((a + np.float32(2)) * ox - (a + np.float32(3))) * ox * ox + one
    c3 = one - c0 - c1 - c2
    coef = np.stack([c0, c1, c2, c3], axis=-1).astype(np.float32)
    return s, np.rint(coef * np.float32(_COEF_SCALE)).astype(np.int64)


def resize_cubic(src: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(src, dsize, interpolation=cv2.INTER_CUBIC)`` of a
    ``uint8`` image ``[H, W]`` or ``[H, W, C]``; ``dsize`` is ``(width,
    height)`` as cv2 takes it. The same size is a copy.

    OpenCV's arithmetic: fixed-point weights with 11 fractional bits, the
    border replicated; a horizontal pass in integers; a vertical pass that
    runs in float32 over the row's first ``8 * floor(width / 8)`` values
    (its 128-bit SIMD body: ``b3 * S3``, then ``+ b2 * S2``, ``+ b1 * S1``,
    ``+ b0 * S0``, each product and sum rounded, the result rounded to
    nearest even) and in integers over the rest (``(sum + 2**21) >> 22``);
    both saturate to [0, 255]. That is bitwise ``cv2.resize`` wherever
    OpenCV resizes by its own code. A build with Intel IPP (the pip
    wheels) hands a non-integer size ratio to IPP's float resize, which
    differs from OpenCV's own by at most one grey level on a few percent
    of the pixels; every rung of a ladder whose sizes divide by its factor
    is an integer ratio, which OpenCV keeps."""
    src = np.asarray(src)
    if src.dtype != np.uint8:
        raise TypeError(f"resize_cubic takes uint8 images, got {src.dtype}")
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = src.shape[:2]
    if (dw, dh) == (w, h):
        return src.copy()
    cn = 1 if src.ndim == 2 else src.shape[2]
    sx, ax = _cubic_table(w, dw)
    sy, ay = _cubic_table(h, dh)
    taps = np.arange(-1, 3)
    cols = np.clip(sx[:, None] + taps, 0, w - 1)
    rows = np.clip(sy[:, None] + taps, 0, h - 1)
    pix = src.reshape(h, w, cn).astype(np.int64)
    horiz = (pix[:, cols, :] * ax[None, :, :, None]).sum(axis=2).reshape(h, dw * cn)
    stacked = horiz[rows]  # [dh, 4, dw * cn]
    out = np.empty((dh, dw * cn), np.int64)
    nvec = (dw * cn // _VLANES) * _VLANES
    if nvec:
        beta = ay.astype(np.float32) * np.float32(1.0 / (_COEF_SCALE * _COEF_SCALE))
        s = stacked[:, :, :nvec].astype(np.float32)
        acc = s[:, 3] * beta[:, 3:4]
        for k in (2, 1, 0):
            acc = s[:, k] * beta[:, k:k + 1] + acc
        out[:, :nvec] = np.rint(acc).astype(np.int64)
    if nvec < dw * cn:
        total = (stacked[:, :, nvec:] * ay[:, :, None]).sum(axis=1)
        out[:, nvec:] = (total + (1 << 21)) >> 22
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out.reshape((dh, dw) if src.ndim == 2 else (dh, dw, cn))


# -- PNG, 8-bit greyscale -----------------------------------------------------

def _needs_cv2(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what}; the port reads 8-bit greyscale PNGs itself, "
                      "any other image needs cv2 (cv2.imread) to be read")


def read_png_gray8(path: str) -> np.ndarray:
    """An 8-bit greyscale, non-interlaced PNG as a ``uint8 [H, W]`` array
    (what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives for it); any
    other image raises ``ValueError`` naming cv2."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise _needs_cv2(path, "not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise _needs_cv2(path, "no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color != 0 or interlace != 0:
        raise _needs_cv2(path, f"bit depth {depth}, colour type {color}, interlace "
                         f"{interlace} (not 8-bit greyscale, non-interlaced)")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w + 1)
    out = np.zeros((h, w), np.uint8)
    prev = np.zeros(w, np.int64)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along the row
            cur = np.cumsum(line) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            cur = np.zeros(w, np.int64)
            left = up_left = 0
            for x in range(w):
                up = int(prev[x])
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
                    pred = left if pa <= pb and pa <= pc else (up if pb <= pc else up_left)
                left = (int(line[x]) + pred) & 0xFF
                cur[x] = left
                up_left = up
        else:
            raise _needs_cv2(path, f"unknown PNG filter {kind}")
        out[y] = cur
        prev = cur
    return out


class EventSimulator:
    """ESIM contrast-threshold event simulation, vectorized numpy.

    Per pixel a reference level tracks the log intensity at the last event;
    when the log intensity, interpolated linearly between two frames,
    crosses ``k`` thresholds, ``k`` events fire at the interpolated
    crossing times; an event within ``refractory_period`` of the pixel's
    previous event is suppressed."""

    def __init__(self, cp: float = 0.3, cn: float = 0.3, refractory_period: float = 1e-4,
                 log_eps: float = 1e-3, use_log: bool = True):
        self.set_parameters(cp, cn, refractory_period, log_eps, use_log)

    def set_parameters(self, cp, cn, refractory_period, log_eps, use_log):
        assert cp > 0 and cn > 0
        self.cp, self.cn = float(cp), float(cn)
        self.refractory_period = float(refractory_period)
        self.log_eps = float(log_eps)
        self.use_log = bool(use_log)

    def _intensity(self, frame: np.ndarray) -> np.ndarray:
        img = np.asarray(frame, np.float64)
        if img.ndim == 3:  # colour -> luma
            img = img.mean(axis=-1)
        if img.max() > 1.5:
            img = img / 255.0
        # a bicubic downscale can overshoot below 0: clamp before the log
        img = np.clip(img, 0.0, None)
        return np.log(img + self.log_eps) if self.use_log else img

    def generate_from_frames(self, frames: Sequence[np.ndarray],
                             timestamps: Sequence[float]) -> np.ndarray:
        """``frames [T, H, W(, C)]`` and ``timestamps [T]`` -> events
        ``[N, 4]`` (x, y, t, p), stably time-sorted."""
        assert len(frames) == len(timestamps) and len(frames) >= 2
        ts = np.asarray(timestamps, np.float64)
        prev = self._intensity(frames[0])
        h, w = prev.shape
        ref = prev.copy()
        last_t = np.full(h * w, -np.inf)
        out = []
        for i in range(1, len(frames)):
            cur = self._intensity(frames[i])
            t0, t1 = ts[i - 1], ts[i]
            dlog = cur - prev
            for sign, thr in ((1.0, self.cp), (-1.0, self.cn)):
                step = sign * thr
                # crossings this pair: multiples of ``step`` between ref and
                # cur, counted only in the direction of change
                delta = (cur - ref) * sign
                n_cross = np.maximum(np.floor(delta / thr).astype(np.int64), 0)
                n_cross = np.where(sign * dlog > 0, n_cross, 0)
                # the k-th crossing of every pixel with at least k, in raster
                # order; a pixel leaves the working set after its last one
                pix = np.flatnonzero(n_cross)
                left = n_cross.reshape(-1)[pix]
                ref_p, prev_p, dlog_p = (a.reshape(-1)[pix] for a in (ref, prev, dlog))
                last_p = last_t[pix]
                k = 1
                while pix.size:
                    level = ref_p + step * k
                    frac = (level - prev_p) / np.where(dlog_p == 0, 1e-12, dlog_p)
                    frac = np.clip(frac, 0.0, 1.0)
                    t_ev = t0 + frac * (t1 - t0)
                    keep = t_ev - last_p >= self.refractory_period
                    tk = t_ev[keep]
                    if tk.size:
                        fired = pix[keep]
                        out.append(np.stack([fired % w, fired // w, tk,
                                             np.full(tk.shape, sign)], axis=1))
                        last_p[keep] = tk
                    done = left == k
                    last_t[pix[done]] = last_p[done]
                    stay = ~done
                    pix, left, ref_p, prev_p, dlog_p, last_p = (
                        a[stay] for a in (pix, left, ref_p, prev_p, dlog_p, last_p))
                    k += 1
                ref = ref + step * n_cross
            prev = cur
        if not out:
            return np.zeros((0, 4), np.float64)
        events = np.concatenate(out, axis=0)
        return events[np.argsort(events[:, 2], kind="stable")]

    def generate_from_folder(self, folder: str, timestamps_file: str) -> np.ndarray:
        """Sorted ``*.jpg`` and ``*.png`` frames of ``folder`` and a
        timestamps txt (one float per line). The frames must be 8-bit
        greyscale PNGs (:func:`read_png_gray8`); any other image raises
        ``ValueError`` naming cv2."""
        paths = sorted(glob(os.path.join(folder, "*.jpg")) + glob(os.path.join(folder, "*.png")))
        ts = np.loadtxt(timestamps_file).reshape(-1)[: len(paths)]
        frames = [read_png_gray8(p) for p in paths]
        return self.generate_from_frames(frames, ts)


_RUNG_FACTOR = {"ori": 1, "down2": 2, "down4": 4, "down8": 8, "down16": 16}
DEFAULT_RUNGS = ("ori", "down2", "down4", "down8", "down16")


def _ladder(frames: Sequence[np.ndarray], timestamps: Sequence[float],
            rungs: Sequence[str], sim_config: Dict, seed: int
            ) -> Tuple[Tuple[float, float], Tuple[int, int], Iterator]:
    """The ladder's (cp, cn), the frames' size, and an iterator of ``(rung,
    events [N, 4], scaled frames)``: each rung's frames bicubic-downscaled
    to ``round(size / factor)``, its events simulated with the one (Cp, Cn)
    draw every rung shares."""
    rng = np.random.default_rng(seed)
    cp, cn = sample_contrast_thresholds(sim_config, rng)
    sim = EventSimulator(cp, cn, sim_config["refractory_period"], sim_config["log_eps"],
                         sim_config["use_log"])
    h, w = np.asarray(frames[0]).shape[:2]

    def rung_iter():
        for rung in rungs:
            f = _RUNG_FACTOR[rung]
            rh, rw = round(h / f), round(w / f)
            scaled = [resize_cubic(np.asarray(fr), (rw, rh)) for fr in frames]
            yield rung, sim.generate_from_frames(scaled, timestamps), scaled

    return (cp, cn), (h, w), rung_iter()


def _gray_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    return img.astype(np.uint8)


def simulate_ladder_recording(frames: Sequence[np.ndarray], timestamps: Sequence[float],
                              output_path: str, rungs: Sequence[str] = DEFAULT_RUNGS,
                              sim_config: Dict = DEFAULT_SIM_CONFIG, seed: int = 0
                              ) -> Tuple[float, float]:
    """Frames -> the multi-resolution event HDF5 at ``output_path`` (needs
    ``h5py``): per rung the downscaled frames' events, the ``ori`` frames as
    images, and the frames' size as ``sensor_resolution``. Returns the
    sampled ``(cp, cn)``."""
    from esr_tpu_torch.tools.packagers import H5LadderPackager

    (cp, cn), size, ladder = _ladder(frames, timestamps, rungs, sim_config, seed)
    with H5LadderPackager(output_path, rungs=rungs) as pk:
        for rung, ev, scaled in ladder:
            pk.package_events(rung, ev[:, 0], ev[:, 1], ev[:, 2], ev[:, 3])
            if rung == "ori":
                for idx, (fr, t) in enumerate(zip(scaled, timestamps)):
                    pk.package_image("ori", _gray_u8(fr), float(t), idx)
        pk.add_metadata(size)
    return cp, cn


def simulate_memory_recording(frames: Sequence[np.ndarray], timestamps: Sequence[float],
                              rungs: Sequence[str] = DEFAULT_RUNGS,
                              sim_config: Dict = DEFAULT_SIM_CONFIG, seed: int = 0,
                              name: str = "simulated"
                              ) -> Tuple[MemoryRecording, Tuple[float, float]]:
    """:func:`simulate_ladder_recording`'s recording kept in memory, with
    the dtypes its HDF5 stores (``xs``/``ys`` int16, ``ts``/``ps`` float64,
    the ``ori`` frames uint8), so reading either back gives the same
    windows. Returns ``(recording, (cp, cn))``."""
    (cp, cn), size, ladder = _ladder(frames, timestamps, rungs, sim_config, seed)
    streams, images = {}, []
    for rung, ev, scaled in ladder:
        streams[rung] = (ev[:, 0].astype(np.int16), ev[:, 1].astype(np.int16),
                         ev[:, 2].astype(np.float64), ev[:, 3].astype(np.float64))
        if rung == "ori":
            images = [_gray_u8(fr) for fr in scaled]
    frame_ts = [float(t) for t in timestamps] if images else None
    return MemoryRecording(size, streams, images or None, frame_ts, name=name), (cp, cn)


def render_scene_frames(seed: int, num_frames: int = 36, h: int = 720, w: int = 1280,
                        fps: float = 20.0, disc_radius_scale: float = 1.0
                        ) -> Tuple[list, np.ndarray]:
    """A procedurally textured drifting scene -> (uint8 frames [H, W], ts):
    four drifting gratings at random orientation and frequency plus
    high-contrast moving discs, so every ladder rung sees dense brightness
    changes. ``disc_radius_scale`` multiplies the disc radii (drawn for a
    720p frame)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    n_g = 4
    theta = rng.uniform(0, np.pi, n_g)
    freq = rng.uniform(0.02, 0.12, n_g)  # cycles / pixel
    amp = rng.uniform(0.3, 1.0, n_g)
    vel = rng.uniform(-120, 120, (n_g, 2))  # px / s

    n_b = 6
    cy = rng.uniform(0, h, n_b)
    cx = rng.uniform(0, w, n_b)
    r = rng.uniform(30, 120, n_b) * disc_radius_scale
    bvel = rng.uniform(-150, 150, (n_b, 2))
    bsign = rng.choice([-1.0, 1.0], n_b)

    frames, ts = [], []
    for i in range(num_frames):
        t = i / fps
        img = np.zeros((h, w), np.float32)
        for g in range(n_g):
            ph = ((xx - vel[g, 1] * t) * np.cos(theta[g])
                  + (yy - vel[g, 0] * t) * np.sin(theta[g])) * (2 * np.pi * freq[g])
            img += amp[g] * np.sin(ph)
        img = (img - img.min()) / (img.max() - img.min() + 1e-9)
        for bi in range(n_b):
            by = (cy[bi] + bvel[bi, 0] * t) % h
            bx = (cx[bi] + bvel[bi, 1] * t) % w
            d2 = (yy - by) ** 2 + (xx - bx) ** 2
            img += bsign[bi] * 0.5 * np.exp(-d2 / (2 * (r[bi] / 2) ** 2))
        img = np.clip(img, 0, 1)
        frames.append((img * 255).astype(np.uint8))
        ts.append(t)
    return frames, np.asarray(ts)


def _bilinear_sample(scene: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Bilinear gather from ``scene [H, W]`` at float coordinates (clamped)."""
    hh, ww = scene.shape
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    wy = (ys - y0).astype(np.float32)
    wx = (xs - x0).astype(np.float32)
    y0c = np.clip(y0, 0, hh - 1)
    y1c = np.clip(y0 + 1, 0, hh - 1)
    x0c = np.clip(x0, 0, ww - 1)
    x1c = np.clip(x0 + 1, 0, ww - 1)
    return (scene[y0c, x0c] * (1 - wy) * (1 - wx) + scene[y0c, x1c] * (1 - wy) * wx
            + scene[y1c, x0c] * wy * (1 - wx) + scene[y1c, x1c] * wy * wx)


def render_natural_frames(seed: int, num_frames: int = 36, h: int = 360, w: int = 640,
                          fps: float = 20.0, n_leaves: int = 4000
                          ) -> Tuple[list, np.ndarray]:
    """A scene with natural-image statistics -> (uint8 frames [H, W], ts): a
    dead-leaves background (occluding discs, power-law radii, a mild
    gradient each), a 1/f illumination field, a smooth camera pan and zoom
    over a margin-padded scene, and textured foreground objects moving on
    straight paths. Deterministic per seed."""
    rng = np.random.default_rng(seed)
    margin = 0.25
    hh = int(round(h * (1 + 2 * margin)))
    ww = int(round(w * (1 + 2 * margin)))

    # dead leaves: radii with p(r) ~ r^-3 by the inverse CDF, painted back
    # to front so later leaves occlude
    r_min, r_max = 2.0, min(hh, ww) / 3.0
    u = rng.uniform(size=n_leaves)
    radii = 1.0 / np.sqrt(u / r_min ** 2 + (1 - u) / r_max ** 2)
    cys = rng.uniform(0, hh, n_leaves)
    cxs = rng.uniform(0, ww, n_leaves)
    grays = rng.uniform(0.05, 0.95, n_leaves)
    gdir = rng.uniform(-1, 1, (n_leaves, 2))
    scene = np.full((hh, ww), 0.5, np.float32)
    for i in range(n_leaves):
        ri = radii[i]
        y0, y1 = int(max(0, cys[i] - ri)), int(min(hh, cys[i] + ri + 1))
        x0, x1 = int(max(0, cxs[i] - ri)), int(min(ww, cxs[i] + ri + 1))
        if y0 >= y1 or x0 >= x1:
            continue
        py, px = np.mgrid[y0:y1, x0:x1]
        m = (py - cys[i]) ** 2 + (px - cxs[i]) ** 2 <= ri * ri
        shade = (gdir[i, 0] * (py - cys[i]) + gdir[i, 1] * (px - cxs[i])) / (ri + 1.0) * 0.15
        patch = scene[y0:y1, x0:x1]
        patch[m] = np.clip(grays[i] + shade, 0.02, 0.98)[m]

    # 1/f illumination (pink noise by spectral shaping)
    fy = np.fft.fftfreq(hh)[:, None]
    fx = np.fft.fftfreq(ww)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    spec = (rng.standard_normal((hh, ww)) + 1j * rng.standard_normal((hh, ww))) / f
    illum = np.real(np.fft.ifft2(spec)).astype(np.float32)
    illum = (illum - illum.mean()) / (illum.std() + 1e-9)
    scene = scene * (1.0 + 0.15 * illum)

    # foreground objects: textured discs on straight paths
    n_obj = 2
    obj_r = rng.uniform(0.06, 0.12, n_obj) * min(h, w)
    obj_y0 = rng.uniform(0.2, 0.8, n_obj) * h
    obj_x0 = rng.uniform(0.2, 0.8, n_obj) * w
    obj_vel = rng.uniform(-0.22, 0.22, (n_obj, 2)) * min(h, w)  # px/s
    obj_gray = rng.uniform(0.1, 0.9, n_obj)
    obj_phase = rng.uniform(0, 2 * np.pi, n_obj)
    obj_freq = rng.uniform(0.05, 0.15, n_obj)  # texture cycles/px

    # camera: a smooth sinusoidal pan inside the margin and a slow zoom
    pan_amp_y = rng.uniform(0.4, 0.9) * margin * h
    pan_amp_x = rng.uniform(0.4, 0.9) * margin * w
    pan_f = rng.uniform(0.1, 0.3, 2)  # Hz
    pan_ph = rng.uniform(0, 2 * np.pi, 2)
    zoom_amp = rng.uniform(0.02, 0.06)
    zoom_f = rng.uniform(0.08, 0.2)
    zoom_ph = rng.uniform(0, 2 * np.pi)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames, ts = [], []
    for i in range(num_frames):
        t = i / fps
        zoom = 1.0 + zoom_amp * np.sin(2 * np.pi * zoom_f * t + zoom_ph)
        oy = hh / 2 + pan_amp_y * np.sin(2 * np.pi * pan_f[0] * t + pan_ph[0])
        ox = ww / 2 + pan_amp_x * np.sin(2 * np.pi * pan_f[1] * t + pan_ph[1])
        img = _bilinear_sample(scene, oy + (yy - h / 2) * zoom, ox + (xx - w / 2) * zoom)
        for oi in range(n_obj):
            cy = obj_y0[oi] + obj_vel[oi, 0] * t
            cx = obj_x0[oi] + obj_vel[oi, 1] * t
            m = (yy - cy) ** 2 + (xx - cx) ** 2 <= obj_r[oi] ** 2
            if m.any():
                tex = obj_gray[oi] + 0.25 * np.sin(
                    2 * np.pi * obj_freq[oi] * (xx + yy) + obj_phase[oi])
                img = np.where(m, np.clip(tex, 0.02, 0.98), img)
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
        ts.append(t)
    return frames, np.asarray(ts)


def read_txt_events(path: str) -> np.ndarray:
    """EventZoom txt (``t x y p``, p in {0, 1}, one header row) -> ``[N, 4]``
    (x, y, t, +-1)."""
    raw = np.loadtxt(path, skiprows=1)
    t, x, y, p = raw[:, 0], raw[:, 1], raw[:, 2], raw[:, 3]
    p = np.where(p == 0, -1.0, p)
    return np.stack([x, y, t, p], axis=1)


def convert_eventzoom(root_data_path: str, path_to_h5: str,
                      sensor_resolution: Tuple[int, int] = (124, 222)) -> int:
    """EventZoom's three-rate txt directories (``ev_hr``, ``ev_lr_1``,
    ``ev_llr_1``) -> ladder HDF5 recordings with the ori / down2 / down4
    rungs (needs ``h5py``). Returns the number written."""
    from esr_tpu_torch.tools.packagers import H5LadderPackager

    dirs: Dict[str, List[str]] = {
        "ori": sorted(glob(os.path.join(root_data_path, "data/ev_hr", "*.txt"))),
        "down2": sorted(glob(os.path.join(root_data_path, "data/ev_lr_1", "*.txt"))),
        "down4": sorted(glob(os.path.join(root_data_path, "data/ev_llr_1", "*.txt"))),
    }
    os.makedirs(path_to_h5, exist_ok=True)
    n = 0
    for hr, lr, llr in zip(dirs["ori"], dirs["down2"], dirs["down4"]):
        assert os.path.basename(hr) == os.path.basename(lr) == os.path.basename(llr)
        name = os.path.splitext(os.path.basename(hr))[0] + ".h5"
        with H5LadderPackager(os.path.join(path_to_h5, name),
                              rungs=("ori", "down2", "down4")) as pk:
            for rung, path in (("ori", hr), ("down2", lr), ("down4", llr)):
                ev = read_txt_events(path)
                pk.package_events(rung, ev[:, 0], ev[:, 1], ev[:, 2], ev[:, 3])
            pk.add_metadata(sensor_resolution)
        n += 1
    return n
