"""Event visualization: count / stack / list renderings as numpy images,
and a PNG writer (counterpart of ``esr_tpu/utils/vis_events.py``).

The 2D renderers compute the reference's images bit for bit:
- ``render_event_cnt``: per-channel percentile normalization (``pos_min =
  P1(pos)``, ``max = max(P99(pos), P99(neg))``), then ``green_red`` (green
  positive, red negative; on a white background ``1 - intensity`` in the
  complementary channels, the larger polarity winning), ``blue_red`` or
  ``gray`` (``0.5 + pos/2 - neg/2``);
- ``render_event_list``: last event per pixel, blue positive, red negative
  on white; ``render_event_stack``: the bins tiled into a near-square grid
  on a red-white-blue map; ``render_frame``: uint8 grayscale.

:func:`save_image` writes a PNG with ``zlib`` and ``struct`` alone (8-bit
RGB or grayscale, one IDAT, no filtering), so the port needs neither
OpenCV nor PIL.

The 3D views need matplotlib, imported inside them (the ``Agg`` backend),
so importing this module loads none; they run on a host that has it (the
card's machine has not):
- ``render_event_3d``: the (x, t, y) scatter of an event cloud, blue
  positive, red negative, y flipped to point up, an optional GT cloud in a
  second panel; the figure's RGB pixels;
- ``animate_event_3d``: windows of (input, GT, frame) as an animated GIF
  (or an mp4 where ffmpeg is there), input left, GT right, the frame inset
  below, at one of the reference's view presets (:data:`VIEW_PRESETS`);
- ``export_event_cloud``: the cloud as a coloured PLY through
  :func:`esr_tpu_torch.tools.h5_tools.events_to_ply`.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterable, Optional, Tuple

import numpy as np


def _normalize_cnt(event_cnt: np.ndarray, norm: bool) -> Tuple[np.ndarray, np.ndarray]:
    pos = event_cnt[:, :, 0].astype(np.float64).copy()
    neg = event_cnt[:, :, 1].astype(np.float64).copy()
    if norm:
        pos_max, pos_min = np.percentile(pos, 99), np.percentile(pos, 1)
        neg_max, neg_min = np.percentile(neg, 99), np.percentile(neg, 1)
        vmax = max(pos_max, neg_max)
        if pos_min != vmax:
            pos = (pos - pos_min) / (vmax - pos_min)
        if neg_min != vmax:
            neg = (neg - neg_min) / (vmax - neg_min)
    else:
        pos_wins = (pos >= neg) & (pos != 0)
        neg_wins = (pos < neg) & (neg != 0)
        pos = np.where(pos_wins, 1.0, 0.0)
        neg = np.where(neg_wins, 1.0, 0.0)
    return np.clip(pos, 0, 1), np.clip(neg, 0, 1)


def render_event_cnt(event_cnt: np.ndarray, color_scheme: str = "green_red",
                     black_background: bool = True, norm: bool = True) -> np.ndarray:
    """``[H, W, 2]`` (pos, neg) counts -> ``[H, W, 3]`` RGB uint8 (``[H, W]``
    for the gray scheme)."""
    if color_scheme not in ("green_red", "blue_red", "gray"):
        raise ValueError(f"unknown color scheme {color_scheme!r}")
    pos, neg = _normalize_cnt(event_cnt, norm)
    if color_scheme == "gray":
        img = 0.5 + 0.5 * pos - 0.5 * neg
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w = pos.shape
    pch = 1 if color_scheme == "green_red" else 2  # the positive channel
    rgb = np.zeros((h, w, 3))
    if black_background:
        rgb[:, :, pch] = np.where(pos > 0, pos, 0.0)
        rgb[:, :, 0] = np.where(neg > 0, neg, 0.0)
    else:
        rgb[:] = 1.0
        pos_wins = (pos >= neg) & (pos > 0)
        neg_wins = (pos < neg) & (neg > 0)
        for c in range(3):
            if c != pch:
                rgb[:, :, c] = np.where(pos_wins, 1 - pos, rgb[:, :, c])
            if c != 0:
                rgb[:, :, c] = np.where(neg_wins, 1 - neg, rgb[:, :, c])
    return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def render_event_list(events: np.ndarray, resolution: Tuple[int, int]) -> np.ndarray:
    """``[N, 4]`` (x, y, t, p) -> white image, blue positive, red negative
    (the last event of a pixel wins)."""
    h, w = resolution
    img = np.full((h, w, 3), 255, np.uint8)
    if events.size == 0:
        return img
    x = events[:, 0].astype(np.int64)
    y = events[:, 1].astype(np.int64)
    p = events[:, 3].astype(np.int64)
    ok = (x >= 0) & (y >= 0) & (x < w) & (y < h)
    mask = np.zeros((h, w), np.int64)
    mask[y[ok], x[ok]] = p[ok]
    img[mask == 1] = (0, 0, 255)
    img[mask == -1] = (255, 0, 0)
    return img


def render_event_stack(stack: np.ndarray, vmin: float = -10.0,
                       vmax: float = 10.0) -> np.ndarray:
    """``[H, W, TB]`` time-binned stack -> the bins tiled into a
    near-square grid; 0 -> red, 0.5 (no events) -> white, 1 -> blue."""
    h, w, tb = stack.shape
    gh = int(np.sqrt(tb))
    while tb % gh:
        gh -= 1
    gw = tb // gh
    x = np.clip((stack - vmin) / (vmax - vmin), 0, 1)
    r = np.where(x < 0.5, 1.0, 2 * (1 - x))
    b = np.where(x > 0.5, 1.0, 2 * x)
    g = 1 - 2 * np.abs(x - 0.5)
    rgb = (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)  # H W TB 3
    rgb = rgb.transpose(2, 0, 1, 3).reshape(gh, gw, h, w, 3)
    return rgb.transpose(0, 2, 1, 3, 4).reshape(gh * h, gw * w, 3)


def render_frame(frame: np.ndarray) -> np.ndarray:
    """``[H, W]`` or ``[H, W, 1]`` float in [0, 1] or uint8 -> uint8
    grayscale."""
    img = np.asarray(frame)
    if img.ndim == 3:
        img = img[:, :, 0]
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img


def _pyplot():
    """matplotlib's pyplot on the ``Agg`` backend (no display)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _scatter_3d(ax, events: np.ndarray, resolution: Tuple[int, int]) -> list:
    """The (x, t, y) scatter of ``[N, 4]`` (x, y, t, p) events on ``ax``:
    blue positive, red negative, y flipped to point up; its artists."""
    if events is None or not len(events):
        return []
    x, y, t, p = events[:, 0], events[:, 1], events[:, 2], events[:, 3]
    y = resolution[0] - y
    return [ax.scatter(x[p > 0], t[p > 0], y[p > 0], c="b", marker=".", s=1),
            ax.scatter(x[p < 0], t[p < 0], y[p < 0], c="r", marker=".", s=1)]


def render_event_3d(events: np.ndarray, resolution: Tuple[int, int],
                    gt_events: Optional[np.ndarray] = None,
                    gt_resolution: Optional[Tuple[int, int]] = None,
                    dpi: int = 100) -> np.ndarray:
    """``[N, 4]`` (x, y, t, p) events -> the RGB uint8 image of their 3D
    scatter (module docstring), the GT cloud beside it when given."""
    plt = _pyplot()
    fig = plt.figure(figsize=(8 if gt_events is None else 14, 6), dpi=dpi)
    clouds = [(events, resolution)]
    if gt_events is not None:
        clouds.append((gt_events, gt_resolution or resolution))
    for i, (ev, res) in enumerate(clouds):
        ax = fig.add_subplot(1, len(clouds), i + 1, projection="3d")
        _scatter_3d(ax, ev, res)
        ax.set_xlabel("x")
        ax.set_ylabel("t")
        ax.set_zlabel("y")
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def export_event_cloud(events: np.ndarray, resolution: Tuple[int, int],
                       output_path: str) -> int:
    """The event cloud as a binary PLY (red positive, blue negative, ``t``
    scaled to the sensor height); the vertices written."""
    from esr_tpu_torch.tools.h5_tools import events_to_ply

    return events_to_ply(events, resolution, output_path)


# the reference's numbered view presets (its interactive keys 1-5)
VIEW_PRESETS = {
    1: {"elev": 0, "azim": -90},
    2: {"elev": 30, "azim": -60},
    3: {"elev": 30, "azim": -120},
    4: {"elev": -30, "azim": -60},
    5: {"elev": -30, "azim": -120},
}


def animate_event_3d(windows: Iterable, resolution: Tuple[int, int], out_path: str,
                     gt_resolution: Optional[Tuple[int, int]] = None, fps: int = 10,
                     view: Optional[int] = None, dpi: int = 80) -> str:
    """``windows`` of ``(inp_events, gt_events)`` or ``(inp_events,
    gt_events, frame)`` (the GT and the frame may be None) -> an animation
    at ``out_path``: an mp4 when the path ends in ``.mp4`` and ffmpeg is
    there, else a GIF (``.mp4`` becomes ``.gif``). Returns the path
    written; raises ``ValueError`` on no windows."""
    plt = _pyplot()
    import matplotlib.animation as manim

    gt_resolution = gt_resolution or resolution
    fig = plt.figure(figsize=(10, 6), dpi=dpi)
    inp_ax = fig.add_axes([-0.05, 0.3, 0.55, 0.65], projection="3d")
    gt_ax = fig.add_axes([0.45, 0.3, 0.55, 0.65], projection="3d")
    frame_ax = fig.add_axes([0.375, 0.0, 0.25, 0.3])
    frame_ax.axis("off")
    for ax, title in ((inp_ax, "input"), (gt_ax, "GT")):
        ax.set_xlabel("x")
        ax.set_ylabel("t")
        ax.set_zlabel("y")
        ax.set_title(title)
        if view in VIEW_PRESETS:
            ax.view_init(**VIEW_PRESETS[view])
    movie = []
    for win in windows:
        inp_ev, gt_ev, frame = (tuple(win) + (None, None))[:3]
        artists = _scatter_3d(inp_ax, np.asarray(inp_ev), resolution)
        if gt_ev is not None:
            artists += _scatter_3d(gt_ax, np.asarray(gt_ev), gt_resolution)
        if frame is not None:
            artists.append(frame_ax.imshow(render_frame(frame), cmap="gray", animated=True))
        movie.append(artists)
    if not movie:
        plt.close(fig)
        raise ValueError("animate_event_3d: no windows to render")
    ani = manim.ArtistAnimation(fig, movie, interval=1000 // fps, repeat=True)
    if out_path.endswith(".mp4") and manim.writers.is_available("ffmpeg"):
        ani.save(out_path, writer="ffmpeg", fps=fps)
    else:
        if out_path.endswith(".mp4"):
            out_path = out_path[:-4] + ".gif"
        ani.save(out_path, writer="pillow", fps=fps)
    plt.close(fig)
    return out_path


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """PNG bytes of an ``[H, W, 3]`` RGB or ``[H, W]`` gray uint8 image."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"PNG takes [H, W] or [H, W, 3] uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    rows = img.reshape(h, -1)
    # filter type 0 (none) before every row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def save_image(path: str, image: np.ndarray) -> None:
    """Write ``image`` (RGB or gray uint8) as a PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


class EventVisualizer:
    """Object API of the reference's ``event_visualisation``: the 2D views,
    and the 3D ones (module docstring)."""

    def plot_event_cnt(self, event_cnt: np.ndarray, is_save: bool = False,
                       path: Optional[str] = None, color_scheme: str = "green_red",
                       is_black_background: bool = True, is_norm: bool = True) -> np.ndarray:
        img = render_event_cnt(event_cnt, color_scheme, is_black_background, is_norm)
        return self._maybe_save(img, is_save, path)

    def plot_event_img(self, event_list: np.ndarray, resolution: Tuple[int, int],
                       is_save: bool = False, path: Optional[str] = None) -> np.ndarray:
        return self._maybe_save(render_event_list(event_list, resolution), is_save, path)

    def plot_event_stack(self, stack: np.ndarray, is_save: bool = False,
                         path: Optional[str] = None) -> np.ndarray:
        return self._maybe_save(render_event_stack(stack), is_save, path)

    def plot_frame(self, frame: np.ndarray, is_save: bool = False,
                   path: Optional[str] = None) -> np.ndarray:
        return self._maybe_save(render_frame(frame), is_save, path)

    def plot_event_3d(self, event_list: np.ndarray, resolution: Tuple[int, int],
                      gt_event_list: Optional[np.ndarray] = None,
                      gt_resolution: Optional[Tuple[int, int]] = None,
                      is_save: bool = False, path: Optional[str] = None) -> np.ndarray:
        img = render_event_3d(event_list, resolution, gt_event_list, gt_resolution)
        return self._maybe_save(img, is_save, path)

    def plot_event_3d_animation(self, windows: Iterable, resolution: Tuple[int, int],
                                path: str, gt_resolution: Optional[Tuple[int, int]] = None,
                                fps: int = 10, view: Optional[int] = None) -> str:
        """:func:`animate_event_3d` to ``path``; the path written."""
        return animate_event_3d(windows, resolution, path, gt_resolution=gt_resolution,
                                fps=fps, view=view)

    @staticmethod
    def _maybe_save(img: np.ndarray, is_save: bool, path: Optional[str]) -> np.ndarray:
        if is_save:
            if path is None:
                raise ValueError("is_save needs a path")
            save_image(path, img)
        return img
