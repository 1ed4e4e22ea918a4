"""Image resizing with ``align_corners=False`` semantics
(counterpart of ``esr_tpu/ops/resize.py``).

Bilinear and bicubic (Keys a=-0.75) with half-pixel source mapping and
border replication are exactly ``torch.nn.functional.interpolate``, so the
tensor path calls it. The data path (numpy, host side) keeps the separable
interpolation matrices, built here in numpy.

:func:`resize` is the differentiable form on NCHW tensors (the models'
bilinear upsampling, ``models.layers.upsample``, and the UNet adapter's
bicubic inside the training forward): ``F.interpolate`` forward,
and a backward that is the product ``A_h^T g A_w`` with the same matrices,
which sums in a fixed order where the stock CUDA backward scatters with
atomics (and raises under deterministic algorithms).

Both forms promote as the reference's does: its product with f32
interpolation matrices turns a narrower float input (bf16) into an f32
output, so a bf16 input is widened to f32 first; the gradient of a bf16
input comes back bf16.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _source_coords(in_size: int, out_size: int) -> np.ndarray:
    """Half-pixel source coordinates (``align_corners=False``)."""
    scale = in_size / out_size
    return (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel; torch uses a=-0.75."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, mode: str) -> np.ndarray:
    """``[out_size, in_size]`` row-stochastic interpolation matrix (numpy)."""
    if mode == "nearest":
        # torch 'nearest' uses floor(dst * scale) (legacy, no half-pixel).
        src = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
        src = np.clip(src, 0, in_size - 1)
        mat = np.zeros((out_size, in_size), dtype=np.float32)
        mat[np.arange(out_size), src] = 1.0
        return mat
    src = _source_coords(in_size, out_size)
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    if mode == "bilinear":
        taps = ((0, 1.0 - frac), (1, frac))
    elif mode == "bicubic":
        taps = tuple((t, _cubic_kernel(frac - t)) for t in range(-1, 3))
    else:
        raise ValueError(f"unsupported resize mode: {mode}")
    for tap, wgt in taps:
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), wgt)
    return mat.astype(np.float32)


def _widen(x: torch.Tensor) -> torch.Tensor:
    """A float narrower than f32 as f32 (the reference's promotion against
    its f32 interpolation matrices); f32 and wider unchanged."""
    if x.is_floating_point() and x.dtype.itemsize < 4:
        return x.float()
    return x


def interpolate(
    x: torch.Tensor, size: Tuple[int, int], mode: str = "bilinear"
) -> torch.Tensor:
    """Resize channel-last ``[H, W, C]`` or ``[N, H, W, C]`` to ``size``."""
    if mode not in ("bilinear", "bicubic", "nearest"):
        raise ValueError(f"unsupported resize mode: {mode}")
    if tuple(x.shape[-3:-1]) == tuple(size):
        return x
    squeeze = x.dim() == 3
    xt = _widen(x[None] if squeeze else x).permute(0, 3, 1, 2)
    kwargs = {} if mode == "nearest" else {"align_corners": False}
    out = F.interpolate(xt, size=tuple(size), mode=mode, **kwargs)
    out = out.permute(0, 2, 3, 1)
    return out[0] if squeeze else out


def interpolate_scale(x: torch.Tensor, scale: int, mode: str = "bilinear") -> torch.Tensor:
    """Scale-factor form of :func:`interpolate`."""
    h, w = x.shape[-3], x.shape[-2]
    return interpolate(x, (h * scale, w * scale), mode)


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int, mode: str, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """:func:`_interp_matrix` as a tensor on ``device``, made once per
    (sizes, mode, dtype, device): a CUDA graph's capture cannot copy from
    host memory, so the first (eager) backward makes it."""
    return torch.from_numpy(_interp_matrix(in_size, out_size, mode)).to(device=device,
                                                                        dtype=dtype)


class _Resize(torch.autograd.Function):
    """``F.interpolate`` forward (of the input widened to f32 when it is
    narrower), the interpolation matrices' backward in the output's dtype,
    rounded to the input's."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, size: Tuple[int, int], mode: str) -> torch.Tensor:
        ctx.geom = (x.shape[-2], x.shape[-1], size[0], size[1], mode, x.dtype)
        return F.interpolate(_widen(x), size=size, mode=mode, align_corners=False)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h, w, oh, ow, mode, dtype = ctx.geom
        ah = resize_matrix(h, oh, mode, g.dtype, g.device)  # [oh, h]
        aw = resize_matrix(w, ow, mode, g.dtype, g.device)  # [ow, w]
        return torch.matmul(torch.matmul(ah.t(), g), aw).to(dtype), None, None


def resize(x: torch.Tensor, size: Tuple[int, int], mode: str = "bicubic") -> torch.Tensor:
    """Resize NCHW ``x`` to ``size`` (bilinear or bicubic,
    ``align_corners=False``; a bf16 input gives an f32 output); its
    backward sums in a fixed order."""
    if mode not in ("bilinear", "bicubic"):
        raise ValueError(f"unsupported resize mode: {mode}")
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    return _Resize.apply(x, size, mode)
