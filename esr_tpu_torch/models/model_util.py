"""Pad/crop helpers (counterpart of ``esr_tpu/models/model_util.py``).

Pad an image so H and W divide a factor (top/left take the ceil half of the
slack) and crop a (possibly upscaled) output back, on channel-last
``[..., H, W, C]`` tensors; and the UNet family's skip connections, which
align the two sides by zero-padding or centre-cropping, on NCHW tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


def optimal_crop_size(size: int, factor: int, safety_margin: int = 0) -> int:
    """Smallest multiple of ``factor`` >= ``size``."""
    return factor * math.ceil(size / factor) + safety_margin * factor


class PadSpec(NamedTuple):
    height: int
    width: int
    padded_height: int
    padded_width: int
    top: int
    bottom: int
    left: int
    right: int


def compute_pad(height: int, width: int, factor_h: int, factor_w: int) -> PadSpec:
    """Pad amounts that make (H, W) divisible by (factor_h, factor_w)."""
    ph = optimal_crop_size(height, factor_h)
    pw = optimal_crop_size(width, factor_w)
    top = math.ceil(0.5 * (ph - height))
    bottom = math.floor(0.5 * (ph - height))
    left = math.ceil(0.5 * (pw - width))
    right = math.floor(0.5 * (pw - width))
    return PadSpec(height, width, ph, pw, top, bottom, left, right)


def pad_image(x: torch.Tensor, spec: PadSpec) -> torch.Tensor:
    """Zero-pad ``[..., H, W, C]`` per ``spec``."""
    return F.pad(x, (0, 0, spec.left, spec.right, spec.top, spec.bottom))


def crop_image(x: torch.Tensor, spec: PadSpec, scale: int = 1) -> torch.Tensor:
    """Center-crop ``[..., H*, W*, C]`` back to ``scale`` x the original size."""
    cx = math.floor(spec.padded_width * scale / 2)
    cy = math.floor(spec.padded_height * scale / 2)
    ix0 = cx - math.floor(spec.width * scale / 2)
    ix1 = cx + math.ceil(spec.width * scale / 2)
    iy0 = cy - math.floor(spec.height * scale / 2)
    iy1 = cy + math.ceil(spec.height * scale / 2)
    return x[..., iy0:iy1, ix0:ix1, :]


def _align_to(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Zero-pad or centre-crop ``x1 [..., C, H, W]`` to ``x2``'s H and W.
    The difference splits as ``d // 2`` before and ``d - d // 2`` after
    (floor division, so a negative difference crops one more row or column
    after than before when it is odd), as ``ZeroPad2d`` takes negative pads."""
    dy = x2.shape[-2] - x1.shape[-2]
    dx = x2.shape[-1] - x1.shape[-1]
    if dy == 0 and dx == 0:
        return x1
    top, bottom = dy // 2, dy - dy // 2
    left, right = dx // 2, dx - dx // 2
    pads = (max(left, 0), max(right, 0), max(top, 0), max(bottom, 0))
    if any(pads):
        x1 = F.pad(x1, pads)
    h, w = x1.shape[-2], x1.shape[-1]
    return x1[..., max(-top, 0):h + min(bottom, 0), max(-left, 0):w + min(right, 0)]


def skip_concat(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Channel concat skip (NCHW) with ``x1`` aligned to ``x2``."""
    return torch.cat([_align_to(x1, x2), x2], dim=1)


def skip_sum(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Additive skip (NCHW) with ``x1`` aligned to ``x2``."""
    return _align_to(x1, x2) + x2
