"""Pad/crop helpers (counterpart of ``esr_tpu/models/model_util.py``).

Pad an image so H and W divide a factor (top/left take the ceil half of the
slack) and crop a (possibly upscaled) output back, on channel-last
``[..., H, W, C]`` tensors.
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
