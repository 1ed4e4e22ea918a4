"""Spatial gradient ops (counterpart of ``esr_tpu/ops/gradients.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def sobel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized Sobel gradients with replication padding: channels folded
    into the batch, the input padded by 1 at its edges, the 3x3 responses
    divided by 8. ``x [B, C, H, W]`` -> ``(gradx, grady)``, each
    ``[B, C, H, W]``."""
    b, c, h, w = x.shape
    flat = F.pad(x.reshape(b * c, 1, h, w), (1, 1, 1, 1), mode="replicate")
    kernels = torch.tensor((_SOBEL_X, _SOBEL_Y), dtype=x.dtype, device=x.device)
    g = F.conv2d(flat, kernels[:, None]) / 8.0
    return g[:, 0].reshape(b, c, h, w), g[:, 1].reshape(b, c, h, w)
