"""Bilinear grid sampling (counterpart of ``esr_tpu/ops/sampling.py``).

``F.grid_sample(mode="bilinear", padding_mode="zeros")`` semantics, written
as the reference writes it: four clamped corner gathers with explicit
weights. The stock ``F.grid_sample`` has no deterministic CUDA backward, so
under the port's numerics policy (``esr_tpu_torch/device.py``) it raises;
the gathers here are advanced indexing, whose backward is an
``index_put_(accumulate=True)`` with a deterministic CUDA path.
"""

from __future__ import annotations

import torch


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """Bilinear sample of ``img [B, C, H, W]`` at ``grid [B, Ho, Wo, 2]``
    (x, y in [-1, 1]) with zero padding -> ``[B, C, Ho, Wo]``.
    ``align_corners=False`` maps -1/+1 to the outer pixel edges, ``True``
    to the outer pixel centres."""
    b, c, h, w = img.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        x = (gx + 1.0) * (w - 1) / 2.0
        y = (gy + 1.0) * (h - 1) / 2.0
    else:
        x = ((gx + 1.0) * w - 1.0) / 2.0
        y = ((gy + 1.0) * h - 1.0) / 2.0
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ho, wo = grid.shape[1], grid.shape[2]
    flat = img.permute(0, 2, 3, 1).reshape(b, h * w, c)
    bidx = torch.arange(b, device=img.device).reshape(b, 1)
    out = None
    for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi = x0 + ox
        yi = y0 + oy
        wgt = (1.0 - torch.abs(x - xi)) * (1.0 - torch.abs(y - yi))
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xc = xi.to(torch.int64).clamp(0, w - 1)
        yc = yi.to(torch.int64).clamp(0, h - 1)
        vals = flat[bidx, (yc * w + xc).reshape(b, -1)].reshape(b, ho, wo, c)
        term = torch.where((inb & torch.isfinite(wgt))[..., None], wgt[..., None] * vals,
                           torch.zeros((), dtype=vals.dtype, device=vals.device))
        out = term if out is None else out + term
    return out.permute(0, 3, 1, 2)
