"""Event rasterization on the device (counterpart of
``esr_tpu/ops/encodings.py``): fixed-capacity event arrays with a validity
mask in, count images out, as scatter-adds
(``index_put_(accumulate=True)``).

Every event adds an integer (0 or 1) to an f32 count, and integer sums in
f32 are exact up to 2^24, so the result is bitwise the host's
(``data/np_encodings.py``) although the device's atomic adds run in no
fixed order. Layouts are channel-last, as in the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch


def events_to_image(xs: torch.Tensor, ys: torch.Tensor, ps: torch.Tensor,
                    sensor_size: Tuple[int, int],
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter-add ``ps`` (times ``valid``) into ``[..., H, W]`` images, one
    per leading index of the ``[..., N]`` event arrays. Out-of-range events
    are dropped, tested on the coordinates as given (before truncation:
    -0.4 is dropped, not put on column 0)."""
    h, w = sensor_size
    lead = tuple(xs.shape[:-1])
    n_images = math.prod(lead)
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xi = xs.to(torch.int64).clamp(0, w - 1)
    yi = ys.to(torch.int64).clamp(0, h - 1)
    image = torch.arange(n_images, device=xs.device).reshape(*lead, 1)
    flat = (image * h + yi) * w + xi
    vals = ps.to(torch.float32)
    if valid is not None:
        vals = vals * valid.to(torch.float32)
    vals = torch.where(inb, vals, torch.zeros((), dtype=torch.float32, device=vals.device))
    img = torch.zeros(n_images * h * w, dtype=torch.float32, device=xs.device)
    img.index_put_((flat.reshape(-1),), vals.reshape(-1), accumulate=True)
    return img.reshape(*lead, h, w)


def events_to_channels(xs: torch.Tensor, ys: torch.Tensor, ps: torch.Tensor,
                       sensor_size: Tuple[int, int],
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Two-channel count images ``[..., H, W, 2]``: positive events count
    in channel 0, negative ones in channel 1."""
    one = torch.ones((), dtype=torch.float32, device=ps.device)
    zero = torch.zeros((), dtype=torch.float32, device=ps.device)
    pos = events_to_image(xs, ys, torch.where(ps > 0, one, zero), sensor_size, valid)
    neg = events_to_image(xs, ys, torch.where(ps < 0, one, zero), sensor_size, valid)
    return torch.stack([pos, neg], dim=-1)


def scale_event_coords(xs_norm: torch.Tensor, ys_norm: torch.Tensor,
                       target_size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coordinates in [0, 1) onto a target grid, floored to int32 (the SR
    input: LR events renormalized onto the HR grid)."""
    h, w = target_size
    return (torch.floor(xs_norm * w).to(torch.int32),
            torch.floor(ys_norm * h).to(torch.int32))


def tile_activity(counts: torch.Tensor, tile: int = 8) -> torch.Tensor:
    """Per-tile sums of a ``[H, W, ...]`` count image -> ``[ceil(H/tile),
    ceil(W/tile)]`` f32; a tile is active iff its sum is > 0 (exact, so
    bitwise the host's ``tile_activity_np``)."""
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    h, w = counts.shape[0], counts.shape[1]
    c = counts.reshape(h, w, -1).sum(dim=-1)
    ht, wt = -(-h // tile), -(-w // tile)
    c = torch.nn.functional.pad(c, (0, wt * tile - w, 0, ht * tile - h))
    return c.reshape(ht, tile, wt, tile).sum(dim=(1, 3)).to(torch.float32)


def make_device_encoder(gt_resolution: Tuple[int, int]
                        ) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """The batch encoder of device rasterization: ``{"inp_events" [B, L, N,
    4] (coordinates normalized to [0, 1)), "inp_valid" [B, L, N],
    "gt_events" [B, L, Ng, 4] (raw GT-grid coordinates), "gt_valid"}`` ->
    the dense ``{"inp", "gt"}`` count images ``[B, L, kH, kW, 2]`` the
    train and eval steps read: the input scaled onto the GT grid and
    counted, the GT counted as it is."""
    kh, kw = gt_resolution

    def encode(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        inp, gt = batch["inp_events"], batch["gt_events"]
        xs, ys = scale_event_coords(inp[..., 0], inp[..., 1], (kh, kw))
        return {
            "inp": events_to_channels(xs, ys, inp[..., 3], (kh, kw), batch["inp_valid"]),
            "gt": events_to_channels(gt[..., 0], gt[..., 1], gt[..., 3], (kh, kw),
                                     batch["gt_valid"]),
        }

    return encode
