"""Image-of-warped-events (IWE) utilities (counterpart of
``esr_tpu/ops/iwe.py``).

Events are ``[B, N, 4]`` rows ``(ts, y, x, p)``, the column layout the
reference indexes (coordinates in columns 1:3, ``ts`` in column 0,
normalized to [0, 1]). Padded event lanes carry a ``valid`` mask that
zeroes their weights. Flow maps are ``[B, 2, H, W]`` with channel 0 the
horizontal (x) and channel 1 the vertical (y) component; IWEs are
``[B, 1, H, W]`` (``[B, 2, H, W]`` per polarity). The scatter-add is an
``index_put(accumulate=True)``, deterministic on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def purge_unfeasible(coords: torch.Tensor, res: Tuple[int, int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero out-of-bounds warped locations: ``coords [B, M, 2]`` as (y, x)
    -> (masked coords, the ``[B, M, 1]`` keep-mask)."""
    h, w = res
    y, x = coords[..., 0:1], coords[..., 1:2]
    mask = ((y >= 0) & (y < h) & (x >= 0) & (x < w)).to(coords.dtype)
    return coords * mask, mask


def get_interpolation(events: torch.Tensor, flow: torch.Tensor, tref: float,
                      res: Tuple[int, int], flow_scaling: float, round_idx: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp events along the per-event flow ``[B, N, 2]`` (y, x) to
    ``tref``: flat row-major indices ``[B, M, 1]`` and weights ``[B, M, 1]``;
    M = N with ``round_idx``, else 4N (the four bilinear taps, tap-major)."""
    h, w = res
    warped = events[:, :, 1:3] + (tref - events[:, :, 0:1]) * flow * flow_scaling
    if round_idx:
        idx = torch.round(warped)
        weights = torch.ones_like(idx)
    else:
        top_y = torch.floor(warped[:, :, 0:1])
        bot_y = top_y + 1
        left_x = torch.floor(warped[:, :, 1:2])
        right_x = left_x + 1
        idx = torch.cat([
            torch.cat([top_y, left_x], dim=2),
            torch.cat([top_y, right_x], dim=2),
            torch.cat([bot_y, left_x], dim=2),
            torch.cat([bot_y, right_x], dim=2),
        ], dim=1)
        warped4 = torch.cat([warped] * 4, dim=1)
        weights = torch.clamp_min(1.0 - torch.abs(warped4 - idx), 0.0)
    idx, mask = purge_unfeasible(idx, res)
    weights = torch.prod(weights, dim=-1, keepdim=True) * mask
    flat = idx[:, :, 0:1] * w + idx[:, :, 1:2]
    return flat, weights


def interpolate(idx: torch.Tensor, weights: torch.Tensor, res: Tuple[int, int],
                polarity_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter-add warped events into a ``[B, 1, H, W]`` image."""
    h, w = res
    if polarity_mask is not None:
        weights = weights * polarity_mask
    b = idx.shape[0]
    flat_idx = idx[..., 0].to(torch.int64).clamp(0, h * w - 1)
    bidx = torch.arange(b, device=idx.device).reshape(b, 1).expand_as(flat_idx)
    img = torch.zeros(b, h * w, dtype=weights.dtype, device=weights.device)
    img = img.index_put((bidx, flat_idx), weights[..., 0], accumulate=True)
    return img.reshape(b, 1, h, w)


def gather_event_flow(flow_map: torch.Tensor, events: torch.Tensor) -> torch.Tensor:
    """Per-event flow ``[B, N, 2]`` as (y, x) components, read from the
    dense ``flow_map [B, 2, H, W]`` at each event's truncated pixel."""
    b, _, h, w = flow_map.shape
    yi = events[:, :, 1].to(torch.int64).clamp(0, h - 1)
    xi = events[:, :, 2].to(torch.int64).clamp(0, w - 1)
    bidx = torch.arange(b, device=flow_map.device).reshape(b, 1)
    fy = flow_map[bidx, 1, yi, xi]
    fx = flow_map[bidx, 0, yi, xi]
    return torch.stack([fy, fx], dim=-1)


def deblur_events(flow_map: torch.Tensor, event_list: torch.Tensor, res: Tuple[int, int],
                  flow_scaling: float = 128, round_idx: bool = True,
                  polarity_mask: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Motion-compensate events into a sharp IWE ``[B, 1, H, W]``;
    ``valid [B, N]`` masks padded lanes."""
    event_flow = gather_event_flow(flow_map, event_list)
    fw_idx, fw_weights = get_interpolation(event_list, event_flow, 1, res, flow_scaling,
                                           round_idx=round_idx)
    reps = 1 if round_idx else 4
    if valid is not None:
        v = valid.to(fw_weights.dtype)[:, :, None]
        fw_weights = fw_weights * torch.cat([v] * reps, dim=1)
    if polarity_mask is not None and not round_idx:
        polarity_mask = torch.cat([polarity_mask] * 4, dim=1)
    return interpolate(fw_idx, fw_weights, res, polarity_mask=polarity_mask)


def compute_pol_iwe(flow_map: torch.Tensor, event_list: torch.Tensor, res: Tuple[int, int],
                    pos_mask: torch.Tensor, neg_mask: torch.Tensor, flow_scaling: float = 128,
                    round_idx: bool = True, valid: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Per-polarity IWE ``[B, 2, H, W]`` (positive, negative)."""
    iwe_pos = deblur_events(flow_map, event_list, res, flow_scaling, round_idx, pos_mask,
                            valid)
    iwe_neg = deblur_events(flow_map, event_list, res, flow_scaling, round_idx, neg_mask,
                            valid)
    return torch.cat([iwe_pos, iwe_neg], dim=1)
