"""Contrast-maximization flow losses (counterpart of
``esr_tpu/losses/flow.py``).

- :func:`event_warping_loss`: squared sums of the forward and backward
  per-polarity average-timestamp images, plus a Charbonnier smoothness
  term on the flow.
- :func:`averaged_iwe`: per pixel and polarity, the warped-event count
  divided by the number of distinct source pixels that warp there.

Events ``[B, N, 4]`` rows ``(ts, y, x, p)`` with a ``valid`` lane mask
(``esr_tpu_torch.ops.iwe``); flow maps ``[B, 2, H, W]`` (x, y channels).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from esr_tpu_torch.ops.iwe import gather_event_flow, get_interpolation, interpolate


def _masked_pol(pol_mask: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    if valid is None:
        return pol_mask
    return pol_mask * valid.to(pol_mask.dtype)[:, :, None]


def event_warping_loss(flow_list, event_list: torch.Tensor, pol_mask: torch.Tensor,
                       resolution: Tuple[int, int], valid: Optional[torch.Tensor] = None,
                       regul_weight: float = 1.0) -> torch.Tensor:
    """Forward + backward averaged-timestamp contrast loss over
    ``flow_list`` (one ``[B, 2, H, W]`` map or a list), ``event_list
    [B, N, 4]`` and ``pol_mask [B, N, 2]``."""
    if not isinstance(flow_list, (list, tuple)):
        flow_list = [flow_list]
    flow_scaling = max(resolution)
    pol_mask = _masked_pol(pol_mask, valid)
    pol4 = torch.cat([pol_mask] * 4, dim=1)
    ts4 = torch.cat([event_list[:, :, 0:1]] * 4, dim=1)

    total = 0.0
    for flow_map in flow_list:
        event_flow = gather_event_flow(flow_map, event_list)

        def avg_ts_images(tref: float, ts_w: torch.Tensor) -> torch.Tensor:
            idx, w = get_interpolation(event_list, event_flow, tref, resolution, flow_scaling)
            acc = 0.0
            for pc in range(2):
                pm = pol4[:, :, pc:pc + 1]
                iwe = interpolate(idx, w, resolution, polarity_mask=pm)
                iwe_ts = interpolate(idx, w * ts_w, resolution, polarity_mask=pm)
                acc = acc + torch.sum((iwe_ts / (iwe + 1e-9)) ** 2)
            return acc

        total = total + avg_ts_images(1.0, ts4) + avg_ts_images(0.0, 1.0 - ts4)
        # Charbonnier flow smoothness
        dx = flow_map[:, :, :-1, :] - flow_map[:, :, 1:, :]
        dy = flow_map[:, :, :, :-1] - flow_map[:, :, :, 1:]
        smooth = torch.sqrt(dx ** 2 + 1e-6).sum() + torch.sqrt(dy ** 2 + 1e-6).sum()
        total = total + regul_weight * smooth
    return total


def averaged_iwe(flow_map: torch.Tensor, event_list: torch.Tensor, pol_mask: torch.Tensor,
                 resolution: Tuple[int, int], valid: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Per-pixel, per-polarity average warped-event count ``[B, 2, H, W]``.

    A destination pixel's raw count is divided by the number of distinct
    source pixels mapping there, per polarity. The distinct (pol, src, dst)
    triples are found by three cascaded stable sorts, least significant key
    first (a composite integer key would overflow at sensor resolutions),
    and their first occurrences are counted."""
    h, w = resolution
    r = h * w
    flow_scaling = max(resolution)
    pol_mask = _masked_pol(pol_mask, valid)

    event_flow = gather_event_flow(flow_map, event_list)
    fw_idx, fw_weights = get_interpolation(event_list, event_flow, 1, resolution,
                                           flow_scaling, round_idx=True)
    if valid is not None:
        fw_weights = fw_weights * valid.to(fw_weights.dtype)[:, :, None]
    iwe_pos = interpolate(fw_idx, fw_weights, resolution, pol_mask[:, :, 0:1])
    iwe_neg = interpolate(fw_idx, fw_weights, resolution, pol_mask[:, :, 1:2])

    with torch.no_grad():
        src = (event_list[:, :, 1].to(torch.int32) * w
               + event_list[:, :, 2].to(torch.int32)).clamp(0, r - 1)
        dst = fw_idx[:, :, 0].to(torch.int32).clamp(0, r - 1)
        # polarity code: 1 positive, 0 negative, 2 unfeasible or padded
        # (a zero-weight or masked lane never counts)
        pol = (event_list[:, :, 3] >= 1).to(torch.int32)
        dead = (fw_weights[:, :, 0] == 0) | ((pol_mask[:, :, 0] + pol_mask[:, :, 1]) == 0)
        pol = torch.where(dead, torch.full_like(pol, 2), pol)
        keys = [pol, src, dst]
        for k in (2, 1, 0):
            order = torch.sort(keys[k], dim=1, stable=True).indices
            keys = [torch.gather(v, 1, order) for v in keys]
        pol_s, src_s, dst_s = keys
        first = torch.ones_like(pol_s, dtype=torch.bool)
        first[:, 1:] = ((pol_s[:, 1:] != pol_s[:, :-1]) | (src_s[:, 1:] != src_s[:, :-1])
                        | (dst_s[:, 1:] != dst_s[:, :-1]))
        b = event_list.shape[0]
        bidx = torch.arange(b, device=dst_s.device).reshape(b, 1).expand_as(dst_s)
        dst_l = dst_s.to(torch.int64)
        contrib = []
        for want in (1, 0):
            ones = (first & (pol_s == want)).to(torch.float32)
            img = torch.zeros(b, r, dtype=torch.float32, device=ones.device)
            contrib.append(img.index_put_((bidx, dst_l), ones, accumulate=True)
                           .reshape(b, 1, h, w))
    pos_c, neg_c = contrib
    iwe_pos = torch.where(pos_c > 0, iwe_pos / torch.clamp_min(pos_c, 1), iwe_pos)
    iwe_neg = torch.where(neg_c > 0, iwe_neg / torch.clamp_min(neg_c, 1), iwe_neg)
    return torch.cat([iwe_pos, iwe_neg], dim=1)
