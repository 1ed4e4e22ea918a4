"""Deformable position-sensitive ROI pooling, DCNv2's second op
(counterpart of ``esr_tpu/ops/psroi.py``).

Semantics, as the reference's CUDA forward computes them:

- the ROI rect ``round(x1), round(y1), round(x2) + 1, round(y2) + 1``
  (C ``round()``: half away from zero) scaled by ``spatial_scale`` and
  shifted by -0.5; width and height at least 0.1;
- per output bin ``(ph, pw)``, ``sample_per_part**2`` bilinear taps from
  the bin's corner, shifted by the learned part offset
  ``trans[n, class, :, part_h, part_w] * trans_std * roi_size``;
- the position-sensitive channel ``(ctop * group_size + gh) * group_size +
  gw`` with ``g = floor(p * group_size / pooled_size)``;
- a tap outside ``[-0.5, size - 0.5]`` is skipped, one inside is clamped
  to ``[0, size - 1]``; the output is sum / count (0 when no tap lands).

The backward is autograd of the gather (advanced indexing, whose backward
is a deterministic ``index_put_(accumulate=True)`` on the card). Layouts
are the DCN op's: ``data [B, C, H, W]`` with ``C = output_dim *
group_size**2``, output ``[N, output_dim, P, P]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C ``round()``: half away from zero (``torch.round`` rounds half to
    even and disagrees at ``.5`` coordinates)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def deform_psroi_pooling(data: torch.Tensor, rois: torch.Tensor,
                         trans: Optional[torch.Tensor] = None, *, spatial_scale: float = 1.0,
                         output_dim: int, group_size: int, pooled_size: int,
                         part_size: Optional[int] = None, sample_per_part: int = 4,
                         trans_std: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(output, count)``, each ``[N, output_dim, P, P]``.
    ``rois``: ``[N, 5]`` rows ``(batch_index, x1, y1, x2, y2)``; ``trans``:
    ``[N, num_classes, 2, part_size, part_size]`` offsets (None: undeformed)."""
    b, c, h, w = data.shape
    p = pooled_size
    part = part_size if part_size is not None else p
    assert c == output_dim * group_size * group_size
    dev = data.device
    n = rois.shape[0]
    if trans is None:
        trans = torch.zeros(n, 1, 2, part, part, dtype=data.dtype, device=dev)
    num_classes = trans.shape[1]
    channels_each_class = max(output_dim // num_classes, 1)
    spp = sample_per_part

    ph = torch.arange(p, device=dev)
    gh = ((ph * group_size) // p).clamp(0, group_size - 1)
    ctop = torch.arange(output_dim, device=dev)
    # channel index [P(h), P(w), OD]
    cidx = (ctop[None, None, :] * group_size + gh[:, None, None]) * group_size + gh[None, :, None]
    class_id = ctop // channels_each_class
    # true divisions by device tensors: CUDA divides by a Python number as a
    # product with its reciprocal, an ulp off, which would move a part index
    # or a tap across an edge on the card only
    p_t = torch.tensor(float(p), device=dev)
    part_hw = torch.floor(ph.to(torch.float32) / p_t * part).to(torch.int64)

    rois = rois.to(torch.float32)
    batch_ind = rois[:, 0].to(torch.int64)
    x1 = _round_half_away(rois[:, 1]) * spatial_scale - 0.5
    y1 = _round_half_away(rois[:, 2]) * spatial_scale - 0.5
    x2 = (_round_half_away(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (_round_half_away(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp_min(x2 - x1, 0.1)
    roi_h = torch.clamp_min(y2 - y1, 0.1)
    bin_w = roi_w / p_t
    bin_h = roi_h / p_t
    spp_t = torch.tensor(float(spp), device=dev)
    sub_w = bin_w / spp_t
    sub_h = bin_h / spp_t

    def per_roi(v):  # [N] -> broadcast over [N, P, P, OD]
        return v[:, None, None, None]

    nidx = torch.arange(n, device=dev)[:, None, None, None]
    cls = class_id[None, None, None, :]
    prh = part_hw[None, :, None, None]
    prw = part_hw[None, None, :, None]
    tx = trans[nidx, cls, 0, prh, prw] * trans_std
    ty = trans[nidx, cls, 1, prh, prw] * trans_std
    pw_f = ph.to(torch.float32)
    wstart = pw_f[None, None, :, None] * per_roi(bin_w) + per_roi(x1) + tx * per_roi(roi_w)
    hstart = pw_f[None, :, None, None] * per_roi(bin_h) + per_roi(y1) + ty * per_roi(roi_h)

    # the sample grid [N, P, P, OD, spp(h), spp(w)]
    steps = torch.arange(spp, device=dev, dtype=torch.float32)
    ws = wstart[..., None, None] + steps[None, None, None, None, None, :] * \
        sub_w[:, None, None, None, None, None]
    hs = hstart[..., None, None] + steps[None, None, None, None, :, None] * \
        sub_h[:, None, None, None, None, None]
    ws, hs = torch.broadcast_tensors(ws, hs)
    ok = (ws >= -0.5) & (ws <= w - 0.5) & (hs >= -0.5) & (hs <= h - 0.5)
    wc = ws.clamp(0.0, w - 1.0)
    hc = hs.clamp(0.0, h - 1.0)

    # floor/ceil-corner bilinear sample at the clamped coordinates
    x_lo = torch.floor(wc).to(torch.int64)
    x_hi = torch.ceil(wc).to(torch.int64)
    y_lo = torch.floor(hc).to(torch.int64)
    y_hi = torch.ceil(hc).to(torch.int64)
    dx = wc - x_lo
    dy = hc - y_lo
    bi = batch_ind[:, None, None, None, None, None]
    ci = cidx[None, :, :, :, None, None]
    vals = ((1 - dx) * (1 - dy) * data[bi, ci, y_lo, x_lo]
            + (1 - dx) * dy * data[bi, ci, y_hi, x_lo]
            + dx * (1 - dy) * data[bi, ci, y_lo, x_hi]
            + dx * dy * data[bi, ci, y_hi, x_hi])
    vals = torch.where(ok, vals, torch.zeros((), dtype=vals.dtype, device=dev))
    count = ok.sum(dim=(-1, -2)).to(data.dtype)
    total = vals.sum(dim=(-1, -2))
    out = torch.where(count > 0, total / torch.clamp_min(count, 1),
                      torch.zeros((), dtype=total.dtype, device=dev))
    return out.permute(0, 3, 1, 2), count.permute(0, 3, 1, 2)
