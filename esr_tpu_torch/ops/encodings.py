"""Event rasterization and its inverse on the device (counterpart of
``esr_tpu/ops/encodings.py``): fixed-capacity event arrays with a validity
mask in, dense images out, as scatter-adds (``index_put_(accumulate=True)``,
deterministic on the card); and dense count grids back to fixed-capacity
event lists.

A count image adds an integer (0 or 1) per event to an f32 count, and
integer sums in f32 are exact up to 2^24, so it is bitwise the host's
(``data/np_encodings.py``) although the device's adds run in no fixed
order; so are the stacks, masks and every event list of the inverse ops.
The voxel grid and the bilinear image add float weights, whose sums depend
on their order. Layouts are channel-last, as in the reference. Events are
a struct of arrays ``xs, ys, ts, ps`` (``ps`` in {-1, +1}, ``ts``
normalized to [0, 1]); the inverse ops return ``[capacity, 4]`` rows
``(x, y, t, p)`` and a ``[capacity]`` valid mask.

A division whose result decides a bin or a coordinate divides by a device
tensor: CUDA divides by a Python number as a product with its reciprocal,
an ulp off true division, which would move an event to another bin or
timestamp on the card only.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch


def _valid_or_ones(valid: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if valid is None:
        return torch.ones(like.shape, dtype=torch.float32, device=like.device)
    return valid.to(torch.float32)


def events_to_image(xs: torch.Tensor, ys: torch.Tensor, ps: torch.Tensor,
                    sensor_size: Tuple[int, int],
                    valid: Optional[torch.Tensor] = None,
                    interpolation: Optional[str] = None) -> torch.Tensor:
    """Scatter-add ``ps`` (times ``valid``) into ``[..., H, W]`` images, one
    per leading index of the ``[..., N]`` event arrays. Out-of-range events
    are dropped, tested on the coordinates as given (before truncation:
    -0.4 is dropped, not put on column 0). ``interpolation="bilinear"``
    splats each event over its 4 neighbouring pixels, weighted by its
    fractional offsets."""
    h, w = sensor_size
    lead = tuple(xs.shape[:-1])
    n_images = math.prod(lead)
    if interpolation == "bilinear":
        return _bilinear_image(xs, ys, ps, sensor_size, valid, lead, n_images)
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


def _bilinear_image(xs, ys, ps, sensor_size, valid, lead, n_images) -> torch.Tensor:
    """:func:`events_to_image`'s bilinear splat."""
    h, w = sensor_size
    px = torch.floor(xs)
    py = torch.floor(ys)
    dx = (xs - px).to(torch.float32)
    dy = (ys - py).to(torch.float32)
    pxi = px.to(torch.int64)
    pyi = py.to(torch.int64)
    vals = ps.to(torch.float32) * _valid_or_ones(valid, xs)
    image = torch.arange(n_images, device=xs.device).reshape(*lead, 1)
    img = torch.zeros(n_images * h * w, dtype=torch.float32, device=xs.device)
    zero = torch.zeros((), dtype=torch.float32, device=xs.device)
    for ox, oy, wgt in ((0, 0, (1.0 - dx) * (1.0 - dy)), (1, 0, dx * (1.0 - dy)),
                        (0, 1, (1.0 - dx) * dy), (1, 1, dx * dy)):
        xi = pxi + ox
        yi = pyi + oy
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        flat = (image * h + yi.clamp(0, h - 1)) * w + xi.clamp(0, w - 1)
        img = img.index_put((flat.reshape(-1),), torch.where(inb, wgt * vals, zero).reshape(-1),
                            accumulate=True)
    return img.reshape(*lead, h, w)


def _normalized_bin_time(ts: torch.Tensor, valid_f: torch.Tensor):
    """First and last valid timestamp, and the window length (+eps)."""
    inf = torch.tensor(float("inf"), dtype=ts.dtype, device=ts.device)
    t0 = torch.where(valid_f > 0, ts, inf).min()
    t1 = torch.where(valid_f > 0, ts, -inf).max()
    zero = torch.zeros((), dtype=ts.dtype, device=ts.device)
    t0 = torch.where(torch.isfinite(t0), t0, zero)
    t1 = torch.where(torch.isfinite(t1), t1, zero)
    return t0, t1, t1 - t0 + 1e-6


def events_to_voxel(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor, ps: torch.Tensor,
                    num_bins: int, sensor_size: Tuple[int, int],
                    valid: Optional[torch.Tensor] = None, round_ts: bool = False
                    ) -> torch.Tensor:
    """Voxel grid ``[..., H, W, num_bins]`` with temporal bilinear weights
    ``max(0, 1 - |t * (num_bins - 1) - b|)``; ``ts`` normalized to [0, 1]."""
    v = _valid_or_ones(valid, xs)
    tnorm = ts.to(torch.float32) * (num_bins - 1)
    if round_ts:
        tnorm = torch.round(tnorm)
    bins = [events_to_image(xs, ys, ps.to(torch.float32) * torch.clamp_min(
        1.0 - torch.abs(tnorm - b), 0.0), sensor_size, v) for b in range(num_bins)]
    return torch.stack(bins, dim=-1)


def events_to_stack(xs: torch.Tensor, ys: torch.Tensor, ts: torch.Tensor, ps: torch.Tensor,
                    num_bins: int, sensor_size: Tuple[int, int],
                    valid: Optional[torch.Tensor] = None, polarity: bool = False,
                    binning: str = "half_open") -> torch.Tensor:
    """Time-binned stack of one ``[N]`` event cloud: ``[H, W, num_bins]``
    signed counts, or ``[H, W, num_bins, 2]`` split by polarity. Bins span
    the valid events' first to last timestamp. ``"half_open"`` puts each
    event in one bin, ``floor((t - t0) / dt * B)``; ``"inclusive"`` is the
    reference's index-based membership, the closed interval ``[tstart,
    tend]`` of the time-sorted stream (an event on an edge counts in both
    bins; ``ts`` ascending over the valid lanes), and zeroes the stack of a
    window whose valid timestamps sum to 0 or that has 3 valid events or
    fewer."""
    assert binning in ("half_open", "inclusive"), binning
    h, w = sensor_size
    n = xs.shape[0]
    dev = xs.device
    v = _valid_or_ones(valid, xs)
    tsf = ts.to(torch.float32)
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xi = xs.to(torch.int64).clamp(0, w - 1)
    yi = ys.to(torch.int64).clamp(0, h - 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    t0, _, dt = _normalized_bin_time(tsf, v)
    planes = 2 if polarity else 1
    cell = (yi * w + xi) * num_bins

    def scatter(out_flat, bins, pc, vals):
        return out_flat.index_put(((cell + bins) * planes + pc,), vals, accumulate=True)

    out = torch.zeros(h * w * num_bins * planes, dtype=torch.float32, device=dev)
    if polarity:
        channels = ((0, torch.where((ps > 0) & inb, v, zero)),
                    (1, torch.where((ps < 0) & inb, v, zero)))
    else:
        channels = ((0, torch.where(inb, ps.to(torch.float32) * v, zero)),)
    shape = (h, w, num_bins, 2) if polarity else (h, w, num_bins)

    if binning == "inclusive":
        delta = dt / torch.tensor(float(num_bins), device=dev)
        ts_eff = torch.where(v > 0, tsf, torch.full_like(tsf, float("inf")))
        starts = t0 + delta * torch.arange(num_bins, device=dev)
        begs = torch.searchsorted(ts_eff, starts)
        ends = torch.searchsorted(ts_eff, starts + delta, right=True)
        idx = torch.arange(n, device=dev)
        member = (idx[:, None] >= begs[None, :]) & (idx[:, None] < ends[None, :])
        n_valid = v.sum()
        ts_sum = torch.where(v > 0, tsf, zero).sum()
        alive = torch.where((ts_sum == 0) | (n_valid <= 3), zero, zero + 1.0)
        for b in range(num_bins):
            for pc, vals in channels:
                out = scatter(out, b, pc, torch.where(member[:, b], vals, zero))
        return out.reshape(shape) * alive

    rel = (tsf - t0) / dt
    bin_idx = torch.floor(rel * num_bins).to(torch.int64).clamp(0, num_bins - 1)
    for pc, vals in channels:
        out = scatter(out, bin_idx, pc, vals)
    return out.reshape(shape)


def activity_fraction(act: torch.Tensor) -> torch.Tensor:
    """Fraction of active tiles of a :func:`tile_activity` map (f32 scalar)."""
    return (act > 0).to(torch.float32).mean()


def events_to_channels_activity(xs: torch.Tensor, ys: torch.Tensor, ps: torch.Tensor,
                                sensor_size: Tuple[int, int],
                                valid: Optional[torch.Tensor] = None, tile: int = 8
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Count image ``[H, W, 2]`` and its per-tile activity ``[Ht, Wt]``, the
    second a reduction of the first."""
    cnt = events_to_channels(xs, ys, ps, sensor_size, valid)
    return cnt, tile_activity(cnt, tile)


def events_to_mask(xs: torch.Tensor, ys: torch.Tensor, ps: torch.Tensor,
                   sensor_size: Tuple[int, int], valid: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Binary ``[H, W]`` activity mask."""
    img = events_to_image(xs, ys, torch.abs(ps.to(torch.float32)), sensor_size, valid)
    return (img > 0).to(torch.float32)


def events_polarity_mask(ps: torch.Tensor) -> torch.Tensor:
    """``[N, 2]`` polarity mask: ``(p, 0)`` for p > 0, ``(0, -p)`` for p < 0."""
    zero = torch.zeros((), dtype=ps.dtype, device=ps.device)
    return torch.stack([torch.where(ps > 0, ps, zero), torch.where(ps < 0, -ps, zero)],
                       dim=-1).to(torch.float32)


def get_hot_event_mask(event_rate: torch.Tensor, idx, max_px: int = 100, min_obvs: int = 5,
                       max_rate: float = 0.8) -> torch.Tensor:
    """Binary ``[H, W]`` mask zeroing hot pixels: those among the
    ``max_px`` largest rates that are above ``max_rate``; all ones while
    ``idx <= min_obvs``. The top-k set comes from a stable descending sort,
    so among equal rates the lower index ranks first, as ``jax.lax.top_k``
    orders ties (``torch.topk`` promises no order among ties)."""
    h, w = event_rate.shape
    flat = event_rate.reshape(-1)
    k = min(max_px, flat.shape[0])
    perm = torch.sort(flat, descending=True, stable=True).indices
    rank = torch.argsort(perm)
    hot = (rank < k) & (flat > max_rate)
    one = torch.ones((), dtype=torch.float32, device=flat.device)
    mask = torch.where(hot, one - 1.0, one).reshape(h, w)
    if isinstance(idx, torch.Tensor):
        return torch.where(idx > min_obvs, mask, one)
    return mask if idx > min_obvs else torch.ones_like(mask)


def _counts_to_events(counts: torch.Tensor, xs_of: torch.Tensor, ys_of: torch.Tensor,
                      ps_of: torch.Tensor, t_start: torch.Tensor, t_end: torch.Tensor,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand per-cell counts ``[M]`` into an event list: event ``r`` of a
    cell with count ``c`` at ``t_start + (t_end - t_start) * r / (c - 1)``
    (``np.linspace`` with endpoints), the list stably sorted by time. Past
    ``capacity`` the first ``capacity`` events in the cells' scan order are
    kept (a biased truncation: ``valid.sum() == capacity`` signals it).
    Negative counts count as 0. The cumulative count is an integer scan
    (a float ``cumsum`` has no deterministic CUDA path)."""
    counts = torch.clamp_min(counts.to(torch.int64), 0)
    cum = torch.cumsum(counts, dim=0)
    total = cum[-1]
    ranks = torch.arange(capacity, dtype=torch.int64, device=counts.device)
    cell = torch.searchsorted(cum, ranks, right=True).clamp(0, counts.shape[0] - 1)
    in_range = ranks < total
    start = cum[cell] - counts[cell]
    r_in_cell = (ranks - start).to(torch.float32)
    c = counts[cell].to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=counts.device)
    frac = torch.where(c > 1, r_in_cell / torch.clamp_min(c - 1.0, 1.0), zero)
    t = t_start[cell] + (t_end[cell] - t_start[cell]) * frac
    ev = torch.stack([xs_of[cell].to(torch.float32), ys_of[cell].to(torch.float32), t,
                      ps_of[cell].to(torch.float32)], dim=-1)
    order = torch.sort(torch.where(in_range, t, zero + float("inf")), stable=True).indices
    valid = in_range[order]
    return torch.where(valid[:, None], ev[order], zero), valid


def _pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ys, xs = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                            indexing="ij")
    return ys.reshape(-1), xs.reshape(-1)


def cnt2event(cnt: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Count image ``[H, W, 2]`` (pos, neg) -> event list: a pixel with
    rounded count ``c`` emits ``c`` events at timestamps ``linspace(0, 1,
    c)``, polarity +1 from channel 0 and -1 from channel 1; the list is
    time-sorted with positives first at equal times. Returns ``([capacity,
    4] (x, y, t, p), [capacity] valid)``."""
    h, w, _ = cnt.shape
    counts = torch.round(cnt).to(torch.int32)
    ys, xs = _pixel_grid(h, w, cnt.device)
    m = h * w
    ones = torch.ones(m, dtype=torch.float32, device=cnt.device)
    flat_counts = torch.cat([counts[..., 0].reshape(-1), counts[..., 1].reshape(-1)])
    return _counts_to_events(flat_counts, torch.cat([xs, xs]), torch.cat([ys, ys]),
                             torch.cat([ones, -ones]), torch.zeros(2 * m, device=cnt.device),
                             torch.ones(2 * m, device=cnt.device), capacity)


def _bin_times(bin_of: torch.Tensor, num_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    n = torch.tensor(float(num_bins), device=bin_of.device)
    t_start = bin_of.to(torch.float32) / n + 1.0 / (100.0 * num_bins)
    t_end = (bin_of + 1.0) / n
    return t_start.to(torch.float32), t_end.to(torch.float32)


def event_redistribute(stack: torch.Tensor, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Time-binned stack ``[H, W, B]`` of signed counts -> event list: a
    cell in bin ``b`` with rounded count ``c`` emits ``|c|`` events of
    polarity ``sign(c)`` at ``linspace(b/B + 1/(100B), (b+1)/B, |c|)``,
    scanned bin-major as the reference's ``[B, Y, X]`` layout is."""
    h, w, num_bins = stack.shape
    counts = torch.round(stack)
    ys, xs = _pixel_grid(h, w, stack.device)
    bin_of = torch.arange(num_bins, device=stack.device).repeat_interleave(h * w)
    flat = counts.permute(2, 0, 1).reshape(-1)
    one = torch.ones((), dtype=torch.float32, device=stack.device)
    t_start, t_end = _bin_times(bin_of, num_bins)
    return _counts_to_events(torch.abs(flat).to(torch.int32), xs.repeat(num_bins),
                             ys.repeat(num_bins), torch.where(flat >= 0, one, -one),
                             t_start, t_end, capacity)


def event_redistribute_polarity(stack: torch.Tensor, capacity: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polarity variant: ``[H, W, B, 2]`` non-negative (pos, neg) counts,
    scanned polarity-major, then by bin (the reference's ``[P, B, Y, X]``)."""
    h, w, num_bins, _ = stack.shape
    counts = torch.round(stack)
    ys, xs = _pixel_grid(h, w, stack.device)
    m = h * w
    bin_of = torch.arange(num_bins, device=stack.device).repeat_interleave(m).repeat(2)
    pol_of = torch.tensor([1.0, -1.0], device=stack.device).repeat_interleave(num_bins * m)
    flat = counts.permute(3, 2, 0, 1).reshape(-1)
    t_start, t_end = _bin_times(bin_of, num_bins)
    return _counts_to_events(flat.to(torch.int32), xs.repeat(2 * num_bins),
                             ys.repeat(2 * num_bins), pol_of, t_start, t_end, capacity)


def _batched(fn):
    def run(grids: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
        outs = [fn(g, capacity) for g in grids]
        return torch.stack([e for e, _ in outs]), torch.stack([v for _, v in outs])

    run.__name__ = f"{fn.__name__}_batch"
    run.__doc__ = f"``{fn.__name__}`` over a leading batch axis."
    return run


cnt2event_batch = _batched(cnt2event)
event_redistribute_batch = _batched(event_redistribute)
event_redistribute_polarity_batch = _batched(event_redistribute_polarity)


def stack2cnt(stack: torch.Tensor) -> torch.Tensor:
    """Time-binned stack ``[..., H, W, TB]`` -> count image ``[..., H, W,
    2]``: round, split the signed counts by sign, sum over the bins."""
    s = torch.round(stack)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    pos = torch.where(s > 0, s, zero).sum(dim=-1)
    neg = (-torch.where(s < 0, s, zero)).sum(dim=-1)
    return torch.stack([pos, neg], dim=-1)


def event_restore(events: torch.Tensor, resolution: Tuple[int, int]) -> torch.Tensor:
    """Denormalize ``[B, N, 4]`` (x, y, t, p) clouds with x, y in [0, 1):
    pixel coordinates, the polarity snapped to exactly +-1 (a zero-padded
    lane stays 0)."""
    h, w = resolution
    return torch.stack([events[..., 0] * w, events[..., 1] * h, events[..., 2],
                        torch.sign(events[..., 3])], dim=-1)


def event_conversion(event_list: torch.Tensor, time_bins: int, resolution: Tuple[int, int],
                     time_bins_voxel: Optional[int] = None,
                     valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Batched clouds ``[B, N, 4]`` (x, y, t, p; ``ts`` in [0, 1]) -> every
    dense encoding: ``{"e_cnt": [B, H, W, 2], "e_voxel": [B, H, W, TBv],
    "e_stack": [B, H, W, TB]}``; each cloud is stably time-sorted first
    (padded lanes last) and its stack binned ``"inclusive"``."""
    if time_bins_voxel is None:
        time_bins_voxel = time_bins
    v = _valid_or_ones(valid, event_list[..., 0])
    inf = torch.tensor(float("inf"), dtype=event_list.dtype, device=event_list.device)
    cnt, voxel, stack = [], [], []
    for entry, vb in zip(event_list, v):
        order = torch.sort(torch.where(vb > 0, entry[:, 2], inf), stable=True).indices
        e, vs = entry[order], vb[order]
        xs, ys, ts, ps = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
        cnt.append(events_to_channels(xs, ys, ps, resolution, valid=vs))
        voxel.append(events_to_voxel(xs, ys, ts, ps, time_bins_voxel, resolution, valid=vs))
        stack.append(events_to_stack(xs, ys, ts, ps, time_bins, resolution, valid=vs,
                                     binning="inclusive"))
    return {"e_cnt": torch.stack(cnt), "e_voxel": torch.stack(voxel),
            "e_stack": torch.stack(stack)}


def normalize_events(xs: torch.Tensor, ys: torch.Tensor, sensor_size: Tuple[int, int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Event coordinates normalized to [0, 1)."""
    h, w = sensor_size
    return (xs.to(torch.float32) / torch.tensor(float(w), device=xs.device),
            ys.to(torch.float32) / torch.tensor(float(h), device=ys.device))
