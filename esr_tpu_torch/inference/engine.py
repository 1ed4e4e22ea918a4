"""Batched streaming inference: lane-packed recordings, fused windows
(counterpart of ``esr_tpu/inference/engine.py``).

- **Lanes.** ``B = lanes`` recordings stream at once, one per batch lane of
  a single ``(B, ...)`` forward, each lane with its own recurrent state;
  lanes refill at chunk boundaries (``data.loader.LanePackedChunks``) and a
  refilled lane's state is reset.
- **Chunks.** ``W = chunk_windows`` consecutive windows per lane run in one
  call of the chunk function (:func:`make_chunk_fn`): a Python loop over the
  windows where the reference scans, the recurrent state carried across.
- **Metrics on the card.** Per-window l1/mse/ssim/psnr of the ESR output and
  of the bicubic baseline are summed per lane on the card, masked by window
  validity; the per-window SSIM pairs come back stacked ``(W, B)`` for the
  report's paired-delta statistics. The host reads back one small dict per
  chunk.
- **Overlap.** A ``DevicePrefetcher`` thread builds and uploads chunk
  ``i+1`` (pinned host memory, non-blocking copies on a side stream) while
  the card runs chunk ``i``; chunk readbacks resolve one chunk behind
  dispatch.

Per-recording results have the schema of the sequential harness
(``inference/harness.py``). ``lanes=1, chunk_windows=1`` is the sequential
schedule. Only f32 is ported: ``compute_dtype`` and ``precision`` other than
f32 raise.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from esr_tpu_torch.data.loader import DevicePrefetcher, LanePackedChunks
from esr_tpu_torch.data.records import recording_name
from esr_tpu_torch.device import DeviceLike, resolve_device
from esr_tpu_torch.ops.resize import interpolate

logger = logging.getLogger(__name__)

# per-lane sums, in the sequential tracker's key order
METRIC_KEYS = (
    "esr_l1", "esr_mse", "esr_ssim", "esr_psnr",
    "bicubic_l1", "bicubic_mse", "bicubic_ssim", "bicubic_psnr",
)

States = Tuple[torch.Tensor, ...]


def check_f32(precision: Optional[str] = None, compute_dtype=None) -> None:
    """Only the f32 rung is ported; anything else raises."""
    if compute_dtype is not None or precision not in (None, "f32", "fp32", "float32"):
        raise NotImplementedError(
            f"precision {precision!r} / compute_dtype {compute_dtype!r} is not "
            "ported yet; the port runs f32"
        )


# -- per-image metrics over a lane batch [B, H, W, C] (the harness's metrics,
# losses/restore.py, one value per image) ------------------------------------

def _l1(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return (p - g).abs().mean(dim=(1, 2, 3))


def _mse(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return ((p - g) ** 2).mean(dim=(1, 2, 3))


def _psnr(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per channel ``data_range = g[c].max() - g.min()``, averaged (the
    reference's multi-channel quirk)."""
    tmin = g.amin(dim=(1, 2, 3))
    per = []
    for c in range(g.shape[-1]):
        r = g[..., c].amax(dim=(1, 2)) - tmin
        err = ((p[..., c] - g[..., c]) ** 2).mean(dim=(1, 2))
        per.append(10.0 * torch.log10(r ** 2 / torch.clamp(err, min=1e-20)))
    return torch.stack(per).mean(dim=0)


def _ssim(p: torch.Tensor, g: torch.Tensor, data_range: float = 2.0,
          win: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Channel-averaged SSIM (uniform 7x7 window, VALID region, sample
    covariance), one value per image."""
    b, h, w, c = p.shape
    x = p.permute(0, 3, 1, 2).reshape(b * c, 1, h, w).float()
    y = g.permute(0, 3, 1, 2).reshape(b * c, 1, h, w).float()
    k = torch.full((1, 1, win, win), 1.0 / (win * win), dtype=x.dtype, device=x.device)
    np_ = win * win
    cov_norm = np_ / (np_ - 1.0)
    ux, uy = F.conv2d(x, k), F.conv2d(y, k)
    uxx, uyy, uxy = F.conv2d(x * x, k), F.conv2d(y * y, k), F.conv2d(x * y, k)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3)).reshape(b, c).mean(dim=1)


_METRIC_FNS = {"l1": _l1, "mse": _mse, "ssim": _ssim, "psnr": _psnr}


def make_chunk_fn(model: torch.nn.Module, lanes: int, chunk_windows: int, kh: int,
                  kw: int, compute_dtype=None, precision=None):
    """The fused chunk: ``(states, reset_keep, windows) -> (states, sums,
    stacked)``, run under ``torch.no_grad()``.

    ``states`` is the model's lane-batched recurrent state; ``reset_keep``
    ``(B,)`` zeroes the lanes where it is 0 (by ``where``, so a non-finite
    state resets to a clean zero); ``windows`` holds ``inp_scaled (W, B,
    seqn, h, w, c)``, ``gt (W, B, kh, kw, c)``, ``inp_mid (W, B, lh, lw,
    c)`` and ``valid (W, B)``. ``sums`` are the per-lane metric sums over
    valid windows (``where`` by ``valid``, so a padded window's inf or NaN
    never reaches a sum) and ``count``; ``stacked`` the per-window SSIM
    pairs ``(W, B)``. ``(kh, kw)`` is the GT grid the output and the LR
    baseline are resized to."""
    check_f32(precision, compute_dtype)
    if lanes < 1 or chunk_windows < 1:
        raise ValueError(f"lanes and chunk_windows must be >= 1, got "
                         f"{lanes}, {chunk_windows}")

    def to_gt_grid(imgs: torch.Tensor) -> torch.Tensor:
        if tuple(imgs.shape[1:3]) != (kh, kw):
            return interpolate(imgs, (kh, kw), "bicubic")
        return imgs

    @torch.no_grad()
    def run_chunk(states: States, reset_keep: torch.Tensor,
                  windows: Dict[str, torch.Tensor]):
        if windows["inp_scaled"].shape[:2] != (chunk_windows, lanes):
            raise ValueError(
                f"chunk of shape {tuple(windows['inp_scaled'].shape[:2])}, "
                f"expected (chunk_windows, lanes) = ({chunk_windows}, {lanes})")
        keep = (reset_keep > 0).reshape(-1, 1, 1, 1)
        states = tuple(torch.where(keep, z, torch.zeros_like(z)) for z in states)
        sums = {k: torch.zeros(lanes, dtype=torch.float32, device=reset_keep.device)
                for k in METRIC_KEYS + ("count",)}
        ssim_pairs: Dict[str, List[torch.Tensor]] = {"esr_ssim": [], "bicubic_ssim": []}
        for t in range(chunk_windows):
            pred, states = model(windows["inp_scaled"][t], states)
            pred = to_gt_grid(pred.float())
            bicubic = to_gt_grid(windows["inp_mid"][t])
            gt = windows["gt"][t]
            valid = windows["valid"][t]
            for name, fn in _METRIC_FNS.items():
                for side, img in (("esr", pred), ("bicubic", bicubic)):
                    v = fn(img, gt)
                    key = f"{side}_{name}"
                    sums[key] = sums[key] + torch.where(valid > 0, v, torch.zeros_like(v))
                    if key in ssim_pairs:
                        ssim_pairs[key].append(v)
            sums["count"] = sums["count"] + valid
        stacked = {k: torch.stack(v) for k, v in ssim_pairs.items()}
        return states, sums, stacked

    return run_chunk


# -- per-lane recurrent state save / restore ----------------------------------
# A stream evicted from its lane resumes bit-identically later, possibly in
# another lane or process: f32 round-trips card -> numpy -> card exactly.


def extract_lane_state(states: States, lane: int) -> Tuple[np.ndarray, ...]:
    """One lane's recurrent state as host numpy arrays (bit-exact)."""
    return tuple(z[lane].detach().cpu().numpy().copy() for z in states)


def inject_lane_state(states: States, lane: int, host_state) -> States:
    """Write a saved lane state (from :func:`extract_lane_state`) into lane
    ``lane``; the other lanes are untouched."""
    if len(host_state) != len(states):
        raise ValueError(f"lane state has {len(host_state)} leaves, the model's "
                         f"{len(states)}")
    for z, h in zip(states, host_state):
        h = torch.as_tensor(np.asarray(h))
        if tuple(h.shape) != tuple(z.shape[1:]):
            raise ValueError(f"lane state leaf {tuple(h.shape)} does not match "
                             f"{tuple(z.shape[1:])}")
        z[lane].copy_(h.to(device=z.device, dtype=z.dtype))
    return states


def lane_states(model: torch.nn.Module, lanes: int, kh: int, kw: int,
                device: torch.device) -> States:
    """Zero lane states, each leaf its own buffer."""
    return tuple(z.clone() for z in model.init_states(lanes, kh, kw, device=device))


class StreamingEngine:
    """Lane-packed, chunk-fused streaming inference over a datalist.

    ``run_datalist`` streams any number of recordings (paths or in-memory
    recordings) through ``lanes`` lanes in chunks of ``chunk_windows``
    windows and returns the sequential harness's per-recording results.
    """

    def __init__(self, model: torch.nn.Module, seqn: int = 3, lanes: int = 4,
                 chunk_windows: int = 8, precision: Optional[str] = None,
                 device: DeviceLike = None):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if chunk_windows < 1:
            raise ValueError(f"chunk_windows must be >= 1, got {chunk_windows}")
        check_f32(precision)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.seqn = int(seqn)
        self.lanes = int(lanes)
        self.chunk_windows = int(chunk_windows)
        self._run_chunk = None
        self._chunk_key = None
        self._copy_stream = None
        self.chunk_seconds: List[float] = []

    def _stage(self, chunk: Dict) -> Dict:
        """Host chunk -> device tensors (on the prefetcher's thread): pinned
        copies uploaded on a side stream; the consumer waits on its event."""
        host = dict(chunk["windows"], reset_keep=chunk["reset_keep"])
        if self.device.type != "cuda":
            return {"tensors": {k: torch.from_numpy(v) for k, v in host.items()},
                    "event": None}
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            tensors = {k: torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
                       for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return {"tensors": tensors, "event": event}

    def _wait(self, staged: Dict) -> Dict[str, torch.Tensor]:
        tensors = staged["tensors"]
        if staged["event"] is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(staged["event"])
            for t in tensors.values():
                t.record_stream(compute)
        return tensors

    def run_datalist(self, data_list: Sequence, dataset_config: Dict
                     ) -> Tuple[List[Dict[str, float]], List[str]]:
        """Stream every recording; per-recording results (sequential-harness
        schema) in datalist order, and the recordings' names."""
        from esr_tpu_torch.inference.harness import (
            _attach_rmse,
            _attach_ssim_window_stats,
            _num_params,
        )

        chunks = LanePackedChunks(data_list, dataset_config, lanes=self.lanes,
                                  chunk_windows=self.chunk_windows)
        kh, kw = chunks.gt_resolution
        if self._run_chunk is None or self._chunk_key != (kh, kw):
            self._run_chunk = make_chunk_fn(self.model, self.lanes, self.chunk_windows,
                                            kh, kw)
            self._chunk_key = (kh, kw)
        acc = [{"sums": {k: 0.0 for k in METRIC_KEYS}, "count": 0, "time_s": 0.0,
                "ssim": {"esr_ssim": [], "bicubic_ssim": []}} for _ in data_list]
        slot = {id(r): i for i, r in enumerate(data_list)}
        params_m = _num_params(self.model)
        states = lane_states(self.model, self.lanes, kh, kw, self.device)
        self.chunk_seconds = []

        def resolve(entry) -> None:
            meta, sums_dev, stacked_dev, t_dispatch = entry
            sums = {k: v.cpu().numpy() for k, v in sums_dev.items()}
            stacked = {k: v.cpu().numpy() for k, v in stacked_dev.items()}
            seconds = time.monotonic() - t_dispatch
            self.chunk_seconds.append(seconds)
            total_valid = int(round(float(sums["count"].sum())))
            for lane, m in enumerate(meta):
                if m is None or m["windows"] == 0:
                    continue
                a = acc[slot[id(m["path"])]]
                for k in METRIC_KEYS:
                    a["sums"][k] += float(sums[k][lane])
                a["count"] += m["windows"]
                a["time_s"] += seconds * m["windows"] / total_valid
                for k in ("esr_ssim", "bicubic_ssim"):
                    a["ssim"][k].extend(float(v) for v in stacked[k][: m["windows"], lane])

        pending: deque = deque()
        with DevicePrefetcher(chunks, self._stage) as pf:
            for host_chunk, staged in pf:
                t0 = time.monotonic()
                w = self._wait(staged)
                windows = {k: w[k] for k in ("inp_scaled", "gt", "inp_mid", "valid")}
                states, sums, stacked = self._run_chunk(states, w["reset_keep"], windows)
                pending.append((host_chunk["meta"], sums, stacked, t0))
                # resolve one chunk behind dispatch
                if len(pending) > 1:
                    resolve(pending.popleft())
        while pending:
            resolve(pending.popleft())

        results, names = [], []
        for rec, a in zip(data_list, acc):
            n = a["count"]
            if n == 0:
                logger.warning("recording %s produced no windows", recording_name(rec))
            result = {k: (a["sums"][k] / n if n else 0.0) for k in METRIC_KEYS}
            result["time"] = a["time_s"] / n if n else 0.0
            result["params"] = params_m
            _attach_rmse(result)
            _attach_ssim_window_stats(result, a["ssim"])
            results.append(result)
            names.append(recording_name(rec))
        return results, names
