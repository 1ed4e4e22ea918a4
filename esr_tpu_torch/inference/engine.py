"""Batched streaming inference: lane-packed recordings, fused windows
(counterpart of ``esr_tpu/inference/engine.py``).

- **Lanes.** ``B = lanes`` recordings stream at once, one per batch lane of
  a single ``(B, ...)`` forward, each lane with its own recurrent state;
  lanes refill at chunk boundaries (``data.loader.LanePackedChunks``) and a
  refilled lane's state is reset.
- **Chunks.** ``W = chunk_windows`` consecutive windows per lane run in one
  call of the chunk function (:func:`make_chunk_fn`): a Python loop over the
  windows where the reference scans, the recurrent state carried across.
  On the card the engine runs it as one CUDA graph (:class:`GraphedChunk`):
  the first chunk runs eagerly (the warm-up), the second captures, and
  each chunk after is its inputs copied into the graph's static ones and
  one replay, the output states carried into the next chunk's inputs in
  the graph. Serving and the AOT programs call :class:`ChunkProgram`
  eagerly.
- **Metrics on the card.** Per-window l1/mse/ssim/psnr of the ESR output and
  of the bicubic baseline are summed per lane on the card, masked by window
  validity; the per-window SSIM pairs come back stacked ``(W, B)`` for the
  report's paired-delta statistics. The host reads back one small dict per
  chunk.
- **Overlap.** A ``DevicePrefetcher`` thread builds and uploads chunk
  ``i+1`` (pinned host memory, non-blocking copies on a side stream) while
  the card runs chunk ``i``; chunk readbacks resolve one chunk behind
  dispatch.
- **Telemetry.** One ``infer_run`` trace per pass and one ``infer_chunk``
  span per chunk (dispatch to readback, with the lanes' recordings), into
  the process-active sink (``obs.active_sink``), when there is one.

Per-recording results have the schema of the sequential harness
(``inference/harness.py``). ``lanes=1, chunk_windows=1`` is the sequential
schedule.

Precision rungs (``esr_tpu_torch.config.precision``): at bf16
(``compute_dtype``) the chunk function runs a bf16 copy of the model, the
lane states are materialized in bf16 and the inputs cast, and each
prediction is upcast to f32 before the resize and the metrics (the per-lane
sums stay f32); at int8 (``precision="int8"``) nothing is cast and the
forward runs inside ``int8_scope()``. A lane state is extracted to the host
bit-exactly at either width (bf16 as its raw 16-bit words,
``serving.wire.BF16_WORDS``).
"""

from __future__ import annotations

import copy
import logging
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from esr_tpu_torch.config.precision import (
    canonical_precision,
    compute_dtype_of,
    resolve_precision,
)
from esr_tpu_torch.config.quantize import int8_scope
from esr_tpu_torch.data.loader import DevicePrefetcher, LanePackedChunks
from esr_tpu_torch.data.records import recording_name
from esr_tpu_torch.device import DeviceLike, resolve_device
from esr_tpu_torch.obs import active_sink, trace
from esr_tpu_torch.ops.resize import interpolate
from esr_tpu_torch.serving.wire import BF16_WORDS
from esr_tpu_torch.training.multistep import GraphedCall

logger = logging.getLogger(__name__)

# per-lane sums, in the sequential tracker's key order
METRIC_KEYS = (
    "esr_l1", "esr_mse", "esr_ssim", "esr_psnr",
    "bicubic_l1", "bicubic_mse", "bicubic_ssim", "bicubic_psnr",
)

States = Tuple[torch.Tensor, ...]


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


class ChunkProgram(torch.nn.Module):
    """The fused chunk as a module: ``(states, reset_keep, windows) ->
    (states, sums, stacked)``, run under ``torch.no_grad()``. The model is
    its submodule ``model``, so ``torch.export`` lifts the model's weights
    (``inference/export.py``); the loop over the windows unrolls in an
    exported graph, as the reference's scan fuses them.

    ``states`` is the model's lane-batched recurrent state; ``reset_keep``
    ``(B,)`` zeroes the lanes where it is 0 (by ``where``, so a non-finite
    state resets to a clean zero); ``windows`` holds ``inp_scaled (W, B,
    seqn, h, w, c)``, ``gt (W, B, kh, kw, c)``, ``inp_mid (W, B, lh, lw,
    c)`` and ``valid (W, B)``. ``sums`` are the per-lane metric sums over
    valid windows (``where`` by ``valid``, so a padded window's inf or NaN
    never reaches a sum) and ``count``; ``stacked`` the per-window SSIM
    pairs ``(W, B)``. ``(kh, kw)`` is the GT grid the output and the LR
    baseline are resized to.

    ``compute_dtype`` (bf16) runs a copy of the model cast once to it, with
    the states and inputs cast; predictions are upcast to f32 before the
    resize and the metrics. ``precision="int8"`` runs the model inside
    ``int8_scope()``, nothing cast; with a ``compute_dtype`` it raises.
    Every branch is on shapes and settings, none on tensor values."""

    def __init__(self, model: torch.nn.Module, lanes: int, chunk_windows: int, kh: int,
                 kw: int, compute_dtype: Optional[torch.dtype] = None,
                 precision: Optional[str] = None):
        super().__init__()
        int8 = precision is not None and canonical_precision(precision) == "int8"
        if int8 and compute_dtype is not None:
            raise ValueError("precision='int8' quantizes at the seams: params and states "
                             "stay f32, so compute_dtype must be None")
        if lanes < 1 or chunk_windows < 1:
            raise ValueError(f"lanes and chunk_windows must be >= 1, got "
                             f"{lanes}, {chunk_windows}")
        self.model = model if compute_dtype is None else copy.deepcopy(model).to(compute_dtype)
        self.lanes = int(lanes)
        self.chunk_windows = int(chunk_windows)
        self.gt_hw = (int(kh), int(kw))
        self.compute_dtype = compute_dtype
        self.int8 = int8

    def _model(self, inp: torch.Tensor, states: States):
        if self.compute_dtype is not None:
            inp = inp.to(self.compute_dtype)
            states = tuple(z.to(self.compute_dtype) for z in states)
        if self.int8:
            with int8_scope():
                return self.model(inp, states)
        return self.model(inp, states)

    def _to_gt_grid(self, imgs: torch.Tensor) -> torch.Tensor:
        if tuple(imgs.shape[1:3]) != self.gt_hw:
            return interpolate(imgs, self.gt_hw, "bicubic")
        return imgs

    def forward(self, states: States, reset_keep: torch.Tensor,
                windows: Dict[str, torch.Tensor]):
        with torch.no_grad():
            return self._run(states, reset_keep, windows)

    def _run(self, states: States, reset_keep: torch.Tensor,
             windows: Dict[str, torch.Tensor]):
        lanes, chunk_windows = self.lanes, self.chunk_windows
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
            pred, states = self._model(windows["inp_scaled"][t], states)
            pred = self._to_gt_grid(pred.float())
            bicubic = self._to_gt_grid(windows["inp_mid"][t])
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


def make_chunk_fn(model: torch.nn.Module, lanes: int, chunk_windows: int, kh: int,
                  kw: int, compute_dtype: Optional[torch.dtype] = None,
                  precision: Optional[str] = None) -> ChunkProgram:
    """The fused chunk function: a :class:`ChunkProgram` over ``model``."""
    return ChunkProgram(model, lanes, chunk_windows, kh, kw, compute_dtype, precision)


class GraphedChunk:
    """A :class:`ChunkProgram`'s call as one CUDA graph replay (module
    docstring), the same bits as the eager call. Its static inputs are the
    ``states``, ``reset_keep`` and ``windows`` of the program; a call copies
    the staged chunk in (and the states, unless they are the graph's own,
    returned by the last call), replays, and returns the graph's states
    and copies of the chunk's sums and SSIM pairs (the next replay writes
    the graph's outputs again)."""

    def __init__(self, program: ChunkProgram):
        self.program = program
        self._graph: Optional[GraphedCall] = None
        self._inputs = None
        self._warm = False

    @property
    def graph(self) -> Optional[GraphedCall]:
        return self._graph

    def _capture(self, states: States, reset_keep: torch.Tensor,
                 windows: Dict[str, torch.Tensor]) -> None:
        s_states = tuple(torch.empty_like(z) for z in states)
        s_keep = torch.empty_like(reset_keep)
        s_windows = {k: torch.empty_like(v) for k, v in windows.items()}
        self._inputs = (s_states, s_keep, s_windows)

        def run():
            out_states, sums, stacked = self.program(s_states, s_keep, s_windows)
            # the carry: the next replay starts from this one's states
            for s, o in zip(s_states, out_states):
                s.copy_(o)
            return (torch.stack([sums[k] for k in METRIC_KEYS + ("count",)]),
                    torch.stack([stacked[k] for k in ("esr_ssim", "bicubic_ssim")]))

        self._graph = GraphedCall(run, reset_keep.device)

    def __call__(self, states: States, reset_keep: torch.Tensor,
                 windows: Dict[str, torch.Tensor]):
        if not self._warm:
            self._warm = True
            return self.program(states, reset_keep, windows)
        if self._graph is None:
            self._capture(states, reset_keep, windows)
        s_states, s_keep, s_windows = self._inputs
        if states is not s_states:
            for s, z in zip(s_states, states):
                s.copy_(z)
        s_keep.copy_(reset_keep)
        for k, v in windows.items():
            s_windows[k].copy_(v)
        sums, stacked = (t.clone() for t in self._graph.replay())
        return (s_states,
                {k: sums[i] for i, k in enumerate(METRIC_KEYS + ("count",))},
                {k: stacked[i] for i, k in enumerate(("esr_ssim", "bicubic_ssim"))})


# -- per-lane recurrent state save / restore ----------------------------------
# A stream evicted from its lane resumes bit-identically later, possibly in
# another lane or process: f32 round-trips card -> numpy -> card exactly, and
# bf16 as its raw 16-bit words.


def extract_lane_state(states: States, lane: int) -> Tuple[np.ndarray, ...]:
    """One lane's recurrent state as host numpy arrays (bit-exact; a bf16
    leaf as :data:`BF16_WORDS`)."""
    out = []
    for z in states:
        z = z[lane].detach()
        if z.dtype == torch.bfloat16:
            out.append(z.view(torch.int16).cpu().numpy().view(BF16_WORDS).copy())
        else:
            out.append(z.cpu().numpy().copy())
    return tuple(out)


def inject_lane_state(states: States, lane: int, host_state) -> States:
    """Write a saved lane state (from :func:`extract_lane_state`) into lane
    ``lane``; the other lanes are untouched."""
    if len(host_state) != len(states):
        raise ValueError(f"lane state has {len(host_state)} leaves, the model's "
                         f"{len(states)}")
    for z, h in zip(states, host_state):
        h = np.asarray(h)
        if z.dtype == torch.bfloat16:
            if h.dtype.itemsize != 2 or h.dtype.kind not in "ui":
                raise ValueError(f"a bf16 lane state takes 16-bit words, got {h.dtype}")
            h = torch.from_numpy(np.ascontiguousarray(h).view(np.int16)).view(torch.bfloat16)
        elif h.dtype == BF16_WORDS and h.dtype.metadata:
            raise ValueError(f"bf16 lane-state words for a {z.dtype} lane")
        else:
            h = torch.as_tensor(h)
        if tuple(h.shape) != tuple(z.shape[1:]):
            raise ValueError(f"lane state leaf {tuple(h.shape)} does not match "
                             f"{tuple(z.shape[1:])}")
        z[lane].copy_(h.to(device=z.device, dtype=z.dtype))
    return states


def lane_states(model: torch.nn.Module, lanes: int, kh: int, kw: int,
                device: torch.device, dtype: Optional[torch.dtype] = None) -> States:
    """Zero lane states, each leaf its own buffer (in ``dtype``, else f32)."""
    return tuple(z.to(dtype or z.dtype).clone()
                 for z in model.init_states(lanes, kh, kw, device=device))


class StreamingEngine:
    """Lane-packed, chunk-fused streaming inference over a datalist.

    ``run_datalist`` streams any number of recordings (paths or in-memory
    recordings) through ``lanes`` lanes in chunks of ``chunk_windows``
    windows and returns the sequential harness's per-recording results, at
    the rung ``precision`` (``None``: f32; the caller resolves CLI >
    checkpoint > f32).
    """

    def __init__(self, model: torch.nn.Module, seqn: int = 3, lanes: int = 4,
                 chunk_windows: int = 8, precision: Optional[str] = None,
                 device: DeviceLike = None):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if chunk_windows < 1:
            raise ValueError(f"chunk_windows must be >= 1, got {chunk_windows}")
        self.precision = resolve_precision(cli=precision)
        self.compute_dtype = compute_dtype_of(self.precision)
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
                                            kh, kw, self.compute_dtype, self.precision)
            if self.device.type == "cuda":
                self._run_chunk = GraphedChunk(self._run_chunk)
            self._chunk_key = (kh, kw)
        acc = [{"sums": {k: 0.0 for k in METRIC_KEYS}, "count": 0, "time_s": 0.0,
                "ssim": {"esr_ssim": [], "bicubic_ssim": []}} for _ in data_list]
        slot = {id(r): i for i, r in enumerate(data_list)}
        params_m = _num_params(self.model)
        states = lane_states(self.model, self.lanes, kh, kw, self.device,
                             self.compute_dtype)
        self.chunk_seconds = []
        sink = active_sink()

        def resolve(entry) -> None:
            idx, meta, sums_dev, stacked_dev, t_dispatch = entry
            sums = {k: v.cpu().numpy() for k, v in sums_dev.items()}
            stacked = {k: v.cpu().numpy() for k, v in stacked_dev.items()}
            t_res = time.monotonic()
            seconds = t_res - t_dispatch
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
            if sink is not None:
                # the ambient infer_run context gives trace_id and parent
                sink.span("infer_chunk", seconds, span_id=trace.new_id(),
                          begin=round(sink.rel(t_dispatch), 6), end=round(sink.rel(t_res), 6),
                          chunk=idx, lanes=self.lanes, chunk_windows=self.chunk_windows,
                          windows=total_valid,
                          recordings=[recording_name(m["path"]) if m else None for m in meta],
                          windows_per_sec=(round(total_valid / seconds, 3)
                                           if seconds > 0 else None))

        pending: deque = deque()
        # one trace per pass: the chunk spans parent under it
        with trace.span("infer_run", recordings=len(data_list), lanes=self.lanes,
                        chunk_windows=self.chunk_windows):
            with DevicePrefetcher(chunks, self._stage) as pf:
                for idx, (host_chunk, staged) in enumerate(pf):
                    t0 = time.monotonic()
                    w = self._wait(staged)
                    windows = {k: w[k] for k in ("inp_scaled", "gt", "inp_mid", "valid")}
                    states, sums, stacked = self._run_chunk(states, w["reset_keep"], windows)
                    pending.append((idx, host_chunk["meta"], sums, stacked, t0))
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
