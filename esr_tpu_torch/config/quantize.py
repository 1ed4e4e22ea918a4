"""Post-training int8 quantization, the serving rung (counterpart of
``esr_tpu/config/quantize.py``): w8a8 at the contraction seams only.

Nothing outside a conv or a dense changes width: params, lane states,
inputs and every activation between seams stay f32. At each seam
(:class:`esr_tpu_torch.models.layers.Conv2d` / ``Linear``):

- weights: per output channel, symmetric, ``scale_c = max|w[c]| / 127``;
- activations: dynamic, per tensor, ``scale = max(amax, 1e-12) / 127``,
  ``q = clip(round(x / scale), -127, 127)``, rounding half to even;
- the contraction: int8 x int8 with an int32 accumulator;
- dequantized at the seam as ``acc * (scale_x * scale_w[c])``, then the bias.

On CUDA tensors :func:`quantized_conv2d` and :func:`quantized_linear` run
the hand-written kernels of :mod:`esr_tpu_torch.ops.int8_cuda` (the
quantization K2 and the int8 convolution K1; a dense is a 1x1 convolution);
on CPU tensors the same wrappers run their plain versions, which are
bitwise the kernels'. A kernel that does not build or launch raises.

The trigger is :func:`int8_scope`, a ``ContextVar``, so the serving pump's
thread and any other thread cannot leak the rung into each other.

:func:`calibrate_ranges` reads per-layer activation ranges off the numerics
plane's stats probes over a seeded corpus (the reference's calibration);
the rung itself stays dynamic per tensor and does not consume them.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

import torch

# floor of the symmetric scale: an all-zero tensor quantizes to zeros
_SCALE_EPS = 1e-12

_INT8_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "esr_torch_int8_scope", default=False
)


@contextlib.contextmanager
def int8_scope(enabled: bool = True):
    """While active, every contraction seam of ``models.layers`` run on
    this thread (or task) takes the int8 path."""
    token = _INT8_SCOPE.set(bool(enabled))
    try:
        yield
    finally:
        _INT8_SCOPE.reset(token)


def int8_enabled() -> bool:
    """Is the int8 scope active here?"""
    return bool(_INT8_SCOPE.get())


def quantize_symmetric(x: torch.Tensor, axis: Optional[int] = None):
    """``(q, scale)``: ``q = clip(round(x / scale), -127, 127)`` as int8,
    ``scale = max(amax, 1e-12) / 127`` f32. ``axis=None`` is per tensor (a
    0-dim scale); ``axis=k`` per channel along ``k`` (the scale keeps the
    reduced dims, so it broadcasts against ``x``)."""
    xf = x.float()
    if axis is None:
        amax = xf.abs().amax()
    else:
        red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
        amax = xf.abs().amax(dim=red, keepdim=True)
    # divide by a tensor on x's device: PyTorch's CUDA division by a host
    # scalar multiplies by its reciprocal, which is not IEEE division
    scale = torch.clamp_min(amax, _SCALE_EPS) / torch.full((), 127.0, device=x.device)
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_symmetric` (f32 out): ``q * scale``."""
    return q.float() * scale


def quantized_conv2d(x: torch.Tensor, weight, bias: Optional[torch.Tensor],
                     stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The int8 conv seam on NCHW f32 ``x``. ``weight`` is the OIHW f32
    weight or its :class:`~esr_tpu_torch.ops.int8_cuda.PackedWeight` (the
    seam caches one per weight)."""
    from esr_tpu_torch.ops import int8_cuda

    if not isinstance(weight, int8_cuda.PackedWeight):
        weight = int8_cuda.pack_weight(weight)
    xq, sx = int8_cuda.quantize_per_tensor(x)
    return int8_cuda.int8_conv(xq, sx, weight, bias, stride, padding)


def quantized_linear(x: torch.Tensor, weight, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The int8 dense seam on ``x [B, in]``, through the conv kernel as a
    1x1 convolution. ``weight`` is ``[out, in]`` f32 or its packed 1x1
    form."""
    from esr_tpu_torch.ops import int8_cuda

    if x.dim() != 2:
        raise ValueError(f"quantized_linear takes [B, in], got {tuple(x.shape)}")
    if not isinstance(weight, int8_cuda.PackedWeight):
        weight = int8_cuda.pack_weight(weight[:, :, None, None])
    out = quantized_conv2d(x[:, :, None, None], weight, bias)
    return out.reshape(x.shape[0], -1)


# -- calibration: a seeded corpus -> per-layer ranges through the probe taps --


def calibrate_ranges(model=None, *, inch: int = 2, basech: int = 8, hw: int = 32,
                     frames: int = 3, batch: int = 1, seed: int = 0, n_batches: int = 2,
                     device=None) -> Dict[str, float]:
    """Per-layer activation ranges ``{tag: max_abs}`` from a seeded synthetic
    corpus through the numerics plane's stats probes
    (:mod:`esr_tpu_torch.ops.numerics`, ``mode="stats"``): the model's own
    taps, no new ones. Deterministic from ``seed``: the default model is
    built under ``torch.manual_seed(seed)`` with the caller's RNG state
    restored after, and the ``n_batches`` standard-normal batches ``[batch,
    frames, hw, hw, inch]`` come from one ``torch.Generator`` seeded by
    ``seed``. ``model`` (when given) must be probe-enabled (``numerics=True,
    numerics_mode="stats"``); by default a ``DeepRecurrNet`` at the drift
    harness's geometry is built. Runs on the card unless ``device`` is the
    CPU; :func:`calibrate_ranges_on` takes given weights and a given
    corpus."""
    if model is None:
        from esr_tpu_torch.models.esr import DeepRecurrNet

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(seed))
            model = DeepRecurrNet(inch=inch, basech=basech, num_frame=frames,
                                  numerics=True, numerics_mode="stats")
    gen = torch.Generator().manual_seed(int(seed))
    corpus = [torch.randn((batch, frames, hw, hw, inch), generator=gen)
              for _ in range(int(n_batches))]
    return calibrate_ranges_on(model, corpus, device=device)


def calibrate_ranges_on(model, corpus, device=None) -> Dict[str, float]:
    """:func:`calibrate_ranges` on given weights and a given corpus: each
    batch ``[B, frames, H, W, inch]`` (a tensor or an array) runs one
    forward from zero states under the probes' ``collect()``; a tag's range
    is the largest ``max_abs`` over the corpus, rounded to 6 decimals as in
    the reference. The stats come back in one copy after the device loop."""
    import numpy as np

    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.ops.numerics import STAT_FIELDS, collect

    if not getattr(model, "numerics", False) or model.numerics_mode != "stats":
        raise ValueError("calibrate_ranges needs a probe-enabled model "
                         "(numerics=True, numerics_mode='stats')")
    dev = resolve_device(device)
    model = model.to(dev).eval()
    tags, vecs = [], []
    with torch.no_grad():
        for x in corpus:
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x, dtype=np.float32))
            x = x.to(dev, torch.float32)
            states = model.init_states(x.shape[0], x.shape[2], x.shape[3], device=dev)
            with collect() as sown:
                model(x, states)
            for tag, vec in sown.items():
                tags.append(tag)
                vecs.append(vec)
    host = torch.stack(vecs).cpu().double().numpy() if vecs else []
    idx = STAT_FIELDS.index("max_abs")
    ranges: Dict[str, float] = {}
    for tag, vec in zip(tags, host):
        ranges[tag] = max(ranges.get(tag, 0.0), float(vec[idx]))
    return {tag: round(v, 6) for tag, v in sorted(ranges.items())}
