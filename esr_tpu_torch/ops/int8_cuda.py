"""The int8 rung's hand-written CUDA kernels, their wrappers, their launch
plans and their plain versions.

One source, ``esr_tpu_torch/csrc/int8_conv.cu``, built on first use with
``nvcc`` into ``esr_tpu_torch/_build/`` by the same
:class:`~esr_tpu_torch.ops.dcn_cuda.CudaLibrary` as the DCN kernels:

- :data:`quantize_per_tensor` (K2): the dynamic per-tensor activation
  quantization of ``esr_tpu/config/quantize.py:quantize_symmetric``
  (``axis=None``), from an NCHW f32 tensor to the NHWC int8 layout the
  convolution reads (channels padded to a multiple of 4 with zeros) and the
  scale, in one launch: a cooperative grid whose blocks' amax partials sit
  in a scratch array kept per device and stream (:func:`quantize_blocks`);
- :data:`int8_conv` (K1): an implicit-GEMM convolution of int8 activations
  and per-output-channel int8 weights with an int32 accumulator
  (``mma.sync.m16n8k32`` on operands staged by ``cp.async``, the K steps
  split across the blocks of a cluster where the output is small),
  dequantized in its epilogue to NCHW f32; its tiles, split and copy width
  come from :func:`conv_plan`.

Neither has a Pallas counterpart: the JAX package runs its int8 rung
through XLA. Both are bitwise equal to their plain versions
(:func:`quantize_per_tensor_plain`, :func:`int8_conv_plain`: a convolution
of the int8 values held in f64, exact because ``|acc| < 2**31 < 2**53``).
Each is a ``torch.library`` op of the ``esr_tpu_torch`` namespace
(``torch.ops.esr_tpu_torch.quantize_per_tensor`` and ``int8_conv``; see
:mod:`esr_tpu_torch.ops.dcn_cuda`), which its wrapper calls: the op's CPU
implementation is the plain version (only for CPU tensors), its CUDA one
launches the kernel or raises, its fake one gives the output's shape for
``torch.export``. ``launches`` counts kernel launches and nothing else.
The weights are quantized by the plain
:func:`~esr_tpu_torch.config.quantize.quantize_symmetric` and packed once per
weight (:func:`pack_weight`); that is not a hot path.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from esr_tpu_torch.config.quantize import quantize_symmetric
from esr_tpu_torch.ops.dcn_cuda import _PKG, CudaLibrary, register_op

_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.quantize_per_tensor_f32.argtypes = [_P] + [_I] * 4 + [_P] * 3 + [_I] + [_P]
    lib.int8_conv_f32.argtypes = [_P] * 6 + [_I] * 20 + [_P]
    lib.empty_launch.argtypes = [_P]
    for fn in (lib.quantize_per_tensor_f32, lib.int8_conv_f32, lib.empty_launch):
        fn.restype = _I


INT8_LIBRARY = CudaLibrary(_PKG / "csrc" / "int8_conv.cu", _declare)
LIBRARIES = (INT8_LIBRARY,)
# the kernel's k step: the depth of one mma.sync.m16n8k32
_K_STEP = 32


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def padded_channels(c: int) -> int:
    """Channels of the NHWC int8 layout: a multiple of 4, so a 32-bit load
    is 4 channels of one pixel."""
    return _round_up(c, 4)


def out_tiles(n: int) -> int:
    """The packing's out-channel granule in tiles of 8: the packed weight
    has ``Np = 8 * nt * ceil(n / (8 * nt))`` rows (the fewest tiles that
    cover ``n`` up to 64, else 8)."""
    for nt in (1, 2, 4):
        if n <= 8 * nt:
            return nt
    return 8


# -- launch plans ------------------------------------------------------------
#
# Pure Python, so the CPU tests check them at every seam shape; the entry
# points refuse a plan they cannot run (cudaErrorInvalidValue).

_SMS = 132
# K1's plan: the blocks it lets be in flight (about 4 a streaming
# multiprocessor), the k-steps a split block aims for and keeps at least,
# and the K loop it splits no matter how many tiles
_RESIDENT_BLOCKS = 4 * _SMS
_STEPS_PER_BLOCK = 4
_MIN_SPLIT_STEPS = 2
_SHORT_K_STEPS = 9
# the most blocks of a portable thread-block cluster (K1's split)
MAX_CLUSTER = 8
# K1: threads a block, cp.async stages, the bytes of a staged row, the
# largest decoded k table, the dynamic shared memory a block may use without
# opting in (48 KB less its static 1 KB)
CONV_THREADS = 128
_CONV_STAGES = 4
_ROW_BYTES = 48
_MAX_K_CHUNKS = 1024
CONV_SMEM_MAX = 47 * 1024
# the (warps along M, warps along N, 8-column tiles a warp, 16-row tiles a
# warp) the source builds
CONV_TILES = ((4, 1, 1, 1), (4, 1, 2, 1), (4, 1, 4, 1), (1, 4, 2, 1), (2, 2, 4, 1),
              (1, 4, 4, 1), (4, 1, 1, 2), (4, 1, 2, 2), (4, 1, 4, 2))


@dataclass(frozen=True)
class ConvPlan:
    """K1's launch: blocks of ``bm = 16 * wm * mt`` rows x ``bn = 8 * nt *
    wn`` out-channels (4 warps, each ``mt`` tiles of 16 rows), ``split``
    blocks along K in one cluster (each a contiguous slice of the ``Kp /
    32`` k-steps), A copied ``chunk`` bytes at a time."""

    wm: int
    wn: int
    nt: int
    split: int
    chunk: int
    mt: int = 1

    @property
    def bm(self) -> int:
        return 16 * self.wm * self.mt

    @property
    def bn(self) -> int:
        return 8 * self.nt * self.wn

    def grid(self, m: int, n: int) -> Tuple[int, int, int]:
        return -(-m // self.bm), -(-n // self.bn), self.split

    def k_slices(self, kp: int) -> List[Tuple[int, int]]:
        """Each split block's ``[begin, end)`` of the k-steps (as the kernel
        cuts them)."""
        ks = kp // _K_STEP
        return [(z * ks // self.split, (z + 1) * ks // self.split) for z in range(self.split)]

    def smem_bytes(self, kp: int) -> int:
        """Dynamic shared memory (``conv_smem_bytes`` in the source): the
        ring of stages, the k table of the largest slice, and the leader's
        slots for the other split blocks' int32 partials."""
        return (_CONV_STAGES * (self.bm + self.bn) * _ROW_BYTES
                + _round_up(4 * self.k_chunks(kp), 16)
                + (self.split - 1) * self.mt * self.nt * 4 * CONV_THREADS * 4)

    def k_chunks(self, kp: int) -> int:
        """Entries of the largest slice's decoded k table."""
        return -(-(kp // _K_STEP) // self.split) * (_K_STEP // self.chunk)


@functools.lru_cache(maxsize=None)
def conv_plan(m: int, n: int, kp: int, cp: int) -> ConvPlan:
    """K1's plan for ``m`` output pixels, ``n`` out-channels, ``kp`` packed
    k-bytes and ``cp`` padded input channels (cached: a window asks for the
    same few dozen shapes on every call).

    - The tile: up to 32 out-channels, one warp column of 64 rows (the head
      and tail seams, bound by bytes: the widest rows; 128, two row tiles a
      warp, where even those make 528 blocks or more); beyond, 16 rows x 64
      out-channels where the output is small (the bottleneck: more blocks in
      flight), 32 x 64 where it is large, and 16 x 128 for a handful of rows
      (the channel MLP's 1x1 convs).
    - The split: none when the tiles alone fill the card's 132 streaming
      multiprocessors and K is short (at most 9 k-steps: the head and tail
      seams, bound by bytes); else blocks along K (one cluster, at most 8)
      of about 4 k-steps each (2 at least), as many as keep the grid within
      about 4 resident blocks a streaming multiprocessor and the leader's
      slots for their partials within 47 KB of shared memory.
    - The copy: the widest of 16, 8, 4 bytes that divides ``cp``."""
    if min(m, n, kp, cp) < 1 or kp % _K_STEP or cp % 4:
        raise ValueError(f"int8_conv: no plan for M {m}, N {n}, Kp {kp}, Cp {cp}")
    if n <= 32:
        wm, wn, nt = 4, 1, next(t for t in (1, 2, 4) if n <= 8 * t)
    elif m <= 16:
        wm, wn, nt = 1, 4, 4
    elif m <= 1024:
        wm, wn, nt = 1, 4, 2
    else:
        wm, wn, nt = 2, 2, 4
    plan = ConvPlan(wm, wn, nt, 1, next(c for c in (16, 8, 4) if cp % c == 0))
    gm, gn, _ = plan.grid(m, n)
    ks = kp // _K_STEP
    if gm * gn >= _SMS and ks <= _SHORT_K_STEPS:
        if gm * gn >= _RESIDENT_BLOCKS and wm == 4:
            # two row tiles a warp: half the blocks, each's fixed cost spread
            # over twice the rows
            return ConvPlan(wm, wn, nt, 1, plan.chunk, 2)
        split = 1
    else:
        split = max(1, min(MAX_CLUSTER, -(-ks // _STEPS_PER_BLOCK), ks // _MIN_SPLIT_STEPS,
                           _RESIDENT_BLOCKS // (gm * gn)))
    plan = ConvPlan(wm, wn, nt, split, plan.chunk)
    while plan.split > 1 and plan.smem_bytes(kp) > CONV_SMEM_MAX:
        plan = ConvPlan(wm, wn, nt, plan.split - 1, plan.chunk)
    while plan.k_chunks(kp) > _MAX_K_CHUNKS and plan.split < min(MAX_CLUSTER, ks):
        plan = ConvPlan(wm, wn, nt, plan.split + 1, plan.chunk)
    if plan.k_chunks(kp) > _MAX_K_CHUNKS or plan.smem_bytes(kp) > CONV_SMEM_MAX:
        raise ValueError(f"int8_conv: Kp {kp} at Cp {cp} exceeds the kernel's k table")
    return plan


# K2: the most (pixel, channel quad) items a block stages (16 bytes each,
# within 48 KB); the items a block aims for (two a thread of its 512); the
# most blocks of its cooperative grid (four a streaming multiprocessor: what
# stays resident at the largest staging)
QUANTIZE_ITEMS_PER_BLOCK = 3040
_QUANTIZE_ITEMS_AIM = 1024
QUANTIZE_MAX_BLOCKS = 4 * _SMS


def quantize_items(shape) -> int:
    """K2's items of an NCHW shape: 4 (padded) channels at one pixel."""
    b, c, h, w = shape
    return b * (padded_channels(c) // 4) * h * w


@functools.lru_cache(maxsize=None)
def quantize_blocks(items: int) -> int:
    """K2's one launch for a tensor of ``items`` (:func:`quantize_items`):
    the blocks of its cooperative grid, one per 1024 items up to four a
    streaming multiprocessor. Each block stages its share of x in shared
    memory, read once, while the share is at most
    ``QUANTIZE_ITEMS_PER_BLOCK`` items, that is for ``items`` up to
    ``QUANTIZE_MAX_BLOCKS * QUANTIZE_ITEMS_PER_BLOCK``; above that the grid
    is the most blocks, and each reads its share of x twice (for the amax,
    then to quantize), so any size takes one launch."""
    if items < 1:
        raise ValueError(f"quantize_per_tensor: no plan for {items} items")
    return min(QUANTIZE_MAX_BLOCKS, -(-items // _QUANTIZE_ITEMS_AIM))


@dataclass(frozen=True)
class PackedWeight:
    """A conv weight quantized per output channel: ``q`` OIHW int8 and
    ``scale [N]`` (the plain function's), and ``wq [Np, Kp]``, the kernel's
    layout (row n: k = tap * Cp + c; zeros past Cin, K and N; ``Np`` a
    multiple of ``8 * nt``, :func:`out_tiles`, and ``Kp`` of 32)."""

    q: torch.Tensor
    scale: torch.Tensor
    wq: torch.Tensor
    nt: int

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return tuple(self.q.shape)


def pack_weight(weight: torch.Tensor) -> PackedWeight:
    """Quantize an OIHW f32 weight per output channel and pack it."""
    n, cin, kh, kw = weight.shape
    q, scale = quantize_symmetric(weight, axis=0)
    cp = padded_channels(cin)
    nt = out_tiles(n)
    kp = _round_up(kh * kw * cp, _K_STEP)
    np_ = _round_up(n, 8 * nt)
    taps = torch.zeros((n, kh, kw, cp), dtype=torch.int8, device=weight.device)
    taps[..., :cin] = q.permute(0, 2, 3, 1)
    wq = torch.zeros((np_, kp), dtype=torch.int8, device=weight.device)
    wq[:n, : kh * kw * cp] = taps.reshape(n, -1)
    return PackedWeight(q=q, scale=scale.reshape(n), wq=wq, nt=nt)


def quantize_per_tensor_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCHW f32 -> (NHWC int8 with the channels padded to a multiple of 4,
    scale ``[1]``): ``quantize_symmetric(x)`` in the kernel's layout."""
    q, scale = quantize_symmetric(x)
    b, c, h, w = x.shape
    out = torch.zeros((b, h, w, padded_channels(c)), dtype=torch.int8, device=x.device)
    out[..., :c] = q.permute(0, 2, 3, 1)
    return out, scale.reshape(1)


def conv_out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def int8_conv_plain(xq: torch.Tensor, sx: torch.Tensor, w: PackedWeight,
                    bias: Optional[torch.Tensor], stride: int = 1,
                    padding: int = 0) -> torch.Tensor:
    """The int8 convolution, exactly: the int8 values in f64 (every product
    and sum an integer below 2**53), then ``acc * (sx * scale[n])`` and the
    bias, in that order; NCHW contiguous, as the kernel writes it."""
    cin = w.shape[1]
    x = xq[..., :cin].permute(0, 3, 1, 2).double()
    acc = F.conv2d(x, w.q.double(), stride=stride, padding=padding)
    out = acc.float() * (sx * w.scale).reshape(1, -1, 1, 1)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out.contiguous()


def _check(name: str, tensors, dtypes) -> None:
    for t, dt in zip(tensors, dtypes):
        if t.device.type != "cuda":
            raise ValueError(f"{name} kernel needs CUDA tensors, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} kernel takes {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors")


def _launch(name: str, fn, device: torch.device, stream: int, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


class QuantizePerTensorKernel:
    """K2: ``x`` NCHW f32 -> (q NHWC int8, channels padded to 4; scale
    ``[1]``), as the op ``esr_tpu_torch::quantize_per_tensor``, launched by
    :func:`quantize_blocks`. Its plain version is
    :func:`quantize_per_tensor_plain`. The blocks' amax partials live in one
    scratch array per device and stream, allocated at its first use and
    kept: every partial is written before it is read."""

    name = "quantize_per_tensor"
    schema = "(Tensor x) -> (Tensor, Tensor)"

    def __init__(self) -> None:
        self.launches = 0
        self.op = None
        self._partials: Dict[Tuple[torch.device, int], torch.Tensor] = {}

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.dim() != 4:
            raise ValueError(f"{self.name} takes NCHW, got shape {tuple(x.shape)}")
        return self.op(x)

    def plain(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return quantize_per_tensor_plain(x)

    def fake(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, c, h, w = x.shape
        if x.device.type == "cuda" and x.dtype != torch.float32:
            raise TypeError(f"{self.name} kernel takes {torch.float32}, got {x.dtype}")
        return (x.new_empty((b, h, w, padded_channels(c)), dtype=torch.int8),
                x.new_empty((1,), dtype=torch.float32))

    def partials(self, device: torch.device, stream: int) -> torch.Tensor:
        """The scratch array of partials on ``device`` for ``stream``."""
        scratch = self._partials.get((device, stream))
        if scratch is None:
            scratch = self._partials[(device, stream)] = torch.empty(
                QUANTIZE_MAX_BLOCKS, dtype=torch.float32, device=device)
        return scratch

    def cuda(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.contiguous()
        _check(self.name, [x], [torch.float32])
        b, c, h, w = x.shape
        cp = padded_channels(c)
        if x.numel() >= 2**31 or b * h * w * cp >= 2**31:
            raise ValueError(f"{self.name} kernel indexes with 32-bit ints; input too large")
        blocks = quantize_blocks(b * (cp // 4) * h * w)
        q = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
        scale = torch.empty(1, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch(self.name, INT8_LIBRARY.load().quantize_per_tensor_f32, x.device, stream,
                x.data_ptr(), b, c, h * w, cp, q.data_ptr(), scale.data_ptr(),
                self.partials(x.device, stream).data_ptr(), blocks)
        self.launches += 1
        return q, scale


class Int8ConvKernel:
    """K1: ``(xq NHWC int8, sx [1], PackedWeight, bias [N] or None)`` ->
    NCHW f32, ``acc * (sx * scale[n]) + bias[n]``. Dilation 1, one group.
    The op ``esr_tpu_torch::int8_conv`` takes the packed weight's tensors
    (``q``, ``scale``, ``wq``) and its ``nt``; the launch follows
    :func:`conv_plan`. Its plain version is :func:`int8_conv_plain`."""

    name = "int8_conv"
    schema = ("(Tensor xq, Tensor sx, Tensor q, Tensor scale, Tensor wq, Tensor? bias, "
              "int stride, int padding, int nt) -> Tensor")

    def __init__(self) -> None:
        self.launches = 0
        self.op = None

    def __call__(self, xq: torch.Tensor, sx: torch.Tensor, w: PackedWeight,
                 bias: Optional[torch.Tensor] = None, stride: int = 1,
                 padding: int = 0) -> torch.Tensor:
        return self.op(xq, sx, w.q, w.scale, w.wq, bias, stride, padding, w.nt)

    def _out_shape(self, xq, q, bias, stride, padding) -> Tuple[int, int, int, int]:
        """``(b, n, ho, wo)``; raises on a mismatch of the operands."""
        b, h, wd, cp = xq.shape
        n, cin, kh, kw = q.shape
        if cp != padded_channels(cin):
            raise ValueError(f"{self.name}: input of {cp} channels, weight of {cin}")
        if bias is not None and tuple(bias.shape) != (n,):
            raise ValueError(f"{self.name}: bias {tuple(bias.shape)} for {n} out-channels")
        return b, n, conv_out_size(h, kh, stride, padding), conv_out_size(wd, kw, stride,
                                                                          padding)

    def plain(self, xq, sx, q, scale, wq, bias, stride, padding, nt) -> torch.Tensor:
        self._out_shape(xq, q, bias, stride, padding)
        return int8_conv_plain(xq, sx, PackedWeight(q, scale, wq, nt), bias, stride,
                               padding)

    def fake(self, xq, sx, q, scale, wq, bias, stride, padding, nt) -> torch.Tensor:
        b, n, ho, wo = self._out_shape(xq, q, bias, stride, padding)
        if ho < 1 or wo < 1:
            raise ValueError(f"{self.name}: empty output {ho}x{wo}")
        return xq.new_empty((b, n, ho, wo), dtype=torch.float32)

    def cuda(self, xq, sx, q, scale, wq, bias, stride, padding, nt) -> torch.Tensor:
        b, n, ho, wo = self._out_shape(xq, q, bias, stride, padding)
        _, h, wd, cp = xq.shape
        _, _, kh, kw = q.shape
        tensors = [xq, sx, wq, scale] + ([bias] if bias is not None else [])
        _check(self.name, tensors, [torch.int8, torch.float32, torch.int8, torch.float32,
                                    torch.float32])
        if ho < 1 or wo < 1:
            raise ValueError(f"{self.name}: empty output {ho}x{wo}")
        out = torch.empty((b, n, ho, wo), dtype=torch.float32, device=xq.device)
        if out.numel() >= 2**31 or xq.numel() >= 2**31:
            raise ValueError(f"{self.name} kernel indexes with 32-bit ints; input too large")
        np_, kp = wq.shape
        if xq.data_ptr() % 16 or wq.data_ptr() % 16:
            raise ValueError(f"{self.name} kernel copies 16-byte aligned operands")
        if np_ % (8 * nt) or np_ < n:
            raise ValueError(f"{self.name}: packed weight of {np_} rows for {n} "
                             f"out-channels in tiles of {8 * nt}")
        plan = conv_plan(b * ho * wo, n, kp, cp)
        _launch(self.name, INT8_LIBRARY.load().int8_conv_f32, xq.device,
                torch.cuda.current_stream(xq.device).cuda_stream,
                xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), scale.data_ptr(),
                bias.data_ptr() if bias is not None else None, out.data_ptr(),
                b, h, wd, cp, ho, wo, n, np_, kp, kh, kw, stride, padding, 1,
                plan.wm, plan.wn, plan.nt, plan.mt, plan.split, plan.chunk)
        self.launches += 1
        return out


quantize_per_tensor = QuantizePerTensorKernel()
int8_conv = Int8ConvKernel()
KERNELS = (quantize_per_tensor, int8_conv)
for _kernel in KERNELS:
    register_op(_kernel)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        k.launches = 0
