"""The int8 rung's hand-written CUDA kernels, their wrappers and their plain
versions.

One source, ``esr_tpu_torch/csrc/int8_conv.cu``, built on first use with
``nvcc`` into ``esr_tpu_torch/_build/`` by the same
:class:`~esr_tpu_torch.ops.dcn_cuda.CudaLibrary` as the DCN kernels:

- :data:`quantize_per_tensor` (K2): the dynamic per-tensor activation
  quantization of ``esr_tpu/config/quantize.py:quantize_symmetric``
  (``axis=None``), from an NCHW f32 tensor to the NHWC int8 layout the
  convolution reads (channels padded to a multiple of 4 with zeros) and the
  scale;
- :data:`int8_conv` (K1): an implicit-GEMM convolution of int8 activations
  and per-output-channel int8 weights with an int32 accumulator
  (``mma.sync.m16n8k32``), dequantized in its epilogue to NCHW f32.

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
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from esr_tpu_torch.config.quantize import quantize_symmetric
from esr_tpu_torch.ops.dcn_cuda import _PKG, CudaLibrary, register_op

_P, _I = ctypes.c_void_p, ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.quantize_per_tensor_f32.argtypes = [_P] + [_I] * 4 + [_P] * 3 + [_P]
    lib.int8_conv_f32.argtypes = [_P] * 6 + [_I] * 15 + [_P]
    lib.quantize_per_tensor_f32.restype = _I
    lib.int8_conv_f32.restype = _I


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
    """Out-channel tiles of 8 per warp (the kernel's ``NT``): the fewest
    that cover ``n`` up to 64, else 8 (a block of 64 out-channels)."""
    for nt in (1, 2, 4):
        if n <= 8 * nt:
            return nt
    return 8


@dataclass(frozen=True)
class PackedWeight:
    """A conv weight quantized per output channel: ``q`` OIHW int8 and
    ``scale [N]`` (the plain function's), and ``wq [Np, Kp]``, the kernel's
    layout (row n: k = tap * Cp + c; zeros past Cin, K and N)."""

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


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


class QuantizePerTensorKernel:
    """K2: ``x`` NCHW f32 -> (q NHWC int8, channels padded to 4; scale
    ``[1]``), as the op ``esr_tpu_torch::quantize_per_tensor``. Its plain
    version is :func:`quantize_per_tensor_plain`."""

    name = "quantize_per_tensor"
    schema = "(Tensor x) -> (Tensor, Tensor)"

    def __init__(self) -> None:
        self.launches = 0
        self.op = None

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

    def cuda(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.contiguous()
        _check(self.name, [x], [torch.float32])
        b, c, h, w = x.shape
        cp = padded_channels(c)
        if x.numel() >= 2**31 or b * h * w * cp >= 2**31:
            raise ValueError(f"{self.name} kernel indexes with 32-bit ints; input too large")
        q = torch.empty((b, h, w, cp), dtype=torch.int8, device=x.device)
        scale = torch.empty(1, dtype=torch.float32, device=x.device)
        word = torch.empty(1, dtype=torch.int32, device=x.device)
        _launch(self.name, INT8_LIBRARY.load().quantize_per_tensor_f32, x.device,
                x.data_ptr(), b, c, h * w, cp, q.data_ptr(), scale.data_ptr(),
                word.data_ptr())
        self.launches += 1
        return q, scale


class Int8ConvKernel:
    """K1: ``(xq NHWC int8, sx [1], PackedWeight, bias [N] or None)`` ->
    NCHW f32, ``acc * (sx * scale[n]) + bias[n]``. Dilation 1, one group.
    The op ``esr_tpu_torch::int8_conv`` takes the packed weight's tensors
    (``q``, ``scale``, ``wq``) and ``nt``. Its plain version is
    :func:`int8_conv_plain`."""

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
        _launch(self.name, INT8_LIBRARY.load().int8_conv_f32, xq.device,
                xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), scale.data_ptr(),
                bias.data_ptr() if bias is not None else None, out.data_ptr(),
                b, h, wd, cp, ho, wo, n, np_, kp, kh, kw, stride, padding, 1, nt)
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
