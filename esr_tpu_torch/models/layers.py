"""Core NN building blocks (counterpart of ``esr_tpu/models/layers.py``).

Same layer semantics as the reference, in PyTorch idiom: ``nn.Module``s on
NCHW tensors with OIHW weights. Only ``norm=None`` is ported (the flagship's
choice); BatchNorm/InstanceNorm wait for a later slice and raise here.

Default initializers are torch's own (kaiming-uniform with a=sqrt(5), i.e.
U(+-1/sqrt(fan_in)) for weights and biases), which is what the reference's
flax initializers mirror; the ConvGRU gates use orthogonal weights and zero
biases like the reference.

**The precision seams.** Every convolution is a :class:`Conv2d` and every
dense a :class:`Linear` (subclasses of ``nn.Conv2d`` / ``nn.Linear``, so the
parameter names and every checkpoint are unchanged), whose contraction
mirrors ``wide_accum_conv_general_dilated`` / ``wide_accum_dot_general`` of
``esr_tpu/models/layers.py``:

- f32 operands: the stock contraction, the program unchanged;
- bf16 operands: bf16 x bf16 with an f32 accumulator, the output rounded to
  bf16, then the bias added in bf16 (flax adds it after the seam returns);
- inside :func:`esr_tpu_torch.config.quantize.int8_scope`: the int8 seam
  (``quantized_conv2d`` / ``quantized_linear``), its weight quantized and
  packed once per weight.

The 2x bilinear upsampling keeps ``F.interpolate`` as its forward; its
backward is a product with the interpolation's matrices, which sums in a
fixed order (the stock CUDA backward scatters with atomics).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from esr_tpu_torch.config.quantize import int8_enabled, quantized_conv2d, quantized_linear

_ACTIVATIONS = {
    None: None,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "leaky_relu": F.leaky_relu,
}


def get_activation(name: Optional[str]) -> Optional[Callable]:
    if name not in _ACTIVATIONS:
        raise ValueError(f"unsupported activation: {name}")
    return _ACTIVATIONS[name]


def _pack(weight: torch.Tensor):
    """The packed int8 form of a conv weight (OIHW) or a dense one
    (``[out, in]``, as a 1x1 convolution)."""
    from esr_tpu_torch.ops.int8_cuda import pack_weight

    w = weight.detach()
    return pack_weight(w if w.dim() == 4 else w[:, :, None, None])


# the packed weight's tensors, as the buffers ``int8_<field>`` of a seam
INT8_BUFFERS = ("q", "scale", "wq")


def _packed(module: nn.Module, weight: torch.Tensor):
    """The int8 seam's packed weight: the module's ``int8_*`` buffers when
    :func:`pack_int8_buffers` gave it some (an exported program reads them,
    never a data pointer), else made once per weight (again only when the
    weight is replaced, moved or updated in place)."""
    from esr_tpu_torch.ops.int8_cuda import PackedWeight

    if hasattr(module, "int8_wq"):
        return PackedWeight(module.int8_q, module.int8_scale, module.int8_wq,
                            module.int8_nt)
    key = (weight.data_ptr(), weight._version, weight.device)
    cache = getattr(module, "_int8_cache", None)
    if cache is None or cache[0] != key:
        cache = (key, _pack(weight))
        module._int8_cache = cache
    return cache[1]


def pack_int8_buffers(model: nn.Module) -> nn.Module:
    """Give every contraction seam of ``model`` its packed int8 weight as
    non-persistent buffers (``int8_q``, ``int8_scale``, ``int8_wq``; the
    packing's ``int8_nt``), which the seam then reads in place of its cache:
    an int8 program exported from ``model`` carries the packs as buffers,
    bitwise the eager cache's. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, (Conv2d, Linear)):
            p = _pack(m.weight)
            for field in INT8_BUFFERS:
                m.register_buffer(f"int8_{field}", getattr(p, field), persistent=False)
            m.int8_nt = p.nt
    return model


def repack_int8_buffers(module: nn.Module) -> None:
    """Re-derive every ``int8_*`` buffer of ``module`` (a model packed by
    :func:`pack_int8_buffers`, or a program unlifted from an export of one)
    from the weight beside it, so the packs follow the weights loaded into
    it."""
    params = dict(module.named_parameters())
    buffers = dict(module.named_buffers())
    for name in buffers:
        if name.endswith("int8_wq"):
            prefix = name[: -len("int8_wq")]
            p = _pack(params[prefix + "weight"])
            with torch.no_grad():
                for field in INT8_BUFFERS:
                    buffers[f"{prefix}int8_{field}"].copy_(getattr(p, field))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose contraction is the precision seam (module
    docstring)."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        if int8_enabled() and x.is_floating_point():
            if (self.groups != 1 or self.dilation != (1, 1) or self.padding_mode != "zeros"
                    or len(set(self.stride)) != 1 or len(set(self.padding)) != 1):
                raise NotImplementedError(
                    "the int8 seam takes square strides and zero paddings, one group, "
                    "dilation 1")
            return quantized_conv2d(x, _packed(self, weight), bias, self.stride[0],
                                    self.padding[0])
        if x.dtype == torch.bfloat16:
            # bf16 operands; cuDNN (and the CPU's oneDNN) accumulate a bf16
            # convolution in f32 and round its output to bf16 once
            out = F.conv2d(x, weight, None, self.stride, self.padding, self.dilation,
                           self.groups)
            return out if bias is None else out + bias.reshape(1, -1, 1, 1)
        return super()._conv_forward(x, weight, bias)


class Linear(nn.Linear):
    """``nn.Linear`` whose contraction is the precision seam (module
    docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if int8_enabled() and x.is_floating_point():
            return quantized_linear(x, _packed(self, self.weight), self.bias)
        if x.dtype == torch.bfloat16:
            # bf16 operands, an f32 accumulator (cuBLAS's reduced-precision
            # reduction is off: esr_tpu_torch.device), the output rounded to bf16
            out = F.linear(x, self.weight)
            return out if self.bias is None else out + self.bias
        return super().forward(x)


class _Upsample(torch.autograd.Function):
    """Bilinear upsampling by an integer factor (``align_corners=False``):
    ``F.interpolate`` forward, a backward by the interpolation matrices."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: int) -> torch.Tensor:
        h, w = x.shape[-2:]
        ctx.geom = (h, w, scale)
        return F.interpolate(x, size=(h * scale, w * scale), mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h, w, scale = ctx.geom
        ah = interpolation_matrix(h, scale, g.dtype, g.device)  # [h*s, h]
        aw = interpolation_matrix(w, scale, g.dtype, g.device)  # [w*s, w]
        return torch.matmul(torch.matmul(ah.t(), g), aw), None


@functools.lru_cache(maxsize=64)
def interpolation_matrix(n: int, scale: int, dtype: torch.dtype,
                         device: torch.device) -> torch.Tensor:
    """``A [n*scale, n]``: the bilinear interpolation (``align_corners=False``)
    of ``n`` samples to ``n*scale`` as a matrix, with PyTorch's weights (the
    source index ``(d + 0.5) / scale - 0.5`` clamped at 0, the right
    neighbour clamped to the edge)."""
    d = torch.arange(n * scale, dtype=torch.float64)
    src = ((d + 0.5) / scale - 0.5).clamp_min(0.0)
    i0 = src.floor().long().clamp_max(n - 1)
    i1 = (i0 + 1).clamp_max(n - 1)
    l1 = src - i0
    a = torch.zeros(n * scale, n, dtype=torch.float64)
    rows = torch.arange(n * scale)
    a.index_put_((rows, i0), 1.0 - l1, accumulate=True)
    a.index_put_((rows, i1), l1, accumulate=True)
    return a.to(device=device, dtype=dtype)


def upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x``scale`` of NCHW ``x`` (``align_corners=False``); its
    backward sums in a fixed order."""
    return _Upsample.apply(x, int(scale))


def _check_norm(norm: Optional[str]) -> None:
    if norm is not None:
        raise NotImplementedError(
            f"norm={norm!r} is not ported yet (only norm=None, the flagship's)"
        )


class ConvLayer(nn.Module):
    """Conv2d + activation."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        activation: Optional[str] = "relu",
        norm: Optional[str] = None,
    ):
        super().__init__()
        _check_norm(norm)
        self.conv = Conv2d(
            in_channels, out_channels, kernel_size, stride=stride, padding=padding
        )
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return self.activation(x) if self.activation is not None else x


class UpsampleConvLayer(nn.Module):
    """Bilinear x``scale`` upsample (``align_corners=False``), then a ConvLayer."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        activation: Optional[str] = "relu",
        norm: Optional[str] = None,
        scale: int = 2,
    ):
        super().__init__()
        self.scale = scale
        self.conv_layer = ConvLayer(
            in_channels, out_channels, kernel_size, stride, padding, activation, norm
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_layer(upsample(x, self.scale))


class ResidualBlock(nn.Module):
    """conv-relu-conv + identity, then relu."""

    def __init__(self, channels: int, norm: Optional[str] = None):
        super().__init__()
        _check_norm(norm)
        self.conv1 = Conv2d(channels, channels, 3, padding=1)
        self.conv2 = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv2(torch.relu(self.conv1(x))) + x)


class ConvGRUCell(nn.Module):
    """Convolutional GRU: ``(x [B,Cin,H,W], state [B,Ch,H,W]) -> new state``."""

    def __init__(self, in_channels: int, hidden: int, kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        cin = in_channels + hidden
        self.update_gate = Conv2d(cin, hidden, kernel_size, padding=pad)
        self.reset_gate = Conv2d(cin, hidden, kernel_size, padding=pad)
        self.out_gate = Conv2d(cin, hidden, kernel_size, padding=pad)
        for gate in (self.update_gate, self.reset_gate, self.out_gate):
            nn.init.orthogonal_(gate.weight)
            nn.init.zeros_(gate.bias)

    def forward(self, x: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        stacked = torch.cat([x, state], dim=1)
        update = torch.sigmoid(self.update_gate(stacked))
        reset = torch.sigmoid(self.reset_gate(stacked))
        out = torch.tanh(self.out_gate(torch.cat([x, state * reset], dim=1)))
        return state * (1.0 - update) + out * update


class RecurrentConvLayer(nn.Module):
    """ConvLayer + ConvGRU (the ported recurrent block type).
    ``(x, state) -> (output, new_state)``; the output IS the new state."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        activation: Optional[str] = "relu",
        norm: Optional[str] = None,
    ):
        super().__init__()
        self.conv_layer = ConvLayer(
            in_channels, out_channels, kernel_size, stride, padding, activation, norm
        )
        self.cell = ConvGRUCell(out_channels, out_channels, kernel_size=3)

    def forward(
        self, x: torch.Tensor, state: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        new_state = self.cell(self.conv_layer(x), state)
        return new_state, new_state


class MLP(nn.Module):
    """Linear stack with ReLU between layers."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(a, b) for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x
