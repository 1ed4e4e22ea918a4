"""Core NN building blocks (counterpart of ``esr_tpu/models/layers.py``).

Same layer semantics as the reference, in PyTorch idiom: ``nn.Module``s on
NCHW tensors with OIHW weights. ``norm`` is ``None`` (the flagship's),
``"BN"`` (:class:`TorchBatchNorm`, the conv's bias dropped) or ``"IN"``
(:class:`TorchInstanceNorm`), held by the layer itself (the reference's
``_NormWrapper`` exists only in the flax names, ``models.convert``).

Default initializers are torch's own (kaiming-uniform with a=sqrt(5), i.e.
U(+-1/sqrt(fan_in)) for weights and biases), which is what the reference's
flax initializers mirror; the ConvGRU gates use orthogonal weights and zero
biases like the reference. The recurrent blocks are ConvGRU (the
flagship's) and ConvLSTM (the UNet family's); :class:`TransposedConvLayer`
and :class:`ConvLayer1D` complete the reference's layer set.

**The precision seams.** Every convolution is a :class:`Conv2d` and every
dense a :class:`Linear` (subclasses of ``nn.Conv2d`` / ``nn.Linear``, so the
parameter names and every checkpoint are unchanged), whose contraction
mirrors ``wide_accum_conv_general_dilated`` / ``wide_accum_dot_general`` of
``esr_tpu/models/layers.py``:

- the operands promote first, as flax's ``promote_dtype`` does: an input
  and a weight of different widths both take the wider (an f32 input with
  bf16 weights computes in f32, the weights and bias widened);
- f32 operands: the stock contraction, the program unchanged;
- bf16 operands: bf16 x bf16 with an f32 accumulator, the output rounded to
  bf16, then the bias added in bf16 (flax adds it after the seam returns);
- inside :func:`esr_tpu_torch.config.quantize.int8_scope`: the int8 seam
  (``quantized_conv2d`` / ``quantized_linear``), its weight quantized and
  packed once per weight.

The bilinear upsampling is :func:`esr_tpu_torch.ops.resize.resize`:
``F.interpolate`` as its forward, and a backward that is a product with
the interpolation's matrices, which sums in a fixed order (the stock CUDA
backward scatters with atomics). A bf16 input comes out of it f32, as the
reference's product with f32 matrices does, so at the bf16 rung every
layer after an upsampling runs f32 (the flagship's decoder, the UNet
family's decoders and skips).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from esr_tpu_torch.config.quantize import int8_enabled, quantized_conv2d, quantized_linear
from esr_tpu_torch.ops.resize import resize
from esr_tpu_torch.parallel.mesh import all_reduce_sum, reduce_mean, world_size

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


def _promote(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]):
    """The operands of a contraction at their common (wider) float dtype,
    as flax's ``promote_dtype`` gives them to its ``nn.Conv`` and
    ``nn.Dense``."""
    if x.dtype == weight.dtype:
        return x, weight, bias
    dtype = torch.promote_types(x.dtype, weight.dtype)
    return (x.to(dtype), weight.to(dtype),
            None if bias is None else bias.to(dtype))


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
        x, weight, bias = _promote(x, weight, bias)
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
        x, weight, bias = _promote(x, self.weight, self.bias)
        if x.dtype == torch.bfloat16:
            # bf16 operands, an f32 accumulator (cuBLAS's reduced-precision
            # reduction is off: esr_tpu_torch.device), the output rounded to bf16
            out = F.linear(x, weight)
            return out if bias is None else out + bias
        return F.linear(x, weight, bias)


def upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear x``scale`` of NCHW ``x`` (``align_corners=False``); its
    backward sums in a fixed order (:func:`esr_tpu_torch.ops.resize.resize`)."""
    h, w = x.shape[-2:]
    return resize(x, (h * int(scale), w * int(scale)), "bilinear")


# set while ``torch.utils.checkpoint`` recomputes a forward in the backward
# (``training.train_step``'s remat): the norms' running statistics were
# updated by the forward itself, as the reference's pure ``jax.checkpoint``
# updates them once
_RECOMPUTING: contextvars.ContextVar = contextvars.ContextVar(
    "esr_torch_norm_recompute", default=False)


@contextlib.contextmanager
def recomputing():
    """The context of a remat recompute: the norms leave their running
    statistics alone inside it."""
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def _channel_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A ``[C]`` vector shaped to broadcast over ``[B, C, *spatial]``."""
    return v.reshape((1, -1) + (1,) * (ndim - 2))


class TorchBatchNorm(nn.Module):
    """``torch.nn.BatchNorm{1,2}d`` semantics on ``[B, C, *spatial]`` with the
    reference's formulas (``esr_tpu/models/layers.py:TorchBatchNorm``).

    In training the moments are f32 ``E[x]`` and ``E[x^2]`` over the batch
    and space, summed over the process group by a differentiable all-reduce
    and divided by its size (``parallel.mesh.all_reduce_sum``: the global
    batch's moments, the reference's GSPMD mean and its ``SyncBatchNorm``;
    one process takes the same formula with no collective); the variance is
    ``max(E[x^2] - E[x]^2, 0)``; the running mean and variance blend ``new =
    (1 - m) * old + m * batch`` (``momentum`` weights the new value), the
    variance Bessel-corrected with the global count. In evaluation it
    normalizes with the running statistics. A narrower input is widened to
    f32 and the output rounded back (the bf16 rung); an f64 input stays
    f64."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = float(momentum)
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x if x.dtype == torch.float64 else x.float()
        if self.training:
            red = [0] + list(range(2, x.dim()))
            moments = torch.stack([xf.mean(red), (xf * xf).mean(red)])
            world = world_size()
            if world > 1:
                moments = all_reduce_sum(moments) / world
            mean, mean2 = moments[0], moments[1]
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            if not _RECOMPUTING.get():
                n = (x.numel() // x.shape[1]) * world
                bessel = n / (n - 1) if n > 1 else 1.0
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_((1.0 - m) * self.running_mean + m * mean)
                    self.running_var.copy_((1.0 - m) * self.running_var + m * var * bessel)
            use_mean, use_var = mean, var
        else:
            use_mean, use_var = self.running_mean, self.running_var
        y = ((xf - _channel_view(use_mean, x.dim()))
             * torch.rsqrt(_channel_view(use_var, x.dim()) + self.eps))
        y = y * _channel_view(self.weight, x.dim()) + _channel_view(self.bias, x.dim())
        return y.to(x.dtype)


class TorchInstanceNorm(nn.Module):
    """``torch.nn.InstanceNorm{1,2}d(affine=False, track_running_stats=True)``
    on ``[B, C, *spatial]`` (``esr_tpu/models/layers.py:TorchInstanceNorm``).
    In training each instance is normalized with its own f32 spatial
    moments (f64 for an f64 input), and the running statistics blend the batch mean of the
    instances' (the variance Bessel-corrected with the spatial count), the
    batch mean taken over the process group; in evaluation it normalizes
    with the running statistics. No affine parameters."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = float(momentum)
        self.eps = float(eps)
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x if x.dtype == torch.float64 else x.float()
        if not self.training:
            y = ((xf - _channel_view(self.running_mean, x.dim()))
                 * torch.rsqrt(_channel_view(self.running_var, x.dim()) + self.eps))
            return y.to(x.dtype)
        red = list(range(2, x.dim()))
        mean_i = xf.mean(red, keepdim=True)
        var_i = torch.clamp_min((xf * xf).mean(red, keepdim=True) - mean_i * mean_i, 0.0)
        if not _RECOMPUTING.get():
            n = math.prod(x.shape[2:])
            bessel = n / (n - 1) if n > 1 else 1.0
            m = self.momentum
            with torch.no_grad():
                b, c = x.shape[:2]
                batch = torch.stack([mean_i.reshape(b, c).mean(0),
                                     (var_i.reshape(b, c) * bessel).mean(0)])
                batch = reduce_mean(batch)
                self.running_mean.copy_((1.0 - m) * self.running_mean + m * batch[0])
                self.running_var.copy_((1.0 - m) * self.running_var + m * batch[1])
        y = (xf - mean_i) * torch.rsqrt(var_i + self.eps)
        return y.to(x.dtype)


def make_norm(norm: Optional[str], channels: int) -> Optional[nn.Module]:
    """The optional norm after a conv: :class:`TorchBatchNorm` for ``"BN"``,
    :class:`TorchInstanceNorm` for ``"IN"``, None for ``norm=None``; refuses
    any other name, as the reference's ``_NormWrapper`` does."""
    if norm is None:
        return None
    if norm == "BN":
        return TorchBatchNorm(channels)
    if norm == "IN":
        return TorchInstanceNorm(channels)
    raise NotImplementedError(f"norm={norm!r} is not supported ('BN', 'IN' or None)")


class ConvLayer(nn.Module):
    """Conv2d + optional norm + activation; the conv has no bias under
    BN."""

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
        self.conv = Conv2d(
            in_channels, out_channels, kernel_size, stride=stride, padding=padding,
            bias=norm != "BN"
        )
        self.norm = make_norm(norm, out_channels)
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
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
    """conv-norm-relu-conv-norm + identity, then relu."""

    def __init__(self, channels: int, norm: Optional[str] = None):
        super().__init__()
        self.conv1 = Conv2d(channels, channels, 3, padding=1, bias=norm != "BN")
        self.norm1 = make_norm(norm, channels)
        self.conv2 = Conv2d(channels, channels, 3, padding=1, bias=norm != "BN")
        self.norm2 = make_norm(norm, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        if self.norm1 is not None:
            out = self.norm1(out)
        out = self.conv2(torch.relu(out))
        if self.norm2 is not None:
            out = self.norm2(out)
        return torch.relu(out + x)


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


class ConvLSTMCell(nn.Module):
    """Convolutional LSTM: ``(x [B,Cin,H,W], (hidden, cell) [B,Ch,H,W]) ->
    (hidden, (hidden, cell))``. One conv over ``cat([x, hidden])`` gives the
    in, remember, out and cell gates, in that order along the channels."""

    def __init__(self, in_channels: int, hidden: int, kernel_size: int = 3):
        super().__init__()
        self.hidden = hidden
        self.gates = Conv2d(in_channels + hidden, 4 * hidden, kernel_size,
                            padding=kernel_size // 2)

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        prev_hidden, prev_cell = state
        gates = self.gates(torch.cat([x, prev_hidden], dim=1))
        in_gate, remember_gate, out_gate, cell_gate = gates.chunk(4, dim=1)
        cell = (torch.sigmoid(remember_gate) * prev_cell
                + torch.sigmoid(in_gate) * torch.tanh(cell_gate))
        hidden = torch.sigmoid(out_gate) * torch.tanh(cell)
        return hidden, (hidden, cell)


RECURRENT_BLOCKS = ("convgru", "convlstm")


class RecurrentConvLayer(nn.Module):
    """ConvLayer + a recurrent cell (``recurrent_block_type``: ``convgru``
    or ``convlstm``, kernel 3). ``(x, state) -> (output, new_state)``; for
    ConvGRU the output IS the new state, for ConvLSTM the state is
    ``(hidden, cell)`` and the output the hidden."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        activation: Optional[str] = "relu",
        norm: Optional[str] = None,
        recurrent_block_type: str = "convgru",
    ):
        super().__init__()
        if recurrent_block_type not in RECURRENT_BLOCKS:
            raise ValueError(f"unsupported recurrent block: {recurrent_block_type}")
        self.recurrent_block_type = recurrent_block_type
        self.conv_layer = ConvLayer(
            in_channels, out_channels, kernel_size, stride, padding, activation, norm
        )
        cell = ConvGRUCell if recurrent_block_type == "convgru" else ConvLSTMCell
        self.cell = cell(out_channels, out_channels, kernel_size=3)

    def forward(self, x: torch.Tensor, state):
        x = self.conv_layer(x)
        if self.recurrent_block_type == "convlstm":
            return self.cell(x, state)
        new_state = self.cell(x, state)
        return new_state, new_state


class TransposedConvLayer(nn.Module):
    """Stride-2 transposed conv (exactly x2: ``output_padding=1``), then the
    activation. The flax kernel ``[kh, kw, in, out]`` is this weight
    ``[in, out, kh, kw]`` flipped in space (``models.convert``); the init's
    fan-in is ``out * k * k``, torch's own for a transposed conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 0, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_channels, out_channels, kernel_size, stride=2,
                                       padding=padding, output_padding=1,
                                       bias=norm != "BN")
        self.norm = make_norm(norm, out_channels)
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # no precision seam (nor int8): a narrower float input climbs to f32
        # for the whole layer, the weights widened, and the output is rounded
        # back to the incoming width, as the reference's layer does
        in_dtype = x.dtype
        conv = self.conv
        x = F.conv_transpose2d(
            x.float(), conv.weight.float(),
            None if conv.bias is None else conv.bias.float(), conv.stride, conv.padding,
            conv.output_padding, conv.groups, conv.dilation)
        if self.norm is not None:
            x = self.norm(x)
        x = self.activation(x) if self.activation is not None else x
        return x.to(in_dtype)


class ConvLayer1D(nn.Module):
    """Conv1d + optional norm + activation on ``[B, C, N]``; the conv has
    no bias under BN."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, activation: Optional[str] = "relu",
                 norm: Optional[str] = None):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=padding, bias=norm != "BN")
        self.norm = make_norm(norm, out_channels)
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.activation(x) if self.activation is not None else x


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
