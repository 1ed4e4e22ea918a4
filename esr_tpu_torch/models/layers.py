"""Core NN building blocks (counterpart of ``esr_tpu/models/layers.py``).

Same layer semantics as the reference, in PyTorch idiom: ``nn.Module``s on
NCHW tensors with OIHW weights. Only ``norm=None`` is ported (the flagship's
choice); BatchNorm/InstanceNorm wait for a later slice and raise here.

Default initializers are torch's own (kaiming-uniform with a=sqrt(5), i.e.
U(+-1/sqrt(fan_in)) for weights and biases), which is what the reference's
flax initializers mirror; the ConvGRU gates use orthogonal weights and zero
biases like the reference.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

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
        self.conv = nn.Conv2d(
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
        h, w = x.shape[-2:]
        x = F.interpolate(
            x, size=(h * self.scale, w * self.scale), mode="bilinear",
            align_corners=False,
        )
        return self.conv_layer(x)


class ResidualBlock(nn.Module):
    """conv-relu-conv + identity, then relu."""

    def __init__(self, channels: int, norm: Optional[str] = None):
        super().__init__()
        _check_norm(norm)
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv2(torch.relu(self.conv1(x))) + x)


class ConvGRUCell(nn.Module):
    """Convolutional GRU: ``(x [B,Cin,H,W], state [B,Ch,H,W]) -> new state``."""

    def __init__(self, in_channels: int, hidden: int, kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        cin = in_channels + hidden
        self.update_gate = nn.Conv2d(cin, hidden, kernel_size, padding=pad)
        self.reset_gate = nn.Conv2d(cin, hidden, kernel_size, padding=pad)
        self.out_gate = nn.Conv2d(cin, hidden, kernel_size, padding=pad)
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
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x
