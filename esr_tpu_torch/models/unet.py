"""The UNet model family (counterpart of ``esr_tpu/models/unet.py``).

- :class:`UNetRecurrent`: recurrent encoders, one image out;
- :class:`UNetFlow`: the same with a 3-channel head split into
  ``{"image", "flow"}``;
- :class:`MultiResUNet`: stateless, a prediction at every decoder scale,
  each fed into the next decoder (concat skips);
- :class:`SRUNetRecurrent`: the SR variant, x4-then-x2 decoders and a x2
  upsampler on every skip, so the output is at 2x the input.

The channel ladder is ``base * multiplier^i``; the encoders are stride-2
convolutions of ``kernel_size`` each followed by a ConvLSTM or ConvGRU
(kernel 3); the skips zero-pad or centre-crop one side to the other
(``model_util.skip_sum`` / ``skip_concat``), which SRUNetRecurrent's
staggered resolutions need in both directions. ``use_upsample_conv``
picks bilinear-upsample-conv decoders or transposed convs (x2 only; the SR
variant needs the former).

Public seam, channel-last as the reference's: ``forward(x [B, H, W, C],
states) -> (out [B, H, W, C'], states)``. ``states`` is a flat tuple of
channel-last tensors, ``(h_0, c_0, h_1, c_1, ...)`` for ConvLSTM and
``(h_0, h_1, ...)`` for ConvGRU, encoder ``i`` at ``ceil(H / 2^(i+1))``:
the form the engine, its lane-state helpers and the CUDA graphs take. The
reference threads a tuple of per-encoder states; its leaves in
``jax.tree_util.tree_leaves`` order are this tuple. Inside, every
convolution runs NCHW. The modules carry the reference's flax names
(``head``, ``encoders.encoder_i``, ``res_i``, ``decoder_i``, ``skip_up_i``,
``pred``, ``pred_i``), so the weight bridge (``models.convert``) is a table.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from esr_tpu_torch.models.layers import (
    ConvLayer,
    RecurrentConvLayer,
    ResidualBlock,
    TransposedConvLayer,
    UpsampleConvLayer,
    get_activation,
)
from esr_tpu_torch.models.model_util import skip_concat, skip_sum

States = Tuple[torch.Tensor, ...]


def states_to_nchw(states: Sequence[torch.Tensor]) -> States:
    """Channel-last state leaves -> contiguous NCHW ones."""
    return tuple(s.permute(0, 3, 1, 2).contiguous() for s in states)


def states_to_nhwc(states: Sequence[torch.Tensor]) -> States:
    return tuple(s.permute(0, 2, 3, 1) for s in states)


class _UNetBase(nn.Module):
    """The shared configuration and channel ladder."""

    def __init__(self, base_num_channels: int = 32, num_encoders: int = 4,
                 num_residual_blocks: int = 2, num_output_channels: int = 1,
                 skip_type: str = "sum", norm: Optional[str] = None,
                 use_upsample_conv: bool = True, num_bins: int = 5,
                 recurrent_block_type: Optional[str] = "convlstm", kernel_size: int = 5,
                 channel_multiplier: int = 2, final_activation: Optional[str] = None):
        super().__init__()
        if skip_type not in ("sum", "concat"):
            raise ValueError(f"skip_type must be sum or concat, got {skip_type!r}")
        self.base_num_channels = base_num_channels
        self.num_encoders = num_encoders
        self.num_residual_blocks = num_residual_blocks
        self.num_output_channels = num_output_channels
        self.skip_type = skip_type
        self.norm = norm
        self.use_upsample_conv = use_upsample_conv
        self.num_bins = num_bins
        self.recurrent_block_type = recurrent_block_type
        self.kernel_size = kernel_size
        self.channel_multiplier = channel_multiplier
        self.final_activation = final_activation

    @property
    def encoder_input_sizes(self) -> List[int]:
        return [int(self.base_num_channels * self.channel_multiplier ** i)
                for i in range(self.num_encoders)]

    @property
    def encoder_output_sizes(self) -> List[int]:
        return [int(self.base_num_channels * self.channel_multiplier ** (i + 1))
                for i in range(self.num_encoders)]

    @property
    def max_num_channels(self) -> int:
        return self.encoder_output_sizes[-1]

    @property
    def _widen(self) -> int:
        """A decoder's input is its skip's width times this."""
        return 2 if self.skip_type == "concat" else 1

    def _skip(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return (skip_sum if self.skip_type == "sum" else skip_concat)(x1, x2)

    def _upsample_layer(self, cin: int, cout: int, scale: int = 2) -> nn.Module:
        k = self.kernel_size
        if self.use_upsample_conv:
            return UpsampleConvLayer(cin, cout, k, padding=k // 2, norm=self.norm,
                                     scale=scale)
        if scale != 2:
            raise AssertionError("TransposedConvLayer only realizes x2 (reference parity)")
        return TransposedConvLayer(cin, cout, k, padding=k // 2, norm=self.norm)

    def _final_act(self, x: torch.Tensor) -> torch.Tensor:
        if self.final_activation in (None, "none"):
            return x
        return get_activation(self.final_activation)(x)

    def _decoders(self, scales: Sequence[int]) -> None:
        """``decoder_i`` for every encoder, deepest first."""
        for i, (c, skip_c) in enumerate(zip(reversed(self.encoder_input_sizes),
                                            reversed(self.encoder_output_sizes))):
            self.add_module(f"decoder_{i}",
                            self._upsample_layer(self._widen * skip_c, c, scales[i]))

    def _residuals(self) -> None:
        for i in range(self.num_residual_blocks):
            self.add_module(f"res_{i}", ResidualBlock(self.max_num_channels, norm=self.norm))

    @property
    def _leaves_per_state(self) -> int:
        return 1 if self.recurrent_block_type == "convgru" else 2

    def lane_state_keys(self) -> List[str]:
        """Each flat state leaf's key as ``jax.tree_util.keystr`` writes it
        for the reference's per-encoder tuple: ``[i]`` for a ConvGRU state,
        ``[i][0]`` and ``[i][1]`` for a ConvLSTM's ``(h, c)`` pair (the
        ESRLANE1 wire's keys, ``serving/wire.py``)."""
        n = len(self.encoder_output_sizes)
        if self._leaves_per_state == 1:
            return [f"[{i}]" for i in range(n)]
        return [f"[{i}][{j}]" for i in range(n) for j in range(2)]

    def init_states(self, batch: int, height: int, width: int,
                    device: Optional[torch.device] = None) -> States:
        """Zero recurrent states, flat and channel-last (module docstring):
        encoder ``i`` at ``ceil(H / 2^(i+1))``, each leaf its own buffer."""
        states = []
        h, w = height, width
        for c in self.encoder_output_sizes:
            h, w = -(-h // 2), -(-w // 2)
            for _ in range(self._leaves_per_state):
                states.append(torch.zeros((batch, h, w, c), dtype=torch.float32,
                                          device=device))
        return tuple(states)


class _RecurrentEncoderStack(nn.Module):
    """``encoder_i``: stride-2 RecurrentConvLayers, on NCHW tensors and a
    flat tuple of NCHW state leaves."""

    def __init__(self, cin: int, sizes: Sequence[int], kernel_size: int,
                 recurrent_block_type: str, norm: Optional[str]):
        super().__init__()
        self.recurrent_block_type = recurrent_block_type
        for i, c in enumerate(sizes):
            self.add_module(f"encoder_{i}", RecurrentConvLayer(
                cin, c, kernel_size, stride=2, padding=kernel_size // 2, norm=norm,
                recurrent_block_type=recurrent_block_type))
            cin = c
        self.num = len(sizes)

    def forward(self, x: torch.Tensor, states: States
                ) -> Tuple[torch.Tensor, List[torch.Tensor], States]:
        lstm = self.recurrent_block_type == "convlstm"
        blocks, new_states = [], []
        for i in range(self.num):
            enc = getattr(self, f"encoder_{i}")
            if lstm:
                x, (h, c) = enc(x, (states[2 * i], states[2 * i + 1]))
                new_states += [h, c]
            else:
                x, s = enc(x, states[i])
                new_states.append(s)
            blocks.append(x)
        return x, blocks, tuple(new_states)


class _RecurrentUNet(_UNetBase):
    """A head, the recurrent encoders and the residual blocks; the
    subclasses add the decoders and the prediction."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        k = self.kernel_size
        self.head = ConvLayer(self.num_bins, self.base_num_channels, k, stride=1,
                              padding=k // 2)
        self.encoders = _RecurrentEncoderStack(
            self.base_num_channels, self.encoder_output_sizes, k,
            self.recurrent_block_type, self.norm)
        self._residuals()

    def encode(self, x: torch.Tensor, states: States):
        """NCHW ``x`` and state leaves -> ``(x, blocks, head, states)``: all
        a frame needs for the next frame's states."""
        x = self.head(x)
        head = x
        x, blocks, states = self.encoders(x, states)
        for i in range(self.num_residual_blocks):
            x = getattr(self, f"res_{i}")(x)
        return x, blocks, head, states

    def decode(self, x: torch.Tensor, blocks: List[torch.Tensor],
               head: torch.Tensor) -> torch.Tensor:
        """The decoders and the prediction, NCHW."""
        for i in range(self.num_encoders):
            x = getattr(self, f"decoder_{i}")(
                self._skip(x, blocks[self.num_encoders - i - 1]))
        return self.pred(self._skip(x, head))

    def forward_nchw(self, x: torch.Tensor, states: States
                     ) -> Tuple[torch.Tensor, States]:
        x, blocks, head, states = self.encode(x, states)
        return self._final_act(self.decode(x, blocks, head)), states

    def forward(self, x: torch.Tensor, states: States) -> Tuple[torch.Tensor, States]:
        out, states = self.forward_nchw(x.permute(0, 3, 1, 2).contiguous(),
                                        states_to_nchw(states))
        return out.permute(0, 2, 3, 1), states_to_nhwc(states)


class UNetRecurrent(_RecurrentUNet):
    """Recurrent UNet, one image out (reference ``unet.py:230-301``)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._decoders([2] * self.num_encoders)
        self.pred = ConvLayer(self._widen * self.base_num_channels,
                              self.num_output_channels, 1, activation=None, norm=self.norm)


class UNetFlow(_RecurrentUNet):
    """Recurrent UNet with an image+flow head (reference ``unet.py:170-227``):
    3 channels, returned as ``{"image": [..., :1], "flow": [..., 1:3]}``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._decoders([2] * self.num_encoders)
        self.pred = ConvLayer(self._widen * self.base_num_channels, 3, 1, activation=None,
                              norm=None)

    def forward(self, x: torch.Tensor, states: States
                ) -> Tuple[Dict[str, torch.Tensor], States]:
        x, blocks, head, states = self.encode(x.permute(0, 3, 1, 2).contiguous(),
                                              states_to_nchw(states))
        img_flow = self.decode(x, blocks, head).permute(0, 2, 3, 1)
        return ({"image": img_flow[..., 0:1], "flow": img_flow[..., 1:3]},
                states_to_nhwc(states))


class SRUNetRecurrent(_RecurrentUNet):
    """SR recurrent UNet, output at 2x the input (reference
    ``unet.py:393-498``): decoder 0 upsamples x4, the rest x2, and every
    skip, the head's included, passes its own x2 upsampler ``skip_up_i``
    first; the skips' pad-or-crop reconciles the staggered sizes."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if not self.use_upsample_conv:
            raise AssertionError("SRUNetRecurrent needs use_upsample_conv=True (x4 decoders)")
        self._decoders([4] + [2] * (self.num_encoders - 1))
        skip_sizes = list(reversed(self.encoder_output_sizes)) + [self.base_num_channels]
        for i, c in enumerate(skip_sizes):
            self.add_module(f"skip_up_{i}", self._upsample_layer(c, c, scale=2))
        self.pred = ConvLayer(self._widen * self.base_num_channels,
                              self.num_output_channels, 1, activation=None, norm=self.norm)

    def decode(self, x: torch.Tensor, blocks: List[torch.Tensor],
               head: torch.Tensor) -> torch.Tensor:
        n = self.num_encoders
        for i in range(n):
            up = getattr(self, f"skip_up_{i}")(blocks[n - i - 1])
            x = getattr(self, f"decoder_{i}")(self._skip(x, up))
        return self.pred(self._skip(x, getattr(self, f"skip_up_{n}")(head)))


class MultiResUNet(_UNetBase):
    """Stateless UNet with a prediction at every decoder scale (reference
    ``unet.py:304-390``): concat skips, no head (``encoder_0`` takes the
    raw input), each prediction concatenated into the next decoder's input.
    ``forward(x [B, H, W, C]) -> [prediction [B, h_i, w_i, C']]``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        k = self.kernel_size
        cin = self.num_bins
        for i, c in enumerate(self.encoder_output_sizes):
            self.add_module(f"encoder_{i}", ConvLayer(cin, c, k, stride=2, padding=k // 2,
                                                      norm=self.norm))
            cin = c
        self._residuals()
        act = self.final_activation if self.final_activation not in (None, "none") else None
        nout = self.num_output_channels
        for i, (c, skip_c) in enumerate(zip(reversed(self.encoder_input_sizes),
                                            reversed(self.encoder_output_sizes))):
            self.add_module(f"decoder_{i}", self._upsample_layer(
                2 * skip_c + (nout if i > 0 else 0), c))
            self.add_module(f"pred_{i}", ConvLayer(c, nout, 1, activation=act,
                                                   norm=self.norm))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous()
        blocks = []
        for i in range(self.num_encoders):
            x = getattr(self, f"encoder_{i}")(x)
            blocks.append(x)
        for i in range(self.num_residual_blocks):
            x = getattr(self, f"res_{i}")(x)
        predictions: List[torch.Tensor] = []
        for i in range(self.num_encoders):
            x = skip_concat(x, blocks[self.num_encoders - i - 1])
            if i > 0:
                x = skip_concat(predictions[-1], x)
            x = getattr(self, f"decoder_{i}")(x)
            predictions.append(getattr(self, f"pred_{i}")(x))
        return [p.permute(0, 2, 3, 1) for p in predictions]
