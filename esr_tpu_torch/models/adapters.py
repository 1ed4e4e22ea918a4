"""Frame-recurrent models as windowed-trainer peers (counterpart of
``esr_tpu/models/adapters.py``).

:class:`FrameRecurrentSR` gives a frame-recurrent UNet
(:class:`~esr_tpu_torch.models.unet.UNetRecurrent`,
:class:`~esr_tpu_torch.models.unet.SRUNetRecurrent`) the windowed interface
of ``DeepRecurrNet``, ``forward(x [B, N, H, W, inch], states) ->
(out [B, H, W, inch], states)``:

- the window's frames run through the wrapped model in order, threading
  its recurrent states;
- the window's prediction is the middle frame's output (``(N - 1) // 2``,
  the frame the loss supervises);
- an output on another grid than the input's (SRUNetRecurrent emits 2x) is
  resized to the input grid by bicubic (``ops.resize.resize``, whose
  backward sums in a fixed order).

The other frames' outputs are never used, so only their encoders run (the
states are all they pass on): the same outputs and states, and the same
gradients, as running every frame whole.

Registered names: ``SRUNetRecurrentSeq``, ``UNetRecurrentSeq``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from esr_tpu_torch.models.unet import (
    SRUNetRecurrent,
    UNetRecurrent,
    States,
    states_to_nchw,
    states_to_nhwc,
)
from esr_tpu_torch.ops.resize import resize


class FrameRecurrentSR(nn.Module):
    """Windowed-trainer interface over a frame-recurrent model (module
    docstring); its child ``model`` carries the flax name ``model``."""

    def __init__(self, model: nn.Module, num_frame: int = 3):
        super().__init__()
        self.model = model
        self.num_frame = num_frame

    @property
    def inch(self) -> int:
        return self.model.num_bins

    def init_states(self, batch: int, height: int, width: int, device=None) -> States:
        return self.model.init_states(batch, height, width, device=device)

    def lane_state_keys(self) -> List[str]:
        return self.model.lane_state_keys()

    def forward(self, x: torch.Tensor, states: States):
        b, n, h, w, c = x.shape
        # the reference's window asserts, raised whatever the interpreter's -O
        if n != self.num_frame:
            raise AssertionError(
                f"window length {n} != num_frame {self.num_frame} (keep "
                "model.args.num_frame == dataset.sequence.seqn, like DeepRecurrNet)")
        if n < 3 or n % 2 == 0:
            raise AssertionError(f"num_frame must be odd and >= 3, got {n}")
        mid = (n - 1) // 2
        frames = x.permute(0, 1, 4, 2, 3).contiguous()
        states = states_to_nchw(states)
        out_mid = None
        for i in range(n):
            if i == mid:
                out_mid, states = self.model.forward_nchw(frames[:, i], states)
            else:
                states = self.model.encode(frames[:, i], states)[3]
        if tuple(out_mid.shape[-2:]) != (h, w):
            out_mid = resize(out_mid, (h, w), "bicubic")
        return out_mid.permute(0, 2, 3, 1), states_to_nhwc(states)


def srunet_recurrent_seq(num_frame: int = 3, **kwargs) -> FrameRecurrentSR:
    """``SRUNetRecurrent`` as a windowed-trainer model (2x SR output,
    bicubic-resized to the input grid)."""
    kwargs.setdefault("num_output_channels", 2)
    kwargs.setdefault("num_bins", 2)
    return FrameRecurrentSR(SRUNetRecurrent(**kwargs), num_frame=num_frame)


def unet_recurrent_seq(num_frame: int = 3, **kwargs) -> FrameRecurrentSR:
    """``UNetRecurrent`` as a windowed-trainer model (same-resolution head)."""
    kwargs.setdefault("num_output_channels", 2)
    kwargs.setdefault("num_bins", 2)
    return FrameRecurrentSR(UNetRecurrent(**kwargs), num_frame=num_frame)
