"""DeepRecurrNet — the flagship event-SR network (counterpart of
``esr_tpu/models/esr.py``).

Head conv -> 3-stage stride-2 encoder -> temporal propagation (local
correlation + bidirectional shared-weight ConvGRU) -> spatio-temporal
fusion with deformable alignment -> 3x upsampling decoder with per-scale
attention -> tail.

Public seam (the reference's, channel-last): ``forward(x [B, N, H, W, C],
states) -> (out [B, H, W, C], states)`` with ConvGRU states
``[B, H/8, W/8, 8*basech]``. Inside, every convolution runs NCHW.

The DCN alignment runs twice per window (once per non-middle frame)
through :func:`esr_tpu_torch.ops.dcn_cuda.dcn`, where the direction is
decided from grad mode, as the reference decides it from ``train``: a
training forward (grad on, parameters that require grad) on the card
launches the train-direction kernel ``dcn_train_fwd`` and, in the
backward, ``dcn_bwd`` and ``dcn_wgrad``; a forward under ``torch.no_grad()``
(evaluation, validation) launches ``dcn_fwd``. CPU tensors take the plain
PyTorch version in both directions. Nothing the model is built from
(constructor arguments, a checkpoint's ``model.args``) can route a CUDA run
off the kernels: only code that sets ``STFusion.dcn_impl = "plain"`` can,
which the tests and ``chip_smoke.py`` alone do.

``dcn_sparse`` (a ``model.args`` key, as in the reference) predicates the
DCN on activity: each call passes the mask of
:func:`esr_tpu_torch.ops.dcn.dcn_image_activity` (OR'd with the caller's
optional ``activity [B]``), so the masked kernels ``dcn_fwd_masked`` /
``dcn_train_fwd_masked`` run in place of the dense forwards. It has no
parameters.

``numerics`` (off by default) arms the numerics plane's probe taps
(:mod:`esr_tpu_torch.ops.numerics`) at the reference's seams and with its
tags: ``head_out``, ``enc0``-``enc2`` (deepest first), ``gru_fwd`` /
``gru_bwd``, ``dcn_offsets`` / ``dcn_mask`` / ``dcn_out`` (each fired once
per aligned frame), ``dec0``-``dec2`` and ``tail_out``.
``numerics_mode="raw"`` records the tensors themselves (the drift
harness), and ``numerics_break`` routes one tag through the harness's
precision breaker.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from esr_tpu_torch.models import model_util
from esr_tpu_torch.models.layers import (
    Conv2d,
    ConvLayer,
    MLP,
    RecurrentConvLayer,
    ResidualBlock,
    UpsampleConvLayer,
)
from esr_tpu_torch.ops.dcn import dcn_offsets_from_conv, deform_conv2d_auto
from esr_tpu_torch.ops.numerics import probe as numerics_probe

States = Tuple[torch.Tensor, torch.Tensor]


class FeatsExtract(nn.Module):
    """Three stride-2 convs b -> 2b -> 4b -> 8b; returns the per-scale
    features deepest-first ``[8b@H/8, 4b@H/4, 2b@H/2]``."""

    def __init__(self, basech: int = 16, norm: Optional[str] = None,
                 activation: str = "relu"):
        super().__init__()
        chans = [basech, 2 * basech, 4 * basech, 8 * basech]
        self.layers = nn.ModuleList(
            ConvLayer(a, b, 3, stride=2, padding=1, activation=activation, norm=norm)
            for a, b in zip(chans[:-1], chans[1:])
        )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for layer in self.layers:
            x = layer(x)
            outs.append(x)
        return outs[::-1]


class TimePropagation(nn.Module):
    """Local + global temporal correlation over ``x [B, N, C, H, W]``;
    the ConvGRU states are threaded through explicitly."""

    def __init__(self, channels: int, norm: Optional[str] = None,
                 activation: str = "relu"):
        super().__init__()
        c = channels
        self.pred_map = nn.Sequential(
            ConvLayer(2 * c, c, 3, padding=1, activation=activation, norm=norm),
            ConvLayer(c, 1, 3, padding=1, activation="sigmoid", norm=norm),
        )
        self.local_res = ResidualBlock(3 * c, norm=norm)
        self.local_out = ConvLayer(3 * c, c, 3, padding=1, activation=None, norm=norm)
        self.gru = RecurrentConvLayer(
            c, c, 3, stride=1, padding=1, activation=activation, norm=norm
        )
        self.global_fusion = ConvLayer(
            2 * c, c, 1, padding=0, activation=activation, norm=norm
        )

    def _local_time_corre(self, f0, f1, f2):
        map0 = self.pred_map(torch.cat([f0, f1], dim=1))
        map1 = self.pred_map(torch.cat([f1, f2], dim=1))
        fused = torch.cat([f0 * map0, f1, f2 * map1], dim=1)
        return self.local_out(self.local_res(fused)) + f1

    def forward(self, x: torch.Tensor, states: States) -> Tuple[torch.Tensor, States]:
        b, n, c, h, w = x.shape
        frames = []
        for i in range(n):
            i0, i1, i2 = (0, 0, 1) if i == 0 else (
                (n - 2, n - 1, n - 1) if i == n - 1 else (i - 1, i, i + 1)
            )
            frames.append(self._local_time_corre(x[:, i0], x[:, i1], x[:, i2]))
        feats = torch.stack(frames, dim=1)
        state_fwd, state_bwd = states
        xs, revs = [], []
        for i in range(n):
            out_f, state_fwd = self.gru(feats[:, i], state_fwd)
            out_b, state_bwd = self.gru(feats[:, n - 1 - i], state_bwd)
            xs.append(out_f)
            revs.append(out_b)
        merged = torch.cat(
            [torch.stack(xs, 1), torch.stack(revs[::-1], 1)], dim=2
        ).reshape(b * n, 2 * c, h, w)
        feats = self.global_fusion(merged).reshape(b, n, c, h, w)
        return feats + x, (state_fwd, state_bwd)


class _Probed(nn.Module):
    """The probe-tap knobs shared by :class:`STFusion` and
    :class:`DeepRecurrNet`."""

    numerics: bool = False
    numerics_mode: str = "stats"
    numerics_break: Optional[str] = None

    def _probe(self, tag: str, x: torch.Tensor) -> torch.Tensor:
        return numerics_probe(tag, x, enabled=self.numerics, mode=self.numerics_mode,
                              break_tag=self.numerics_break)


class STFusion(_Probed):
    """Spatio-temporal fusion + upsampling decoder."""

    def __init__(self, channels: int, num_frame: int = 3,
                 norm: Optional[str] = None, activation: str = "relu",
                 deformable_groups: int = 8, dcn_sparse: bool = False,
                 numerics: bool = False, numerics_mode: str = "stats",
                 numerics_break: Optional[str] = None):
        super().__init__()
        self.numerics = numerics
        self.numerics_mode = numerics_mode
        self.numerics_break = numerics_break
        if (num_frame + 1) % 2 or num_frame < 3:
            raise ValueError(f"num_frame must be odd and >= 3, got {num_frame}")
        c = channels
        self.num_frame = num_frame
        self.deformable_groups = deformable_groups
        self.dcn_sparse = dcn_sparse
        # "plain" forces the plain PyTorch DCN; set only by the tests and
        # chip_smoke.py to hold the kernel path against it
        self.dcn_impl = "auto"
        act = activation

        def pair(cin):
            return nn.Sequential(
                ConvLayer(cin, c, 3, padding=1, activation=act, norm=norm),
                ConvLayer(c, c, 3, padding=1, activation=None, norm=norm),
            )

        self.offset_conv = pair(2 * c)
        self.dcn_offset_mask = Conv2d(c, deformable_groups * 3 * 9, 3, padding=1)
        # zero-initialized like the reference's DCN_sep offset conv
        nn.init.zeros_(self.dcn_offset_mask.weight)
        nn.init.zeros_(self.dcn_offset_mask.bias)
        bound = 1.0 / (c * 9) ** 0.5
        # HWIO, the DCN op's weight layout
        self.dcn_weight = nn.Parameter(torch.empty(3, 3, c, c).uniform_(-bound, bound))
        self.dcn_bias = nn.Parameter(torch.empty(c).uniform_(-bound, bound))
        self.post_dcn = pair(2 * c)
        self.spatial_kernel = ConvLayer(c, 2, 1, padding=0, activation="sigmoid", norm=norm)
        self.channel_mlp = MLP(c, c // 2, 2 * c, num_layers=2)
        self.dcn_fusion = pair(2 * c)
        self.dense_fusion = pair(num_frame * c)
        self.atten = nn.ModuleList(
            ConvLayer(c >> i, 1, 3, padding=1, activation="sigmoid", norm=norm)
            for i in range(3)
        )
        self.recon = nn.ModuleList(
            UpsampleConvLayer(c >> i, c >> (i + 1), 3, padding=1, norm=norm)
            for i in range(3)
        )

    @property
    def mid_idx(self) -> int:
        return (self.num_frame - 1) // 2

    def _fuse(self, feat0: torch.Tensor, feat1: torch.Tensor,
              activity: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deformable-align ``feat0`` to ``feat1`` and gate-fuse."""
        c = feat0.shape[1]
        raw = self.dcn_offset_mask(self.offset_conv(torch.cat([feat0, feat1], 1)))
        offsets, mask = dcn_offsets_from_conv(
            raw.permute(0, 2, 3, 1), self.deformable_groups, 9
        )
        offsets = self._probe("dcn_offsets", offsets)
        mask = self._probe("dcn_mask", mask)
        aligned = deform_conv2d_auto(
            feat0.permute(0, 2, 3, 1).contiguous(), offsets, mask,
            self.dcn_weight, self.dcn_bias, impl=self.dcn_impl,
            sparse=self.dcn_sparse, activity=activity,
        )
        aligned = self._probe("dcn_out", torch.relu(aligned)).permute(0, 3, 1, 2)
        feat = self.post_dcn(torch.cat([aligned, feat1], 1))
        sk = self.spatial_kernel(feat)  # [B, 2, H, W]
        # channel gate: spatial max-pool -> MLP -> sigmoid, [B, 2C]
        ck = torch.sigmoid(self.channel_mlp(feat.amax(dim=(2, 3))))[:, :, None, None]
        y0 = aligned * sk[:, 0:1] * ck[:, :c]
        y1 = feat1 * sk[:, 1:2] * ck[:, c:]
        return self.dcn_fusion(torch.cat([y0, y1], 1))

    def _dense_fuse(self, x: torch.Tensor,
                    activity: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Align every non-middle frame to the middle one, then fuse."""
        n = x.shape[1]
        outs = [self._fuse(x[:, i], x[:, self.mid_idx], activity)
                for i in range(n) if i != self.mid_idx]
        outs.append(x[:, self.mid_idx])
        return self.dense_fusion(torch.cat(outs, 1))

    def forward(self, x: torch.Tensor, feats_list: Sequence[torch.Tensor],
                activity: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [B, N, C, H, W]``; ``feats_list[i] [B*N, C/2^i, 2^i H, 2^i W]``;
        ``activity [B]`` (optional) vetoes skipping when ``dcn_sparse``."""
        b, n = x.shape[:2]
        if n != self.num_frame:
            raise ValueError(f"expected {self.num_frame} frames, got {n}")
        out = self._dense_fuse(x, activity)
        for idx, feats in enumerate(feats_list):
            # attention-weighted mean of the frames' skip features, then x2
            agg = (feats * self.atten[idx](feats)).reshape(
                b, n, *feats.shape[1:]).mean(dim=1)
            out = self._probe(f"dec{idx}", self.recon[idx](out + agg))
        return out


class DeepRecurrNet(_Probed):
    """The ESR network. ``forward(x [B, N, H, W, inch], states) ->
    (out [B, H, W, inch], states)``; create states with :meth:`init_states`
    and reset them per recording. ``dcn_sparse`` predicates the DCN on
    activity, ``numerics`` arms the probe taps (module docstring)."""

    def __init__(self, inch: int = 2, basech: int = 16, num_frame: int = 3,
                 norm: Optional[str] = None, activation: str = "relu",
                 down_scale: int = 8, dcn_sparse: bool = False,
                 numerics: bool = False, numerics_mode: str = "stats",
                 numerics_break: Optional[str] = None):
        super().__init__()
        self.numerics = numerics
        self.numerics_mode = numerics_mode
        self.numerics_break = numerics_break
        c = down_scale * basech
        self.inch = inch
        self.basech = basech
        self.num_frame = num_frame
        self.down_scale = down_scale
        self.head = ConvLayer(inch, basech, 3, padding=1, activation=activation, norm=norm)
        self.feat_extract = FeatsExtract(basech, norm, activation)
        self.time_propagate = TimePropagation(c, norm, activation)
        self.spacetime_fuse = STFusion(c, num_frame, norm, activation,
                                       dcn_sparse=dcn_sparse, numerics=numerics,
                                       numerics_mode=numerics_mode,
                                       numerics_break=numerics_break)
        self.tail = ConvLayer(basech, inch, 3, padding=1, activation="relu", norm=norm)

    def init_states(self, batch: int, height: int, width: int,
                    device: Optional[torch.device] = None) -> States:
        """Zero ConvGRU states ``[B, H/8, W/8, 8*basech]`` for an input of
        spatial size (height, width)."""
        spec = model_util.compute_pad(height, width, self.down_scale, self.down_scale)
        shape = (batch, spec.padded_height // self.down_scale,
                 spec.padded_width // self.down_scale, self.down_scale * self.basech)
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return (z, z.clone())

    def forward(self, x: torch.Tensor, states: States,
                activity: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, States]:
        b, n, h, w, cin = x.shape
        spec = model_util.compute_pad(h, w, self.down_scale, self.down_scale)
        need_crop = (spec.padded_height, spec.padded_width) != (h, w)
        if need_crop:
            x = model_util.pad_image(x, spec)
        ph, pw = x.shape[2], x.shape[3]

        flat = self.head(x.reshape(b * n, ph, pw, cin).permute(0, 3, 1, 2))
        flat = self._probe("head_out", flat)
        # deepest first: enc0 is the bottleneck
        feats_list = [self._probe(f"enc{i}", f)
                      for i, f in enumerate(self.feat_extract(flat))]
        bottleneck = feats_list[0]
        seq = bottleneck.reshape(b, n, *bottleneck.shape[1:])
        nchw_states = tuple(s.permute(0, 3, 1, 2) for s in states)
        seq, (sf, sb) = self.time_propagate(seq, nchw_states)
        sf, sb = self._probe("gru_fwd", sf), self._probe("gru_bwd", sb)
        out = self.tail(self.spacetime_fuse(seq, feats_list, activity))
        out = self._probe("tail_out", out).permute(0, 2, 3, 1)
        if need_crop:
            out = model_util.crop_image(out, spec, scale=1)
        return out, (sf.permute(0, 2, 3, 1), sb.permute(0, 2, 3, 1))
