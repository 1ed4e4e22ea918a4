"""Super-SloMo frame-rate upsampling for offline dataset generation
(counterpart of ``esr_tpu/tools/upsampling.py``).

- :class:`SloMoUNet`: the paper's UNet (7x7 / 5x5 / 3x3 kernels, leaky
  ReLU 0.1, average-pool downs, align-corners bilinear ups), NCHW. Its five
  2x pools need both sides divisible by 32 (a 720-row frame fails at the
  first skip, as the reference's does; pad it to 736 first).
- :func:`backwarp`: ``I0 = warp(I1, F_0_1)`` through
  :func:`esr_tpu_torch.ops.sampling.grid_sample` (``align_corners=True``).
- :func:`interpolate_frame`: the arbitrary-time interpolation (flow mixing
  ``[-t(1-t), t^2, (1-t)^2, -t(1-t)]``, residual flow and visibility from
  the second UNet, visibility-weighted fusion).
- :func:`upsample_adaptive`: one output frame per pixel of peak motion.
- :func:`convert_superslomo_checkpoint` turns the published
  ``SuperSloMo.ckpt`` (``state_dictFC`` / ``state_dictAT``) into an npz;
  :func:`load_superslomo_npz` gives the two state dicts, whose torch key
  names (``conv1.weight``, ``down1.conv1.weight``, ...) are this module's
  own. The checkpoint is not shipped: without it the nets carry seeded
  weights.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from esr_tpu_torch.ops.sampling import grid_sample


def _linear_ac_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The ``[n_out, n_in]`` matrix of an align-corners linear resize."""
    if n_out == 1 or n_in == 1:
        return np.ones((n_out, n_in), np.float32) / n_in
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    f = src - i0
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), i0] += 1 - f
    m[np.arange(n_out), i1] += f
    return m


def _resize_linear_ac(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Align-corners bilinear resize of ``[B, C, H, W]`` as two products with
    the interpolation matrices (its backward sums in a fixed order)."""
    my = torch.from_numpy(_linear_ac_matrix(x.shape[2], oh)).to(x.device, x.dtype)
    mx = torch.from_numpy(_linear_ac_matrix(x.shape[3], ow)).to(x.device, x.dtype)
    out = torch.einsum("oh,bchw->bcow", my, x)
    return torch.einsum("pw,bcow->bcop", mx, out)


class _Down(nn.Module):
    """avg-pool 2 -> conv + lrelu -> conv + lrelu."""

    def __init__(self, in_channels: int, features: int, kernel_size: int):
        super().__init__()
        p = (kernel_size - 1) // 2
        self.conv1 = nn.Conv2d(in_channels, features, kernel_size, padding=p)
        self.conv2 = nn.Conv2d(features, features, kernel_size, padding=p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.avg_pool2d(x, 2)
        x = F.leaky_relu(self.conv1(x), 0.1)
        return F.leaky_relu(self.conv2(x), 0.1)


class _Up(nn.Module):
    """bilinear x2 (align corners) -> conv + lrelu -> conv(cat skip) + lrelu."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, padding=1)
        self.conv2 = nn.Conv2d(2 * features, features, 3, padding=1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = _resize_linear_ac(x, 2 * x.shape[2], 2 * x.shape[3])
        x = F.leaky_relu(self.conv1(x), 0.1)
        return F.leaky_relu(self.conv2(torch.cat([x, skip], dim=1)), 0.1)


class SloMoUNet(nn.Module):
    """The Super-SloMo UNet on ``[B, in_channels, H, W]``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 32, 7, padding=3)
        self.conv2 = nn.Conv2d(32, 32, 7, padding=3)
        self.down1 = _Down(32, 64, 5)
        self.down2 = _Down(64, 128, 3)
        self.down3 = _Down(128, 256, 3)
        self.down4 = _Down(256, 512, 3)
        self.down5 = _Down(512, 512, 3)
        self.up1 = _Up(512, 512)
        self.up2 = _Up(512, 256)
        self.up3 = _Up(256, 128)
        self.up4 = _Up(128, 64)
        self.up5 = _Up(64, 32)
        self.conv3 = nn.Conv2d(32, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.conv1(x), 0.1)
        s1 = F.leaky_relu(self.conv2(x), 0.1)
        s2 = self.down1(s1)
        s3 = self.down2(s2)
        s4 = self.down3(s3)
        s5 = self.down4(s4)
        x = self.down5(s5)
        x = self.up1(x, s5)
        x = self.up2(x, s4)
        x = self.up3(x, s3)
        x = self.up4(x, s2)
        x = self.up5(x, s1)
        return F.leaky_relu(self.conv3(x), 0.1)


def backwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample ``img [B, C, H, W]`` at the pixel grid plus ``flow [B, 2, H,
    W]`` (u, v), normalized as the vendored ``backWarp`` does."""
    _, _, h, w = img.shape
    dev = img.device
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + flow[:, 0]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + flow[:, 1]
    # true division by device tensors on every device (CUDA divides by a
    # Python number as a product with its reciprocal)
    grid = torch.stack([2 * (gx / torch.tensor(float(w), device=dev) - 0.5),
                        2 * (gy / torch.tensor(float(h), device=dev) - 0.5)], dim=-1)
    return grid_sample(img, grid, align_corners=True)


def flow_nets(channels: int = 3) -> Tuple[SloMoUNet, SloMoUNet]:
    """The flow net (two frames in, two flows out) and the interpolation
    net (frames, flows, intermediate flows and warps in; two residual flows
    and a visibility out) for ``channels``-channel frames."""
    return SloMoUNet(2 * channels, 4), SloMoUNet(4 * channels + 8, 5)


def interpolate_frame(flow_model: nn.Module, interp_model: nn.Module, i0: torch.Tensor,
                      i1: torch.Tensor, t: float,
                      flows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """One intermediate frame ``[B, C, H, W]`` at relative time ``t`` in
    (0, 1) between ``i0`` and ``i1``; ``flows`` = (F_0_1, F_1_0) skips the
    flow net."""
    if flows is None:
        flow_out = flow_model(torch.cat([i0, i1], dim=1))
        f01, f10 = flow_out[:, :2], flow_out[:, 2:]
    else:
        f01, f10 = flows
    temp = -t * (1 - t)
    ft0 = temp * f01 + (t * t) * f10
    ft1 = ((1 - t) * (1 - t)) * f01 + temp * f10
    g0 = backwarp(i0, ft0)
    g1 = backwarp(i1, ft1)
    interp_out = interp_model(torch.cat([i0, i1, f01, f10, ft1, ft0, g1, g0], dim=1))
    ft0_f = interp_out[:, :2] + ft0
    ft1_f = interp_out[:, 2:4] + ft1
    v0 = torch.sigmoid(interp_out[:, 4:5])
    v1 = 1 - v0
    g0f = backwarp(i0, ft0_f)
    g1f = backwarp(i1, ft1_f)
    w0, w1 = 1 - t, t
    return (w0 * v0 * g0f + w1 * v1 * g1f) / (w0 * v0 + w1 * v1 + 1e-12)


@torch.no_grad()
def upsample_adaptive(flow_model: nn.Module, interp_model: nn.Module, i0: torch.Tensor,
                      i1: torch.Tensor, t0: float, t1: float
                      ) -> Tuple[List[np.ndarray], List[float]]:
    """One output frame per ~pixel of peak motion between ``i0`` and
    ``i1``: ``(frames [C, H, W] of the first batch item, timestamps)``,
    ``i1`` excluded."""
    flow_out = flow_model(torch.cat([i0, i1], dim=1))
    f01, f10 = flow_out[:, :2], flow_out[:, 2:]
    peak = torch.maximum(torch.sqrt((f01 ** 2).sum(1)).max(), torch.sqrt((f10 ** 2).sum(1)).max())
    n = int(np.ceil(float(peak)))
    frames = [i0[0].cpu().numpy()]
    stamps = [t0]
    for k in range(1, max(n, 1)):
        t = k / n
        ft = interpolate_frame(flow_model, interp_model, i0, i1, t, flows=(f01, f10))
        frames.append(ft[0].cpu().numpy())
        stamps.append(t0 + t * (t1 - t0))
    return frames, stamps


def convert_superslomo_checkpoint(ckpt_path: str, out_npz_path: str) -> None:
    """``SuperSloMo.ckpt`` -> a flat npz of ``fc.<key>`` and ``at.<key>``."""
    ckpt = torch.load(ckpt_path, map_location="cpu")
    out = {}
    for name, sd in (("fc", ckpt["state_dictFC"]), ("at", ckpt["state_dictAT"])):
        for k, v in sd.items():
            out[f"{name}.{k}"] = v.numpy()
    np.savez(out_npz_path, **out)


def _torch_keys() -> List[str]:
    keys = [f"{c}.{p}" for c in ("conv1", "conv2", "conv3") for p in ("weight", "bias")]
    for i in range(1, 6):
        for c in ("conv1", "conv2"):
            for part in ("down", "up"):
                keys += [f"{part}{i}.{c}.weight", f"{part}{i}.{c}.bias"]
    return keys


def load_superslomo_npz(npz_path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """npz -> ``(flow_state, interp_state)``, state dicts for
    :class:`SloMoUNet` under the checkpoint's own key names; raises
    ``KeyError`` on a missing weight."""
    data = np.load(npz_path)

    def build(prefix: str) -> Dict[str, torch.Tensor]:
        state = {}
        for key in _torch_keys():
            full = f"{prefix}.{key}"
            if full not in data.files:
                raise KeyError(f"missing weight {full}")
            state[key] = torch.from_numpy(np.array(data[full], np.float32))
        return state

    return build("fc"), build("at")
