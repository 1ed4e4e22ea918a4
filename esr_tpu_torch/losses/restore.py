"""Restoration metrics: L1/MSE/PSNR/SSIM on device tensors (counterpart of
``esr_tpu/losses/restore.py``), reproducing scikit-image's algorithm as the
reference uses it: uniform 7x7 window, VALID region, sample covariance."""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

Number = Union[float, torch.Tensor]


def mse_metric(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - tgt) ** 2)


def l1_metric(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - tgt))


def psnr(pred: torch.Tensor, tgt: torch.Tensor, data_range: Number = 1.0) -> torch.Tensor:
    """``10 log10(R^2 / MSE)``."""
    err = torch.mean((pred - tgt) ** 2)
    r = torch.as_tensor(data_range, dtype=pred.dtype, device=pred.device)
    return 10.0 * torch.log10(r**2 / torch.clamp(err, min=1e-20))


def _uniform_filter_valid(img: torch.Tensor, win: int) -> torch.Tensor:
    """Mean filter over the VALID region of an ``[H, W]`` image."""
    k = torch.full((1, 1, win, win), 1.0 / (win * win), dtype=img.dtype,
                   device=img.device)
    return F.conv2d(img[None, None], k)[0, 0]


def ssim(pred: torch.Tensor, tgt: torch.Tensor, data_range: Number = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity of two ``[H, W]`` images (scikit-image
    ``structural_similarity`` defaults, ``use_sample_covariance=True``)."""
    x = pred.float()
    y = tgt.float()
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    ux = _uniform_filter_valid(x, win_size)
    uy = _uniform_filter_valid(y, win_size)
    uxx = _uniform_filter_valid(x * x, win_size)
    uyy = _uniform_filter_valid(y * y, win_size)
    uxy = _uniform_filter_valid(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return torch.mean(s)


def ssim_metric(pred: torch.Tensor, tgt: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """``[H, W]`` or channel-averaged ``[H, W, C]`` SSIM. ``data_range``
    defaults to 2.0: the reference passes none to scikit-image, which takes
    the float dtype range (-1, 1)."""
    if pred.dim() == 2:
        return ssim(pred, tgt, data_range)
    return torch.stack(
        [ssim(pred[..., c], tgt[..., c], data_range) for c in range(pred.shape[-1])]
    ).mean()


def psnr_metric(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Multi-channel: per-channel ``data_range = tgt[c].max() - tgt.min()``
    (the reference's quirk), averaged. Single-channel: clipped to [0, 1],
    ``data_range = 1``."""
    if pred.dim() == 2:
        return psnr(pred.clamp(0, 1), tgt.clamp(0, 1), 1.0)
    tmin = tgt.min()
    return torch.stack([
        psnr(pred[..., c], tgt[..., c], tgt[..., c].max() - tmin)
        for c in range(pred.shape[-1])
    ]).mean()
