"""Brightness-constancy self-supervised reconstruction loss (counterpart of
``esr_tpu/losses/reconstruction.py``): (1) the generative model's
brightness-increment error, (2) temporal consistency by flow warping,
(3) total-variation regularization. Images are ``[B, C, H, W]``, flow maps
``[B, 2, H, W]`` (x, y); the warping is :func:`esr_tpu_torch.ops.sampling.
grid_sample` and the averaged IWE :func:`esr_tpu_torch.losses.flow.averaged_iwe`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from esr_tpu_torch.losses.flow import averaged_iwe
from esr_tpu_torch.ops.gradients import sobel
from esr_tpu_torch.ops.sampling import grid_sample


class BrightnessConstancy:
    """Stateless loss object with the reference module's API.
    ``resolution``: (H, W); ``weights``: (tv_weight, tc_weight)."""

    def __init__(self, resolution: Tuple[int, int], weights: Sequence[float] = (1.0, 1.0)):
        self.res = resolution
        self.flow_scaling = max(resolution)
        self.weights = tuple(weights)

    def _warp_grid(self, flow_map: torch.Tensor) -> torch.Tensor:
        """Backward-sampling grid ``[B, H, W, 2]`` from a flow map: the
        reference normalizes with size - 1 but samples with
        ``align_corners=False``, and so does this."""
        h, w = self.res
        dev = flow_map.device
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev),
                                indexing="ij")
        warped_y = ys[None] - flow_map[:, 1] * self.flow_scaling
        warped_x = xs[None] - flow_map[:, 0] * self.flow_scaling
        # divided by device tensors (true division on every device; CUDA
        # divides by a Python number as a product with its reciprocal, an
        # ulp off, which moves a tap across a pixel edge on one device only)
        gy = 2.0 * warped_y / torch.tensor(h - 1.0, device=dev) - 1.0
        gx = 2.0 * warped_x / torch.tensor(w - 1.0, device=dev) - 1.0
        return torch.stack([gx, gy], dim=-1)

    def generative_model(self, flow_map: torch.Tensor, img: torch.Tensor,
                         event_cnt: torch.Tensor, event_list: torch.Tensor,
                         pol_mask: torch.Tensor, valid: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Brightness-increment error: ``flow_map [B, 2, H, W]``, the previous
        reconstruction ``img [B, 1, H, W]``, ``event_cnt [B, 2, H, W]``,
        ``event_list [B, N, 4]`` (ts, y, x, p), ``pol_mask [B, N, 2]``."""
        active = (event_cnt.sum(dim=1, keepdim=True) > 0).to(flow_map.dtype)
        flow_map = flow_map * active
        grid = self._warp_grid(flow_map)
        gradx, grady = sobel(img)
        wgx = grid_sample(gradx, grid)
        wgy = grid_sample(grady, grid)
        pred_delta = (wgx * flow_map[:, 0:1] + wgy * flow_map[:, 1:2]) * self.flow_scaling
        avg = averaged_iwe(flow_map, event_list, pol_mask, self.res, valid)
        event_delta = avg[:, 0:1] - avg[:, 1:2]
        err = event_delta + pred_delta
        return (err ** 2).sum()

    def temporal_consistency(self, flow_map: torch.Tensor, prev_img: torch.Tensor,
                             img: torch.Tensor) -> torch.Tensor:
        """L1 warping error between consecutive reconstructions."""
        warped_prev = grid_sample(prev_img, self._warp_grid(flow_map))
        return self.weights[1] * torch.abs(img - warped_prev).sum()

    def regularization(self, img: torch.Tensor) -> torch.Tensor:
        """Total variation with forward differences."""
        dx = torch.abs(img[:, :, :-1, :] - img[:, :, 1:, :])
        dy = torch.abs(img[:, :, :, :-1] - img[:, :, :, 1:])
        return self.weights[0] * (dx.sum() + dy.sum())
