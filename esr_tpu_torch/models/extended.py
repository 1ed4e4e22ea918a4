"""Extended submodules (counterpart of ``esr_tpu/models/extended.py``):
attention, inception and dilated blocks, 3D convolutions and point-cloud
ops. The flagship does not use them; they complete the reference's module
surface.

Images are ``[B, C, H, W]`` and volumes ``[B, C, D, H, W]``, as the port's
layers take them; point sets are ``[B, N, C]`` (the ``nn.Linear`` idiom).
Every module takes its input width as its first argument (flax infers it).
The BatchNorms are :class:`~esr_tpu_torch.models.layers.TorchBatchNorm`
(BatchNorm1d / 3d semantics, ``batch_stats`` in the flax tree); the 3D
blocks' ``norm="IN"`` is flax's ``GroupNorm(group_size=1)`` with its
affine parameters. ``models.convert`` maps each block's flax names.

Under the port's deterministic numerics every backward here has a
deterministic CUDA path: the 3D max pool is the max over the window's
strided slices (``MaxPool3d``'s CUDA backward has none) and the neighbour
gathers are advanced indexing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from esr_tpu_torch.models.layers import Conv2d, Linear, TorchBatchNorm, get_activation


class InceptionBlock(nn.Module):
    """1x1 -> kxk (dilated) -> 1x1 bottleneck, ReLU after each."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        mid = features // 2
        self.conv_0 = Conv2d(in_channels, mid, 1)
        self.conv_1 = Conv2d(mid, mid, kernel_size, stride=stride, padding=dilation,
                             dilation=dilation)
        self.conv_2 = Conv2d(mid, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv_0(x))
        x = torch.relu(self.conv_1(x))
        return torch.relu(self.conv_2(x))


class DilatedBlock(nn.Module):
    """Sum of inception branches at dilations 1, 2 and 3, ``cardinality``
    branches each (children ``d{dilation}_{i}``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, cardinality: int = 2):
        super().__init__()
        self.names = [f"d{d}_{i}" for d in (1, 2, 3) for i in range(cardinality)]
        for name in self.names:
            self.add_module(name, InceptionBlock(in_channels, features, kernel_size, stride,
                                                 int(name[1])))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = 0
        for name in self.names:
            out = out + getattr(self, name)(x)
        return out


class SelfAttention(nn.Module):
    """Offset attention over point features ``[B, N, C]``: Q and K share one
    projection, the attention is a softmax renormalized over its columns,
    and the output is ``x + relu(BN(trans(x - x_r)))``."""

    def __init__(self, channels: int):
        super().__init__()
        self.qk = Linear(channels, channels // 4, bias=False)
        self.v = Linear(channels, channels)
        self.trans = Linear(channels, channels)
        self.after_norm = TorchBatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.qk(x)
        energy = torch.einsum("bnc,bmc->bnm", q, q)
        attention = torch.softmax(energy, dim=-1)
        attention = attention / (1e-9 + attention.sum(dim=1, keepdim=True))
        x_r = torch.einsum("bmc,bmn->bnc", self.v(x), attention)
        delta = self.trans(x - x_r)
        # BatchNorm1d over [B, C, N]: per-channel moments over (B, N)
        delta = self.after_norm(delta.transpose(1, 2)).transpose(1, 2)
        return x + torch.relu(delta)


class GroupNormIN(nn.Module):
    """flax ``nn.GroupNorm(num_groups=None, group_size=1)``: each channel of
    each instance normalized over its space (eps 1e-6), then a per-channel
    scale and bias."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, x.shape[1], self.weight, self.bias, self.eps)


def _norm3d(norm: Optional[str], channels: int) -> Optional[nn.Module]:
    if norm == "BN":
        return TorchBatchNorm(channels)
    if norm == "IN":
        return GroupNormIN(channels)
    if norm is None:
        return None
    raise NotImplementedError(f"norm={norm!r} is not supported ('BN', 'IN' or None)")


class Conv3DBlock(nn.Module):
    """Conv3d (with its bias) + norm + activation on ``[B, C, D, H, W]``;
    the reference always applies BatchNorm3d (``norm="BN"``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, activation: Optional[str] = "leaky_relu",
                 norm: Optional[str] = "BN"):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, features, kernel_size, stride, padding)
        self.norm = _norm3d(norm, features)
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.activation(x) if self.activation is not None else x


class Deconv3DBlock(nn.Module):
    """ConvTranspose3d x2 (``output_padding=1``) + norm + activation."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 1, activation: Optional[str] = "leaky_relu",
                 norm: Optional[str] = "BN"):
        super().__init__()
        self.conv = nn.ConvTranspose3d(in_channels, features, kernel_size, stride=2,
                                       padding=padding, output_padding=1)
        self.norm = _norm3d(norm, features)
        self.activation = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.activation(x) if self.activation is not None else x


def max_pool3d(x: torch.Tensor, kernel: int, stride: int, padding: int) -> torch.Tensor:
    """``F.max_pool3d`` (padding with -inf) as the max over the window's
    strided slices, whose backward has a deterministic CUDA path."""
    if padding:
        x = F.pad(x, (padding,) * 6, value=float("-inf"))
    d, h, w = x.shape[-3:]
    od, oh, ow = ((n - kernel) // stride + 1 for n in (d, h, w))
    out = None
    for i in range(kernel):
        for j in range(kernel):
            for k in range(kernel):
                s = x[..., i:i + stride * (od - 1) + 1:stride, j:j + stride * (oh - 1) + 1:stride,
                      k:k + stride * (ow - 1) + 1:stride]
                out = s if out is None else torch.maximum(out, s)
    return out


class Conv3DBlock2(nn.Module):
    """Two conv blocks (width-preserving, then projecting) and a max pool."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, pool_kernel: int = 2,
                 pool_stride: int = 2, pool_padding: int = 0,
                 activation: Optional[str] = "leaky_relu"):
        super().__init__()
        self.block_0 = Conv3DBlock(in_channels, in_channels, kernel_size, stride, padding,
                                   activation)
        self.block_1 = Conv3DBlock(in_channels, features, kernel_size, stride, padding,
                                   activation)
        self.pool = (pool_kernel, pool_stride, pool_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool3d(self.block_1(self.block_0(x)), *self.pool)


class Deconv3DBlock2(nn.Module):
    """A deconv block, then two LeakyReLU conv blocks (the reference fixes
    their activation)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 1, activation: Optional[str] = "leaky_relu"):
        super().__init__()
        self.deconv = Deconv3DBlock(in_channels, features, kernel_size, padding, activation)
        self.block_0 = Conv3DBlock(features, features, 3, 1, 1, "leaky_relu")
        self.block_1 = Conv3DBlock(features, features, 3, 1, 1, "leaky_relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_1(self.block_0(self.deconv(x)))


def batch_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances ``[B, N, M]`` between point sets."""
    ra = torch.sum(a * a, dim=2, keepdim=True)
    rb = torch.sum(b * b, dim=2, keepdim=True)
    return ra - 2 * torch.einsum("bnc,bmc->bnm", a, b) + rb.transpose(1, 2)


def group_knn(k: int, query: torch.Tensor, points: torch.Tensor, unique: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k nearest neighbours of ``query [B, M, C]`` among ``points [B, N,
    C]``: ``(neighbors [B, M, k, C], indices [B, M, k], distances [B, M,
    k])``. ``unique`` pushes a point that repeats one of lower index to the
    end of the ranking. Equal distances rank the lower index first, as
    ``jax.lax.top_k`` does (a stable sort; ``torch.topk`` promises no
    order among ties)."""
    b, n, _ = points.shape
    assert n >= k, "points size must be >= k"
    d = batch_distance_matrix(query, points)
    if unique:
        eq = torch.all(points[:, :, None, :] == points[:, None, :, :], dim=-1)
        earlier = torch.tril(torch.ones(n, n, dtype=torch.bool, device=points.device), -1)
        duplicated = torch.any(eq & earlier[None], dim=-1)
        d = d + torch.max(d) * duplicated[:, None, :].to(d.dtype)
    idx = torch.sort(-d.detach(), dim=-1, descending=True, stable=True).indices[..., :k]
    m = query.shape[1]
    bidx = torch.arange(b, device=d.device)[:, None, None]
    midx = torch.arange(m, device=d.device)[None, :, None]
    neighbors = points[bidx, idx]
    return neighbors, idx, d[bidx, midx, idx]


class DenseEdgeConv(nn.Module):
    """Densely connected edge convolution over point features ``[B, N, C]``
    -> (``[B, N, C + n * growth_rate]``, the neighbour indices)."""

    def __init__(self, in_channels: int, growth_rate: int, n: int, k: int):
        super().__init__()
        self.n, self.k = n, k
        dims = [2 * in_channels] + [in_channels + i * growth_rate for i in range(1, n)]
        self.mlps = nn.ModuleList(Linear(d, growth_rate) for d in dims)

    def _local_graph(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Edge features ``[x_center, nn_i - x_center]`` -> ``[B, N, k, 2C]``."""
        knn_point, idx, _ = group_knn(self.k + 1, x, x, unique=True)
        idx = idx[:, :, 1:]
        knn_point = knn_point[:, :, 1:, :]
        center = x[:, :, None, :].expand_as(knn_point)
        return torch.cat([center, knn_point - center], dim=-1), idx

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y, idx = self._local_graph(x)
        for i, mlp in enumerate(self.mlps):
            if i == 0:
                xk = x[:, :, None, :].expand(*y.shape[:3], x.shape[-1])
                y = torch.cat([torch.relu(mlp(y)), xk], dim=-1)
            elif i == self.n - 1:
                y = torch.cat([mlp(y), y], dim=-1)
            else:
                y = torch.cat([torch.relu(mlp(y)), y], dim=-1)
        return torch.amax(y, dim=2), idx


class MeanShift(nn.Module):
    """Fixed RGB mean / std shift of ``[B, C, H, W]`` images:
    ``x / std + sign * 255 * mean / std``."""

    def __init__(self, rgb_mean: Sequence[float], rgb_std: Sequence[float], sign: int = -1):
        super().__init__()
        self.register_buffer("mean", torch.tensor(rgb_mean, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("std", torch.tensor(rgb_std, dtype=torch.float32),
                             persistent=False)
        self.sign = sign

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        std = self.std.reshape(1, -1, 1, 1)
        mean = self.mean.reshape(1, -1, 1, 1)
        return x / std + self.sign * 255.0 * mean / std
