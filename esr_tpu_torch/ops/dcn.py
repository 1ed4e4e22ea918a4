"""Modulated deformable convolution (DCNv2) — counterpart of
``esr_tpu/ops/dcn.py``.

Layouts are the reference's, channel-last:

- ``x [B, H, W, Cin]``;
- ``offsets [B, Ho, Wo, dg, K, 2]`` as (dy, dx) per output pixel,
  deformable group and kernel tap (K = kh*kw, row-major taps);
- ``mask [B, Ho, Wo, dg, K]`` (already sigmoid'd);
- ``weight [kh, kw, Cin, Cout]`` (HWIO), ``bias [Cout]``.

:func:`deform_conv2d` is the plain PyTorch version: a 4-corner bilinear
gather with zero outside the image, the mask multiply, and one contraction.
:func:`deform_conv2d_backward` is the plain version of its backward (the five
cotangents, by autograd through :func:`deform_conv2d`). On CPU tensors they
are what runs; on the card they are the references the CUDA kernels
(``esr_tpu_torch.ops.dcn_cuda``) are held against, in the tests and
``chip_smoke.py``.

:func:`deform_conv2d_auto` is the model's call. With ``impl='auto'`` it is
:func:`esr_tpu_torch.ops.dcn_cuda.dcn`, the one place where the direction
is decided: with grad mode on and an input that requires grad, the train
direction (on the card the ``torch.autograd.Function`` that launches
``dcn_train_fwd`` and, in its backward, ``dcn_bwd`` and ``dcn_wgrad``; on
the CPU this plain version under autograd); otherwise the forward kernel
``dcn_fwd`` (on the CPU, this plain version). ``impl='plain'`` forces the
plain version in both directions, for the tests and ``chip_smoke.py`` only.

Activity masking (the reference's ``dcn_sparse``, ``esr_tpu/ops/
dcn.py:252-265`` and ``dcn_pallas.py:388-422``): a ``tile_mask`` of
``[B]`` per-image or ``[B, n_tiles]`` per-output-tile activity marks which
(image, output tile) pairs are computed; an inactive one gives zeros before
the bias. The tiles are the reference kernels' own (:func:`fwd_tiling`,
:func:`train_tiling`), so an explicit ``[B, n_tiles]`` mask means the same
output pixels as there. :func:`deform_conv2d_masked` is the plain version;
on the card the masked kernels ``dcn_fwd_masked`` and
``dcn_train_fwd_masked`` run (the backward stays dense). With ``sparse``,
:func:`deform_conv2d_auto` derives the mask from the input
(:func:`dcn_image_activity`: an all-zero image is inactive, a NaN image
active), OR'd with the caller's ``activity``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _sampling_positions(
    offsets: torch.Tensor, kh: int, kw: int, stride: int, padding: int,
    dilation: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base grid + tap offset + learned offset: ``(ys, xs)`` each
    ``[B, Ho, Wo, dg, K]`` f32."""
    _, ho, wo, _, _, _ = offsets.shape
    dev = offsets.device
    oy = (torch.arange(ho, device=dev) * stride - padding).float()
    ox = (torch.arange(wo, device=dev) * stride - padding).float()
    ky, kx = torch.meshgrid(
        torch.arange(kh, device=dev), torch.arange(kw, device=dev), indexing="ij"
    )
    tap_y = (ky * dilation).reshape(-1).float()
    tap_x = (kx * dilation).reshape(-1).float()
    base_y = oy[:, None, None, None] + tap_y[None, None, None, :]
    base_x = ox[None, :, None, None] + tap_x[None, None, None, :]
    return base_y[None] + offsets[..., 0], base_x[None] + offsets[..., 1]


def deform_conv2d(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """Plain PyTorch DCNv2 forward. Returns ``[B, Ho, Wo, Cout]``."""
    b, h, w, cin = x.shape
    kh, kw, wcin, cout = weight.shape
    _, ho, wo, dg, k, _ = offsets.shape
    if wcin != cin or k != kh * kw or cin % dg:
        raise ValueError(
            f"DCN shapes disagree: x {tuple(x.shape)}, offsets "
            f"{tuple(offsets.shape)}, weight {tuple(weight.shape)}"
        )
    cg = cin // dg
    ys, xs = _sampling_positions(offsets, kh, kw, stride, padding, dilation)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    dy = ys - y0
    dx = xs - x0
    y0i = y0.long()
    x0i = x0.long()

    # x regrouped [B, dg, H*W, Cg]; positions per group [B, dg, Ho*Wo*K]
    xg = x.reshape(b, h * w, dg, cg).permute(0, 2, 1, 3)

    def per_group(t: torch.Tensor) -> torch.Tensor:
        return t.permute(0, 3, 1, 2, 4).reshape(b, dg, ho * wo * k)

    cols = None
    for oy, ox, wgt in (
        (0, 0, (1 - dy) * (1 - dx)),
        (0, 1, (1 - dy) * dx),
        (1, 0, dy * (1 - dx)),
        (1, 1, dy * dx),
    ):
        yi = y0i + oy
        xi = x0i + ox
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = per_group(yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        v = torch.gather(xg, 2, idx[..., None].expand(-1, -1, -1, cg))
        v = v * per_group(torch.where(inb, wgt, torch.zeros_like(wgt)))[..., None]
        cols = v if cols is None else cols + v
    # [B, dg, Ho, Wo, K, Cg] * mask
    cols = cols.reshape(b, dg, ho, wo, k, cg)
    cols = cols * mask.permute(0, 3, 1, 2, 4)[..., None]
    wk = weight.reshape(k, dg, cg, cout)
    out = torch.einsum("bgijkc,kgco->bijo", cols, wk)
    if bias is not None:
        out = out + bias
    return out


def deform_conv2d_backward(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    g: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain DCNv2 backward: ``(gx, goffsets, gmask, gweight, gbias)`` for
    the output cotangent ``g [B, Ho, Wo, Cout]``, by autograd through
    :func:`deform_conv2d` (``gbias`` is ``g`` summed over B, Ho, Wo)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, offsets, mask, weight)]
        out = deform_conv2d(*leaves, None, stride, padding, dilation)
        grads = torch.autograd.grad(out, leaves, g)
    return (*grads, g.sum(dim=(0, 1, 2)))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def train_tiling(hw: int, no: int) -> Tuple[int, int]:
    """``(no_tile, n_tiles)`` of the reference's train-direction kernel
    (``esr_tpu/ops/dcn_pallas.py:_tiling``): ``hw`` input and ``no`` output
    pixels per image."""
    hw_pad = _round_up(hw, 128)
    cap = 512 if hw_pad <= 1024 else (256 if hw_pad <= 4096 else 128)
    no_tile = min(cap, _round_up(no, 128))
    return no_tile, _round_up(no, no_tile) // no_tile


def fwd_tiling(h: int, w: int, no: int) -> Tuple[int, int]:
    """``(no_tile, n_tiles)`` of the reference's forward kernel
    (``dcn_pallas.py:_fwd_tiling``): rows padded to 8, columns to 128."""
    return train_tiling(_round_up(h, 8) * _round_up(w, 128), no)


def output_tiling(x: torch.Tensor, offsets: torch.Tensor, direction: str) -> Tuple[int, int]:
    """``(no_tile, n_tiles)`` for a call in ``direction`` ('fwd' or 'train')."""
    _, h, w, _ = x.shape
    no = offsets.shape[1] * offsets.shape[2]
    if direction == "fwd":
        return fwd_tiling(h, w, no)
    if direction == "train":
        return train_tiling(h * w, no)
    raise ValueError(f"unknown DCN direction {direction!r} (use 'fwd' or 'train')")


def tile_mask_grid(tile_mask: torch.Tensor, b: int, n_tiles: int) -> torch.Tensor:
    """A ``[B]`` or ``[B, n_tiles]`` activity mask as the kernels' int32
    ``[b, n_tiles]`` bitmap (``> 0`` is active; ``[B]`` covers every tile)."""
    am = torch.as_tensor(tile_mask)
    if am.dim() == 1:
        am = am[:, None].expand(am.shape[0], n_tiles)
    if tuple(am.shape) != (b, n_tiles):
        raise ValueError(
            f"tile_mask shape {tuple(am.shape)} does not match the kernel grid "
            f"({b}, {n_tiles}); pass [B] per-image activity or the exact "
            f"[B, n_tiles] per-output-tile bitmap"
        )
    return (am > 0).to(torch.int32).contiguous()


def dcn_image_activity(x: torch.Tensor) -> torch.Tensor:
    """``[B]`` f32: 1.0 where any value of the image is nonzero. A NaN
    image counts as active, so its NaN output is never replaced by zeros."""
    # max |x| is >= 0 or NaN: "> 0 or NaN" is "!= 0"
    return (x.abs().flatten(1).amax(dim=1) != 0).to(torch.float32)


def deform_conv2d_masked(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    tile_mask: torch.Tensor,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
    direction: str = "fwd",
) -> torch.Tensor:
    """Plain masked DCNv2: :func:`deform_conv2d` with the output pixels of
    inactive (image, tile) pairs set to 0 before the bias."""
    b, ho, wo = offsets.shape[:3]
    no_tile, n_tiles = output_tiling(x, offsets, direction)
    am = tile_mask_grid(tile_mask.to(x.device), b, n_tiles)
    pix = torch.arange(ho * wo, device=x.device) // no_tile
    active = (am[:, pix] > 0).reshape(b, ho, wo, 1)
    out = deform_conv2d(x, offsets, mask, weight, None, stride, padding, dilation)
    out = torch.where(active, out, torch.zeros_like(out))
    if bias is not None:
        out = out + bias
    return out


def wants_grad(tensors: Sequence[Optional[torch.Tensor]]) -> bool:
    """The train direction: grad mode on and an input that requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def deform_conv2d_auto(
    x: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
    impl: str = "auto",
    sparse: bool = False,
    activity: Optional[torch.Tensor] = None,
    tile_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The model's DCN call. ``impl='auto'`` is ``dcn_cuda.dcn``, which
    decides the direction and, through the kernel wrappers, the device;
    ``impl='plain'`` forces the plain version (tests and the on-card
    comparison only). A bf16 call runs in f32 and returns bf16.
    ``tile_mask`` is passed through as given; else, with
    ``sparse``, the mask is :func:`dcn_image_activity` OR'd with
    ``activity`` (``[B]``): a tile is skipped only when both call it idle."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown DCN impl {impl!r} (use 'auto' or 'plain')")
    if x.dtype != torch.float32:
        # the dtype seam of the reference's Pallas wrapper (dcn_pallas.py
        # :609-612, :1216-1219): the DCN computes in f32, the bias added in
        # f32, and the output returns in the caller's dtype (bf16 rung)
        out = deform_conv2d_auto(
            x.float(), offsets.float(), mask.float(), weight.float(),
            None if bias is None else bias.float(), stride, padding, dilation, impl,
            sparse, activity, tile_mask)
        return out.to(x.dtype)
    tm = tile_mask
    if tm is None and sparse:
        tm = dcn_image_activity(x)
        if activity is not None:
            tm = torch.maximum(tm, (activity.reshape(-1) > 0).to(tm))
    if impl == "auto":
        from esr_tpu_torch.ops.dcn_cuda import dcn

        return dcn(x, offsets, mask, weight, bias, stride, padding, dilation,
                   tile_mask=tm)
    if tm is None:
        return deform_conv2d(x, offsets, mask, weight, bias, stride, padding, dilation)
    direction = "train" if wants_grad([x, offsets, mask, weight, bias]) else "fwd"
    return deform_conv2d_masked(x, offsets, mask, weight, bias, tm, stride, padding,
                                dilation, direction)


def dcn_offsets_from_conv(
    raw: torch.Tensor, deformable_groups: int, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split the offset/mask conv output ``[B, Ho, Wo, dg*3*K]`` into
    ``offsets [B, Ho, Wo, dg, K, 2]`` (first third dy, second dx) and the
    sigmoid'd ``mask [B, Ho, Wo, dg, K]`` (last third)."""
    b, ho, wo, ch = raw.shape
    dg = deformable_groups
    if ch != dg * 3 * k:
        raise ValueError(f"offset conv gives {ch} channels, expected {dg * 3 * k}")
    o1, o2, m = torch.split(raw, dg * k, dim=-1)
    offsets = torch.stack(
        [o1.reshape(b, ho, wo, dg, k), o2.reshape(b, ho, wo, dg, k)], dim=-1
    )
    mask = torch.sigmoid(m.reshape(b, ho, wo, dg, k)).contiguous()
    return offsets, mask
