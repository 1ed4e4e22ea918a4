"""LPIPS perceptual distance (counterpart of ``esr_tpu/losses/lpips.py``).

The input is shifted and scaled per RGB channel, run through a backbone
trunk whose feature taps are each normalized over channels; the squared
differences of the two images' taps are weighted per channel by the
non-negative ``lin`` weights (a 1x1 conv without bias), averaged over
space and summed over taps. Three trunks, as the reference's: AlexNet (5
taps), VGG16 (``vgg16`` or ``vgg``, 5 taps) and SqueezeNet1.1 (7 taps, its
max pools in ceil mode). Stock convolutions and pooling: on the card it
runs f32 with TF32 off (the port's numerics policy, ``device.py``).

Weights: the alex ``lin`` weights ship with the port
(``losses/lpips_lin_alex.npz``, the public PerceptualSimilarity v0.1
release). The backbone comes from a user's converted torchvision npz
(:func:`load_backbone_npz`, made by :func:`convert_backbone_pth`), or, only
when asked for with ``allow_uncalibrated=True``, from a seeded numpy draw of
flax's default initializers (LeCun truncated normal kernels, zero biases):
a deterministic but uncalibrated distance, and not the reference's draw
(its generator is JAX's). :func:`load_lpips_params` returns the parameters
as the reference's flax tree of numpy arrays; :func:`build_lpips` loads
such a tree (the reference's own too) through ``models.convert``.

:meth:`LPIPS.multi_channel` replicates each channel of a count image to RGB
and averages the distances. It takes ``[H, W, C]`` or ``[B, H, W, C]``: the
reference's harness passes one window unbatched, which its own module
cannot reduce (``mean(axis=(1, 2))`` over a 2D map); here an unbatched
image gets the batch axis that mean expects.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# (channels, kernel, stride, pool_before) of the 5 AlexNet stages; a tap
# after each stage's ReLU
_ALEX_STAGES = (
    (64, 11, 4, False),
    (192, 5, 1, True),
    (384, 3, 1, True),
    (256, 3, 1, False),
    (256, 3, 1, False),
)
# VGG16: the widths of each tap block's 3x3 convs; 2x2 max pools between
_VGG_STAGES = (
    (64, 64),
    (128, 128),
    (256, 256, 256),
    (512, 512, 512),
    (512, 512, 512),
)
# SqueezeNet1.1's 7 slices: ('conv',) | ('pool',) | ('fire', squeeze, expand)
_SQUEEZE_SLICES = (
    (("conv",),),
    (("pool",), ("fire", 16, 64), ("fire", 16, 64)),
    (("pool",), ("fire", 32, 128), ("fire", 32, 128)),
    (("pool",), ("fire", 48, 192)),
    (("fire", 48, 192),),
    (("fire", 64, 256),),
    (("fire", 64, 256),),
)
NET_CHNS = {
    "alex": tuple(s[0] for s in _ALEX_STAGES),
    "vgg16": tuple(s[-1] for s in _VGG_STAGES),
    "squeeze": (64, 128, 256, 384, 384, 512, 512),
}
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

LIN_WEIGHTS_FILE = os.path.join(os.path.dirname(__file__), "lpips_lin_alex.npz")

# the torchvision ``features`` indices of each trunk's convs (SqueezeNet:
# the stem, then the Fire modules)
_ALEX_CONV_IDX = (0, 3, 6, 8, 10)
_VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_SQUEEZE_FIRE_IDX = (3, 4, 6, 7, 9, 10, 11, 12)
_FIRE_MEMBERS = ("squeeze", "expand1x1", "expand3x3")


def canon_net(net: str) -> str:
    """``vgg`` is ``vgg16``, as the reference's ``DistModel`` takes it."""
    net = "vgg16" if net == "vgg" else net
    if net not in NET_CHNS:
        raise ValueError(f"unknown LPIPS net {net!r} (alex, vgg16/vgg, squeeze)")
    return net


class _Trunk(nn.Module):
    """A backbone returning its taps; its convs carry the flax names."""

    def taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        raise NotImplementedError


class _AlexFeatures(_Trunk):
    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, k, s, _) in enumerate(_ALEX_STAGES):
            setattr(self, f"conv{i}", nn.Conv2d(cin, ch, k, s, padding=2 if k in (11, 5) else 1))
            cin = ch

    def taps(self, x):
        out = []
        for i, (_, _, _, pool_before) in enumerate(_ALEX_STAGES):
            if pool_before:
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(getattr(self, f"conv{i}")(x))
            out.append(x)
        return out


class _VGG16Features(_Trunk):
    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for widths in _VGG_STAGES:
            for ch in widths:
                setattr(self, f"conv{i}", nn.Conv2d(cin, ch, 3, padding=1))
                cin, i = ch, i + 1

    def taps(self, x):
        out, i = [], 0
        for block, widths in enumerate(_VGG_STAGES):
            if block:
                x = F.max_pool2d(x, 2, 2)
            for _ in widths:
                x = F.relu(getattr(self, f"conv{i}")(x))
                i += 1
            out.append(x)
        return out


class _Fire(nn.Module):
    """1x1 squeeze, ReLU, then the 1x1 and 3x3 expands concatenated."""

    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand, 3, padding=1)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)), F.relu(self.expand3x3(s))], dim=1)


class _SqueezeFeatures(_Trunk):
    def __init__(self):
        super().__init__()
        cin, i = 64, 0
        self.conv0 = nn.Conv2d(3, 64, 3, 2)
        for ops in _SQUEEZE_SLICES:
            for op in ops:
                if op[0] == "fire":
                    setattr(self, f"fire{i}", _Fire(cin, op[1], op[2]))
                    cin, i = 2 * op[2], i + 1

    def taps(self, x):
        out, i = [], 0
        for ops in _SQUEEZE_SLICES:
            for op in ops:
                if op[0] == "conv":
                    x = F.relu(self.conv0(x))
                elif op[0] == "pool":
                    x = F.max_pool2d(x, 3, 2, ceil_mode=True)
                else:
                    x = getattr(self, f"fire{i}")(x)
                    i += 1
            out.append(x)
        return out


_TRUNKS = {"alex": _AlexFeatures, "vgg16": _VGG16Features, "squeeze": _SqueezeFeatures}


class LPIPS(nn.Module):
    """``forward(x, y) -> [B]`` on ``[B, H, W, 3]`` images; ``normalize``
    maps [0, 1] to [-1, 1] first. The trunk carries the flax name of
    ``net``, the weights ``lin{i}``."""

    def __init__(self, net: str = "alex", use_lins: bool = True):
        super().__init__()
        self.net = canon_net(net)
        self.use_lins = use_lins
        self.trunk = _TRUNKS[self.net]()
        chns = NET_CHNS[self.net]
        self.lins = nn.ParameterList(
            [nn.Parameter(torch.full((c,), 1.0 / c)) for c in chns] if use_lins else [])
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        y = y.permute(0, 3, 1, 2)
        if normalize:
            x = 2.0 * x - 1.0
            y = 2.0 * y - 1.0
        fx = self.trunk.taps((x - self.shift) / self.scale)
        fy = self.trunk.taps((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
            diff = (a - b) ** 2
            if self.use_lins:
                val = (diff * self.lins[i].abs().view(1, -1, 1, 1)).sum(dim=1)
            else:
                val = diff.sum(dim=1)
            total = total + val.mean(dim=(1, 2))
        return total

    def multi_channel(self, pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """The mean distance over channels of ``[B, H, W, C]`` (or ``[H,
        W, C]``) images, each channel replicated to RGB; a 3-channel image
        is taken as RGB."""
        if pred.dim() == 3:
            pred, tgt = pred[None], tgt[None]
        c = pred.shape[-1]
        if c == 3:
            return self(pred, tgt).mean()
        dists = [self(pred[..., i:i + 1].repeat(1, 1, 1, 3),
                      tgt[..., i:i + 1].repeat(1, 1, 1, 3)).mean() for i in range(c)]
        return torch.stack(dists).mean()


# -- parameters ---------------------------------------------------------------

def _trunk_shapes(net: str) -> Dict[str, Any]:
    """The flax tree of the trunk's kernel (HWIO) and bias shapes."""
    tree: Dict[str, Any] = {}
    module = _TRUNKS[net]()
    for name, child in module.named_children():
        convs = {name: child} if isinstance(child, nn.Conv2d) else {
            m: getattr(child, m) for m in _FIRE_MEMBERS}
        node = tree if isinstance(child, nn.Conv2d) else tree.setdefault(name, {})
        for key, conv in convs.items():
            o, i, kh, kw = conv.weight.shape
            node[key] = {"kernel": (kh, kw, i, o), "bias": (o,)}
    return tree


def _seeded_trunk(tree: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    """flax's default initializers from ``rng``: kernels LeCun normal
    truncated at two standard deviations (fan in = kh * kw * in), biases
    zero."""
    out: Dict[str, Any] = {}
    for key, node in tree.items():
        if "kernel" not in node:
            out[key] = _seeded_trunk(node, rng)
            continue
        shape = node["kernel"]
        # flax's variance_scaling: the truncated normal's std corrected
        # for the truncation
        std = np.sqrt(1.0 / np.prod(shape[:-1])) / 0.87962566103423978
        draw = rng.standard_normal(shape)
        bad = np.abs(draw) > 2.0
        while bad.any():
            draw[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(draw) > 2.0
        out[key] = {"kernel": (draw * std).astype(np.float32),
                    "bias": np.zeros(node["bias"], np.float32)}
    return out


def _torch_conv_to_flax(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _load_backbone(p: Dict[str, Any], net: str, state: Dict[str, Any]) -> None:
    """A torchvision ``<net>.features`` state dict (``features.<i>...``
    keys, numpy or torch values) into the flax trunk subtree ``p``."""

    def arr(key):
        v = state[key]
        return np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v,
                          np.float32)

    if net in ("alex", "vgg16"):
        for i, li in enumerate(_ALEX_CONV_IDX if net == "alex" else _VGG_CONV_IDX):
            p[f"conv{i}"]["kernel"] = _torch_conv_to_flax(arr(f"features.{li}.weight"))
            p[f"conv{i}"]["bias"] = arr(f"features.{li}.bias")
        return
    p["conv0"]["kernel"] = _torch_conv_to_flax(arr("features.0.weight"))
    p["conv0"]["bias"] = arr("features.0.bias")
    for i, li in enumerate(_SQUEEZE_FIRE_IDX):
        for member in _FIRE_MEMBERS:
            p[f"fire{i}"][member]["kernel"] = _torch_conv_to_flax(
                arr(f"features.{li}.{member}.weight"))
            p[f"fire{i}"][member]["bias"] = arr(f"features.{li}.{member}.bias")


def load_lpips_params(alexnet_state: Optional[Dict[str, Any]] = None,
                      lin_npz_path: Optional[str] = None, rng_seed: int = 0,
                      allow_uncalibrated: bool = False, net: str = "alex",
                      backbone_state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The LPIPS parameters as the reference's flax tree ``{"params":
    {net: trunk, "lin{i}": ...}}`` of numpy arrays.

    ``backbone_state`` (or its alias ``alexnet_state``): a torchvision
    ``<net>().state_dict()``-style mapping with ``features.*`` keys (see
    :func:`convert_backbone_pth`). Without it the backbone is drawn from
    ``rng_seed``, and only if ``allow_uncalibrated``: otherwise this raises,
    as a random backbone does not measure perceptual similarity. The same
    holds for the ``lin`` weights: ``lin_npz_path``, or the bundled alex
    file, or (``allow_uncalibrated``) the constant ``1 / C``; an explicit
    ``lin_npz_path`` that does not exist raises ``FileNotFoundError``."""
    net = canon_net(net)
    state = backbone_state if backbone_state is not None else alexnet_state
    if state is None and not allow_uncalibrated:
        raise ValueError(
            "No backbone weights supplied. LPIPS with a random backbone does not measure "
            "perceptual similarity. Pass backbone_state=<converted torchvision state dict> "
            "(see convert_backbone_pth), or opt in to the uncalibrated fallback explicitly "
            "with allow_uncalibrated=True.")
    p: Dict[str, Any] = {net: _seeded_trunk(_trunk_shapes(net), np.random.default_rng(rng_seed))}
    if state is not None:
        _load_backbone(p[net], net, state)
    if lin_npz_path is not None and not os.path.exists(lin_npz_path):
        raise FileNotFoundError(f"lin_npz_path={lin_npz_path!r} does not exist")
    chns = NET_CHNS[net]
    path = lin_npz_path or (LIN_WEIGHTS_FILE if net == "alex" else None)
    if path is not None:
        with np.load(path) as lins:
            for i in range(len(chns)):
                p[f"lin{i}"] = np.asarray(lins[f"lin{i}"], np.float32)
    elif allow_uncalibrated:
        for i, c in enumerate(chns):
            p[f"lin{i}"] = np.full((c,), 1.0 / c, np.float32)
    else:
        raise ValueError(
            f"No lin calibration weights for net={net!r} (convert the richzhang release with "
            "convert_lpips_lin_pth and pass lin_npz_path), or opt in to the uncalibrated "
            "fallback explicitly with allow_uncalibrated=True.")
    return {"params": p}


def build_lpips(params: Dict[str, Any], net: str = "alex",
                device: Optional[torch.device] = None) -> LPIPS:
    """An f32 :class:`LPIPS` in eval mode on ``device`` holding ``params``
    (a flax tree: :func:`load_lpips_params`'s, or the reference's own)."""
    from esr_tpu_torch.models import convert

    model = LPIPS(net=net)
    convert.load_flax_params(model, params)
    return model.requires_grad_(False).eval().to(device=device, dtype=torch.float32)


# -- converters of the published weights ----------------------------------------

def convert_lpips_lin_pth(pth_path: str, out_npz_path: str, net: str = "alex") -> None:
    """The richzhang LPIPS v0.1 ``<net>.pth`` (``lin{i}.model.1.weight``
    of shape ``[1, C, 1, 1]``) -> a flat npz of ``lin{i}``."""
    sd = torch.load(pth_path, map_location="cpu")
    np.savez(out_npz_path, **{
        f"lin{i}": sd[f"lin{i}.model.1.weight"].numpy().reshape(-1)
        for i in range(len(NET_CHNS[canon_net(net)]))})


def backbone_layout(net: str) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(torchvision key prefix, OIHW weight shape)`` of each of the
    trunk's convs, in order: the entries of a backbone npz (``<prefix>.
    weight`` and ``<prefix>.bias``)."""
    net = canon_net(net)
    trunk = _TRUNKS[net]()
    if net == "squeeze":
        convs = [("features.0", trunk.conv0)] + [
            (f"features.{li}.{m}", getattr(getattr(trunk, f"fire{i}"), m))
            for i, li in enumerate(_SQUEEZE_FIRE_IDX) for m in _FIRE_MEMBERS]
    else:
        idx = _ALEX_CONV_IDX if net == "alex" else _VGG_CONV_IDX
        convs = [(f"features.{li}", getattr(trunk, f"conv{i}")) for i, li in enumerate(idx)]
    return [(prefix, tuple(conv.weight.shape)) for prefix, conv in convs]


def convert_backbone_pth(pth_path: str, out_npz_path: str, net: str = "alex") -> None:
    """A torchvision state dict (``alexnet-owt-*.pth``, ``vgg16-*.pth``,
    ``squeezenet1_1-*.pth``) -> an npz of the trunk's convs, what
    :func:`load_backbone_npz` reads."""
    sd = torch.load(pth_path, map_location="cpu")
    out = {}
    for k, _ in backbone_layout(net):
        out[f"{k}.weight"] = sd[f"{k}.weight"].numpy()
        out[f"{k}.bias"] = sd[f"{k}.bias"].numpy()
    np.savez(out_npz_path, **out)


def convert_alexnet_backbone_pth(pth_path: str, out_npz_path: str) -> None:
    """:func:`convert_backbone_pth` for alex."""
    convert_backbone_pth(pth_path, out_npz_path, net="alex")


def load_backbone_npz(npz_path: str) -> Dict[str, np.ndarray]:
    """A converted backbone npz as the mapping :func:`load_lpips_params`
    takes."""
    with np.load(npz_path) as data:
        return {k: data[k] for k in data.files}


load_alexnet_npz = load_backbone_npz
