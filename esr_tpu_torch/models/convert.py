"""Weight bridge between the reference's flax parameter tree and the port.

The flax tree is plain nested dicts of numpy arrays (``{"params": {...}}``
or the inner dict), named as flax names them. Conv kernels are HWIO there
and OIHW here; 1D conv kernels ``[k, in, out]`` there and ``[out, in, k]``
here; a transposed conv's kernel ``[kh, kw, in, out]`` there (flax's
``transpose_kernel=False``) is ``nn.ConvTranspose2d``'s ``[in, out, kh, kw]``
flipped in space here; ``nn.Dense`` kernels are ``[in, out]`` there and
``[out, in]`` here; the DCN's ``dcn_weight`` stays HWIO (the DCN op's
layout).

One table, :func:`_children`, says for each port module which flax name
each child carries. :func:`load_flax_params` walks it to fill a model and
raises on any leaf that is missing, left over, or of the wrong shape;
:func:`export_flax_params` walks it the other way. The table covers the
models, the extended blocks (``models/extended.py``) and the LPIPS module
(``losses/lpips.py``).

A model with norms (``norm: BN`` / ``IN``) also has the reference's
``batch_stats`` collection: each norm's running ``mean`` and ``var`` (the
port's ``running_mean`` / ``running_var`` buffers) under the flax path of
its module (``_NormWrapper_0/TorchBatchNorm_0/mean``). The tree is then
``{"params": ..., "batch_stats": ...}``, both ways; BatchNorm's affine
``scale`` and ``bias`` are parameters.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from esr_tpu_torch.losses import lpips
from esr_tpu_torch.models import adapters, esr, extended, layers, unet


def _numbered(mod: nn.Module, name: str) -> List[Tuple[str, object]]:
    """``name_0``, ``name_1``, ... children of ``mod``, by that name."""
    out = []
    while hasattr(mod, f"{name}_{len(out)}"):
        key = f"{name}_{len(out)}"
        out.append((key, getattr(mod, key)))
    return out


def _children(mod: nn.Module) -> List[Tuple[str, object]]:
    """``(flax name, port child)`` pairs; a child is a module or a Parameter."""
    if isinstance(mod, esr.DeepRecurrNet):
        return [("head", mod.head), ("feat_extract", mod.feat_extract),
                ("time_propagate", mod.time_propagate),
                ("spacetime_fuse", mod.spacetime_fuse), ("tail", mod.tail)]
    if isinstance(mod, esr.FeatsExtract):
        return [(f"ConvLayer_{i}", m) for i, m in enumerate(mod.layers)]
    if isinstance(mod, esr.TimePropagation):
        return [(f"pred_map_{i}", m) for i, m in enumerate(mod.pred_map)] + [
            ("local_res", mod.local_res), ("local_out", mod.local_out),
            ("gru", mod.gru), ("global_fusion", mod.global_fusion)]
    if isinstance(mod, esr.STFusion):
        def listed(name, mods):
            return [(f"{name}_{i}", m) for i, m in enumerate(mods)]

        return (listed("offset_conv", mod.offset_conv)
                + [("dcn_offset_mask", mod.dcn_offset_mask),
                   ("dcn_weight", mod.dcn_weight), ("dcn_bias", mod.dcn_bias)]
                + listed("post_dcn", mod.post_dcn)
                + [("spatial_kernel", mod.spatial_kernel),
                   ("channel_mlp", mod.channel_mlp)]
                + listed("dcn_fusion", mod.dcn_fusion)
                + listed("dense_fusion", mod.dense_fusion)
                + listed("atten", mod.atten) + listed("recon", mod.recon))
    if isinstance(mod, adapters.FrameRecurrentSR):
        return [("model", mod.model)]
    if isinstance(mod, unet.MultiResUNet):
        return (_numbered(mod, "encoder") + _numbered(mod, "res")
                + _numbered(mod, "decoder") + _numbered(mod, "pred"))
    if isinstance(mod, unet._RecurrentUNet):
        return ([("head", mod.head), ("encoders", mod.encoders)] + _numbered(mod, "res")
                + _numbered(mod, "decoder") + _numbered(mod, "skip_up")
                + [("pred", mod.pred)])
    if isinstance(mod, unet._RecurrentEncoderStack):
        return _numbered(mod, "encoder")
    if isinstance(mod, (layers.ConvLayer, layers.ConvLayer1D)):
        return [("Conv_0", mod.conv)] + _norms(mod.norm)
    if isinstance(mod, layers.TransposedConvLayer):
        return [("ConvTranspose_0", mod.conv)] + _norms(mod.norm)
    if isinstance(mod, layers.ResidualBlock):
        return [("Conv_0", mod.conv1), ("Conv_1", mod.conv2)] + _norms(mod.norm1, mod.norm2)
    if isinstance(mod, layers.TorchBatchNorm):
        return [("scale", mod.weight), ("bias", mod.bias), ("mean", mod.running_mean),
                ("var", mod.running_var)]
    if isinstance(mod, layers.TorchInstanceNorm):
        return [("mean", mod.running_mean), ("var", mod.running_var)]
    if isinstance(mod, layers.UpsampleConvLayer):
        return [("ConvLayer_0", mod.conv_layer)]
    if isinstance(mod, layers.RecurrentConvLayer):
        return [("ConvLayer_0", mod.conv_layer),
                (f"{type(mod.cell).__name__}_0", mod.cell)]
    if isinstance(mod, layers.ConvLSTMCell):
        return [("Conv_0", mod.gates)]
    if isinstance(mod, layers.ConvGRUCell):
        return [("update_gate", mod.update_gate), ("reset_gate", mod.reset_gate),
                ("out_gate", mod.out_gate)]
    if isinstance(mod, layers.MLP):
        return [(f"Dense_{i}", m) for i, m in enumerate(mod.layers)]
    if isinstance(mod, lpips.LPIPS):
        return [(mod.net, mod.trunk)] + [(f"lin{i}", p) for i, p in enumerate(mod.lins)]
    if isinstance(mod, (lpips._Trunk, lpips._Fire)):
        return list(mod.named_children())
    if isinstance(mod, extended.InceptionBlock):
        return [("Conv_0", mod.conv_0), ("Conv_1", mod.conv_1), ("Conv_2", mod.conv_2)]
    if isinstance(mod, extended.DilatedBlock):
        return [(name, getattr(mod, name)) for name in mod.names]
    if isinstance(mod, extended.SelfAttention):
        return [("qk", mod.qk), ("v", mod.v), ("trans", mod.trans),
                ("after_norm", mod.after_norm)]
    if isinstance(mod, (extended.Conv3DBlock, extended.Deconv3DBlock)):
        conv = "Conv_0" if isinstance(mod, extended.Conv3DBlock) else "ConvTranspose_0"
        norm = [] if mod.norm is None else [(f"{_FLAX_NORM[type(mod.norm)]}_0", mod.norm)]
        return [(conv, mod.conv)] + norm
    if isinstance(mod, extended.Conv3DBlock2):
        return [("Conv3DBlock_0", mod.block_0), ("Conv3DBlock_1", mod.block_1)]
    if isinstance(mod, extended.Deconv3DBlock2):
        return [("Deconv3DBlock_0", mod.deconv), ("Conv3DBlock_0", mod.block_0),
                ("Conv3DBlock_1", mod.block_1)]
    if isinstance(mod, extended.DenseEdgeConv):
        return [(f"mlp_{i}", m) for i, m in enumerate(mod.mlps)]
    if isinstance(mod, extended.GroupNormIN):
        return [("scale", mod.weight), ("bias", mod.bias)]
    if isinstance(mod, extended.MeanShift):
        return []
    if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                        nn.ConvTranspose3d, nn.Linear)):
        # a conv before BatchNorm has no bias
        return [("kernel", mod.weight)] + ([] if mod.bias is None else [("bias", mod.bias)])
    raise TypeError(f"no flax mapping for {type(mod).__name__}")


# the flax class name of each norm a 3D block of ``models.extended`` holds
_FLAX_NORM = {layers.TorchBatchNorm: "TorchBatchNorm", extended.GroupNormIN: "GroupNorm"}


def _norms(*norms) -> List[Tuple[str, object]]:
    """Each norm a layer has (None: no norm) under the reference's two
    names, ``_NormWrapper_i/<its class>_0``: the flax layer holds a
    ``_NormWrapper`` that holds the norm."""
    return [(f"_NormWrapper_{i}/{type(n).__name__}_0", n) for i, n in enumerate(norms)
            if n is not None]


def flax_leaves(mod: nn.Module, prefix: Tuple[str, ...] = ()) -> Iterator[
        Tuple[Tuple[str, ...], torch.Tensor, Optional[str]]]:
    """``(flax path, tensor, layout)`` for every leaf (a ``/`` in a name of
    :func:`_children` nests it), the path led by its
    collection (``params`` or, for a norm's running statistics,
    ``batch_stats``); ``layout`` is ``"kernel"`` for a conv or dense kernel,
    ``"transposed"`` for a transposed conv's (2D or 3D), and None for leaves stored in
    the flax layout (biases, ``dcn_weight``, the statistics)."""
    for name, child in _children(mod):
        if isinstance(child, nn.Parameter):
            layout = None
            if name == "kernel":
                layout = ("transposed" if isinstance(mod, (nn.ConvTranspose2d,
                                                             nn.ConvTranspose3d))
                          else "kernel")
            yield ("params",) + prefix + (name,), child, layout
        elif isinstance(child, torch.Tensor):
            yield ("batch_stats",) + prefix + (name,), child, None
        else:
            yield from flax_leaves(child, prefix + tuple(name.split("/")))


def _transpose(arr: np.ndarray, to_port: bool, layout: Optional[str]) -> np.ndarray:
    """Conv HWIO <-> OIHW (DHWIO <-> OIDHW in 3D), transposed conv HWIO <->
    IOHW flipped in space (and in 3D),
    1D conv ``[k, in, out]`` <-> ``[out, in, k]``, Dense ``[in, out]`` <->
    ``[out, in]``."""
    if layout is None:
        return arr
    if layout == "transposed":
        # the spatial axes lead: flip them, move in/out to the front
        sp = arr.ndim - 2
        flip = (slice(None, None, -1),) * sp
        if to_port:
            return arr[flip].transpose(sp, sp + 1, *range(sp))
        return arr.transpose(*range(2, 2 + sp), 0, 1)[flip]
    if arr.ndim == 5:
        return arr.transpose((4, 3, 0, 1, 2) if to_port else (2, 3, 4, 1, 0))
    if arr.ndim == 4:
        return arr.transpose((3, 2, 0, 1) if to_port else (2, 3, 1, 0))
    if arr.ndim == 3:
        return arr.transpose(2, 1, 0)
    if arr.ndim == 2:
        return arr.T
    return arr


def flatten_tree(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    """Nested dicts -> ``{path tuple: array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_tree(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _collections(tree: Dict) -> Dict:
    """``tree`` as ``{"params": ..., "batch_stats": ...}``: a bare parameter
    tree is the ``params`` collection."""
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        return tree
    return {"params": tree}


def load_flax_params(model: nn.Module, tree: Dict) -> int:
    """Copy the flax ``tree`` (a bare parameter tree, or ``{"params": ...}``
    with ``"batch_stats"`` for a model with norms) into ``model`` in place.
    Returns the number of leaves copied; raises ``ValueError`` on any
    missing, left-over or mis-shaped leaf (nothing is copied then)."""
    flat = flatten_tree(_collections(tree))
    wanted = list(flax_leaves(model))
    problems = []
    staged = []
    for path, param, layout in wanted:
        key = "/".join(path)
        if path not in flat:
            problems.append(f"missing: {key}")
            continue
        arr = _transpose(flat[path], True, layout)
        if tuple(arr.shape) != tuple(param.shape):
            problems.append(
                f"shape: {key} is {tuple(flat[path].shape)}, the port needs "
                f"{tuple(param.shape)}{' after transpose' if layout else ''}"
            )
            continue
        staged.append((param, arr))
    extra = set(flat) - {p for p, _, _ in wanted}
    problems += [f"left over: {'/'.join(p)}" for p in sorted(extra)]
    if problems:
        raise ValueError("flax parameter tree does not fit the model:\n  "
                         + "\n  ".join(problems))
    with torch.no_grad():
        for param, arr in staged:
            param.copy_(torch.from_numpy(np.array(arr, np.float32)))
    return len(staged)


def export_flax_params(model: nn.Module) -> Dict:
    """The model's parameters as a flax tree ``{"params": {...}}`` (and
    ``"batch_stats"`` for a model with norms) of f32 numpy arrays that own
    their memory (a CPU parameter is copied, not viewed)."""
    root: Dict = {"params": {}}
    for path, param, layout in flax_leaves(model):
        arr = param.detach().to("cpu", copy=True).numpy()
        node = root
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(_transpose(arr, False, layout))
    return root
