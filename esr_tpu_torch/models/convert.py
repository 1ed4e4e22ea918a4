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
models and the LPIPS module (``losses/lpips.py``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from esr_tpu_torch.losses import lpips
from esr_tpu_torch.models import adapters, esr, layers, unet


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
        return [("Conv_0", mod.conv)]
    if isinstance(mod, layers.TransposedConvLayer):
        return [("ConvTranspose_0", mod.conv)]
    if isinstance(mod, layers.ResidualBlock):
        return [("Conv_0", mod.conv1), ("Conv_1", mod.conv2)]
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
    if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
        return [("kernel", mod.weight), ("bias", mod.bias)]
    raise TypeError(f"no flax mapping for {type(mod).__name__}")


def _leaves(mod: nn.Module, prefix: Tuple[str, ...] = ()) -> Iterator[
        Tuple[Tuple[str, ...], nn.Parameter, Optional[str]]]:
    """``(flax path, parameter, layout)`` for every leaf; ``layout`` is
    ``"kernel"`` for a conv or dense kernel, ``"transposed"`` for a
    transposed conv's, and None for leaves stored in the flax layout
    (biases, ``dcn_weight``)."""
    for name, child in _children(mod):
        if isinstance(child, nn.Parameter):
            layout = None
            if name == "kernel":
                layout = "transposed" if isinstance(mod, nn.ConvTranspose2d) else "kernel"
            yield prefix + (name,), child, layout
        else:
            yield from _leaves(child, prefix + (name,))


def _transpose(arr: np.ndarray, to_port: bool, layout: Optional[str]) -> np.ndarray:
    """Conv HWIO <-> OIHW, transposed conv HWIO <-> IOHW flipped in space,
    1D conv ``[k, in, out]`` <-> ``[out, in, k]``, Dense ``[in, out]`` <->
    ``[out, in]``."""
    if layout is None:
        return arr
    if layout == "transposed":
        if to_port:
            return arr[::-1, ::-1].transpose(2, 3, 0, 1)
        return arr.transpose(2, 3, 0, 1)[::-1, ::-1]
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


def load_flax_params(model: nn.Module, tree: Dict) -> int:
    """Copy the flax parameter ``tree`` into ``model`` in place. Returns
    the number of leaves copied; raises ``ValueError`` on any missing,
    left-over or mis-shaped leaf (nothing is copied then)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = flatten_tree(tree)
    wanted = list(_leaves(model))
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
    """The model's parameters as a flax tree ``{"params": {...}}`` of numpy
    arrays that own their memory (a CPU parameter is copied, not viewed)."""
    root: Dict = {}
    for path, param, layout in _leaves(model):
        arr = param.detach().to("cpu", copy=True).numpy()
        node = root
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(_transpose(arr, False, layout))
    return {"params": root}
