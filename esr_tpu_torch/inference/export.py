"""Model export: ``torch.export`` artifacts of the forward and of the
engine's chunk program (counterpart of ``esr_tpu/inference/export.py``).

The whole program is captured: the recurrent state threading, the metric
sums and the hand-written kernels, which are ``torch.library`` custom ops
(``ops/dcn_cuda.py``, ``ops/int8_cuda.py``) and stay ops in the graph, so an
artifact exported for ``cuda`` launches them when it runs and never the
plain version. Artifact layout:

- ``<path>``: ``torch.export.save`` of the program (``strict=False``; the
  loop over a chunk's windows unrolls, as the reference's scan fuses them);
- ``<path>.json``: the reference's sidecar keys, with its ``platforms``
  replaced by the port's ``device`` (``cuda`` or ``cpu``).

The reference's artifact takes ``params`` as an argument; the port's
carries the weights. A loader that is given the serving model puts that
model's own ``state_dict`` into the loaded program (``strict=True``) and
re-packs the int8 rung's weights from it
(``models.layers.repack_int8_buffers``), so an artifact never serves other
weights than the engine holds. The device is baked into the graph (the
chunk program makes its sums on ``reset_keep``'s device), so an artifact is
per device: one exported for ``cuda`` refuses to load for ``cpu`` and the
other way round. Loading passes through ``device.resolve_device``, which
sets the numerics policy in a process that only loads.

The rung is baked in at export (explicit argument > checkpoint
``trainer.precision`` > f32, as everywhere): a bf16 program runs a bf16
copy of the model on bf16 states, an int8 program runs its seams inside
``int8_scope()`` with the weights packed as buffers. The serving loader
refuses an artifact of another rung.
"""

from __future__ import annotations

import copy
import io
import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from esr_tpu_torch.config.precision import compute_dtype_of, resolve_precision
from esr_tpu_torch.device import DeviceLike, resolve_device
from esr_tpu_torch.inference.engine import ChunkProgram, lane_states
from esr_tpu_torch.models.layers import pack_int8_buffers, repack_int8_buffers

PROGRAMS = ("forward", "engine_chunk")
# the weights' prefix in each program's state_dict
_PREFIX = {"forward": "", "engine_chunk": "model."}


def _export_copy(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """The model to capture: a copy on ``device``, in eval mode, its weights
    needing no gradient (the DCN then takes the forward direction)."""
    return copy.deepcopy(model).to(device).eval().requires_grad_(False)


def _export(module: torch.nn.Module, args: Tuple) -> bytes:
    with torch.no_grad():
        program = torch.export.export(module, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _describe(tree) -> Dict:
    leaves, spec = pytree.tree_flatten(tree)
    return {
        "treedef": str(spec),
        "shapes": [list(t.shape) for t in leaves],
        "dtypes": [str(t.dtype).replace("torch.", "") for t in leaves],
    }


def _write_sidecar(path: str, sidecar: Dict) -> None:
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2, default=str)


def read_sidecar(path: str) -> Dict:
    """The ``<path>.json`` sidecar of an artifact (empty when absent)."""
    if not os.path.exists(path + ".json"):
        return {}
    with open(path + ".json") as f:
        return json.load(f)


def export_forward(model: torch.nn.Module, example_input: torch.Tensor,
                   example_states: Sequence[torch.Tensor],
                   device: DeviceLike = None) -> bytes:
    """Capture ``model(x, states) -> (y, states)`` on ``device`` (the card
    unless the CPU is asked for) and serialize it."""
    dev = resolve_device(device)
    model = _export_copy(model, dev)
    return _export(model, (example_input.to(dev), tuple(s.to(dev) for s in example_states)))


def _program_device(program) -> Optional[str]:
    """The device type of an exported program's weights and constants."""
    tensors = list(program.state_dict.values()) + [
        t for t in program.constants.values() if isinstance(t, torch.Tensor)]
    types = {t.device.type for t in tensors}
    if len(types) > 1:
        raise ValueError(f"exported program holds tensors on several devices: {types}")
    return types.pop() if types else None


def load_exported(data: bytes, device: DeviceLike = None,
                  model: Optional[torch.nn.Module] = None,
                  program: str = "forward") -> Callable:
    """Deserialize an artifact into a callable on ``device`` with the
    exported signature (``program``: ``forward`` or ``engine_chunk``).
    Given ``model``, the callable runs that model's weights (module
    docstring). Raises when the artifact was exported for another device."""
    dev = resolve_device(device)
    # the op namespace must exist before the graph is deserialized
    import esr_tpu_torch.ops.dcn_cuda  # noqa: F401
    import esr_tpu_torch.ops.int8_cuda  # noqa: F401

    exported = torch.export.load(io.BytesIO(data))
    got = _program_device(exported)
    if got is not None and got != dev.type:
        raise ValueError(f"artifact was exported for device {got!r}, asked to run on "
                         f"{dev.type!r}")
    module = exported.module()
    if model is not None:
        prefix = _PREFIX[program]
        module.load_state_dict({prefix + k: v for k, v in model.state_dict().items()},
                               strict=True)
        repack_int8_buffers(module)
    return module.requires_grad_(False)


def save_exported_model(path: str, model: torch.nn.Module, example_input: torch.Tensor,
                        example_states: Sequence[torch.Tensor],
                        config: Optional[Dict] = None, device: DeviceLike = None) -> str:
    """Export the forward to ``path`` (+ the ``path.json`` sidecar).
    Returns ``path``."""
    dev = resolve_device(device)
    blob = export_forward(model, example_input, example_states, dev)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
    _write_sidecar(path, {
        "model": type(model).__name__,
        "program": "forward",
        "config": config or {},
        "device": dev.type,
        "input": _describe(example_input),
        "states": _describe(tuple(example_states)),
    })
    return path


def load_exported_model(path: str, device: DeviceLike = None,
                        model: Optional[torch.nn.Module] = None) -> Tuple[Callable, Dict]:
    """``(callable, sidecar)`` of an artifact written by
    :func:`save_exported_model` or :func:`export_checkpoint`. The sidecar's
    device is checked before anything is loaded: an artifact exported for
    ``cuda`` refuses ``cpu`` and the other way round. Given ``model``, the
    callable runs that model's weights."""
    sidecar = read_sidecar(path)
    dev = resolve_device(device)
    want = sidecar.get("device")
    if want is not None and want != dev.type:
        raise ValueError(f"artifact {path} was exported for device {want!r}, asked to "
                         f"load for {dev.type!r} (export one per device)")
    with open(path, "rb") as f:
        fn = load_exported(f.read(), dev, model, sidecar.get("program") or "forward")
    return fn, sidecar


def export_chunk_program(model: torch.nn.Module, lanes: int, chunk_windows: int,
                         gt_hw: Tuple[int, int], inp_hw: Optional[Tuple[int, int]] = None,
                         lr_hw: Optional[Tuple[int, int]] = None, seqn: int = 3,
                         precision: Optional[str] = None,
                         device: DeviceLike = None) -> bytes:
    """Capture the engine's chunk program (:class:`~esr_tpu_torch.inference
    .engine.ChunkProgram`) at ``lanes`` x ``chunk_windows`` on the ``gt_hw``
    grid, the rung baked in, and serialize it: the artifact the serving tier
    loads (``serving/server.py``). Its signature is ``(states, reset_keep,
    windows) -> (states, sums, stacked)`` with ``windows`` the engine's
    ``{"inp_scaled": (W, B, seqn, ih, iw, c), "gt": (W, B, kh, kw, c),
    "inp_mid": (W, B, lh, lw, c), "valid": (W, B)}``. ``inp_hw`` and
    ``lr_hw`` default to the GT grid, as in the reference."""
    dev = resolve_device(device)
    kh, kw = gt_hw
    ih, iw = inp_hw if inp_hw is not None else gt_hw
    lh, lw = lr_hw if lr_hw is not None else gt_hw
    w_, b = int(chunk_windows), int(lanes)
    rung = resolve_precision(cli=precision)
    compute_dtype = compute_dtype_of(rung)
    model = _export_copy(model, dev)
    if rung == "int8":
        pack_int8_buffers(model)
    inch = int(getattr(model, "inch", 2))
    windows = {
        "inp_scaled": torch.zeros((w_, b, seqn, ih, iw, inch), device=dev),
        "gt": torch.zeros((w_, b, kh, kw, inch), device=dev),
        "inp_mid": torch.zeros((w_, b, lh, lw, inch), device=dev),
        "valid": torch.zeros((w_, b), device=dev),
    }
    # the states' dtype is part of the signature: the serving tier's at
    # this rung
    states = lane_states(model, b, kh, kw, dev, compute_dtype)
    reset_keep = torch.zeros((b,), device=dev)
    program = ChunkProgram(model, b, w_, kh, kw, compute_dtype, rung)
    return _export(program, (states, reset_keep, windows))


def export_checkpoint(ckpt_path: str, out_path: str, batch: int = 1, height: int = 64,
                      width: int = 64, program: str = "forward", chunk_windows: int = 8,
                      scale: int = 2, precision: Optional[str] = None,
                      device: DeviceLike = None) -> str:
    """Checkpoint directory (``inference/checkpoint.py``) -> artifact at the
    given geometry, on ``device`` (the card unless the CPU is asked for).

    ``program``: ``"forward"`` (one forward at batch ``batch``) or
    ``"engine_chunk"`` (the chunk program at ``batch`` lanes x
    ``chunk_windows`` windows on a ``(height, width)`` GT grid with an LR
    grid of ``(height // scale, width // scale)``: the serving tier's
    artifact, one per request-class depth). The sidecar records the
    program, the device and, for chunk programs, the geometry and the rung
    the serving loader checks."""
    if program not in PROGRAMS:
        raise ValueError(f"unknown program {program!r} (forward | engine_chunk)")
    from esr_tpu_torch.inference.checkpoint import load_checkpoint

    model, config = load_checkpoint(ckpt_path)
    dev = resolve_device(device)
    seqn = int(config.get("model", {}).get("args", {}).get("num_frame", 3))
    inch = int(getattr(model, "inch", 2))
    precision = resolve_precision(cli=precision,
                                  config=(config.get("trainer") or {}).get("precision"))
    if program == "engine_chunk":
        blob = export_chunk_program(
            model, lanes=batch, chunk_windows=chunk_windows, gt_hw=(height, width),
            lr_hw=(height // scale, width // scale), seqn=seqn, precision=precision,
            device=dev)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "wb") as f:
            f.write(blob)
        _write_sidecar(out_path, {
            "model": type(model).__name__,
            "program": "engine_chunk",
            "config": config,
            "device": dev.type,
            "lanes": int(batch),
            "chunk_windows": int(chunk_windows),
            "gt_hw": [height, width],
            "lr_hw": [height // scale, width // scale],
            "seqn": seqn,
            "precision": precision,
        })
        return out_path
    x = torch.zeros((batch, seqn, height, width, inch))
    states = model.init_states(batch, height, width)
    return save_exported_model(out_path, model, x, states, config=config, device=dev)
