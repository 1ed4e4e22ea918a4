"""The port's checkpoint: a directory holding

- ``params.npz``: the flax parameter tree, one array per leaf, keyed by the
  flax path joined with ``/`` (``params/head/Conv_0/kernel``), in the flax
  layouts (HWIO convs, ``[in, out]`` dense);
- ``config.json``: the training config; ``model.name`` and ``model.args``
  build the model, as in the reference's checkpoints.

A training checkpoint (``esr_tpu_torch.training.checkpoint``) adds the
optimizer state and its commit marker beside these two; this module reads
either.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch.nn as nn

from esr_tpu_torch.models import convert
from esr_tpu_torch.models.registry import get_model


def build_model(model_config: Dict) -> nn.Module:
    """``{"name": <a registered model>, "args": {...}}`` -> the port's model
    (``models.registry``)."""
    return get_model(model_config.get("name"), **(model_config.get("args") or {}))


def save_checkpoint(path: str, params: Dict, config: Dict) -> None:
    """Write ``params`` (a flax tree of arrays) and ``config``."""
    os.makedirs(path, exist_ok=True)
    flat = convert.flatten_tree(params)
    np.savez(os.path.join(path, "params.npz"),
             **{"/".join(k): v for k, v in flat.items()})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=1)


def read_params(path: str) -> Dict:
    """The flax tree of ``params.npz`` in a checkpoint directory."""
    tree: Dict = {}
    with np.load(os.path.join(path, "params.npz")) as npz:
        for key in npz.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = npz[key]
    return tree


def load_checkpoint(path: str) -> Tuple[nn.Module, Dict]:
    """Rebuild ``(model, config)`` from a checkpoint directory (CPU
    parameters; the caller moves the model to its device)."""
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    model = build_model(config["model"])
    convert.load_flax_params(model, read_params(path))
    return model, config
