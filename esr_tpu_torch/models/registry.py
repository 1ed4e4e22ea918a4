"""Model registry: config name -> model class or factory (counterpart of
``esr_tpu/models/registry.py``), the same seven names.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch.nn as nn

from esr_tpu_torch.models.adapters import srunet_recurrent_seq, unet_recurrent_seq
from esr_tpu_torch.models.esr import DeepRecurrNet
from esr_tpu_torch.models.unet import MultiResUNet, SRUNetRecurrent, UNetFlow, UNetRecurrent

MODEL_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "DeepRecurrNet": DeepRecurrNet,
    "UNetFlow": UNetFlow,
    "UNetRecurrent": UNetRecurrent,
    "MultiResUNet": MultiResUNet,
    "SRUNetRecurrent": SRUNetRecurrent,
    # windowed-trainer peers (the same YAML and trainer as DeepRecurrNet)
    "SRUNetRecurrentSeq": srunet_recurrent_seq,
    "UNetRecurrentSeq": unet_recurrent_seq,
}


def get_model(name: str, **kwargs) -> nn.Module:
    """Instantiate a registered model by config name. An argument the model
    does not take (a UNet given ``dcn_sparse`` or ``numerics``) raises the
    constructor's ``TypeError``, the kind the reference's dataclasses raise."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; registered: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)

