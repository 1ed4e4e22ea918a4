"""Device resolution and the f32 numerics policy of the port.

Every entry point of ``esr_tpu_torch`` runs on the CUDA card unless the
caller asks for the CPU by name. There is no silent fallback: asking for
``cuda`` on a machine without a card raises.

The f32 policy: cuDNN convolutions and cuBLAS matmuls would otherwise be
allowed to round their operands to TF32 (about three decimal digits). The
reference contracts at ``Precision.HIGHEST``, so the port turns TF32 off.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def apply_f32_policy() -> None:
    """Keep f32 convolutions and matmuls in full f32 (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises when a card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "esr_tpu_torch: no CUDA device is available; pass "
                "device='cpu' explicitly to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s} (use 'cuda' or 'cpu')")
    apply_f32_policy()
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
