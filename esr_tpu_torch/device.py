"""Device resolution and the numerics policy of the port.

Every entry point of ``esr_tpu_torch`` runs on the CUDA card unless the
caller asks for the CPU by name. There is no silent fallback: asking for
``cuda`` on a machine without a card raises.

The numerics policy (:func:`apply_numerics_policy`, applied by
:func:`resolve_device`, which every entry point passes):

- **f32 means f32.** cuDNN convolutions and cuBLAS matmuls would otherwise
  round their operands to TF32 (about three decimal digits); the reference
  contracts at ``Precision.HIGHEST``, so TF32 is off. cuBLAS's
  reduced-precision reduction of bf16 products is off too, so the bf16
  rung accumulates in f32 as the reference's seams do.
- **Run to run, the same bits.** ``torch.use_deterministic_algorithms(True)``:
  cuDNN and cuBLAS pick deterministic algorithms, and an op with no
  deterministic implementation raises rather than run. cuBLAS needs
  ``CUBLAS_WORKSPACE_CONFIG`` before its first handle exists, so it is set
  here (if the caller has not). The port's own kernels are deterministic by
  construction (``csrc/dcn_train.cu``, "Determinism"); the bilinear
  upsampling's backward is a matrix product (``models/layers.py``). Memory
  from ``torch.empty`` is not filled: every kernel writes all its outputs.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def apply_numerics_policy() -> None:
    """Full-f32 contractions (no TF32), f32 accumulation of bf16 matmuls,
    deterministic algorithms (module docstring)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


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
    apply_numerics_policy()
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
