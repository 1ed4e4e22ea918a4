"""One precision policy for evaluation, the engine and serving (a copy of
``esr_tpu/config/precision.py`` for the port, which imports nothing of the
JAX package).

Every entry point resolves the same spelling through the same precedence::

    explicit CLI flag  >  checkpoint config (``trainer.precision``)  >  f32

so a checkpoint trained at ``bf16`` evaluates and serves at ``bf16`` unless
the operator overrides it. ``int8`` is the serving rung (post-training
quantization, :mod:`esr_tpu_torch.config.quantize`); the trainer refuses it
and, in the port, ``bf16`` too (no oracle while the reference's bf16
backward is red).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

#: the config-level rungs: ``trainer.precision`` / ``--precision`` values
PRECISIONS = ("f32", "bf16", "int8")

# short/long spellings -> canonical rung; "w8a8" (8-bit weights, 8-bit
# activations) is the literature's name of the int8 rung
_PRECISION_ALIASES = {
    "f32": "f32",
    "fp32": "f32",
    "float32": "f32",
    "bf16": "bf16",
    "bfloat16": "bf16",
    "int8": "int8",
    "i8": "int8",
    "w8a8": "int8",
}

# short/long spellings -> numpy-parsable dtype name
_DTYPE_ALIASES = {
    "bf16": "bfloat16",
    "bfloat16": "bfloat16",
    "f16": "float16",
    "fp16": "float16",
    "half": "float16",
    "float16": "float16",
    "f32": "float32",
    "fp32": "float32",
    "float32": "float32",
    "f64": "float64",
    "fp64": "float64",
    "float64": "float64",
    "int8": "int8",
    "i8": "int8",
    "w8a8": "int8",
}

#: every spelling ``--precision`` accepts
PRECISION_SPELLINGS = tuple(sorted(_PRECISION_ALIASES))


def canonical_dtype(name: Any) -> str:
    """A dtype spelling -> its numpy-parsable name (``"bf16"`` ->
    ``"bfloat16"``); an unknown name raises ``ValueError``."""
    key = str(name).strip().lower()
    if key not in _DTYPE_ALIASES:
        raise ValueError(
            f"unknown dtype {name!r}; accepted spellings: "
            f"{sorted(set(_DTYPE_ALIASES))}"
        )
    return _DTYPE_ALIASES[key]


def canonical_precision(name: Any) -> str:
    """A precision spelling -> its rung (``f32``/``bf16``/``int8``)."""
    key = str(name).strip().lower()
    if key not in _PRECISION_ALIASES:
        raise ValueError(
            f"unknown precision {name!r}; supported rungs: {PRECISIONS}"
        )
    return _PRECISION_ALIASES[key]


def resolve_precision(
    cli: Optional[str] = None,
    config: Optional[str] = None,
    default: str = "f32",
) -> str:
    """One rung: CLI > checkpoint config > default. ``None`` defers to the
    next source; every spelling is validated, so a misspelled rung raises
    here rather than running f32 silently."""
    for source in (cli, config, default):
        if source is not None:
            return canonical_precision(source)
    return canonical_precision(default)


def compute_dtype_of(precision: Optional[str]) -> Optional[torch.dtype]:
    """The dtype params, states and inputs are cast to: ``None`` for f32
    (the program unchanged) and for int8 (quantization happens inside the
    contraction seams; everything between them stays f32), else
    ``torch.bfloat16``."""
    if precision is None:
        return None
    rung = canonical_precision(precision)
    if rung in ("f32", "int8"):
        return None
    return torch.bfloat16
