#!/usr/bin/env python3
"""Export a checkpoint that ``esr_tpu`` trained to the format of the
PyTorch port (``esr_tpu_torch``):

    python scripts/export_torch_checkpoint.py <ckpt-dir> <out-dir>

``<ckpt-dir>`` is a committed ``checkpoint-iteration{N}/`` or
``model_best_until_iteration{N}/`` (Orbax ``state/`` plus the ``meta.yml``
commit marker). It is read through the reference's own
``esr_tpu.training.checkpoint.load_for_inference``; the model's variables
are kept (the ``params`` collection and, for a model with norms, the
``batch_stats`` running statistics), the optimizer state is not.
``<out-dir>`` receives ``params.npz`` (flax paths joined with ``/``, each
led by its collection) and ``config.json`` (``meta["config"]``), which
``esr_tpu_torch.inference.checkpoint.load_checkpoint`` and
``python -m esr_tpu_torch.infer --model_path <out-dir>`` read.

This script imports JAX and ``esr_tpu``; the port never imports it.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import Optional, Sequence

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def export(src: str, dst: str) -> str:
    """Write the port's checkpoint of ``src`` to ``dst``; returns ``dst``.
    Refuses a directory without the commit marker (a torn save)."""
    if not os.path.isfile(os.path.join(src, "meta.yml")):
        raise ValueError(f"{src} has no meta.yml commit marker: not a committed "
                         "esr_tpu checkpoint")
    import jax
    import numpy as np

    from esr_tpu.training.checkpoint import load_for_inference
    from esr_tpu_torch.inference.checkpoint import save_checkpoint

    _, params, config = load_for_inference(src)
    save_checkpoint(dst, jax.tree.map(np.asarray, jax.device_get(params)), config)
    return dst


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="committed esr_tpu checkpoint directory")
    p.add_argument("dst", help="output directory (params.npz + config.json)")
    args = p.parse_args(argv)
    out = export(args.src, args.dst)
    print(out)
    return out


if __name__ == "__main__":
    main()
