#!/usr/bin/env python3
"""Time the port's kernel wrappers on the card, for one checkout of the
repository: the A/B yardstick of a change to the wrappers' host path (such
as registering the kernels as ``torch.library`` custom ops).

    python scripts/time_port_wrappers.py [--root DIR] [--tag NAME] [--iters N]

``--root`` is the checkout whose ``esr_tpu_torch`` and ``chip_smoke.py`` are
imported (default: this one); run it once per checkout, in turns (parent,
change, change, parent), in one call on one card. At the shapes of the main
paths it times each wrapper over ``--iters`` back-to-back calls with CUDA
events (host-bound at these sizes, so the time is the wrapper's host cost
or the kernel's, whichever is longer): ``dcn_fwd`` at B=1 (evaluation),
``dcn_fwd_masked`` at B=4 with every image active (the engine's and
serving's lanes), ``int8_conv`` at the bottleneck seam 240 x 64 x 1152 and
``quantize_per_tensor`` on its [1, 128, 12, 20] input (the int8 rung). It
prints one JSON line: the card and its power limit and ms a call of each.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    p.add_argument("--tag", default="")
    p.add_argument("--iters", type=int, default=2000)
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    import chip_smoke as cs
    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.ops import dcn_cuda, int8_cuda

    if not torch.cuda.is_available():
        print("time_port_wrappers: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    b1 = cs.dcn_inputs(torch, rng, 1, 12, 20, 64, 64, 8)
    b4 = cs.dcn_inputs(torch, rng, 4, 12, 20, 64, 64, 8)
    tm = torch.ones(4, device=dev)
    x = torch.randn(1, 128, 12, 20, device=dev)
    packed = int8_cuda.pack_weight(torch.randn(64, 128, 3, 3, device=dev) * 0.05)
    bias = torch.randn(64, device=dev)
    xq, sx = int8_cuda.quantize_per_tensor(x)
    calls = {
        "dcn_fwd_b1": lambda: dcn_cuda.dcn_fwd(**b1),
        "dcn_fwd_masked_b4": lambda: dcn_cuda.dcn_fwd_masked(**b4, tile_mask=tm),
        "int8_conv_240x64x1152": lambda: int8_cuda.int8_conv(xq, sx, packed, bias, 1, 1),
        "quantize_per_tensor_1x128x12x20": lambda: int8_cuda.quantize_per_tensor(x),
    }
    out = {name: cs.time_ms(torch, fn, iters=args.iters, warmup=50)
           for name, fn in calls.items()}
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "ms": {k: round(v, 5) for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
