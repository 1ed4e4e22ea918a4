#!/usr/bin/env python3
"""Time the int8 rung's two kernels on the card, for one checkout of the
repository: the A/B yardstick of a change to ``int8_conv`` (K1) or
``quantize_per_tensor`` (K2).

    python scripts/time_int8_kernels.py [--root DIR] [--tag NAME] [--alt-rows]

``--root`` is the checkout whose ``esr_tpu_torch`` and ``chip_smoke.py`` are
imported (default: this one); run it once per checkout, in turns (parent,
change, change, parent), in one call on one card. At every distinct seam
shape of one flagship window (``chip_smoke.int8_seam_calls``: the
flagship's seeded weights, a 90x160 window) at B=1 and at lanes 4, it
checks K1 and K2 bitwise against their plain versions, then times each
through its op two ways: eagerly over 200 back-to-back calls with CUDA
events (``op_ms``: the host's cost or the kernel's, whichever is longer)
and inside a CUDA graph of 20 calls, replayed (``device_ms``: the kernel's
own time, launch gaps included, no host). The window sums weigh each shape
by its calls a window. ``--alt-rows`` also times K1, at the seams whose
plan has no K split and one warp column, with the other count of 16-row
tiles a warp (``ConvPlan.mt``), so two row tilings of the large-M seams
are compared in one run. It prints one JSON line: the card and its power
limit, the window sums, ``ptxas``'s spill lines for the int8 source (when
this process built it) and each shape's times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def graph_ms(torch, time_ms, fn, n: int = 20) -> float:
    """Device time of one call of ``fn`` inside a CUDA graph of ``n`` calls
    (captured once, replayed)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    torch.cuda.synchronize()
    return time_ms(torch, graph.replay, iters=20, warmup=3) / n


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    p.add_argument("--tag", default="")
    p.add_argument("--alt-rows", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    import chip_smoke as cs
    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.ops import int8_cuda

    if not torch.cuda.is_available():
        print("time_int8_kernels: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    torch.manual_seed(0)
    model = cs.flagship_model(torch, np, dcn_sparse=False).to(dev).eval()
    rows = []
    sums = {}
    for batch in (1, cs.LANES):
        distinct = {}
        for mod, shape, cout, k, stride, pad in cs.int8_seam_calls(torch, model, dev, batch,
                                                                   90, 160):
            distinct.setdefault((shape, cout, k, stride, pad), [mod, 0])[1] += 1
        for (shape, cout, k, stride, pad), (mod, calls) in distinct.items():
            x = torch.randn(shape, device=dev)
            w = mod.weight.detach()
            packed = int8_cuda.pack_weight(w if w.dim() == 4 else w[:, :, None, None])
            bias = mod.bias.detach()
            xq, sx = int8_cuda.quantize_per_tensor(x)
            out = int8_cuda.int8_conv(xq, sx, packed, bias, stride, pad)
            pq, psx = int8_cuda.quantize_per_tensor_plain(x)
            ref = int8_cuda.int8_conv_plain(pq, psx, packed, bias, stride, pad)
            torch.cuda.synchronize()
            if not (torch.equal(xq, pq) and torch.equal(out.view(torch.int32),
                                                         ref.view(torch.int32))):
                print(f"time_int8_kernels: {shape} -> {cout} differs from the plain version",
                      file=sys.stderr)
                return 1

            def k1():
                int8_cuda.int8_conv(xq, sx, packed, bias, stride, pad)

            def k2():
                int8_cuda.quantize_per_tensor(x)
            row = {"batch": batch, "shape": list(shape), "cout": cout, "k": k,
                   "stride": stride, "calls": calls,
                   "k1_op_ms": cs.time_ms(torch, k1, iters=200),
                   "k1_device_ms": graph_ms(torch, cs.time_ms, k1),
                   "k2_op_ms": cs.time_ms(torch, k2, iters=200),
                   "k2_device_ms": graph_ms(torch, cs.time_ms, k2)}
            if args.alt_rows and hasattr(int8_cuda, "conv_plan"):
                b, _, h, wd = shape
                ho, wo = out.shape[2:]
                plan = int8_cuda.conv_plan(b * ho * wo, cout, packed.wq.shape[1], xq.shape[-1])
                if plan.split == 1 and plan.wm == 4:
                    alt = int8_cuda.ConvPlan(plan.wm, plan.wn, plan.nt, 1, plan.chunk,
                                             3 - plan.mt)
                    chosen = int8_cuda.conv_plan
                    int8_cuda.conv_plan = lambda *a: alt
                    try:
                        again = int8_cuda.int8_conv(xq, sx, packed, bias, stride, pad)
                        torch.cuda.synchronize()
                        if not torch.equal(again.view(torch.int32), ref.view(torch.int32)):
                            print(f"time_int8_kernels: {shape} -> {cout} at mt {alt.mt} differs",
                                  file=sys.stderr)
                            return 1
                        row["k1_mt"] = plan.mt
                        row["k1_alt_mt"] = alt.mt
                        row["k1_alt_device_ms"] = graph_ms(torch, cs.time_ms, k1)
                    finally:
                        int8_cuda.conv_plan = chosen
            rows.append(row)
            s = sums.setdefault(f"batch {batch}", {"k1_op_ms": 0.0, "k1_device_ms": 0.0,
                                                   "k2_op_ms": 0.0, "k2_device_ms": 0.0})
            for key in s:
                s[key] += calls * row[key]
    spills = [line.strip() for line in (int8_cuda.INT8_LIBRARY.build_log or "").splitlines()
              if "spill" in line]
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "window_ms": sums, "ptxas_spill_lines": spills, "shapes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
