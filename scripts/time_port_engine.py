#!/usr/bin/env python3
"""Time the port's streaming engine on the card, for one checkout of the
repository: the A/B yardstick of a change that touches the engine's host
path (such as its ``DevicePrefetcher``).

    python scripts/time_port_engine.py [--root DIR] [--tag NAME] [--runs N]
        [--precision f32|bf16|int8] [--eager]

``--root`` is the checkout whose ``esr_tpu_torch`` and ``chip_smoke.py`` are
imported (default: this one); run it once per checkout, in turns (parent,
change, change, parent), in one call on one card. It drives what
``chip_smoke.py``'s engine phase drives: the sparse flagship
(``flagship_model``, seeded weights) at lanes 4 x chunk 8 over the same six
seeded 720x1280 recordings, at the rung ``--precision`` (f32 by default),
one warm run, then ``--runs`` timed runs of the whole datalist (host clock
to ``synchronize``). It prints one JSON line:
the card and its power limit, windows/s of each run and their median, and
the chunks' dispatch-to-readback p50. On the card a checkout with
``GraphedChunk`` (``inference/engine.py``) runs its chunk as a CUDA graph;
``--eager`` swaps in the eager ``ChunkProgram`` after the warm run (the
path before the graph, and what a checkout without it runs anyway), so
graphed and eager are timed in turns in one call, with the key ``chunk``
naming what ran.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    p.add_argument("--tag", default="")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--precision", default="f32")
    p.add_argument("--eager", action="store_true")
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    import chip_smoke as cs
    from esr_tpu_torch.data.synthetic import make_synthetic_recording
    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.inference.engine import StreamingEngine

    if not torch.cuda.is_available():
        print("time_port_engine: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    recs = [make_synthetic_recording((720, 1280), base_events=ev, num_frames=2,
                                     rungs=("down8", "down16"), seed=30 + i, name=f"engine{i}")
            for i, ev in enumerate((120_000, 200_000, 80_000, 160_000, 100_000, 140_000))]
    model = cs.flagship_model(torch, np, dcn_sparse=True)
    engine = StreamingEngine(model, 3, lanes=cs.LANES, chunk_windows=cs.CHUNK_WINDOWS,
                             precision=args.precision, device=dev)
    engine.run_datalist(recs[:1], cs.FLAGSHIP_DATA)  # warm: cuDNN picks its algorithms
    torch.cuda.synchronize()
    program = getattr(engine._run_chunk, "program", None)
    if args.eager and program is not None:
        engine._run_chunk = program
    chunk = "graphed" if getattr(engine._run_chunk, "program", None) is not None else "eager"
    rates, p50s = [], []
    for _ in range(args.runs):
        engine.chunk_seconds.clear()
        t0 = time.perf_counter()
        results, _ = engine.run_datalist(recs, cs.FLAGSHIP_DATA)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates.append(sum(int(r["n_windows"]) for r in results) / wall)
        chunk_ms = sorted(s * 1e3 for s in engine.chunk_seconds)
        p50s.append(chunk_ms[len(chunk_ms) // 2])
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "precision": args.precision, "chunk": chunk,
                      "windows_per_sec": [round(r, 3) for r in rates],
                      "median_windows_per_sec": round(sorted(rates)[len(rates) // 2], 3),
                      "chunk_p50_ms": [round(v, 3) for v in p50s]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
