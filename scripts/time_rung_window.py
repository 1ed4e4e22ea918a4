#!/usr/bin/env python3
"""Time one flagship window through the sequential harness at a precision
rung on the card, for one checkout of the repository: the A/B yardstick of a
change to a rung's numerics (such as where the bf16 rung widens to f32).

    python scripts/time_rung_window.py [--root DIR] [--tag NAME]
        [--precision f32|bf16|int8] [--windows N]

``--root`` is the checkout whose ``esr_tpu_torch`` and ``chip_smoke.py`` are
imported (default: this one); run it once per checkout, in turns (parent,
change, change, parent), in one call on one card. It builds the dense
flagship of ``chip_smoke.py``'s precision phase (``flagship_model``, seeded
weights) and one seeded 720x1280 recording, and takes ``--windows`` readings
of ``chip_smoke.rung_window_profile`` (a warm window, then one under
``torch.profiler``, read as the union of its kernels' device intervals), then
the recording once through ``chip_smoke.rung_window_metrics`` (the harness's
per-window wall time, host clock to ``synchronize``). It prints one JSON
line: the card and its power limit, each reading's device ms and their
median, and the harness's window latency p50.
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
    p.add_argument("--precision", default="bf16")
    p.add_argument("--windows", type=int, default=5)
    args = p.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    import chip_smoke as cs
    from esr_tpu_torch.data.synthetic import make_synthetic_recording
    from esr_tpu_torch.device import resolve_device
    from esr_tpu_torch.inference.harness import InferenceRunner

    if not torch.cuda.is_available():
        print("time_rung_window: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    model = cs.flagship_model(torch, np, dcn_sparse=False).to(dev).eval()
    recording = make_synthetic_recording((720, 1280), base_events=80_000, num_frames=2,
                                         rungs=("down8", "down16"), seed=0)
    runner = InferenceRunner(model, 3, device=dev, precision=args.precision)
    busy = [cs.rung_window_profile(torch, runner, recording, dev, card)[0]
            for _ in range(args.windows)]
    lat = sorted(cs.rung_window_metrics(torch, runner, recording, dev)[2])
    print(json.dumps({
        "tag": args.tag, "root": str(args.root), "card": card, "precision": args.precision,
        "device_ms_per_window": busy, "device_ms_median": sorted(busy)[len(busy) // 2],
        "harness_windows": len(lat), "harness_p50_ms": round(lat[len(lat) // 2], 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
