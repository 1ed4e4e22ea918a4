#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s card-against-CPU window of the SR recipe
(phase 8d: ``configs/train_srunet_2x.yml`` trained 3 steps at batch 8 on
the card, then one full-width window at B=1 on the card and on the CPU, the
output and every gradient of its MSE) from the same trained weights, with
the CPU side at several intra-op thread counts, and print each side's
distance from the same window on the CPU in f64 every time.

    python scripts/srunet_card_vs_cpu.py [--repeats 10] [--threads 1,4,0]

``--threads`` lists the CPU side's thread counts (0: the process's
default); each repeat runs the card once and the CPU at every count. One
JSON line at the end: the card and its power limit, the host's CPU, and
per thread count the distances from f64 of each repeat.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--threads", default="1,4,0")
    args = p.parse_args()
    repo = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(repo))

    import numpy as np
    import torch

    import chip_smoke as cs
    from esr_tpu_torch.device import resolve_device

    if not torch.cuda.is_available():
        print("srunet_card_vs_cpu: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    default = torch.get_num_threads()
    counts = [int(t) or default for t in args.threads.split(",")]
    train_recs, valid_recs, _ = cs.srunet_recordings(np, cs.training_recordings(np))
    with tempfile.TemporaryDirectory(prefix="srunet_c10_") as out:
        _, trainer = cs.srunet_trainer(dev, repo, out, (train_recs, valid_recs), 3)
        trainer.train()
        sel = trainer._select(next(iter(trainer.train_loader)))
        runs = {str(t): [] for t in counts}
        f64 = None
        for i in range(args.repeats):
            for t in counts:
                print(f"repeat {i}, CPU at {t} threads")
                try:
                    d = cs.srunet_card_vs_cpu(torch, trainer, sel, cpu_threads=t, f64=f64)
                    f64 = d.pop("f64")
                    d["ok"] = True
                except SystemExit:
                    d = {"ok": False}
                runs[str(t)].append(d)
    print(json.dumps({"card": card, "cpu": cs.cpu_identity(), "default_threads": default,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
