"""Training entry point of the port (counterpart of the root ``train.py``):

    python -m esr_tpu_torch.train -c configs/train_esr_2x.yml -id run0
    python -m esr_tpu_torch.train -c cfg.yml -r <ckpt-dir>|auto [--reset]
    python -m esr_tpu_torch.train -c cfg.yml ... --device cpu
    python -m esr_tpu_torch.train -c cfg.yml --live-port 0 --profile-steps 2

It trains on the CUDA card unless ``--device cpu`` asks for the CPU, and
prints the final train log as one JSON line. ``--live-port PORT`` is
``-o "trainer;live_telemetry=PORT"`` (0 an ephemeral port: ``/metrics``,
``/healthz``, ``/slo`` and ``/snapshot`` during the run, the bound port in
the ``live_telemetry`` event of ``telemetry.jsonl``), ``--profile-steps
N`` is ``-o "trainer;profile_steps=N"`` (a ``torch.profiler`` trace of
the first N steps under ``<log_dir>/profile``). What each trainer key
does, and which keys are refused, is in
``esr_tpu_torch.training.trainer``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional, Sequence


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="ESR training (PyTorch/CUDA port)")
    p.add_argument("-c", "--config", required=True, help="YAML config path")
    p.add_argument("-id", "--runid", default=None, help="run id (default: timestamp)")
    p.add_argument("-seed", "--seed", default=123, type=int)
    p.add_argument("-r", "--resume", default=None,
                   help="checkpoint dir to resume, or 'auto' for the newest")
    p.add_argument("--reset", action="store_true",
                   help="on resume, restore weights but reset trainer progress")
    p.add_argument("-o", "--override", action="append", default=[],
                   metavar="key;path=value",
                   help="config override by semicolon key path (repeatable)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--live-port", type=int, default=None, metavar="PORT",
                   help="serve live telemetry (/metrics, /healthz, /slo) on this port while "
                        "training (0 = ephemeral; default off): -o 'trainer;live_telemetry=PORT'")
    p.add_argument("--profile-steps", type=int, default=None, metavar="N",
                   help="torch.profiler trace of the first N iterations, stamped as a "
                        "profiler_capture event: -o 'trainer;profile_steps=N'")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, log_to_file: bool = False) -> dict:
    """Parse ``argv``, train, print the final train log. ``log_to_file``
    (the command line's choice) sends the log to the console and to
    ``<log_dir>/info.txt``."""
    args = get_args(argv)
    # config shorthands: appended as overrides, so they land in the
    # effective config (and its fingerprint)
    if args.live_port is not None:
        args.override.append(f"trainer;live_telemetry={args.live_port}")
    if args.profile_steps is not None:
        args.override.append(f"trainer;profile_steps={args.profile_steps}")
    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.training.trainer import Trainer

    run = RunConfig.from_args(args.config, overrides=args.override, runid=args.runid,
                              resume=args.resume, reset=args.reset, seed=args.seed)
    if log_to_file:
        logging.basicConfig(level=logging.INFO, format="%(message)s", handlers=[
            logging.StreamHandler(),
            logging.FileHandler(os.path.join(run.log_dir, "info.txt"))])
    result = Trainer(run, device=args.device).train()
    print(json.dumps({k: round(v, 6) for k, v in result.items()}))
    return result


if __name__ == "__main__":
    main(log_to_file=True)
