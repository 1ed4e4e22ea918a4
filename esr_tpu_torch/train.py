"""Training entry point of the port (counterpart of the root ``train.py``):

    python -m esr_tpu_torch.train -c configs/train_esr_2x.yml -id run0
    python -m esr_tpu_torch.train -c cfg.yml -r <ckpt-dir>|auto [--reset]
    python -m esr_tpu_torch.train -c cfg.yml ... --device cpu

It trains on the CUDA card unless ``--device cpu`` asks for the CPU, and
prints the final train log as one JSON line. Trainer keys that ask for
what is not ported raise, naming the override that turns them off
(``esr_tpu_torch.training.trainer``).
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
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, log_to_file: bool = False) -> dict:
    """Parse ``argv``, train, print the final train log. ``log_to_file``
    (the command line's choice) sends the log to the console and to
    ``<log_dir>/info.txt``."""
    args = get_args(argv)
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
