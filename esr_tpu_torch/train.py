"""Training entry point of the port (counterpart of the root ``train.py``):

    python -m esr_tpu_torch.train -c configs/train_esr_2x.yml -id run0
    python -m esr_tpu_torch.train -c cfg.yml -r <ckpt-dir>|auto [--reset]
    python -m esr_tpu_torch.train -c cfg.yml ... --device cpu
    python -m esr_tpu_torch.train -c cfg.yml --live-port 0 --profile-steps 2
    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m esr_tpu_torch.train -c cfg.yml -id run0 --multihost [--device cpu]

It trains on the CUDA card unless ``--device cpu`` asks for the CPU, and
prints the final train log as one JSON line. ``--multihost`` joins the
process group that ``torch.distributed.run`` describes in the environment
(``esr_tpu_torch.parallel.mesh``: NCCL, one card a process at
``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and trains data-parallel:
``train_dataloader.batch_size`` is per process, each process reads its own
rows of every global batch, the gradients are averaged across the group,
and only rank 0 writes the logs, telemetry and checkpoints and prints the
final line. Without ``-id`` the run id is rank 0's timestamp. ``--live-port PORT`` is
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
from datetime import datetime
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
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed.run process group (NCCL on cuda:"
                        "LOCAL_RANK, gloo with --device cpu) and train data-parallel")
    p.add_argument("--live-port", type=int, default=None, metavar="PORT",
                   help="serve live telemetry (/metrics, /healthz, /slo) on this port while "
                        "training (0 = ephemeral; default off): -o 'trainer;live_telemetry=PORT'")
    p.add_argument("--profile-steps", type=int, default=None, metavar="N",
                   help="torch.profiler trace of the first N iterations, stamped as a "
                        "profiler_capture event: -o 'trainer;profile_steps=N'")
    return p.parse_args(argv)


def run(args: argparse.Namespace, train_recordings=None, valid_recordings=None):
    """Train as the parsed command line says; returns ``(trainer,
    result)``. With ``--multihost`` the process group stays up (the caller
    leaves it: a captured group replays its collectives).
    ``train_recordings`` / ``valid_recordings`` (in-memory recordings)
    replace the datalists, as the trainer takes them. The run's
    ``RunConfig`` sets up the logging: the console and ``<log_dir>/info.txt``
    (rank 0 at INFO, the other ranks WARNING and above)."""
    # config shorthands: appended as overrides, so they land in the
    # effective config (and its fingerprint)
    if args.live_port is not None:
        args.override.append(f"trainer;live_telemetry={args.live_port}")
    if args.profile_steps is not None:
        args.override.append(f"trainer;profile_steps={args.profile_steps}")
    from esr_tpu_torch.config.parser import RunConfig
    from esr_tpu_torch.parallel import mesh
    from esr_tpu_torch.training.trainer import Trainer

    runid = args.runid
    if args.multihost:
        mesh.initialize_multihost(args.device)
        # one run directory for the group: rank 0's timestamp
        runid = mesh.broadcast_object(runid or datetime.now().strftime(r"%m%d_%H%M%S"))
    is_main = mesh.process_shard_info()[0] == 0
    config = RunConfig.from_args(args.config, overrides=args.override, runid=runid,
                                 resume=args.resume, reset=args.reset, seed=args.seed,
                                 is_main=is_main)
    trainer = Trainer(config, device=args.device, train_recordings=train_recordings,
                      valid_recordings=valid_recordings)
    return trainer, trainer.train()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, train, print the final train log (rank 0 alone under
    ``--multihost``)."""
    args = get_args(argv)
    trainer, result = run(args)
    if args.multihost:
        # a process that raised leaves the group to the launcher, which ends it
        from esr_tpu_torch.parallel import mesh

        mesh.destroy()
    if trainer.is_main:
        print(json.dumps({k: round(v, 6) for k, v in result.items()}))
    return result


if __name__ == "__main__":
    main()
