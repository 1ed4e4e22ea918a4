"""Training checkpoints: save, find, resume (counterpart of
``esr_tpu/training/checkpoint.py``; the reference writes Orbax pytrees,
which the port cannot read until an exporter exists).

A checkpoint is a directory ``checkpoint-iteration{N}/`` (and, on a new
best, ``model_best_until_iteration{N}/``) holding

- ``params.npz`` and ``config.json``: the inference checkpoint
  (``esr_tpu_torch.inference.checkpoint``), so ``load_checkpoint`` and
  ``python -m esr_tpu_torch.infer`` read it as it is;
- ``optimizer.pt``: the optimizer state and its update count;
- ``meta.json``: the commit marker (format, model/optimizer/scheduler
  names, iteration, ``monitor_best``), written last, temp-then-
  ``os.replace``, so a save cut short leaves a directory that
  :func:`find_latest_checkpoint` ignores.

Resume checks names as the reference does: another model name skips the
restore; another optimizer name restores the parameters only; ``reset``
(or another training mode) keeps the weights and restarts the trainer's
progress.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from esr_tpu_torch.inference import checkpoint as inference_checkpoint
from esr_tpu_torch.models import convert
from esr_tpu_torch.training.optim import ScheduledOptimizer

logger = logging.getLogger(__name__)

CHECKPOINT_FORMAT = 1
META = "meta.json"


def save_checkpoint(save_dir: str, model: nn.Module, optimizer: ScheduledOptimizer,
                    config: Dict, iteration: int, monitor_best: float,
                    training_mode: str = "iteration_based_train",
                    save_best: bool = False) -> str:
    """Write ``checkpoint-iteration{N}`` (and the best alias when asked);
    returns the last path written."""
    meta = {
        "format": CHECKPOINT_FORMAT,
        "model": {"name": config["model"]["name"]},
        "optimizer": {"name": config["optimizer"]["name"]},
        "lr_scheduler": {"name": (config.get("lr_scheduler") or {}).get("name")},
        "trainer": {"training_mode": training_mode, "iteration": int(iteration),
                    "monitor_best": float(monitor_best)},
    }
    names = [f"checkpoint-iteration{iteration}"]
    if save_best:
        names.append(f"model_best_until_iteration{iteration}")
    params = convert.export_flax_params(model)
    opt_state = optimizer.state_dict()
    paths = [os.path.join(os.path.abspath(save_dir), n) for n in names]
    for path in paths:
        marker = os.path.join(path, META)
        if os.path.exists(marker):
            # re-saving an iteration: uncommit before any file changes
            os.remove(marker)
        inference_checkpoint.save_checkpoint(path, params, config)
        torch.save(opt_state, os.path.join(path, "optimizer.pt"))
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, marker)
        logger.info("Saved checkpoint: %s", path)
    return paths[-1]


def read_meta(path: str) -> Dict:
    with open(os.path.join(path, META)) as f:
        return json.load(f)


def find_committed_checkpoints(root: str) -> List[str]:
    """Every committed ``checkpoint-iteration{N}`` under ``root`` (searched
    recursively), newest marker first (iteration as tie-break). A directory
    without a marker, or with one that does not parse, is skipped."""
    found = []
    for dirpath, dirnames, _ in os.walk(root):
        matched = [d for d in dirnames if d.startswith("checkpoint-iteration")]
        dirnames[:] = [d for d in dirnames
                       if not d.startswith(("checkpoint-iteration", "model_best_until"))]
        for d in matched:
            try:
                it = int(d[len("checkpoint-iteration"):])
            except ValueError:
                continue
            path = os.path.join(dirpath, d)
            marker = os.path.join(path, META)
            if not os.path.exists(marker):
                continue
            try:
                doc = read_meta(path)
                if not isinstance(doc, dict) or "model" not in doc:
                    raise ValueError("not a checkpoint meta mapping")
            except (OSError, ValueError) as e:
                logger.error("checkpoint %s has a corrupt %s (%r); treating it as "
                             "uncommitted", path, META, e)
                continue
            found.append(((os.path.getmtime(marker), it), path))
    found.sort(reverse=True)
    return [path for _, path in found]


def find_latest_checkpoint(root: str) -> Optional[str]:
    """The most recently committed checkpoint under ``root``, or None."""
    committed = find_committed_checkpoints(root)
    return committed[0] if committed else None


def resume_checkpoint(path: str, model: nn.Module, optimizer: ScheduledOptimizer,
                      config: Dict, reset: bool = False,
                      training_mode: str = "iteration_based_train",
                      ) -> Tuple[int, Optional[float]]:
    """Name-checked resume into ``model`` and ``optimizer`` in place.
    Returns ``(start_iteration, monitor_best)``; ``monitor_best`` is None
    when the trainer's progress was not restored."""
    meta = read_meta(path)
    if meta.get("format") != CHECKPOINT_FORMAT:
        raise ValueError(f"checkpoint {path} has format {meta.get('format')}, "
                         f"this build reads {CHECKPOINT_FORMAT}")
    if meta["model"]["name"] != config["model"]["name"]:
        logger.warning("Checkpoint model %r != configured %r; not resuming.",
                       meta["model"]["name"], config["model"]["name"])
        return 0, None
    convert.load_flax_params(model, inference_checkpoint.read_params(path))
    if meta["optimizer"]["name"] != config["optimizer"]["name"]:
        logger.warning("Checkpoint optimizer %r != configured %r; restoring params "
                       "only.", meta["optimizer"]["name"], config["optimizer"]["name"])
    else:
        device = next(model.parameters()).device
        optimizer.load_state_dict(torch.load(os.path.join(path, "optimizer.pt"),
                                             map_location=device))
    trainer_meta = meta.get("trainer", {})
    if reset or trainer_meta.get("training_mode") != training_mode:
        # as in the reference, the optimizer keeps its own update count
        logger.info("Checkpoint loaded; trainer progress reset.")
        return 0, None
    start = int(trainer_meta.get("iteration", 0)) + 1
    best = float(trainer_meta.get("monitor_best", float("inf")))
    logger.info("Checkpoint loaded; resuming from iteration %d (best=%g).", start, best)
    return start, best
