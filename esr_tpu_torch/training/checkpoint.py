"""Training checkpoints: save, find, resume (counterpart of
``esr_tpu/training/checkpoint.py``; the reference writes Orbax pytrees,
which the port cannot read until an exporter exists).

A checkpoint is a directory ``checkpoint-iteration{N}/`` (and, on a new
best, ``model_best_until_iteration{N}/``) holding

- ``params.npz`` and ``config.json``: the inference checkpoint
  (``esr_tpu_torch.inference.checkpoint``), so ``load_checkpoint`` and
  ``python -m esr_tpu_torch.infer`` read it as it is;
- ``optimizer.pt``: the optimizer state and its update count;
- ``digest.json``: sha256 of the saved state (:func:`host_state`, through
  ``resilience.recovery.state_digest``), which a validated restore
  (``recovery.restore_with_fallback``) recomputes;
- ``meta.json``: the commit marker (format, model/optimizer/scheduler
  names, iteration, ``monitor_best``), written last, temp-then-
  ``os.replace``, so a save cut short leaves a directory that
  :func:`find_latest_checkpoint` ignores.

A save is two parts: :func:`snapshot_state` copies the model's and the
optimizer's state into host memory the snapshot owns, and
:func:`commit_checkpoint` writes that host state. :func:`save_checkpoint`
runs both inline; ``training.async_checkpoint`` runs the commit on a
writer thread. The ``ckpt_commit`` fault site fires once per commit
attempt, keyed by the iteration: ``fail`` raises before a byte is
written, ``torn`` between the arrays and the marker (the trainer retries
the commit, ``trainer.commit_retries``).

Under data parallelism rank 0 writes the checkpoint and the other
processes wait for an inline commit at a barrier (``training.trainer``);
every process resumes from it.

Resume checks names as the reference does: another model name skips the
restore; another optimizer name restores the parameters only; ``reset``
(or another training mode) keeps the weights and restarts the trainer's
progress.
"""

from __future__ import annotations

import copy
import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from esr_tpu_torch.inference import checkpoint as inference_checkpoint
from esr_tpu_torch.models import convert
from esr_tpu_torch.training.optim import ScheduledOptimizer

logger = logging.getLogger(__name__)

CHECKPOINT_FORMAT = 1
META = "meta.json"


def _flatten_state(obj, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """Every leaf of a nested state (dicts in sorted key order, lists and
    tuples by index) as a host array; non-numeric leaves as the bytes of
    their ``repr``."""
    if isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _flatten_state(obj[k], f"{prefix}/{k}", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten_state(v, f"{prefix}/{i}", out)
    elif isinstance(obj, torch.Tensor):
        out[prefix] = obj.detach().cpu().numpy()
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix] = np.asarray(obj)
    else:
        out[prefix] = np.frombuffer(repr(obj).encode(), np.uint8)


def host_state(params: Dict, opt_state: Dict) -> Dict[str, np.ndarray]:
    """A checkpoint's state as one flat ``{key: host array}``: the flax
    parameter tree (``params/...``) and the optimizer state
    (``optimizer/...``), the input of ``recovery.state_digest``."""
    out = {"params/" + "/".join(k): np.asarray(v)
           for k, v in convert.flatten_tree(params).items()}
    _flatten_state(opt_state, "optimizer", out)
    return out


def restore_state(path: str) -> Dict[str, np.ndarray]:
    """The :func:`host_state` of a checkpoint directory, read from disk
    (raises on a torn or missing file)."""
    opt_state = torch.load(os.path.join(path, "optimizer.pt"), map_location="cpu")
    return host_state(inference_checkpoint.read_params(path), opt_state)


def host_copy(obj):
    """``obj`` (a nested state of dicts, lists and tensors) with every
    tensor copied to host memory of its own: PyTorch updates parameters
    and optimizer moments in place, and ``state_dict()`` holds the live
    tensors, not copies."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [host_copy(v) for v in obj]
    return copy.deepcopy(obj)


def snapshot_state(model: nn.Module, optimizer: ScheduledOptimizer) -> Tuple[Dict, Dict]:
    """``(params, opt_state)``: the flax parameter tree (numpy) and the
    optimizer's state dict, both in host memory that no later step
    touches. Blocks until the device's copies are done."""
    return convert.export_flax_params(model), host_copy(optimizer.state_dict())


def save_checkpoint(save_dir: str, model: nn.Module, optimizer: ScheduledOptimizer,
                    config: Dict, iteration: int, monitor_best: float,
                    training_mode: str = "iteration_based_train",
                    save_best: bool = False) -> str:
    """Write ``checkpoint-iteration{N}`` (and the best alias when asked)
    from the live model and optimizer; returns the last path written."""
    params, opt_state = snapshot_state(model, optimizer)
    return commit_checkpoint(save_dir, params, opt_state, config, iteration, monitor_best,
                             training_mode=training_mode, save_best=save_best)


def commit_checkpoint(save_dir: str, params: Dict, opt_state: Dict, config: Dict,
                      iteration: int, monitor_best: float,
                      training_mode: str = "iteration_based_train",
                      save_best: bool = False) -> str:
    """Write a :func:`snapshot_state` as ``checkpoint-iteration{N}`` (and
    the best alias when asked): the arrays, then the digest, then the
    marker. Returns the last path written."""
    from esr_tpu_torch.resilience import faults
    from esr_tpu_torch.resilience.recovery import state_digest, write_digest

    injected = faults.fire("ckpt_commit", iteration)
    for spec in injected:
        if spec.kind == "fail":
            raise faults.InjectedFault(spec)
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
    paths = [os.path.join(os.path.abspath(save_dir), n) for n in names]
    for path in paths:
        marker = os.path.join(path, META)
        if os.path.exists(marker):
            # re-saving an iteration: uncommit before any file changes
            os.remove(marker)
        inference_checkpoint.save_checkpoint(path, params, config)
        torch.save(opt_state, os.path.join(path, "optimizer.pt"))
    for spec in injected:
        if spec.kind == "torn":
            raise faults.InjectedFault(spec)
    # the digest of the state the arrays were written from, before the
    # marker: a committed checkpoint always carries it
    digest = state_digest(host_state(params, opt_state))
    for path in paths:
        marker = os.path.join(path, META)
        write_digest(path, digest)
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
