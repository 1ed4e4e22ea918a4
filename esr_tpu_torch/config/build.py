"""Component construction from config blocks (counterpart of
``esr_tpu/config/build.py``): the model, the gated ExponentialLR schedule,
the optimizer, and the sequence loaders."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

from esr_tpu_torch.data.loader import ConcatSequenceDataset, SequenceLoader, read_datalist
from esr_tpu_torch.inference.checkpoint import build_model
from esr_tpu_torch.training.optim import ScheduledOptimizer, make_optimizer
from esr_tpu_torch.training.schedule import exponential_with_floor

LR_FLOOR = 1e-4  # the reference recipe's gate

__all__ = ["build_model", "build_lr_schedule", "build_optimizer", "build_train_loader"]


def build_lr_schedule(optimizer_cfg: Dict, scheduler_cfg: Optional[Dict],
                      lr_change_rate: Optional[int]) -> Callable[[int], float]:
    """The reference's gated ExponentialLR as a function of the step."""
    base_lr = float((optimizer_cfg.get("args") or {}).get("lr", 1e-3))
    if scheduler_cfg is None or lr_change_rate is None:
        return lambda step: base_lr
    name = scheduler_cfg["name"]
    if name != "ExponentialLR":
        raise KeyError(f"unknown lr_scheduler '{name}'")
    gamma = float((scheduler_cfg.get("args") or {}).get("gamma", 0.95))
    return exponential_with_floor(base_lr, gamma=gamma, change_rate=int(lr_change_rate),
                                  floor=LR_FLOOR)


def build_optimizer(optimizer_cfg: Dict, params: Iterable[torch.nn.Parameter],
                    scheduler_cfg: Optional[Dict] = None,
                    lr_change_rate: Optional[int] = None,
                    ) -> Tuple[ScheduledOptimizer, Callable[[int], float]]:
    """The optimizer over ``params`` and its schedule."""
    args = dict(optimizer_cfg.get("args") or {})
    schedule = build_lr_schedule(optimizer_cfg, scheduler_cfg, lr_change_rate)
    opt = make_optimizer(
        optimizer_cfg["name"], params, lr=schedule,
        weight_decay=float(args.get("weight_decay", 0.0)),
        amsgrad=bool(args.get("amsgrad", False)),
        betas=tuple(args.get("betas", (0.9, 0.999))),
        eps=float(args.get("eps", 1e-8)),
    )
    return opt, schedule


def build_train_loader(loader_cfg: Dict, seed: int = 0,
                       recordings: Optional[Sequence] = None, shard_id: int = 0,
                       num_shards: int = 1) -> SequenceLoader:
    """A ``train_dataloader``/``valid_dataloader`` block -> this process's
    loader (``shard_id`` of ``num_shards``; ``batch_size`` is per process).
    The recordings are the datalist's paths, or ``recordings`` (paths or
    in-memory recordings) when given. The reference schema's ``use_ddp`` is
    read and means nothing: sharding is always on, a no-op at one shard."""
    if recordings is None:
        recordings = read_datalist(loader_cfg["path_to_datalist_txt"])
    dataset = ConcatSequenceDataset(recordings, loader_cfg["dataset"])
    return SequenceLoader(
        dataset,
        batch_size=int(loader_cfg["batch_size"]),
        shuffle=bool(loader_cfg.get("shuffle", True)),
        drop_last=bool(loader_cfg.get("drop_last", True)),
        seed=seed,
        prefetch=int(loader_cfg.get("prefetch", 2)),
        num_workers=int(loader_cfg.get("num_workers", 0)),
        shard_id=shard_id,
        num_shards=num_shards,
    )
