"""Data parallelism over ``torch.distributed`` (counterpart of
``esr_tpu/parallel/mesh.py``).

The reference shards the batch over a mesh's ``'data'`` axis and lets XLA
insert the collectives. The port has a process group instead: one process a
card (``cuda:LOCAL_RANK``, NCCL) or, when the caller asks for the CPU, one
process a share of the host (gloo). Each process holds a replica of the
model and the optimizer, reads its own rows of every batch
(``data.loader.ShardedSampler``'s ``shard_id`` / ``num_shards``: the global
batch is ``batch_size x world``) and, after the backward, takes the mean of
the gradients across the group, so every replica makes the same update.

- :func:`initialize_multihost` joins the group from the ``torchrun``
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``); a second call is a no-op.
- :func:`process_shard_info` is ``(rank, world)``, ``(0, 1)`` without a
  group.
- :func:`stage_batch`: the process's rows to its device.
- :func:`mean_gradients`: one coalesced all-reduce of every gradient, in
  the parameters' order, divided by the group's size (the world, or the
  ``group`` given: tensor parallelism's data group, ``parallel.tensor``).
- :func:`all_reduce_sum`: a differentiable sum across the group (its
  backward is the same sum of the cotangents), for BatchNorm's global batch
  moments (``models.layers``).
- :func:`reduce_mean` / :func:`gather_merge`: the step's scalars and the
  numerics probes' stats as the whole group's (``reduce_mean`` over a
  ``group`` when one is given).
- :func:`agree`: every process's value gathered and compared; a
  disagreement raises on every process.

**Without a group every function is the identity and launches nothing**, so
a single process runs today's step to the same bits. With a group of one,
``all_reduce`` and the division by 1 are exact, so ``train --multihost`` at
world 1 is the same bits as without it. On the card a collective is issued
on the current stream, so a CUDA graph captures it like any kernel
(``training.multistep`` runs the gradient all-reduce inside the captured
group); the warm-up before a capture has run it once.

The reference's ``honor_platform_env`` steers JAX's platform choice and has
no counterpart here.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

# the group's collectives time out after this (a peer that died leaves the
# others in a collective; the launcher then kills the group)
DEFAULT_TIMEOUT_S = 600.0


def is_distributed() -> bool:
    """A process group is up."""
    return dist.is_available() and dist.is_initialized()


def process_shard_info() -> Tuple[int, int]:
    """``(shard_id, num_shards)`` for the per-process loader: the rank and
    the world size, ``(0, 1)`` without a group."""
    if not is_distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def world_size() -> int:
    return process_shard_info()[1]


def local_rank() -> int:
    """``LOCAL_RANK`` of the launcher (0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_multihost(device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S
                         ) -> Tuple[int, int]:
    """Join the process group that ``torchrun`` (``python -m
    torch.distributed.run``) describes in the environment: NCCL on
    ``cuda:LOCAL_RANK`` (made the current device), gloo when ``device`` is
    ``cpu``. Idempotent: with a group up it returns its ``(rank, world)``.
    Raises when the launcher's variables are missing, or when the card is
    asked for and absent."""
    if is_distributed():
        return process_shard_info()
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--multihost needs the launcher's environment ({', '.join(missing)} unset); "
            "start it with python -m torch.distributed.run --nproc_per_node N -m "
            "esr_tpu_torch.train ... --multihost")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("esr_tpu_torch: --multihost on cuda, but no CUDA device is "
                               "available; pass --device cpu for a gloo group")
        torch.cuda.set_device(local_rank())
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return process_shard_info()


def local_device(device: torch.device) -> torch.device:
    """The process's device: ``cuda:LOCAL_RANK`` for a card under a group,
    else ``device`` as it is."""
    if device.type == "cuda" and is_distributed() and device.index is None:
        return torch.device("cuda", local_rank())
    return device


def destroy() -> None:
    """Leave the group (nothing without one)."""
    if is_distributed():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every process (nothing without a group)."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def stage_batch(batch: Dict[str, torch.Tensor], device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """The process's rows of a batch (``{key: (B, ...)}``, already its
    shard: the sampler deals them) on its device. A full ``k_steps`` group
    is staged batch by batch into the captured group's slots
    (``training.multistep``), so no megabatch is staged whole."""
    return {k: v.to(device) for k, v in batch.items()}


def mean_gradients(params: Sequence[torch.nn.Parameter], group=None) -> None:
    """Every process's gradients replaced by their mean across ``group``
    (None: the world), in place: one all-reduce of the gradients flattened
    in ``params``' order (a parameter without a gradient is left out, the
    same ones on every process), then divided by the group's size. Nothing
    without a process group."""
    if not is_distributed():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


class _AllReduceSum(torch.autograd.Function):
    """``y = sum over the group of x``; the cotangent of ``x`` is the sum
    over the group of the cotangents of ``y`` (every process's loss depends
    on every process's ``x``)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the group, differentiable; ``x`` itself
    without a group."""
    if not is_distributed():
        return x
    return _AllReduceSum.apply(x)


def reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (None: the world), a new tensor (no
    gradient); ``x`` itself without a process group."""
    if not is_distributed():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y.div_(dist.get_world_size(group))


def gather_merge(stats: Dict[str, torch.Tensor], merge) -> Dict[str, torch.Tensor]:
    """``{tag: vector}`` of every process, gathered in one collective and
    folded in rank order by ``merge(acc, new)`` (the numerics probes'
    :func:`~esr_tpu_torch.ops.numerics.merge_stat_vectors`). The dict as it
    is without a group."""
    if not is_distributed() or not stats:
        return stats
    tags = list(stats)
    mine = torch.stack([stats[t] for t in tags])
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    acc = parts[0]
    for part in parts[1:]:
        acc = merge(acc, part)
    return {t: acc[i] for i, t in enumerate(tags)}


def all_gather_objects(value: Any) -> List[Any]:
    """Every process's ``value`` (picklable), in rank order; ``[value]``
    without a group."""
    if not is_distributed():
        return [value]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def broadcast_object(value: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``value`` on every process; ``value`` without a
    group."""
    if not is_distributed():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def agree(value: Any, what: str) -> Any:
    """Gather every process's ``value`` and raise on every process when
    they differ (a one-way broadcast could not fail on its source).
    Returns ``value``."""
    values = all_gather_objects(value)
    if any(v != values[0] for v in values[1:]):
        raise RuntimeError(f"the processes disagree on {what}: "
                           + ", ".join(f"rank {r}: {v!r}" for r, v in enumerate(values)))
    return value

