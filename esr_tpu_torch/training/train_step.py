"""The train and eval steps: BPTT over overlapping event windows
(counterpart of ``esr_tpu/training/train_step.py:make_train_step`` and
``make_eval_step``, at f32: the port has no bf16 training rung). Device
rasterization (:func:`make_device_rasterizer`) turns a raw-event batch into
the dense batch below before the step.

A batch is ``{"inp": [B, L, H, W, C], "gt": [B, L, H, W, C]}`` on the
model's device. The ConvGRU states start at zero for every batch; window
``i`` runs the model on ``inp[:, i:i+seqn]`` carrying the states, and its
loss is the MSE against ``gt[:, i + mid]`` (``mid = (seqn - 1) // 2``). The
train loss is the sum over the ``L - seqn + 1`` windows, with one backward
and one optimizer update per batch, as the reference's loop does.

``remat`` (the counterpart of ``jax.checkpoint`` over the window forward)
runs each window's forward under ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``: the window keeps only its inputs, and the backward
recomputes the forward (on the card the DCN's train forward runs twice per
window) to the same bits; the recompute runs under
``models.layers.recomputing``, so the norms' running statistics are
updated once a window, by the forward, as the reference's pure
``jax.checkpoint`` updates them. ``numerics`` collects the model's probe taps
(a model built with ``numerics=True``) over the step's windows, plus
``loss`` and ``grad_norm`` taps, as ``metrics["numerics"]`` (``{tag:
f32[NSTATS]}`` on the device); the probes observe detached copies, so the
losses, gradients and parameters are the same bits with them off.

Data parallelism (``parallel.mesh``): with a process group up, each
process runs the step on its rows of the global batch; after the backward
the gradients are averaged across the group in one all-reduce, before the
grad norm and the optimizer, and the per-window losses (so ``loss``) are
averaged too, and the probes' stats merged, so every metric is the global
batch's, as the reference's step returns it. Without a group the step
launches no collective. Under tensor parallelism (``parallel.tensor
.make_tp_train_step``) the mean and the metrics are taken over the data
group alone (``group``), and the grad norm counts each shard of a
parameter split over the model group (``sharded``, ``model_group``) once.

The train step is capture-safe (``training.multistep`` replays ``k`` of
them as one CUDA graph): it reads no value back to the host, and
``zero_grad`` sets the grads to ``None``, so each step's backward
allocates them afresh (from the graph's pool under a capture), as
PyTorch's whole-network capture does. :func:`make_fused_eval_accum` is the
eval step that adds its scalars into device sums, the body of fused
validation.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from esr_tpu_torch.models.layers import recomputing
from esr_tpu_torch.ops.encodings import make_device_encoder
from esr_tpu_torch.ops.numerics import collect, flatten_probes, merge_stat_vectors, tensor_stats
from esr_tpu_torch.parallel.mesh import gather_merge, is_distributed, mean_gradients, reduce_mean
from esr_tpu_torch.training.optim import ScheduledOptimizer


def _remat_contexts():
    """The forward's context and the recompute's (``checkpoint``'s
    ``context_fn``)."""
    return contextlib.nullcontext(), recomputing()


def make_device_rasterizer(gt_resolution: Tuple[int, int]) -> Callable[[Dict], Dict]:
    """The train side's name for :func:`esr_tpu_torch.ops.encodings
    .make_device_encoder`: raw-event batches on the device -> ``{"inp",
    "gt"}`` count images, bitwise the host's."""
    return make_device_encoder(gt_resolution)


def window_losses(model: nn.Module, batch: Dict[str, torch.Tensor], seqn: int,
                  remat: bool = False):
    """Per-window MSE ``[Wc]`` and the last window's prediction; ``remat``
    recomputes each window's forward in the backward."""
    inp, gt = batch["inp"], batch["gt"]
    b, length, h, w, _ = inp.shape
    mid = (seqn - 1) // 2
    states = model.init_states(b, h, w, device=inp.device)
    losses = []
    pred = None
    for i in range(length - seqn + 1):
        if remat:
            # the model draws no random numbers: no RNG state to stash
            pred, states = checkpoint(model, inp[:, i:i + seqn], states,
                                      use_reentrant=False, preserve_rng_state=False,
                                      context_fn=_remat_contexts)
        else:
            pred, states = model(inp[:, i:i + seqn], states)
        losses.append(((pred - gt[:, i + mid]) ** 2).mean())
    return torch.stack(losses), pred


def global_norm(tensors, sharded: Sequence[bool] = (), group=None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors (``optax.global_norm``).
    ``sharded`` flags the tensors that are this process's shard of a tensor
    split over ``group``: their squares are summed over the group, once; the
    others are the same on every process of it and count once. The flags
    are known when the step is built, so nothing is read back to the host."""
    tensors = list(tensors)
    if not any(sharded):
        return torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(t) for t in tensors]))
    shards = torch.stack([t.square().sum() for t, s in zip(tensors, sharded) if s]).sum()
    if is_distributed():
        dist.all_reduce(shards, group=group)
    rest = [t.square().sum() for t, s in zip(tensors, sharded) if not s]
    return torch.sqrt(torch.stack(rest).sum() + shards if rest else shards)


def make_train_step(model: nn.Module, optimizer: ScheduledOptimizer, seqn: int = 3,
                    remat: bool = False, numerics: bool = False, group=None,
                    sharded: Sequence[torch.Tensor] = (), model_group=None,
                    ) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """``metrics = train_step(batch)``: one BPTT update of ``model`` in place.
    ``metrics``: ``loss`` (the window sum), ``loss_per_window``,
    ``grad_norm`` (the global norm of the raw grads, before weight decay)
    and ``last_pred``, all detached tensors on the device, and with
    ``numerics`` the probes' ``{tag: stats}`` (module docstring).
    ``group`` (None: the world) takes the gradients' and the losses' mean;
    ``sharded`` lists the parameters that are shards over ``model_group``
    (tensor parallelism), for the grad norm."""
    params = [p for p in model.parameters() if p.requires_grad]
    shard_ids = {id(p) for p in sharded}
    shard_flags = [id(p) in shard_ids for p in params]

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        if numerics:
            # the forward only: a remat recompute in the backward runs
            # outside the block and records nothing twice
            with collect() as sown:
                losses, pred = window_losses(model, batch, seqn, remat)
        else:
            losses, pred = window_losses(model, batch, seqn, remat)
        losses.sum().backward()
        # the group's mean gradient (nothing without a group)
        mean_gradients(params, group)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grad_norm = global_norm(grads, shard_flags, model_group)
        optimizer.step()
        losses = reduce_mean(losses.detach(), group)
        metrics = {"loss": losses.sum(), "loss_per_window": losses,
                   "grad_norm": grad_norm, "last_pred": pred.detach()}
        if numerics:
            probes = gather_merge(flatten_probes(sown), merge_stat_vectors)
            metrics["numerics"] = {**probes, "loss": tensor_stats(losses),
                                   "grad_norm": tensor_stats(grad_norm)}
        return metrics

    return train_step


def make_eval_step(model: nn.Module, seqn: int = 3) -> Callable[[Dict], Dict]:
    """``metrics = eval_step(batch)`` under ``torch.no_grad()``:
    ``valid_loss`` (the window sum) and ``valid_mse_loss`` (the last
    window's MSE)."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        losses, _ = window_losses(model, batch, seqn)
        return {"valid_loss": losses.sum(), "valid_mse_loss": losses[-1]}

    return eval_step


def make_fused_eval_accum(model: nn.Module, seqn: int = 3) -> Callable:
    """``accum(sums, batch) -> sums``: the eval step on ``batch`` adding its
    ``valid_loss`` and ``valid_mse_loss`` into ``sums`` (a dict of device
    scalars, updated in place) and 1 into ``sums["count"]`` (counterpart of
    the reference's ``make_fused_eval_accum``; chained through
    ``training.multistep.make_multi_step`` for fused validation)."""
    eval_step = make_eval_step(model, seqn)

    def accum(sums: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        out = eval_step(batch)
        sums["valid_loss"].add_(out["valid_loss"])
        sums["valid_mse_loss"].add_(out["valid_mse_loss"])
        sums["count"].add_(1.0)
        return sums

    return accum
