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
window) to the same bits. ``numerics`` collects the model's probe taps
(a model built with ``numerics=True``) over the step's windows, plus
``loss`` and ``grad_norm`` taps, as ``metrics["numerics"]`` (``{tag:
f32[NSTATS]}`` on the device); the probes observe detached copies, so the
losses, gradients and parameters are the same bits with them off.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from esr_tpu_torch.ops.encodings import make_device_encoder
from esr_tpu_torch.ops.numerics import collect, flatten_probes, tensor_stats
from esr_tpu_torch.training.optim import ScheduledOptimizer


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
                                      use_reentrant=False, preserve_rng_state=False)
        else:
            pred, states = model(inp[:, i:i + seqn], states)
        losses.append(((pred - gt[:, i + mid]) ** 2).mean())
    return torch.stack(losses), pred


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors (``optax.global_norm``)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def make_train_step(model: nn.Module, optimizer: ScheduledOptimizer, seqn: int = 3,
                    remat: bool = False, numerics: bool = False,
                    ) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """``metrics = train_step(batch)``: one BPTT update of ``model`` in place.
    ``metrics``: ``loss`` (the window sum), ``loss_per_window``,
    ``grad_norm`` (the global norm of the raw grads, before weight decay)
    and ``last_pred``, all detached tensors on the device, and with
    ``numerics`` the probes' ``{tag: stats}`` (module docstring)."""
    params = [p for p in model.parameters() if p.requires_grad]

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
        loss = losses.sum()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grad_norm = global_norm(grads)
        optimizer.step()
        metrics = {"loss": loss.detach(), "loss_per_window": losses.detach(),
                   "grad_norm": grad_norm, "last_pred": pred.detach()}
        if numerics:
            metrics["numerics"] = {**flatten_probes(sown), "loss": tensor_stats(losses),
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
