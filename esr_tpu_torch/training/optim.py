"""Optimizers (counterpart of ``esr_tpu/training/optim.py``).

The reference's recipe is ``torch.optim.Adam(lr=1e-3, weight_decay=1e-4,
amsgrad=True)``; its optax chain (``scale_by_amsgrad_torch``) copies that
optimizer's semantics (the running max over the uncorrected second moment,
weight decay as L2 added to the gradient), so the port uses it as it is.
``AdamW`` (decoupled decay) and ``SGD`` (L2 decay, no momentum) are
``torch.optim``'s, as ``make_optimizer`` builds them in the reference.

:class:`ScheduledOptimizer` sets the lr from the schedule before each
update. The optax count is the number of updates already made, so update
``i`` (0-based) uses ``schedule(i)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Union

import torch


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer driven by an lr schedule of the step."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]):
        self.optimizer = optimizer
        self.schedule = schedule
        self.count = 0

    @property
    def lr(self) -> float:
        """The lr the next update will use."""
        return self.schedule(self.count)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.lr
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def make_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    lr: Union[float, Callable[[int], float]] = 1e-3,
    weight_decay: float = 0.0,
    amsgrad: bool = True,
    betas: Sequence[float] = (0.9, 0.999),
    eps: float = 1e-8,
) -> ScheduledOptimizer:
    schedule = lr if callable(lr) else (lambda step: float(lr))
    lr0 = schedule(0)
    if name == "Adam":
        opt = torch.optim.Adam(params, lr=lr0, betas=tuple(betas), eps=eps,
                               weight_decay=weight_decay, amsgrad=amsgrad)
    elif name == "AdamW":
        opt = torch.optim.AdamW(params, lr=lr0, betas=tuple(betas), eps=eps,
                                weight_decay=weight_decay, amsgrad=amsgrad)
    elif name == "SGD":
        opt = torch.optim.SGD(params, lr=lr0, weight_decay=weight_decay)
    else:
        raise KeyError(f"unknown optimizer '{name}'")
    return ScheduledOptimizer(opt, schedule)
