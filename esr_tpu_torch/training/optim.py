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

On the card Adam and AdamW take their capturable form (``capturable=True``:
the step counts are device tensors, and the lr is one device tensor that
each update reads), so that a CUDA graph of ``k`` updates
(``training.multistep``) and the eager loop do the same arithmetic: an
eager update writes the schedule's lr into the device tensor, an update
under capture copies it from the static vector the graph is fed
(:meth:`ScheduledOptimizer.feeding`). On the CPU the optimizers are as
before, the lr a Python float.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, List, Sequence, Union

import torch


class ScheduledOptimizer:
    """A ``torch.optim`` optimizer driven by an lr schedule of the step.
    ``lr_tensor``: the device lr of the capturable form (module docstring),
    else ``None``. ``generation`` counts the restores that rebound the
    optimizer's state tensors (a captured graph holds them by address)."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                 lr_tensor: torch.Tensor = None):
        self.optimizer = optimizer
        self.schedule = schedule
        self.count = 0
        self.lr_tensor = lr_tensor
        self.generation = 0
        self._feed = None

    @property
    def capturable(self) -> bool:
        return self.lr_tensor is not None

    @property
    def lr(self) -> float:
        """The lr the next update will use."""
        return self.schedule(self.count)

    def group_lrs(self, k: int) -> List[float]:
        """The lrs of the next ``k`` updates."""
        return [self.schedule(self.count + j) for j in range(k)]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    @contextlib.contextmanager
    def feeding(self, lrs: Sequence[torch.Tensor]):
        """Under a CUDA graph capture: update ``j`` copies ``lrs[j]`` (a
        device scalar) into the lr tensor and leaves ``count`` alone; each
        replay then advances it (:meth:`advance`)."""
        if not self.capturable:
            raise ValueError("feeding the lr from the device needs the capturable form")
        self._feed = iter(lrs)
        try:
            yield
        finally:
            self._feed = None

    def advance(self, k: int) -> None:
        """Count ``k`` updates made by a replayed graph."""
        self.count += int(k)

    def step(self) -> None:
        if self._feed is not None:
            self.lr_tensor.copy_(next(self._feed))
            self.optimizer.step()
            return
        lr = self.lr
        if self.lr_tensor is not None:
            self.lr_tensor.fill_(lr)
        else:
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.count += 1

    def state_dict(self) -> Dict:
        state = self.optimizer.state_dict()
        if self.capturable:
            # the checkpoint's form is the CPU's: a float lr, not capturable
            last = self.schedule(max(self.count - 1, 0))
            state["param_groups"] = [dict(g, lr=last, capturable=False)
                                     for g in state["param_groups"]]
        return {"optimizer": state, "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])
        if self.capturable:
            # back to this optimizer's form: the device lr, device step counts
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_tensor
                group["capturable"] = True
                for p in group["params"]:
                    st = self.optimizer.state.get(p)
                    if st and "step" in st:
                        st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
        self.generation += 1


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
    params = list(params)
    lr0 = schedule(0)
    # the capturable form on the card (module docstring)
    cuda = bool(params) and params[0].device.type == "cuda"
    lr_tensor = (torch.tensor(lr0, dtype=torch.float32, device=params[0].device)
                 if cuda and name in ("Adam", "AdamW") else None)
    adam_kw = dict(lr=lr0 if lr_tensor is None else lr_tensor, betas=tuple(betas), eps=eps,
                   weight_decay=weight_decay, amsgrad=amsgrad, capturable=cuda)
    if name == "Adam":
        opt = torch.optim.Adam(params, **adam_kw)
    elif name == "AdamW":
        opt = torch.optim.AdamW(params, **adam_kw)
    elif name == "SGD":
        opt = torch.optim.SGD(params, lr=lr0, weight_decay=weight_decay)
    else:
        raise KeyError(f"unknown optimizer '{name}'")
    if lr_tensor is not None:
        # the very tensor each update reads, whatever the constructor kept
        for group in opt.param_groups:
            group["lr"] = lr_tensor
    return ScheduledOptimizer(opt, schedule, lr_tensor)
