"""K-step training as one super-step (counterpart of
``esr_tpu/training/multistep.py``), and the CUDA graph it runs as.

``make_multi_step(step, k)`` wraps a port step ``metrics = step(batch)``
(state updated in place: the model's parameters and the optimizer's
moments) into a super-step ``metrics = multi_step(megabatch)`` where:

- the **megabatch** is the ``k`` per-step batches stacked on a new leading
  axis (``{key: (k, B, L, ...)}``, :func:`esr_tpu_torch.data.loader
  .collate_megabatch`), or the batches put one at a time into their slots
  (:meth:`MultiStep.load`), as the trainer does;
- metrics come back stacked on a leading ``k`` axis (``loss [k]``,
  ``loss_per_window [k, Wc]``, ``grad_norm [k]``, each probe tag ``[k,
  NSTATS]``); ``last_pred`` is the final step's only;
- ``reuse_batch=True`` feeds one batch (no ``k`` axis) to every step, the
  bench mode.

On the CPU the super-step is a plain loop over the leading axis. On CUDA it
is a **captured super-step**: the ``k`` chained steps are one
``torch.cuda.CUDAGraph``, replayed for each full group. Its inputs are static
slots of ``(k, B, ...)`` that each staged batch is copied into, its metrics
static outputs read back once a group. The first call runs the ``k`` steps
eagerly from the slots (the warm-up: the optimizer's state, cuDNN's and
cuBLAS's handles come to exist), and the second captures (capturing runs
nothing) and replays. With a :class:`~esr_tpu_torch.training.optim
.ScheduledOptimizer` the group's ``k`` learning rates are copied into a
static device vector before each replay, and a restore that rebinds the
optimizer's state (``load_state_dict``, its ``generation``) makes the next
call the warm-up again and the one after capture again: a restored state
may lack the moments (a run-start snapshot), and the optimizer would
create them inside the capture, so that every replay zeroed them.
A capture or replay that fails raises; nothing runs eagerly in its place.
Under data parallelism (``parallel.mesh``) the step's collectives (the
gradient all-reduce, the metrics', BatchNorm's moments) run in the warm-up
and are captured with the rest, so each replay issues them again.

:class:`GraphedCall` is the graph itself, shared with fused validation
(``training.trainer``) and the streaming engine's chunk
(``inference.engine``). The kernels' launch counters (``ops.dcn_cuda``,
``ops.int8_cuda``) count in Python where a wrapper launches; a capture
launches nothing, so it takes back what its wrappers counted and each
replay adds it again: the counts are the launches captured times the
replays, what the card ran.

:func:`instrument_dispatch` wraps a step or super-step so each call is the
attribution's ``dispatch`` span (``obs.spans``), as the reference wraps a
compiled call.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from esr_tpu_torch.obs import trace


def launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launch count, by name."""
    from esr_tpu_torch.ops import dcn_cuda, int8_cuda

    return {k.name: k.launches for k in dcn_cuda.KERNELS + int8_cuda.KERNELS}


def _add_launches(delta: Dict[str, int], sign: int = 1) -> None:
    from esr_tpu_torch.ops import dcn_cuda, int8_cuda

    for k in dcn_cuda.KERNELS + int8_cuda.KERNELS:
        k.launches += sign * delta.get(k.name, 0)


class GraphedCall:
    """``fn()`` captured once as a CUDA graph and replayed.

    ``fn`` reads static inputs and returns its outputs (any nesting of
    dicts, lists and tuples of tensors), which stay static: each replay
    writes the same tensors. The capture runs in ``thread_local`` mode, so
    the loader's and the telemetry's threads may use the card meanwhile.
    ``launches`` is what the capture's kernel wrappers counted, added to
    their counters by each replay."""

    def __init__(self, fn: Callable, device: torch.device):
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.device(device):
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.out = fn()
        after = launch_counts()
        self.launches = {n: c - before[n] for n, c in after.items() if c != before[n]}
        # the capture launched nothing on the card
        _add_launches(self.launches, -1)
        self.replays = 0

    def replay(self):
        self.graph.replay()
        _add_launches(self.launches)
        self.replays += 1
        return self.out


def _stack(metrics: List[Dict]) -> Dict:
    """Per-step metric dicts stacked on a leading axis; ``last_pred`` the
    final step's; nested dicts (the probes' tags) stacked per key."""
    if not metrics or not metrics[0]:
        return {}
    out = {}
    for key, value in metrics[0].items():
        if key == "last_pred":
            out[key] = metrics[-1][key]
        elif isinstance(value, dict):
            out[key] = {t: torch.stack([m[key][t] for m in metrics]) for t in value}
        else:
            out[key] = torch.stack([m[key] for m in metrics])
    return out


class MultiStep:
    """The super-step of :func:`make_multi_step` (module docstring)."""

    def __init__(self, step: Callable, k: int, reuse_batch: bool = False,
                 optimizer=None):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.step = step
        self.k = int(k)
        self.reuse_batch = bool(reuse_batch)
        self.optimizer = optimizer
        self._slots: Optional[Dict[str, torch.Tensor]] = None
        self._host: List = [None] * self.n_slots
        self._lrs: Optional[torch.Tensor] = None
        self._graph: Optional[GraphedCall] = None
        # the optimizer's generation the warm-up ran at (a token without one)
        self._warm_key = None

    @property
    def n_slots(self) -> int:
        return 1 if self.reuse_batch else self.k

    @property
    def graph(self) -> Optional[GraphedCall]:
        """The captured super-step, once there is one."""
        return self._graph

    def release(self) -> None:
        """Drop the graph (and its memory pool); the next call on the card
        captures again."""
        self._graph = None

    def _check(self, megabatch: Dict[str, torch.Tensor]) -> None:
        for key, leaf in megabatch.items():
            shape = tuple(getattr(leaf, "shape", ()))
            if shape[:1] != (self.k,):
                raise ValueError(f"megabatch leaf {key!r} has shape {shape}; expected "
                                 f"leading axis {self.k} (one slice per chained step)")

    def load(self, j: int, batch: Dict[str, torch.Tensor]) -> None:
        """Put step ``j``'s batch in its slot: on CUDA a copy into the
        static ``(k, B, ...)`` input (allocated at the first load), on the
        CPU the batch itself."""
        if not 0 <= j < self.n_slots:
            raise IndexError(f"slot {j} of {self.n_slots}")
        first = next(iter(batch.values()))
        if first.device.type != "cuda":
            self._host[j] = batch
            return
        if self._slots is None:
            self._slots = {key: torch.empty((self.n_slots, *v.shape), dtype=v.dtype,
                                            device=v.device) for key, v in batch.items()}
        for key, v in batch.items():
            slot = self._slots.get(key)
            if slot is None or slot.shape[1:] != v.shape or slot.dtype != v.dtype:
                raise ValueError(f"batch leaf {key!r} {tuple(v.shape)} {v.dtype} does not "
                                 "fit the super-step's static slots "
                                 f"{None if slot is None else (tuple(slot.shape[1:]), slot.dtype)}")
            slot[j].copy_(v)

    def _batches(self) -> List[Dict[str, torch.Tensor]]:
        """Each step's batch: views of the slots."""
        if self._slots is not None:
            views = [{key: v[j] for key, v in self._slots.items()}
                     for j in range(self.n_slots)]
        else:
            if any(b is None for b in self._host):
                raise ValueError("the super-step's slots are not all loaded")
            views = list(self._host)
        return views * self.k if self.reuse_batch else views

    def _run_steps(self, lrs=None) -> Dict:
        batches = self._batches()
        if lrs is None:
            return _stack([self.step(b) for b in batches])
        with self.optimizer.feeding(lrs):
            return _stack([self.step(b) for b in batches])

    def __call__(self, megabatch: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        if megabatch is not None:
            if self.reuse_batch:
                self.load(0, megabatch)
            else:
                self._check(megabatch)
                for j in range(self.k):
                    self.load(j, {key: v[j] for key, v in megabatch.items()})
        if self._slots is None:
            out = self._run_steps()
            self._host = [None] * self.n_slots
            return out
        return self._run_cuda()

    def _run_cuda(self) -> Dict:
        opt = self.optimizer
        if opt is not None and not opt.capturable:
            raise ValueError("a captured super-step needs the optimizer's capturable form "
                             f"(Adam or AdamW on the card), not {type(opt.optimizer).__name__}")
        key = "warm" if opt is None else opt.generation
        if self._warm_key != key:
            # the warm-up (again after a restore): the k steps eagerly
            self._graph = None  # its pool goes with it
            self._warm_key = key
            return self._run_steps()
        if self._graph is None:
            device = next(iter(self._slots.values())).device
            if opt is not None:
                self._lrs = torch.empty(self.k, dtype=torch.float32, device=device)
            lrs = None if opt is None else self._lrs.unbind(0)
            self._graph = GraphedCall(lambda: self._run_steps(lrs), device)
        if opt is not None:
            self._lrs.copy_(torch.tensor(opt.group_lrs(self.k), dtype=torch.float32))
        out = self._graph.replay()
        if opt is not None:
            opt.advance(self.k)
        return out


def make_multi_step(step: Callable, k: int, *, reuse_batch: bool = False,
                    optimizer=None) -> MultiStep:
    """Fuse ``k`` applications of ``step`` into one super-step (module
    docstring). ``optimizer``: the :class:`~esr_tpu_torch.training.optim
    .ScheduledOptimizer` that ``step`` updates, whose learning rates a
    captured super-step feeds from the device; ``None`` for a step with no
    optimizer (an eval accumulator)."""
    return MultiStep(step, k, reuse_batch=reuse_batch, optimizer=optimizer)


class _InstrumentedStep:
    """A step callable whose calls are the open bucket's ``dispatch`` span
    (run under the bucket's trace context), stamping the start of its
    ``device_step``. With no open bucket it is a plain pass-through;
    attributes delegate to the wrapped step."""

    def __init__(self, step, attribution):
        self._step = step
        self._attribution = attribution

    def __call__(self, *args, **kwargs):
        attribution = self._attribution
        with trace.adopt(attribution.current_ctx()):
            with attribution.measure("dispatch"):
                out = self._step(*args, **kwargs)
            attribution.dispatched()
        return out

    def __getattr__(self, name):
        return getattr(self._step, name)


def instrument_dispatch(step: Callable, attribution) -> Callable:
    """Wrap ``step`` (a step or a super-step, eager or replayed) so each
    call records its ``dispatch`` span and the dispatch timestamp into
    ``attribution`` (an ``obs.spans.StepAttribution``)."""
    return _InstrumentedStep(step, attribution)
