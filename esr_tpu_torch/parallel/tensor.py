"""Tensor (channel) parallelism over ``torch.distributed`` (counterpart of
``esr_tpu/parallel/tensor.py``).

The reference lays its state out on a 2-D ``(data, model)`` device mesh: a
leaf whose trailing (output-channel) axis divides by the ``model`` axis is
split on it, everything else is replicated, the batch is split on ``data``,
and GSPMD inserts the collectives. The port runs one process a device on
the same grid and writes the collectives out, as column-parallel layers:

- :func:`make_tp_mesh`: the ``(data, model)`` grid of the processes, the
  ranks of one model group contiguous (the reference's
  ``devices.reshape(data, n // data)``), with a process group for each
  model group (the shards of a layer) and each data group (the replicas of
  one shard);
- :func:`channel_shardings`: the plan, per leaf the torch dim that is
  flax's trailing axis (through ``models.convert``'s name map: 0 for an
  OIHW conv and a ``[out, in]`` dense, 3 for ``STFusion.dcn_weight``, kept
  HWIO, 0 for a bias), or None; the reference's rule: split when that axis
  divides by ``tp`` and is at least ``tp``, and nothing when ``tp`` is 1;
- :func:`shard_state_tp`: each process keeps its contiguous slice of every
  split parameter and of Adam's moments beside it (an update is
  elementwise, so a slice's update is that slice of the full update), and
  its split layers compute only their slice: a :class:`ColumnParallel`
  layer takes its input through :class:`CopyToModel` (the identity; in the
  backward the input gradient summed over the model group), computes its
  ``Cout / tp`` output channels with its own weights, and gathers the full
  output over the model group (:class:`GatherFromModel`; its backward
  takes the process's slice of the output gradient). The layers it knows
  are the flagship's: ``models.layers.Conv2d`` (the ConvGRU's gates and the
  DCN's offset/mask conv among them), ``models.layers.Linear``, and the
  DCN (``models.esr.DeformConv``, its kernels at ``Cout / tp``); any other
  layer with a split leaf raises ``NotImplementedError``;
- :func:`make_tp_train_step`: the train step on the process's rows of the
  global batch (split over ``data`` only: the processes of a model group
  see the same rows), the gradients and the metrics averaged over the data
  group, the grad norm counting each shard once.

No process holds the full weight of a split leaf or computes with it. The
downstream of every gathered output is the same on every process of a
model group, so the losses, and the replicated parameters' gradients, are
the same there too. Without a process group the mesh is one process, the
plan replicates everything, and the step is ``make_train_step``'s.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from esr_tpu_torch.models import convert, layers
from esr_tpu_torch.models.esr import DeformConv, STFusion
from esr_tpu_torch.parallel.mesh import initialize_multihost, is_distributed, world_size
from esr_tpu_torch.training.train_step import make_train_step


@dataclasses.dataclass(frozen=True)
class TPMesh:
    """The process's place on the ``(data, model)`` grid: its rank is
    ``data_index * model + model_index``. ``model_group`` holds the
    processes of its data index (a layer's shards), ``data_group`` those of
    its model index (one shard's replicas); both None without a process
    group."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def make_tp_mesh(world: Optional[int] = None, data: int = 2, device: str = "cuda") -> TPMesh:
    """The ``(data, model = world / data)`` grid of the process group (one
    that is up, else the one ``torch.distributed.run``'s environment
    describes, joined as ``parallel.mesh.initialize_multihost`` joins it:
    NCCL on the card, gloo when ``device`` is ``cpu``; else one process).
    ``world`` (default: the group's size) must be the group's size; raises
    ``ValueError`` when ``data`` does not divide it. Every process calls it,
    in the same order as any other group it makes."""
    if not is_distributed() and "RANK" in os.environ:
        initialize_multihost(device)
    n = world_size()
    if world is not None and world != n:
        raise ValueError(f"a mesh of {world} processes asked for, the group has {n}")
    if data < 1 or n % data != 0:
        raise ValueError(f"{n} processes do not split into data={data}")
    model = n // data
    if not is_distributed():
        return TPMesh(data, model, 0, 0)
    rank = dist.get_rank()
    grid = [[d * model + m for m in range(model)] for d in range(data)]
    mine = {}
    # every process makes every group, in one order
    for d in range(data):
        group = dist.new_group(grid[d])
        if rank in grid[d]:
            mine["model"] = group
    for m in range(model):
        ranks = [grid[d][m] for d in range(data)]
        group = dist.new_group(ranks)
        if rank in ranks:
            mine["data"] = group
    return TPMesh(data, model, rank // model, rank % model, mine["data"], mine["model"])


@dataclasses.dataclass(frozen=True)
class ShardLeaf:
    """A leaf of the plan: the tensor's name in the model (a parameter's, or
    a buffer's for a norm's running statistics), its flax path, the torch
    dim that is flax's trailing axis, and whether it is split."""

    name: str
    flax_path: Tuple[str, ...]
    dim: Optional[int]

    @property
    def sharded(self) -> bool:
        return self.dim is not None


def _trailing_dim(tensor: torch.Tensor, layout: Optional[str]) -> int:
    """The torch dim of flax's trailing axis: a conv's or a dense's kernel
    keeps its output channels first (OIHW, ``[out, in]``), a transposed
    conv's second (IOHW), and a leaf in the flax layout last (biases,
    ``dcn_weight`` HWIO, a norm's vectors)."""
    if layout == "kernel":
        return 0
    if layout == "transposed":
        return 1
    return tensor.dim() - 1


def channel_shardings(model: nn.Module, mesh: TPMesh) -> Dict[str, ShardLeaf]:
    """The plan (module docstring): every leaf of ``models.convert``'s map,
    by its name in ``model``."""
    tp = mesh.model
    names = {id(t): n for n, t in model.named_parameters()}
    names.update({id(t): n for n, t in model.named_buffers()})
    plan = {}
    for path, tensor, layout in convert.flax_leaves(model):
        dim = _trailing_dim(tensor, layout) if tensor.dim() else None
        size = tensor.shape[dim] if dim is not None else 1
        split = tp > 1 and dim is not None and size % tp == 0 and size >= tp
        name = names[id(tensor)]
        plan[name] = ShardLeaf(name, path, dim if split else None)
    return plan


def take_shard(tensor: torch.Tensor, dim: int, index: int, tp: int) -> torch.Tensor:
    """Slice ``index`` of ``tp`` contiguous slices of ``tensor`` along
    ``dim``, as a contiguous copy of its own (no view keeps the whole
    tensor's storage)."""
    size = tensor.shape[dim] // tp
    return tensor.narrow(dim, index * size, size).clone(memory_format=torch.contiguous_format)


class CopyToModel(torch.autograd.Function):
    """The input of a column-parallel layer: the identity; its gradient is
    the sum over the model group of the processes' input gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class GatherFromModel(torch.autograd.Function):
    """The output of a column-parallel layer: the model group's slices
    concatenated along ``dim`` in rank order; the gradient of a slice is its
    part of the output gradient (the same on every process of the group)."""

    @staticmethod
    def forward(ctx, y, dim, index, tp, group):
        ctx.dim, ctx.index, ctx.size = dim, index, y.shape[dim]
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(tp)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous(), None, None, None, None


class ColumnParallel:
    """A layer made column-parallel by hooks: its first ``n_inputs``
    positional inputs go through :class:`CopyToModel`, its output through
    :class:`GatherFromModel` along ``dim``. The layer's module, its
    parameters' names and its checkpoint entries stay as they were."""

    def __init__(self, module: nn.Module, dim: int, n_inputs: int, mesh: TPMesh):
        self.dim, self.n_inputs, self.mesh = dim, n_inputs, mesh
        module.register_forward_pre_hook(self._inputs)
        module.register_forward_hook(self._output)

    def _inputs(self, module, args):
        group = self.mesh.model_group
        return tuple(CopyToModel.apply(a, group) if i < self.n_inputs else a
                     for i, a in enumerate(args))

    def _output(self, module, args, out):
        m = self.mesh
        return GatherFromModel.apply(out, self.dim, m.model_index, m.model, m.model_group)


def _column_form(module: nn.Module, parent: Optional[nn.Module]) -> Optional[Tuple[int, int]]:
    """``(output channel dim, inputs that carry a gradient)`` of a layer
    :class:`ColumnParallel` knows, else None. A ConvLSTM's gate conv is not
    one: the UNet family is not held against the reference under tensor
    parallelism."""
    if isinstance(module, layers.Conv2d) and not isinstance(parent, layers.ConvLSTMCell):
        return 1, 1
    if isinstance(module, layers.Linear):
        return -1, 1
    if isinstance(module, DeformConv):
        return -1, 3
    return None


@dataclasses.dataclass
class _TPState:
    """The mesh and the plan :func:`shard_state_tp` split a model by."""

    mesh: TPMesh
    plan: Dict[str, ShardLeaf]


def _layer_of(model: nn.Module, plan: Dict[str, ShardLeaf]):
    """The column-parallel layer of each split leaf: ``{module name:
    (module, (dim, n_inputs))}``; raises ``NotImplementedError`` naming
    every other layer that holds a split leaf, with its flax path."""
    modules = dict(model.named_modules())
    found, unknown = {}, []
    for leaf in plan.values():
        if not leaf.sharded:
            continue
        owner_name, _, attr = leaf.name.rpartition(".")
        owner = modules[owner_name]
        if isinstance(owner, STFusion) and attr in ("dcn_weight", "dcn_bias"):
            owner_name = f"{owner_name}.deform"
            owner, parent = owner.deform, owner
        else:
            parent = modules.get(owner_name.rpartition(".")[0])
        form = _column_form(owner, parent)
        if form is None:
            unknown.append(f"{type(owner).__name__} at {'/'.join(leaf.flax_path)}")
        else:
            found[owner_name] = (owner, form)
    if unknown:
        raise NotImplementedError(
            "tensor parallelism splits leaves of layers it has no column-parallel form for "
            "(the flagship's Conv2d, Linear and DCN only): " + "; ".join(unknown))
    return found


def shard_state_tp(model: nn.Module, optimizer, mesh: TPMesh) -> Dict[str, ShardLeaf]:
    """Keep this process's slice of every split parameter and of the
    optimizer's state of the same shape beside it, in place (the parameter
    objects stay, so the optimizer keeps them), and make the layers that
    hold them column-parallel. Returns the plan. A second call with the
    same mesh returns it again; raises ``NotImplementedError`` for a split
    leaf of an unknown layer (nothing is changed then)."""
    state = getattr(model, "_tensor_parallel", None)
    if state is not None:
        if state.mesh != mesh:
            raise ValueError("the model is already split over another mesh")
        return state.plan
    plan = channel_shardings(model, mesh)
    found = _layer_of(model, plan)
    params = dict(model.named_parameters())
    # a torch.optim optimizer's state, or that of the one a ScheduledOptimizer drives
    moments = getattr(optimizer, "optimizer", optimizer).state
    with torch.no_grad():
        for leaf in plan.values():
            if not leaf.sharded:
                continue
            p = params[leaf.name]
            full = tuple(p.shape)
            p.data = take_shard(p.data, leaf.dim, mesh.model_index, mesh.model)
            st = moments.get(p, {})
            for key, value in list(st.items()):
                if torch.is_tensor(value) and tuple(value.shape) == full:
                    st[key] = take_shard(value, leaf.dim, mesh.model_index, mesh.model)
    for module, (dim, n_inputs) in found.values():
        ColumnParallel(module, dim, n_inputs, mesh)
    model._tensor_parallel = _TPState(mesh, plan)
    return plan


def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of a model split by :func:`shard_state_tp`, whole:
    the split ones gathered over the model group (a new tensor), the others
    as they are."""
    state = model._tensor_parallel
    mesh = state.mesh
    out = {}
    for name, p in model.named_parameters():
        leaf = state.plan.get(name)
        t = p.detach()
        if leaf is not None and leaf.sharded:
            parts = [torch.empty_like(t) for _ in range(mesh.model)]
            dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
            t = torch.cat(parts, leaf.dim)
        out[name] = t
    return out


def make_tp_train_step(model: nn.Module, optimizer, mesh: TPMesh, seqn: int = 3):
    """``metrics = step(batch)``: the train step (``training.train_step
    .make_train_step``) under tensor parallelism. The state is split first
    (:func:`shard_state_tp`) if it is not yet. ``batch`` is the global batch,
    the same on every process; the process takes rows ``data_index * B /
    data`` onwards of it (``ValueError`` when ``data`` does not divide B).
    The metrics are the data group's means, the same on every process."""
    plan = shard_state_tp(model, optimizer, mesh)
    params = dict(model.named_parameters())
    sharded = [params[leaf.name] for leaf in plan.values() if leaf.sharded]
    step = make_train_step(model, optimizer, seqn, group=mesh.data_group, sharded=sharded,
                           model_group=mesh.model_group)

    def tp_step(batch: Dict[str, torch.Tensor]) -> Dict:
        rows = batch["inp"].shape[0]
        if rows % mesh.data:
            raise ValueError(f"a batch of {rows} does not split over data={mesh.data}")
        n = rows // mesh.data
        lo = mesh.data_index * n
        return step({k: v[lo:lo + n] for k, v in batch.items()})

    return tp_step
