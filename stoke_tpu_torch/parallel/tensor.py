"""Tensor, expert and pipeline parallelism of the port, and the placement
of a leaf on any mesh axis: the Megatron, expert and stage splits, with
their collectives written by hand, and the gathered placement of every
other leaf a partition rule places (on the model, expert, stage, data or
``seq`` axes).

Counterpart of the JAX package's partition rules under a mesh of model,
expert or stage axes beside the data axis (``PartitionRulesConfig``,
``stoke_tpu/models/bert.py:236-253`` ``bert_tensor_parallel_rules``,
``stoke_tpu/models/moe.py:146-157`` ``moe_expert_parallel_rules``). There
GSPMD derives every collective from the placements; here
:func:`apply_partition_rules` reads the same rules, cuts each parameter
they place down to this process's slice, and gives each split module
the group of the axis its leaves name (one :class:`ModelGroup` a mesh
axis: the attention and the FFN take the model axis, ``MoEFFN`` the
expert axis), whose forwards run three autograd functions at the
boundaries of the split:

- :func:`copy_to_group`: identity forward, all-reduce (sum) backward, on
  the replicated input of a column-parallel product (``qkv``, ``ff_in``)
  and on the input of the local experts;
- :func:`reduce_from_group`: all-reduce (sum) forward, identity backward,
  on the partial output of a row-parallel product (``attention/out``,
  ``ff_out``), whose bias is added once, after it;
- :func:`gather_from_group`: all-gather forward along dim 0, and as its
  backward this rank's slice of the incoming gradient (everything after
  it is computed alike on every rank, so every rank's gradient there is
  the same), on the experts' outputs, so that every rank combines over
  all E experts.

**The invariant.** Every activation outside the split regions, hence
every parameter the rules leave replicated, is the same bit for bit on
every rank of a model (expert) group: each of them sees the same rows
(its data coordinate's), draws the same dropout masks (its generator is
seeded by the data coordinate) and combines the same whole results.
So the ladder reduces such a gradient over the data sub-group only.

The rules are matched against each tensor's JAX leaf path
(:func:`stoke_tpu_torch.convert.jax_param_layout`), a rule's dims read in
the JAX layout. The compute splits are the leaves of the three published
sets:

- Megatron: ``attention/qkv`` kernel ``[hidden, 3, heads, D]`` over
  heads (dim 2) and its bias ``[3, heads, D]`` (dim 1); ``attention/out``
  kernel over its input (dim 0); ``ff_in`` kernel over ff (dim 1) and its
  bias (dim 0); ``ff_out`` kernel over its input (dim 0), all on one
  axis. The port's ``qkv`` weight is ``qkv.reshape(hidden, -1).T``: a
  rank's heads are rows ``[:, heads_r]`` of its ``[3, heads, D, hidden]``
  view, not one block of rows;
- expert: ``moe/w_in`` ``[E, H, ff]`` and ``moe/w_out`` ``[E, ff, H]``
  over the experts (dim 0), on one axis; the router stays replicated;
- stage (``pipeline_parallel_rules``): every stage-stacked leaf of a
  ``PipelinedLM`` (``stages/...``, ``[V·S, ...]``) over its dim 0. The
  cut is strided, as the JAX package reshapes the stack to ``[V, S,
  ...]`` and shards dim 1: rank ``d`` holds ``stages[d::S]``. The model
  gets the group (:mod:`~stoke_tpu_torch.parallel.pipeline` runs its
  schedule over it); the embedding and the head stay whole. There the
  invariant holds of every tensor outside the stages: every rank of a
  stage group takes the same rows and ends with the whole batch's logits
  (the model's docstring).

**The gathered placement.** Any other placement of a dim on a mesh axis,
or on a tuple of axes (a norm, a row-parallel bias, another dim, a
column-parallel product without its partner, a bias without its kernel,
a dim on two axes, a placement on a stage-stacked leaf beside or outside
the stage set, any placement on the data or ``seq`` axis) is what GSPMD
does when an operand's placement is not its consumer's: the rank stores
its JAX shard (the block along the JAX dim, in a view of the port's
tensor where that dim is a dim of its own: the ``qkv`` layouts' ``[3,
heads, D, ...]``), and before each forward :func:`gather_placed`
all-gathers it whole over the flattened sub-group of its levels' axes in
one autograd function (one all-gather for the placements over one group,
:meth:`TensorParallel.run_params`). The module then runs whole, as
without the rule (under a published split: on its heads, ff or experts
whole). A dim on a tuple of axes is cut in one level a run of axes of
one kind, the first axis major, so rank ``(d, m)`` of ``("data",
"model")`` holds block ``d·M + m``; a leaf placed beside a compute cut
(the stage cut, or a Megatron or expert split whose other dim is on the
data axis) holds its gathered levels inside that cut's block.

**Which ranks hold which gradient.** Two kinds of axes:

- the model, expert and stage axes: every rank of such a group computes
  the same gradient of every tensor outside the split regions (the
  invariant above; a stage placement outside the stage set runs no
  pipeline, so every stage rank runs the whole stack), so the backward of
  a gathered level on them takes this rank's slice of the incoming
  gradient, with no collective;
- the data and ``seq`` axes (a ``mean`` level of the cut): their ranks
  take other rows or other tokens and compute different gradients, whose
  mean is the global batch's. The backward of a gathered level on them
  reduce-scatters the gradient (in fp32, averaged) over the level's
  group, at every backward (once all the gathered placements' gradients
  are in, one collective a group): the fsdp tier's per-micro-step
  reduction, so the ladder does not reduce such a leaf over that axis
  again (:meth:`TensorParallel.mean_axes`).

So every leaf's slice ends each backward with its part of the global
batch's gradient over the axes its cut names, and the ladder averages it
over the data and ``seq`` axes its cut does not name. The norms of a step
count a cut leaf's squares summed over its own group (the axes that cut
it) and a replicated leaf once.

A head, ff, expert or stage count the axis does not divide, a placed dim
the axes do not divide, and an axis the mesh lacks raise ``ValueError``
naming the leaf.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from stoke_tpu_torch.parallel.sharding import (
    compile_partition_rules,
    rule_entries,
)

@dataclass(frozen=True)
class ModelGroup:
    """One process's place on a model, expert or stage axis (or on the
    flattened axes of a tuple, the first major): the axis's process
    ``group``, its ``size``, this process's coordinate ``rank`` and the
    axis's name (a tuple of names for a flattened group). A ``group`` of
    None is a virtual rank: its collectives are left out and the caller
    combines the ranks' results (the forwards' ``partial`` methods).
    ``order``: the group rank of each coordinate where they differ (a
    flattened group of axes not in the mesh's order), else None."""

    group: Any
    size: int
    rank: int
    axis: Any
    order: Optional[tuple] = None

    def by_coordinate(self, parts: Sequence) -> list:
        """Parts laid out by group rank (a collective's), by coordinate."""
        if self.order is None:
            return list(parts)
        return [parts[g] for g in self.order]

    def by_group_rank(self, parts: Sequence) -> list:
        """Parts by coordinate, laid out by group rank (for a
        collective)."""
        if self.order is None:
            return list(parts)
        out = [None] * len(parts)
        for c, g in enumerate(self.order):
            out[g] = parts[c]
        return out


def _sum_(t: torch.Tensor, group: Optional[ModelGroup]) -> torch.Tensor:
    if group is not None and group.group is not None:
        dist.all_reduce(t, group=group.group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_(grad.clone(memory_format=torch.contiguous_format),
                     ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        if group.group is None:
            raise ValueError(
                "gather_from_group: a virtual rank has no group to gather "
                "over (its caller gathers the ranks' outputs)")
        out = x.new_empty((group.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[0] // ctx.group.size
        return grad[ctx.group.rank * n:(ctx.group.rank + 1) * n], None


class _MeanIdentityBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out.div_(dist.get_world_size(group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """``x`` unchanged; in backward its gradient summed over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """``x`` summed over ``group``; its gradient passes unchanged."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, rank-major; in
    backward this rank's rows of the gradient."""
    return _GatherFromGroup.apply(x, group)


def mean_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` averaged over the process ``group``; its gradient passes
    unchanged (each rank's objective then carries its own rows' part, and
    the ladder's average of the gradients is the global batch's)."""
    return _MeanIdentityBackward.apply(x, group)


def _levels(cut: "Cut", rank: int) -> List[tuple]:
    """``(level, this rank's coordinate on it)`` of every level of
    ``cut``, outermost first, from the rank over all of them."""
    out = []
    while cut is not None:
        inner = cut.inner.parts if cut.inner is not None else 1
        coord, rank = divmod(rank, inner)
        out.append((cut, coord))
        cut = cut.inner
    return out


class _GatherPlaced(torch.autograd.Function):
    """Several gathered placements over one group (their slices of one
    dtype once cast) in one all-gather; in backward each slice's gradient
    walks its levels, and the slices waiting at a ``mean`` level on one
    group reduce-scatter together."""

    @staticmethod
    def forward(ctx, cuts, group, groups, dtype, *ts):
        ctx.cuts, ctx.rank, ctx.groups = cuts, group.rank, groups
        ctx.dtypes = [t.dtype for t in ts]
        if group.group is None:
            raise ValueError(
                "gather_placed: a virtual rank has no group to gather over "
                "(its caller puts the ranks' slices together)")
        ts = [t.to(dtype) if dtype is not None and t.is_floating_point()
              else t for t in ts]
        flat = torch.cat([t.reshape(-1) for t in ts])
        out = flat.new_empty((group.size * flat.numel(),))
        dist.all_gather_into_tensor(out, flat, group=group.group)
        rows = group.by_coordinate(out.view(group.size, -1).unbind(0))
        whole, at = [], 0
        for cut, t in zip(cuts, ts):
            n = t.numel()
            whole.append(cut.join([r[at:at + n].view(t.shape)
                                   for r in rows]))
            at += n
        return tuple(whole)

    @staticmethod
    def backward(ctx, *grads):
        grads = list(grads)
        walks = [_levels(cut, ctx.rank) for cut in ctx.cuts]
        at = [0] * len(grads)
        while True:
            # each slice takes its own part where the level's ranks hold
            # the same gradient, up to its next mean level
            waiting: Dict[tuple, List[int]] = {}
            for i, walk in enumerate(walks):
                while at[i] < len(walk) and not walk[at[i]][0].mean:
                    level, coord = walk[at[i]]
                    grads[i] = level._take(grads[i], coord)
                    at[i] += 1
                if at[i] < len(walk):
                    waiting.setdefault(walk[at[i]][0].axes, []).append(i)
            if not waiting:
                break
            # a mean level's ranks hold different gradients: their mean,
            # in fp32, reduce-scattered (each rank its block), one
            # collective for the slices waiting on one group
            for axes, idx in waiting.items():
                g = ctx.groups[axes]
                levels = [walks[i][at[i]][0] for i in idx]
                parts = [torch.stack(g.by_group_rank(
                    [lv._take(grads[i], r).float() for r in range(g.size)])
                ).view(g.size, -1) for i, lv in zip(idx, levels)]
                flat = torch.cat(parts, 1)
                out = flat.new_empty((flat.shape[1],))
                dist.reduce_scatter_tensor(out, flat.view(-1),
                                           op=dist.ReduceOp.AVG,
                                           group=g.group)
                for i, lv, piece in zip(idx, levels, out.split(
                        [p.shape[1] for p in parts])):
                    grads[i] = piece.view(lv.block)
                    at[i] += 1
        return (None, None, None, None,
                *[g.to(dt) for g, dt in zip(grads, ctx.dtypes)])


def gather_placed(t: torch.Tensor, cut: "Cut", group: ModelGroup,
                  groups: Optional[Dict[tuple, ModelGroup]] = None,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A gathered placement's whole tensor (``cut.full``) from this rank's
    slice ``t`` (cast to ``dtype`` first, when given), all-gathered over
    ``group`` (the flattened group of the cut's levels); in backward this
    rank's slice of the gradient, in ``t``'s dtype: taken with no
    collective at a level whose ranks compute the same gradient, averaged
    in fp32 over the level's own group (``groups``, by axes) at a
    ``mean`` level."""
    return _GatherPlaced.apply((cut,), group, groups or {}, dtype, t)[0]


def _split_sizes(full: Sequence[int], view: Sequence[int]) -> List[tuple]:
    """For each dim of ``full``, the ``(first, end)`` dims of ``view`` it
    spans (``view`` splits some dims of ``full`` into several)."""
    out, j = [], 0
    for n in full:
        start, prod = j, 1
        while j < len(view) and (prod < n or (n == 1 and j == start)):
            prod *= view[j]
            j += 1
        if prod != n:
            raise ValueError(f"view {tuple(view)} does not split "
                             f"{tuple(full)}")
        out.append((start, j))
    return out


@dataclass(frozen=True)
class Cut:
    """How one parameter splits over a mesh axis (or the flattened axes
    ``axes``): its whole shape ``full`` in the port's layout, the view
    ``view`` of it in which the split dimension ``dim`` is a dimension of
    its own (the ``qkv`` layouts' ``[3, heads, D, ...]``), and the axis
    size. Rank ``r`` holds the ``r``-th of ``size`` equal blocks along
    ``dim`` of the view. ``gathered`` marks a gathered placement (the
    module runs on the whole tensor, gathered before each forward);
    ``inner`` a second level that cuts this one's block again (a
    stage-stacked leaf's model placement, a Megatron leaf's data
    placement). The ranks of a two-level cut are numbered over both
    levels' axes, this level's major. ``mean`` marks a level on the data
    or ``seq`` axes, whose ranks compute different gradients (averaged
    over the level's group in the backward of :func:`gather_placed`)."""

    full: tuple
    view: tuple
    dim: int
    size: int
    axes: tuple = ()
    gathered: bool = False
    inner: Optional["Cut"] = None
    mean: bool = False

    @property
    def local_view(self) -> tuple:
        v = list(self.view)
        v[self.dim] //= self.size
        return tuple(v)

    @property
    def block(self) -> tuple:
        """One rank's block of this level, in the port's layout."""
        shape = list(self.full)
        for k, (a, b) in enumerate(_split_sizes(self.full, self.view)):
            if a <= self.dim < b:
                shape[k] //= self.size
        return tuple(shape)

    @property
    def local(self) -> tuple:
        """The shape a rank holds, in the port's layout."""
        return self.inner.local if self.inner is not None else self.block

    @property
    def parts(self) -> int:
        """How many slices the leaf is cut into, over every level."""
        return self.size * (self.inner.parts if self.inner is not None
                            else 1)

    @property
    def group_axes(self) -> tuple:
        """The axes of every level, outermost first: the flattened group
        over which the ranks hold the leaf's slices."""
        return self.axes + (self.inner.group_axes if self.inner is not None
                            else ())

    @property
    def strided(self) -> bool:
        """Whether this is a stage cut: rank ``d`` holds rows ``d::size``
        of the stack's dim 0."""
        return (not self.gathered and self.dim == 1
                and self.view == (self.full[0] // self.size, self.size,
                                  *self.full[1:]))

    @property
    def gathered_level(self) -> Optional["Cut"]:
        """The outermost level from which every level is gathered (None:
        the module runs on the slice)."""
        if self.gathered:
            return self
        return (self.inner.gathered_level if self.inner is not None
                else None)

    def _take(self, whole, rank: int):
        n = self.view[self.dim] // self.size
        idx = [slice(None)] * len(self.view)
        idx[self.dim] = slice(rank * n, (rank + 1) * n)
        part = whole.reshape(self.view)[tuple(idx)].reshape(self.block)
        if isinstance(part, np.ndarray):
            return np.ascontiguousarray(part)
        return part.contiguous()

    def take(self, whole, rank: int):
        """Rank ``rank``'s slice of ``whole`` (a tensor or numpy array of
        shape ``full``)."""
        if self.inner is None:
            return self._take(whole, rank)
        outer, inner = divmod(rank, self.inner.parts)
        return self.inner.take(self._take(whole, outer), inner)

    @property
    def mean_axes(self) -> tuple:
        """The axes of every ``mean`` level, outermost first."""
        return ((self.axes if self.mean else ())
                + (self.inner.mean_axes if self.inner is not None else ()))

    def reduced(self, grads: Sequence) -> list:
        """Each rank's slice of the reduced gradient, by rank, from every
        rank's gradient of the whole tensor (``grads``, by rank over every
        level): the virtual ranks' counterpart of :func:`gather_placed`'s
        backward (a ``mean`` level averages its ranks', every other level
        takes the rank's own)."""
        out = []
        for r in range(self.parts):
            mine = [c for _, c in _levels(self, r)]
            peers = [q for q in range(self.parts) if all(
                level.mean or c == m
                for (level, c), m in zip(_levels(self, q), mine))]
            out.append(sum(self.take(grads[q], r) for q in peers)
                       / len(peers))
        return out

    def join(self, parts: Sequence):
        """The whole tensor (or array) of every rank's slice, by rank."""
        if self.inner is not None:
            n = self.inner.parts
            parts = [self.inner.join(parts[k * n:(k + 1) * n])
                     for k in range(self.size)]
        parts = [p.reshape(self.local_view) for p in parts]
        if isinstance(parts[0], np.ndarray):
            return np.concatenate(parts, self.dim).reshape(self.full)
        return torch.cat(parts, self.dim).reshape(self.full)


class TensorParallel:
    """What :func:`apply_partition_rules` did to one model: the groups of
    the axes its cuts name (one :class:`ModelGroup` a mesh axis, or a
    flattened tuple of axes, keyed by the axes' tuple), the :class:`Cut`
    of each parameter it split, by name, and the names of the parameters
    a rule placed (split or replicated: the rule wins over the tier, so
    the ladder keeps them whole over the data axis)."""

    def __init__(self, groups: Dict[tuple, ModelGroup], cuts: Dict[str, Cut],
                 placed: Set[str]):
        self.groups = groups
        self.cuts = cuts
        self.placed = placed
        #: the parameters gathered whole before each forward
        self.gathered = sorted(n for n, c in cuts.items()
                               if c.gathered_level is not None)

    @property
    def group(self) -> ModelGroup:
        """The one group of a split whose cuts all run over the same axes
        (a two-axis mesh's), else the split's first axis's."""
        keys = {c.group_axes for c in self.cuts.values()}
        if len(keys) == 1:
            return self.groups[keys.pop()]
        return next(iter(self.groups.values()), ModelGroup(None, 1, 0, None))

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def rank(self) -> int:
        return self.group.rank

    def group_of(self, name: str) -> ModelGroup:
        """The (flattened) group over which parameter ``name``'s slices
        lie."""
        return self.groups[self.cuts[name].group_axes]

    def full_shape(self, name: str, shape: Sequence[int]) -> tuple:
        """The whole shape of parameter ``name`` held at ``shape``."""
        cut = self.cuts.get(name)
        return tuple(shape) if cut is None else cut.full

    def take(self, name: str, whole):
        """This rank's part of parameter ``name``'s whole tensor or array
        (or of a state shaped like it); other names pass through."""
        cut = self.cuts.get(name)
        if cut is None or tuple(whole.shape) != cut.full:
            return whole
        return cut.take(whole, self.group_of(name).rank)

    @torch.no_grad()
    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``name``'s whole tensor from every rank's slice ``t``
        (or a state shaped like the slice), over its own group; every rank
        of the group calls it, in the same order. Other names and shapes
        pass through."""
        cut = self.cuts.get(name)
        if cut is None or tuple(t.shape) != cut.local:
            return t
        g = self.group_of(name)
        out = t.new_empty((g.size * t.numel(),))
        dist.all_gather_into_tensor(out, t.contiguous().view(-1),
                                    group=g.group)
        return cut.join(g.by_coordinate(
            out.view(g.size, *cut.local).unbind(0)))

    def run_params(self, tensors: Dict[str, torch.Tensor],
                   dtype: Optional[torch.dtype] = None
                   ) -> Dict[str, torch.Tensor]:
        """The tensors the forward runs on for each gathered placement:
        ``tensors[name]`` (the slice) cast to ``dtype`` (when given) and
        gathered to the shape the module uses (:func:`gather_placed`, one
        collective for the placements over one group; its gradient comes
        back in the slice's dtype, a ``mean`` level's averaged in
        fp32)."""
        # one all-gather (and one reduce-scatter a mean group) for the
        # placements over one group, of one dtype once cast
        buckets: Dict[tuple, List[str]] = {}
        for name in self.gathered:
            t = tensors[name]
            cast = (dtype if dtype is not None and t.is_floating_point()
                    else t.dtype)
            buckets.setdefault((self.cuts[name].gathered_level.group_axes,
                                cast), []).append(name)
        out = {}
        for (axes, _), names in buckets.items():
            out.update(zip(names, _GatherPlaced.apply(
                tuple(self.cuts[n].gathered_level for n in names),
                self.groups[axes], self.groups, dtype,
                *[tensors[n] for n in names])))
        return out

    def mean_axes(self, name: str) -> Set[str]:
        """The data and ``seq`` axes over which parameter ``name``'s cut
        averages its gradient in the backward (empty for a leaf the split
        leaves whole or cuts only over model, expert or stage axes)."""
        cut = self.cuts.get(name)
        return set(cut.mean_axes) if cut is not None else set()

    def reduce_(self, t: torch.Tensor, op: str = "sum",
                axes: Optional[tuple] = None) -> torch.Tensor:
        """``t`` summed (or maxed) over the group of ``axes`` (the split's
        one group when None), in place."""
        g = self.group if axes is None else self.groups[axes]
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=g.group)
        return t

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A bool tensor ANDed over every group of the split (on the
        device)."""
        f = flag.to(torch.float32)
        for g in self.groups.values():
            dist.all_reduce(f, op=dist.ReduceOp.MIN, group=g.group)
        return f > 0.5

    @torch.no_grad()
    def whole_copy(self, model: nn.Module, memo=None) -> nn.Module:
        """A copy of the split ``model`` made whole: every cut parameter
        gathered over its group, every block's group dropped (collective:
        each rank of the groups calls it). The copy shares the groups
        until it drops them: a process group cannot be copied."""
        memo = {} if memo is None else memo
        for g in self.groups.values():
            memo.setdefault(id(g), g)
        out = copy.deepcopy(model, memo)
        for name in self.cuts:
            owner, _, attr = name.rpartition(".")
            mod = out.get_submodule(owner) if owner else out
            p = getattr(mod, attr)
            setattr(mod, attr, nn.Parameter(self.gather(name, p.data),
                                            requires_grad=p.requires_grad))
        for m in out.modules():
            if getattr(m, "group", None) is not None and hasattr(
                    m, "sync_widths"):
                m.group = None
                m.sync_widths()
        return out

    def sliced_indices(self, model: nn.Module,
                       params: Sequence[torch.Tensor]) -> List[int]:
        """The positions in ``params`` of the parameters this split cut."""
        names = {id(p): n for n, p in model.named_parameters()}
        return [i for i, p in enumerate(params)
                if names.get(id(p)) in self.cuts]


#: the leaves each recognised module splits: tensor -> the JAX dim the
#: rule places on the axis, and the leaves that stay whole
_ATTENTION = ({"qkv.weight": 2, "qkv.bias": 1, "out.weight": 0},
              ("out.bias",))
_FFN = ({"ff_in.weight": 1, "ff_in.bias": 0, "ff_out.weight": 0},
        ("ff_out.bias",))
_EXPERTS = ({"w_in": 0, "w_out": 0}, ("router.weight",))


def apply_partition_rules(model: nn.Module, rules, mesh,
                          data_axis: str = "data",
                          seq_axis: str = "seq") -> TensorParallel:
    """Split ``model`` (the whole model, seeded, converted or loaded, on
    its device) over ``mesh``'s axes by ``rules``
    (``PartitionRulesConfig.rules``, plain or compiled): see
    :func:`shard_module`. Each axis (or flattened tuple of axes) a cut
    names gets its sub-group (:func:`~stoke_tpu_torch.parallel.mesh
    .axis_coordinates`); the levels on ``data_axis`` and ``seq_axis`` are
    ``mean`` levels."""
    from stoke_tpu_torch.parallel.mesh import axis_coordinates, axis_order

    names = tuple(mesh.mesh_dim_names)

    def group_for(axes: tuple) -> Optional[ModelGroup]:
        if any(a not in names for a in axes):
            return None
        g, n, r = axis_coordinates(mesh, axes)
        return ModelGroup(g, n, r, axes[0] if len(axes) == 1 else axes,
                          axis_order(mesh, axes))

    return shard_module(model, rules, group_for,
                        mean_axes=(data_axis, seq_axis))


def _resolver(groups) -> Callable[[tuple], Optional[ModelGroup]]:
    """``axes -> ModelGroup`` (None for an axis the split has no group
    for) from one group, a mapping by axis name (or tuple of names), or
    such a function. Virtual groups of single axes make the virtual
    flattened group of a tuple, the first axis major."""
    if callable(groups) and not isinstance(groups, ModelGroup):
        return groups
    if isinstance(groups, ModelGroup):
        groups = {groups.axis: groups} if groups.axis is not None else {}
    table = {((k,) if isinstance(k, str) else tuple(k)): g
             for k, g in groups.items()}

    def get(axes: tuple) -> Optional[ModelGroup]:
        if axes in table:
            return table[axes]
        parts = [table.get((a,)) for a in axes]
        if len(axes) < 2 or any(p is None or p.group is not None
                                for p in parts):
            return None
        rank = 0
        for p in parts:
            rank = rank * p.size + p.rank
        return ModelGroup(None, math.prod(p.size for p in parts), rank, axes)

    return get


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _jax_view(shape: tuple, perm, jshape: Sequence[int], jdim: int) -> tuple:
    """``(view, dim)``: a view of the port's tensor of shape ``shape`` in
    which JAX dim ``jdim`` of the leaf (JAX shape ``jshape``: the tensor
    permuted by ``perm``, then reshaped) is a dim of its own."""
    order = tuple(perm) if perm is not None else tuple(range(len(shape)))
    spans = _split_sizes([shape[d] for d in order], jshape)
    by_port = {order[k]: span for k, span in enumerate(spans)}
    view, dim = [], None
    for d in range(len(shape)):
        a, b = by_port[d]
        if a <= jdim < b:
            dim = len(view) + jdim - a
        view.extend(jshape[a:b])
    return tuple(view), dim


def _runs(axes: tuple, mean_axes) -> List[tuple]:
    """``axes`` (one dim's entry) in runs of one kind, in order:
    ``[(run, whether its axes are mean axes), ...]``."""
    out: List[tuple] = []
    for a in axes:
        kind = a in mean_axes
        if out and out[-1][1] == kind:
            out[-1] = (out[-1][0] + (a,), kind)
        else:
            out.append(((a,), kind))
    return out


def shard_module(model: nn.Module, rules, groups,
                 mean_axes: Sequence[str] = ("data", "seq")
                 ) -> TensorParallel:
    """Cut each parameter of ``model`` that ``rules`` place on a mesh
    axis down to this rank's slice, and give the attention blocks their
    local heads, the FFNs their local ff, the MoE FFNs their local
    experts and a ``PipelinedLM`` its stages, each with the group of the
    axis its leaves name. ``groups`` gives each axis's
    :class:`ModelGroup`: one group (a split over one axis), a mapping by
    axis name, or a function of an axes tuple. A recognised module whose
    leaves the rules place as a published set (beside which a leaf may
    also place another dim, or its split dim after the split's axis, on
    ``mean_axes``) is split; every other placement is a gathered
    placement, its levels on ``mean_axes`` ``mean`` levels (the module
    docstring). A placement on an axis without a group raises
    ``ValueError`` naming the leaf."""
    from stoke_tpu_torch.convert import jax_param_layout
    from stoke_tpu_torch.models.bert import (
        MultiHeadAttention,
        TransformerBlock,
    )
    from stoke_tpu_torch.models.moe import MoEFFN
    from stoke_tpu_torch.models.pipelined_lm import PipelinedLM

    resolve = _resolver(groups)
    made: Dict[tuple, ModelGroup] = {}
    mean_axes = tuple(mean_axes)

    def group(axes: tuple) -> Optional[ModelGroup]:
        if axes not in made:
            g = resolve(axes)
            if g is None:
                return None
            made[axes] = g
        return made[axes]

    # ``re.compile`` of a compiled pattern is the pattern: plain and
    # compiled rules alike
    compiled = compile_partition_rules(rules)
    layout = jax_param_layout(model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    placed: Set[str] = set()
    on: Dict[str, List[tuple]] = {}
    entries_of: Dict[str, tuple] = {}
    paths: Dict[str, str] = {}
    for name in shapes:
        path, _, jshape = layout[name]
        paths[name] = spath = "/".join(path)
        entries = rule_entries(spath, jshape, compiled, strict=True)
        if entries is None:
            continue
        placed.add(name)
        entries_of[name] = entries
        dims = [(d, _axes(e)) for d, e in enumerate(entries)
                if e is not None and _axes(e)]
        if dims:
            on[name] = dims
    for name, dims in on.items():
        used = [a for _, axes in dims for a in axes]
        if len(set(used)) != len(used):
            raise ValueError(
                f"Stoke -- partition rule places {paths[name]} as "
                f"{entries_of[name]}, which names a mesh axis twice")
        for d, axes in dims:
            for run, _ in _runs(axes, mean_axes):
                if group(run) is None:
                    raise ValueError(
                        f"Stoke -- partition rule places {paths[name]} as "
                        f"{entries_of[name]}: dim {d} on {run!r}, an axis "
                        f"the mesh does not have")
    stacks = {(f"{n}.stages." if n else "stages."): m
              for n, m in model.named_modules()
              if isinstance(m, PipelinedLM)}

    # the stage sets, then the published splits of the modules: compute
    # cuts, by the JAX dim each cuts
    cuts: Dict[str, Cut] = {}
    cut_dim: Dict[str, int] = {}
    for prefix, m in stacks.items():
        names = [n for n in shapes if n.startswith(prefix)]
        lead_axes = {next((a for d, a in on.get(n, ()) if d == 0), None)
                     for n in names}
        axes = next(iter(lead_axes))
        if (len(lead_axes) != 1 or axes is None or len(axes) != 1
                or axes[0] in mean_axes):
            # no stage set (every leaf's dim 0 on one axis, not the data
            # or seq axis): every stage rank runs the whole stack, and a
            # placement on the stack is gathered
            continue
        g = group(axes)
        lead = shapes[names[0]][0]
        if lead % g.size:
            raise ValueError(
                f"Stoke -- partition rule places {paths[names[0]]} dim 0 "
                f"({lead} stages) on the {axes[0]!r} axis of "
                f"{g.size} devices, which does not divide it")
        for n in names:
            shape = shapes[n]
            cuts[n] = Cut(shape, (lead // g.size, g.size, *shape[1:]), 1,
                          g.size, axes)
            cut_dim[n] = 0
            on[n] = [(d, a) for d, a in on[n] if d != 0]
        m.group = g
    groups_of_modules: List[nn.Module] = [m for m in stacks.values()
                                          if m.group is not None]
    for mname, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            kind, count, what = _ATTENTION, m.heads, "heads"
        elif isinstance(m, TransformerBlock):
            kind, count, what = _FFN, m.ff_in.out_features, "ff"
        elif isinstance(m, MoEFFN):
            kind, count, what = _EXPERTS, m.num_experts, "experts"
        else:
            continue
        keys = kind[0]
        full = {k: f"{mname}.{k}" if mname else k for k in keys}
        if full[next(iter(keys))].startswith(tuple(stacks)):
            # a stage stack's block: any placement beside the stage cut is
            # gathered
            continue
        # each leaf's dims on other axes than the data and seq axes: the
        # split's one dim, on one axis, whose entry names the data or seq
        # axes only after it
        split_axes = set()
        for k in keys:
            ds = on.get(full[k], ())
            other = [(d, axes) for d, axes in ds
                     if any(a not in mean_axes for a in axes)]
            if (len(other) != 1 or other[0][0] != keys[k]
                    or other[0][1][0] in mean_axes
                    or any(a not in mean_axes for a in other[0][1][1:])):
                break
            split_axes.add(other[0][1][:1])
        else:
            if len(split_axes) != 1:
                continue
            axes = split_axes.pop()
            g = group(axes)
            if count % g.size:
                k = next(iter(keys))
                raise ValueError(
                    f"Stoke -- partition rule places {paths[full[k]]} dim "
                    f"{keys[k]} ({count} {what}) on the {axes[0]!r} axis "
                    f"of {g.size} devices, which does not divide it")
            for k in keys:
                n = full[k]
                cuts[n] = _cut_for(m, k, shapes[n], g.size, axes)
                cut_dim[n] = keys[k]
                # what is left: the data and seq levels inside the split
                on[n] = [(d, a[1:] if d == keys[k] else a)
                         for d, a in on[n] if d != keys[k] or len(a) > 1]
            m.group = g
            groups_of_modules.append(m)

    # every other placement: gathered, in levels by JAX dim and by run of
    # axes of one kind (inside a compute cut, levels of its block)
    for name, dims in on.items():
        if not dims:
            continue
        path, perm, jshape = layout[name]
        outer = cuts.get(name)
        shape = outer.block if outer is not None else shapes[name]
        jlocal = list(jshape)
        if outer is not None:
            jlocal[cut_dim[name]] //= outer.size
        levels: List[Cut] = []
        for d, axes in dims:
            for run, mean in _runs(axes, mean_axes):
                g = group(run)
                if jlocal[d] % g.size:
                    raise ValueError(
                        f"Stoke -- partition rule places {paths[name]} dim "
                        f"{d} ({jshape[d]}) on the {run!r} axes of "
                        f"{g.size} devices, which does not divide it")
                view, vdim = _jax_view(shape, perm, jlocal, d)
                levels.append(Cut(shape, view, vdim, g.size, run, True,
                                  mean=mean))
                shape = levels[-1].block
                jlocal[d] //= g.size
        cut = levels[-1]
        for level in reversed(levels[:-1]):
            cut = dataclasses.replace(level, inner=cut)
        if outer is not None:
            cut = dataclasses.replace(outer, inner=cut)
        cuts[name] = cut
    # the group of each level, and of each level with the levels inside it
    tp_groups = {}
    for cut in cuts.values():
        c: Optional[Cut] = cut
        while c is not None:
            for axes in (c.group_axes, c.axes):
                tp_groups[axes] = group(axes)
            c = c.inner
    with torch.no_grad():
        for name, cut in cuts.items():
            owner, _, attr = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            p = getattr(mod, attr)
            setattr(mod, attr, nn.Parameter(
                cut.take(p.data, tp_groups[cut.group_axes].rank).clone(),
                requires_grad=p.requires_grad))
    for m in groups_of_modules:
        m.sync_widths()
    return TensorParallel(tp_groups, cuts, placed)


def _cut_for(module: nn.Module, key: str, shape: tuple, size: int,
             axes: tuple) -> Cut:
    """The :class:`Cut` of ``module``'s tensor ``key`` of port shape
    ``shape``: ``qkv`` in its ``[3, heads, D, ...]`` view; a ``Linear``
    weight ``[out, in]`` along the port dim of the JAX kernel's dim; the
    experts' ``[E, ...]`` along dim 0."""
    if key.startswith("qkv."):
        heads = module.heads
        d = module.hidden // heads
        return Cut(shape, (3, heads, d, *shape[1:]), 1, size, axes)
    port_dim = {"out.weight": 1, "ff_in.weight": 0, "ff_in.bias": 0,
                "ff_out.weight": 1, "w_in": 0, "w_out": 0}[key]
    return Cut(shape, shape, port_dim, size, axes)
