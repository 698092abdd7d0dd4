"""Tensor, expert and pipeline parallelism of the port: the Megatron,
expert and stage splits, with their collectives written by hand.

Counterpart of the JAX package's partition rules under a ``("data",
"model")`` or ``("data", "expert")`` mesh (``PartitionRulesConfig``,
``stoke_tpu/models/bert.py:236-253`` ``bert_tensor_parallel_rules``,
``stoke_tpu/models/moe.py:146-157`` ``moe_expert_parallel_rules``). There
GSPMD derives every collective from the placements; here
:func:`apply_partition_rules` reads the same rules, cuts each parameter
they place on the second axis down to this process's slice, and gives the
blocks their group, whose forwards run three autograd functions at the
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
every rank of the model (expert) group: each of them sees the same rows
(its data coordinate's), draws the same dropout masks (its generator is
seeded by the data coordinate) and combines the same whole results.
So the ladder reduces every gradient over the data sub-group only, and
the norms of a step count a sliced leaf's squares summed over the model
group and a replicated leaf once.

The rules are matched against each tensor's JAX leaf path
(:func:`stoke_tpu_torch.convert.jax_param_layout`), a rule's dims read in
the JAX layout. Recognised are the leaves of the three published sets:

- Megatron: ``attention/qkv`` kernel ``[hidden, 3, heads, D]`` over
  heads (dim 2) and its bias ``[3, heads, D]`` (dim 1); ``attention/out``
  kernel over its input (dim 0); ``ff_in`` kernel over ff (dim 1) and its
  bias (dim 0); ``ff_out`` kernel over its input (dim 0). The port's
  ``qkv`` weight is ``qkv.reshape(hidden, -1).T``: a rank's heads are
  rows ``[:, heads_r]`` of its ``[3, heads, D, hidden]`` view, not one
  block of rows;
- expert: ``moe/w_in`` ``[E, H, ff]`` and ``moe/w_out`` ``[E, ff, H]``
  over the experts (dim 0); the router stays replicated;
- stage (``pipeline_parallel_rules``): every stage-stacked leaf of a
  ``PipelinedLM`` (``stages/...``, ``[V·S, ...]``) over its dim 0. The
  cut is strided, as the JAX package reshapes the stack to ``[V, S,
  ...]`` and shards dim 1: rank ``d`` holds ``stages[d::S]``. The model
  gets the group (:mod:`~stoke_tpu_torch.parallel.pipeline` runs its
  schedule over it); the embedding and the head stay whole. There the
  invariant holds of every tensor outside the stages: every rank of a
  stage group takes the same rows and ends with the whole batch's logits
  (the model's docstring).

Any other placement on a mesh axis, a column-parallel product without its
row-parallel partner, a split bias without its kernel and a stage set
that leaves a stacked leaf whole or places another dim are refused
(``NotImplementedError`` naming the leaf and ROADMAP item 8e), and a
head, ff, expert or stage count the axis does not divide raises
``ValueError``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from stoke_tpu_torch.parallel.sharding import (
    compile_partition_rules,
    rule_entries,
)

LATER_RULES = ("ROADMAP Queue 1 item 8e (meshes of three axes, dcn_axes "
               "and partition rules beyond the Megatron, expert and stage "
               "sets)")


@dataclass(frozen=True)
class ModelGroup:
    """One process's place on the model (or expert) axis: the axis's
    process ``group``, its ``size``, this process's coordinate ``rank`` and
    the axis's name. A ``group`` of None is a virtual rank: its
    collectives are left out and the caller combines the ranks' results
    (the forwards' ``partial`` methods)."""

    group: Any
    size: int
    rank: int
    axis: Optional[str]


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


@dataclass(frozen=True)
class Cut:
    """How one parameter splits over the model axis: its whole shape
    ``full`` in the port's layout, the view ``view`` of it in which the
    split dimension ``dim`` is a dimension of its own (the ``qkv``
    layouts' ``[3, heads, D, ...]``), and the axis size. Rank ``r`` holds
    the ``r``-th of ``size`` equal blocks along ``dim`` of the view."""

    full: tuple
    view: tuple
    dim: int
    size: int

    @property
    def local_view(self) -> tuple:
        v = list(self.view)
        v[self.dim] //= self.size
        return tuple(v)

    @property
    def local(self) -> tuple:
        """The slice's shape in the port's layout."""
        shape = list(self.full)
        shape[0 if self.view != self.full else self.dim] //= self.size
        return tuple(shape)

    def take(self, whole, rank: int):
        """Rank ``rank``'s slice of ``whole`` (a tensor or numpy array of
        shape ``full``)."""
        n = self.view[self.dim] // self.size
        idx = [slice(None)] * len(self.view)
        idx[self.dim] = slice(rank * n, (rank + 1) * n)
        part = whole.reshape(self.view)[tuple(idx)].reshape(self.local)
        if isinstance(part, np.ndarray):
            return np.ascontiguousarray(part)
        return part.contiguous()

    def join(self, parts: Sequence):
        """The whole tensor (or array) of every rank's slice, by rank."""
        parts = [p.reshape(self.local_view) for p in parts]
        if isinstance(parts[0], np.ndarray):
            return np.concatenate(parts, self.dim).reshape(self.full)
        return torch.cat(parts, self.dim).reshape(self.full)


class TensorParallel:
    """What :func:`apply_partition_rules` did to one model: the model
    group (:class:`ModelGroup`), the :class:`Cut` of each parameter it
    split, by name, and the names of the parameters a rule placed (split
    or replicated: the rule wins over the tier, so the ladder keeps them
    whole over the data axis)."""

    def __init__(self, group: ModelGroup, cuts: Dict[str, Cut],
                 placed: Set[str]):
        self.group = group
        self.cuts = cuts
        self.placed = placed

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def rank(self) -> int:
        return self.group.rank

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
        return cut.take(whole, self.rank)

    @torch.no_grad()
    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``name``'s whole tensor from every rank's slice ``t``
        (or a state shaped like the slice); every rank of the group calls
        it, in the same order. Other names and shapes pass through."""
        cut = self.cuts.get(name)
        if cut is None or tuple(t.shape) != cut.local:
            return t
        out = t.new_empty((self.size * t.numel(),))
        dist.all_gather_into_tensor(out, t.contiguous().view(-1),
                                    group=self.group.group)
        return cut.join(list(out.view(self.size, *cut.local).unbind(0)))

    def reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) over the model group, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group.group)
        return t

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A bool tensor ANDed over the model group (on the device)."""
        f = flag.to(torch.float32)
        dist.all_reduce(f, op=dist.ReduceOp.MIN, group=self.group.group)
        return f > 0.5

    @torch.no_grad()
    def whole_copy(self, model: nn.Module, memo=None) -> nn.Module:
        """A copy of the split ``model`` made whole: every cut parameter
        gathered over the group, every block's group dropped (collective:
        each rank of the group calls it). The copy shares the group until
        it drops it: a process group cannot be copied."""
        memo = {} if memo is None else memo
        memo.setdefault(id(self.group), self.group)
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


def _refuse(path: str, entries, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"Stoke -- the partition rule placing {path} as {entries} is not "
        f"ported yet ({why}): {LATER_RULES}")


def apply_partition_rules(model: nn.Module, rules, mesh,
                          data_axis: str = "data") -> TensorParallel:
    """Split ``model`` (the whole model, seeded, converted or loaded, on
    its device) over ``mesh``'s axis other than ``data_axis`` by
    ``rules`` (``PartitionRulesConfig.rules``, plain or compiled): see
    :func:`shard_module`. On a 1-D mesh no rule may name an axis."""
    names = tuple(mesh.mesh_dim_names)
    other = [a for a in names if a != data_axis]
    if not other:
        group = ModelGroup(None, 1, 0, None)
    else:
        pg = mesh.get_group(other[0])
        group = ModelGroup(pg, dist.get_world_size(pg), dist.get_rank(pg),
                           other[0])
    return shard_module(model, rules, group)


def shard_module(model: nn.Module, rules, group: ModelGroup) -> TensorParallel:
    """Cut each parameter of ``model`` that ``rules`` place on
    ``group.axis`` down to rank ``group.rank``'s slice, and give the
    attention blocks their local heads, the FFNs their local ff, the
    MoE FFNs their local experts and a ``PipelinedLM`` its stages, with
    ``group``. The rule set is recognised by the leaves it places (the
    module docstring); anything else raises."""
    from stoke_tpu_torch.convert import jax_param_layout
    from stoke_tpu_torch.models.bert import (
        MultiHeadAttention,
        TransformerBlock,
    )
    from stoke_tpu_torch.models.moe import MoEFFN

    # ``re.compile`` of a compiled pattern is the pattern: plain and
    # compiled rules alike
    compiled = compile_partition_rules(rules)
    layout = jax_param_layout(model)
    placed: Set[str] = set()
    on_axis: Dict[str, int] = {}
    paths: Dict[str, str] = {}
    for name, _ in model.named_parameters():
        path, _, jshape = layout[name]
        paths[name] = spath = "/".join(path)
        entries = rule_entries(spath, jshape, compiled, strict=True)
        if entries is None:
            continue
        placed.add(name)
        named = [(d, e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                  else e) for d, e in enumerate(entries) if e is not None]
        if not named:
            continue
        if (len(named) > 1 or group.axis is None
                or named[0][1] != group.axis):
            raise _refuse(spath, entries, "the port splits one dimension "
                          f"of a leaf over the mesh's "
                          f"{group.axis or 'second'!s} axis")
        on_axis[name] = named[0][0]

    cuts = _stage_cuts(model, on_axis, paths, group)
    for mname, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            kind, count, what = _ATTENTION, m.heads, "heads"
        elif isinstance(m, TransformerBlock):
            kind, count, what = _FFN, m.ff_in.out_features, "ff"
        elif isinstance(m, MoEFFN):
            kind, count, what = _EXPERTS, m.num_experts, "experts"
        else:
            continue
        split, whole = kind
        full = {k: f"{mname}.{k}" if mname else k
                for k in (*split, *whole)}
        for k in whole:
            if full[k] in on_axis:
                raise _refuse(paths[full[k]], "split",
                              "it stays whole in the published sets")
        for k, d in split.items():
            if full[k] in on_axis and on_axis[full[k]] != d:
                raise _refuse(paths[full[k]], f"dim {on_axis[full[k]]}",
                              f"the published set splits dim {d}")
        on = [k for k in split if full[k] in on_axis]
        if not on:
            continue
        if len(on) != len(split):
            missing = [paths[full[k]] for k in split if k not in on]
            raise NotImplementedError(
                f"Stoke -- the partition rules split "
                f"{[paths[full[k]] for k in on]} but not {missing}: a "
                f"column-parallel product needs its row-parallel partner "
                f"(and its bias split with it) in the port; "
                f"{LATER_RULES}")
        if count % group.size:
            k = on[0]
            raise ValueError(
                f"Stoke -- partition rule places {paths[full[k]]} dim "
                f"{split[k]} ({count} {what}) on the {group.axis!r} axis "
                f"of {group.size} devices, which does not divide it")
        for k in on:
            p = model.get_parameter(full[k])
            cuts[full[k]] = _cut_for(m, k, tuple(p.shape), group.size)
        m.group = group
    left = sorted(set(on_axis) - set(cuts))
    if left:
        raise _refuse(paths[left[0]], "split", "the port splits only the "
                      "Megatron, expert and stage leaves")
    with torch.no_grad():
        for name, cut in cuts.items():
            owner, _, attr = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            p = getattr(mod, attr)
            setattr(mod, attr, nn.Parameter(
                cut.take(p.data, group.rank).clone(),
                requires_grad=p.requires_grad))
    for m in model.modules():
        if getattr(m, "group", None) is group:
            m.sync_widths()
    return TensorParallel(group, cuts, placed)


def _stage_cuts(model: nn.Module, on_axis: Dict[str, int],
                paths: Dict[str, str], group: ModelGroup) -> Dict[str, Cut]:
    """The strided cut of each ``PipelinedLM``'s stage set that the rules
    place on ``group.axis`` (taken out of ``on_axis``); each such model
    gets ``group``. A set placed in part, or on another dim than the
    stacked stage dim, is refused."""
    from stoke_tpu_torch.models.pipelined_lm import PipelinedLM

    cuts: Dict[str, Cut] = {}
    for mname, m in model.named_modules():
        if not isinstance(m, PipelinedLM):
            continue
        prefix = f"{mname}.stages." if mname else "stages."
        names = [n for n in paths if n.startswith(prefix)]
        on = [n for n in names if n in on_axis]
        if not on:
            continue
        for n in on:
            if on_axis[n] != 0:
                raise _refuse(paths[n], f"dim {on_axis[n]}", "the stage "
                              "set places the stacked stage dim, dim 0")
        if len(on) != len(names):
            missing = [paths[n] for n in names if n not in on]
            raise NotImplementedError(
                f"Stoke -- the partition rules place {len(on)} of the "
                f"{len(names)} stage-stacked leaves on the {group.axis!r} "
                f"axis but not {missing}: the stage set places every leaf "
                f"under stages/; {LATER_RULES}")
        lead = model.get_parameter(on[0]).shape[0]
        if lead % group.size:
            raise ValueError(
                f"Stoke -- partition rule places {paths[on[0]]} dim 0 "
                f"({lead} stages) on the {group.axis!r} axis of "
                f"{group.size} devices, which does not divide it")
        for n in on:
            shape = tuple(model.get_parameter(n).shape)
            cuts[n] = Cut(shape, (lead // group.size, group.size,
                                  *shape[1:]), 1, group.size)
            del on_axis[n]
        m.group = group
    return cuts


def _cut_for(module: nn.Module, key: str, shape: tuple, size: int) -> Cut:
    """The :class:`Cut` of ``module``'s tensor ``key`` of port shape
    ``shape``: ``qkv`` in its ``[3, heads, D, ...]`` view; a ``Linear``
    weight ``[out, in]`` along the port dim of the JAX kernel's dim; the
    experts' ``[E, ...]`` along dim 0."""
    if key.startswith("qkv."):
        heads = module.heads
        d = module.hidden // heads
        return Cut(shape, (3, heads, d, *shape[1:]), 1, size)
    port_dim = {"out.weight": 1, "ff_in.weight": 0, "ff_in.bias": 0,
                "ff_out.weight": 1, "w_in": 0, "w_out": 0}[key]
    return Cut(shape, shape, port_dim, size)
