"""The DP / ZeRO ladder's collectives, written by hand over flat buckets.

The JAX package places each tier's state with ``NamedSharding`` and GSPMD
derives the collectives (``stoke_tpu/parallel/sharding.py``); the engine
synchronises once per optimizer step, at the apply boundary
(``stoke_tpu/engine.py:30``). :class:`Ladder` does the same work with
plain ``torch.distributed`` calls, which NCCL runs inside a captured CUDA
graph, and no module hooks (DDP's reducer and FSDP2's pre-forward hooks
would replace the step engine's 16-bit casts of the masters):

- leaves the rules replicate: their gradients all-reduced (AVG) in one
  flat bucket a dtype at the apply;
- leaves the rules shard: one bucket a dtype, laid out rank-major (rank
  ``r``'s region holds the ``r``-th slice of each leaf along its
  dimension), so a reduce-scatter leaves each rank the reduced gradient of
  its slices and an all-gather of the ranks' slices rebuilds the leaves.
  The optimizer holds the rank's slices (views into the bucket's ``own``
  buffer) in place of those leaves, so its state is 1/W of theirs;
- oss: at the apply the full gradients are reduce-scattered, the step
  runs on the slices, the slices are all-gathered into the parameters;
- sddp: each micro-step's gradient is reduce-scattered into the sharded
  accumulator right after its backward, so the full ``.grad`` lives for
  one micro-step. A leaf whose gradient buffer shards but whose optimizer
  state does not (``SDDPConfig.min_shard_size`` below
  ``OSSConfig.min_shard_size``) keeps only its accumulator's slice; at the
  apply the slices are all-gathered into its ``.grad`` and the optimizer
  steps it whole;
- fsdp: the parameters of sharded leaves hold no storage between steps;
  they are all-gathered before a forward and freed after the backward
  (or after a forward without grad). The whole model is gathered at once:
  the port has no per-layer wrapping, so a micro-step's peak holds every
  parameter, while between steps only the slices are kept. With
  :meth:`Ladder.offload_params` (``OffloadParamsConfig``) the slices too
  live in pinned host memory between steps: copied to the card before
  the gather of a forward, back after the optimizer step (the JAX
  engine's ``_vars_to_compute`` and host ``out_shardings``).

With a gradient transport (``CommConfig``,
:mod:`~stoke_tpu_torch.parallel.collectives`), the apply first makes every
leaf's reduced gradient whole on every rank (oss all-reduces where it
would reduce-scatter, the sharded accumulators are all-gathered), the
transport rewrites them, and the slices take their parts; without one the
path above is unchanged.

Under a mesh of several axes the group is the data sub-group, and a
sharded leaf's slice ``d`` is held alike by every rank of data row ``d``,
as the JAX package places each tier's state over the data axis alone
(``stoke_tpu/parallel/sharding.py:243-294``):

- model, expert or stage axes (:mod:`~stoke_tpu_torch.parallel.tensor`):
  every rank of a model group holds the same gradient of each leaf it does
  not split, and its own slice's of each leaf it splits, so each is
  averaged over the ranks that share its place on the other axes. The
  leaves a partition rule places (``keep_whole``) stay whole over the data
  axis whatever the tier, as the JAX package's rules win over the tier's
  placement; a leaf a rule places on the data axis (or the ``seq`` axis)
  ends its backward with its slice's gradient already averaged over that
  axis (:mod:`~stoke_tpu_torch.parallel.tensor`'s ``mean`` levels), so it
  is not averaged over it again (``averaged``);
- a ``seq`` axis (``across``, the shards of one data row): each shard's
  gradient is its part of the row's, so every reduction of gradients runs
  over the data sub-group and then over ``across`` (a reduce-scatter over
  the data sub-group, then the slice averaged over the row's shards): the
  mean over the whole world, as dp takes it.

Every reduction of gradients averages over the W ranks: each rank's
objective is the mean over its rows, so their average is the mean over the
global batch, which the JAX engine differentiates. A gradient that a rank
does not have (a parameter its forward did not use) is reduced as zeros,
so every rank agrees on the bucket's size.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from stoke_tpu_torch.parallel.sharding import ShardingRules

def _grad_or_zeros(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


class _Bucket:
    """Sharded leaves of one dtype and one placement. ``grad`` holds the
    reduced gradient of this rank's slices (reduced after every micro-step
    when ``per_micro``: the sharded accumulator). When ``steps_slices``
    the optimizer steps on the slices: ``own`` holds this rank's slices of
    the leaves' values and ``shards`` views of it in each slice's shape;
    when ``frees`` too (fsdp) the leaves hold no storage between steps.
    Otherwise (sddp's gradient buffer alone) ``own`` is None and
    ``shards`` empty."""

    def __init__(self, index: List[int], leaves: List[torch.Tensor],
                 dims: List[int], world: int, rank: int, per_micro: bool,
                 steps_slices: bool, frees: bool):
        self.index, self.leaves, self.dims = index, leaves, dims
        self.world, self.rank, self.per_micro = world, rank, per_micro
        self.steps_slices, self.frees = steps_slices, frees
        self.chunks = []
        for t, d in zip(leaves, dims):
            shape = list(t.shape)
            shape[d] //= world
            self.chunks.append(tuple(shape))
        self.numels = [t.numel() // world for t in leaves]
        self.offsets = [sum(self.numels[:i]) for i in range(len(leaves))]
        self.size = sum(self.numels)
        kw = dict(dtype=leaves[0].dtype, device=leaves[0].device)
        self.grad = torch.zeros(self.size, **kw)
        self.own, self.shards = None, []
        if steps_slices:
            self.own = torch.empty(self.size, **kw)
            self.shards = self.views(self.own)
            self.load_own()

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each slice of a rank's region ``flat``, in its shape."""
        return [flat[o:o + n].view(c) for o, n, c in
                zip(self.offsets, self.numels, self.chunks)]

    def _stacked(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """A view of leaf-shaped ``t`` as ``[W, *slice shape]``: entry
        ``r`` is rank ``r``'s slice."""
        d = self.dims[i]
        return t.unflatten(d, (self.world, t.shape[d] // self.world)
                           ).movedim(d, 0)

    def pack(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Leaf-shaped ``tensors`` as one rank-major flat buffer."""
        return torch.cat([self._stacked(t, i).reshape(self.world, -1)
                          for i, t in enumerate(tensors)], 1).view(-1)

    def unpack(self, flat: torch.Tensor,
               into: Optional[Sequence[torch.Tensor]] = None) -> None:
        """A rank-major flat buffer into the leaves (or into leaf-shaped
        ``into``)."""
        rows = flat.view(self.world, self.size)
        for i, t in enumerate(self.leaves if into is None else into):
            o, n = self.offsets[i], self.numels[i]
            self._stacked(t, i).copy_(
                rows[:, o:o + n].view(self.world, *self.chunks[i]))

    @torch.no_grad()
    def load_own(self) -> None:
        """This rank's slices of the leaves into ``own``."""
        for i, (s, t) in enumerate(zip(self.shards, self.leaves)):
            s.copy_(self._stacked(t, i)[self.rank])


class Ladder:
    """The collectives of one run's tier over its parameters.

    Args:
        params: the module's trainable parameters, in order.
        rules: the tier's :class:`~stoke_tpu_torch.parallel.sharding
            .ShardingRules` over the group's size; ``opt_dim``,
            ``grad_dim`` and ``param_dim`` place each leaf.
        group: the process group of the data axis.
        keep_whole: indices of ``params`` a partition rule placed; they
            are stepped whole.
        across: under a ``seq`` axis, the process group of this process's
            data row (the seq axis's sub-group), over which every
            gradient is averaged after the data sub-group.
        averaged: for indices of ``keep_whole``, the reductions their
            gradients have had in the backward: a set of ``"group"`` (the
            data sub-group) and ``"across"``; they are not run again.
        jax_layout: for each of ``params``, ``(its JAX shape, each JAX dim
            that is a whole dim of the tensor, to that dim)``
            (:func:`~stoke_tpu_torch.parallel.sharding.jax_dim_map`), or
            None: the rules then pick the dim on the JAX shape, as the JAX
            package places the leaf, where that dim is whole in the port's
            tensor (else, and without a layout, on the tensor's shape).
    """

    def __init__(self, params: Sequence[torch.Tensor], rules: ShardingRules,
                 group=None, keep_whole: Sequence[int] = (), across=None,
                 jax_layout: Optional[Sequence[Optional[tuple]]] = None,
                 averaged: Optional[Dict[int, set]] = None):
        self.group = group
        #: the reductions each leaf's gradient has had in the backward
        self.averaged = {i: frozenset(v) for i, v in (averaged or {}).items()
                         if v}
        self.across = (across if across is not None
                       and dist.get_world_size(across) > 1 else None)
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if rules.axis_size != self.world:
            raise ValueError(
                f"Stoke -- sharding rules over {rules.axis_size} devices "
                f"for a group of {self.world}")
        self.params = list(params)
        # leaves the optimizer steps whole (their gradients all-reduced,
        # or all-gathered from a sharded accumulator)
        self.replicated: List[int] = []
        grouped: Dict[tuple, List[int]] = {}
        dims: Dict[int, int] = {}
        keep_whole = set(keep_whole)
        for i, p in enumerate(self.params):
            shape = tuple(p.shape)
            jl = jax_layout[i] if jax_layout is not None else None

            def pick(rule):
                if jl is not None:
                    d = rule(jl[0])
                    if d is None:
                        return None
                    if d in jl[1]:
                        return jl[1][d]
                return rule(shape)

            opt, grad = pick(rules.opt_dim), pick(rules.grad_dim)
            frees = pick(rules.param_dim) is not None
            if i in keep_whole:
                opt = grad = None
                frees = False
            if frees and opt is None:
                raise ValueError(
                    "Stoke -- a sharded parameter needs sharded optimizer "
                    f"state (leaf of shape {shape})")
            if opt is None:
                self.replicated.append(i)
            if opt is None and grad is None:
                continue
            # the rules pick the dimension by shape alone; their min sizes
            # decide only whether a leaf shards
            dims[i] = opt if opt is not None else grad
            grouped.setdefault((p.dtype, grad is not None, opt is not None,
                                frees), []).append(i)
        made = [_Bucket(idx, [self.params[i] for i in idx],
                        [dims[i] for i in idx], self.world, self.rank,
                        *key[1:])
                for key, idx in grouped.items()]
        #: buckets whose slices the optimizer steps on
        self.buckets = [b for b in made if b.steps_slices]
        #: sddp's sharded accumulators of leaves stepped whole
        self.grad_buckets = [b for b in made if not b.steps_slices]
        self.opt_params = list(self.params)
        for b in self.buckets:
            for i, s in zip(b.index, b.shards):
                self.opt_params[i] = s
        #: fsdp's buckets, whose leaves hold no storage between steps
        self._freed = [b for b in self.buckets if b.frees]
        self._materialized = True
        #: fsdp's slices in host memory between steps (offload_params)
        self._host_own: List[torch.Tensor] = []
        self._own_resident = True
        if self._freed:
            for b in self._freed:
                for p in b.leaves:
                    if (p.storage_offset() != 0
                            or p.untyped_storage().nbytes()
                            != p.numel() * p.element_size()):
                        raise ValueError(
                            "Stoke -- fsdp frees each sharded parameter's "
                            "storage between steps, so a parameter must "
                            "own its storage (no views or shared storage)")
            self.release()

    # ------------------------------------------------------------------ #
    # parameters (fsdp: gathered for a forward, freed after)
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def gather_params(self, buckets: List[_Bucket]) -> None:
        """All-gather every rank's slices into the leaves of
        ``buckets``."""
        for b in buckets:
            full = torch.empty(self.world * b.size, dtype=b.own.dtype,
                               device=b.own.device)
            dist.all_gather_into_tensor(full, b.own, group=self.group)
            b.unpack(full)

    def offload_params(self) -> None:
        """fsdp: keep this rank's slices of the sharded parameters in host
        memory (pinned when they live on a CUDA device) between steps; they
        come back to the device for a forward's gather and leave after the
        optimizer step."""
        if not self._freed or self._host_own:
            return
        for b in self._freed:
            host = torch.empty(b.size, dtype=b.own.dtype, device="cpu",
                               pin_memory=b.own.is_cuda)
            host.copy_(b.own)
            self._host_own.append(host)
        self._spill_own()

    @property
    def host_slices(self) -> List[torch.Tensor]:
        """fsdp's slices in host memory (empty without offload)."""
        return list(self._host_own)

    @torch.no_grad()
    def _restore_own(self) -> None:
        """The offloaded slices back into their device buffers."""
        if self._own_resident:
            return
        for b, host in zip(self._freed, self._host_own):
            b.own.untyped_storage().resize_(b.size * b.own.element_size())
            b.own.copy_(host, non_blocking=True)
        self._own_resident = True

    @torch.no_grad()
    def _spill_own(self) -> None:
        """The slices to host memory, their device buffers freed."""
        if not (self._host_own and self._own_resident):
            return
        for b, host in zip(self._freed, self._host_own):
            host.copy_(b.own, non_blocking=True)
            b.own.untyped_storage().resize_(0)
        self._own_resident = False

    def materialize(self) -> None:
        """fsdp: give the sharded parameters storage and gather them
        (nothing when they are already whole, or below fsdp); offloaded
        slices come back to the device first."""
        if self._materialized:
            return
        self._restore_own()
        for b in self._freed:
            for p in b.leaves:
                p.untyped_storage().resize_(p.numel() * p.element_size())
        self._materialized = True
        self.gather_params(self._freed)

    def release(self) -> None:
        """fsdp: free the sharded parameters' storage; their values live
        in the slices."""
        if not (self._freed and self._materialized):
            return
        for b in self._freed:
            for p in b.leaves:
                p.untyped_storage().resize_(0)
        self._materialized = False

    @contextlib.contextmanager
    def whole(self) -> Iterator[None]:
        """The parameters whole inside the block (fsdp gathers them, and
        frees them after when it was they that were gathered)."""
        gathered = not self._materialized
        spilled = not self._own_resident
        self.materialize()
        try:
            yield
        finally:
            if gathered:
                self.release()
            if spilled:
                self._spill_own()

    def load_from_params(self) -> None:
        """After the parameters were written (a checkpoint load), take the
        slices from them again."""
        spilled = not self._own_resident
        self._restore_own()
        for b in self.buckets:
            b.load_own()
        if spilled:
            self._spill_own()

    # ------------------------------------------------------------------ #
    # gradients
    # ------------------------------------------------------------------ #

    def _avg_across(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over ``across`` in place (nothing without
        one)."""
        if self.across is not None:
            dist.all_reduce(t, op=dist.ReduceOp.AVG, group=self.across)
        return t

    def _all_reduce_avg(self, t: torch.Tensor,
                        done: frozenset = frozenset()) -> None:
        """``t`` averaged over the group, then over ``across``, leaving
        out the reductions ``done`` names (``"group"``, ``"across"``)."""
        if "group" not in done:
            dist.all_reduce(t, op=dist.ReduceOp.AVG, group=self.group)
        if "across" not in done:
            self._avg_across(t)

    def _average_leaves(self, idx: Sequence[int]) -> List[torch.Tensor]:
        """The gradients of the leaves ``idx`` (in the parameters' order)
        averaged over the ranks, one flat bucket a dtype and set of
        reductions still to run: each averaged gradient, by position."""
        out: List[Optional[torch.Tensor]] = [None] * len(idx)
        # in the parameters' order, the same on every rank (a set's order
        # of dtypes could differ between processes)
        keys = dict.fromkeys(
            (self.params[i].dtype, self.averaged.get(i, frozenset()))
            for i in idx)
        for dtype, done in keys:
            at = [j for j, i in enumerate(idx)
                  if self.params[i].dtype == dtype
                  and self.averaged.get(i, frozenset()) == done]
            grads = [_grad_or_zeros(self.params[idx[j]]) for j in at]
            flat = torch.cat([g.reshape(-1) for g in grads])
            self._all_reduce_avg(flat, done)
            for j, v in zip(at, flat.split([g.numel() for g in grads])):
                out[j] = v.view_as(self.params[idx[j]])
        return out

    @torch.no_grad()
    def _reduce_scatter_into(self, b: _Bucket, accumulate: bool) -> None:
        flat = b.pack([_grad_or_zeros(p) for p in b.leaves])
        if accumulate:
            out = torch.empty_like(b.grad)
            dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.AVG,
                                       group=self.group)
            b.grad.add_(self._avg_across(out))
        else:
            dist.reduce_scatter_tensor(b.grad, flat, op=dist.ReduceOp.AVG,
                                       group=self.group)
            self._avg_across(b.grad)
        for p in b.leaves:
            p.grad = None

    def after_backward(self, sync: bool = True) -> None:
        """After a micro-step's backward: reduce-scatter the gradients of
        the buckets that shard their accumulator (sddp, fsdp) into it
        (unless ``sync`` is False), then free fsdp's parameters."""
        if sync:
            for b in self.buckets + self.grad_buckets:
                if b.per_micro:
                    self._reduce_scatter_into(b, accumulate=True)
        self.release()

    @torch.no_grad()
    def reduce_for_apply(self, transport: Optional[Callable[
            [List[torch.Tensor]], None]] = None
    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """At the apply boundary: all-reduce the replicated leaves'
        gradients (all-gather those that sddp accumulated sharded),
        reduce-scatter the other buckets', and hand the slices their
        reduced gradients. Returns (the replicated gradients, the slices'
        gradients), which together are what the optimizer steps on.

        With a gradient ``transport`` (a function that rewrites the whole
        reduced gradients in place, the same on every rank), every leaf's
        gradient is first made whole on every rank (the oss buckets
        all-reduced instead of reduce-scattered, the sharded accumulators
        all-gathered), the transport runs on them, and the slices take
        their parts of its result."""
        if transport is not None:
            full = self._whole_grads()
            transport(full)
            return self._hand_out(full)
        rep = [self.params[i] for i in self.replicated]
        gathered = set()
        for b in self.grad_buckets:
            full = torch.empty(self.world * b.size, dtype=b.grad.dtype,
                               device=b.grad.device)
            dist.all_gather_into_tensor(full, b.grad, group=self.group)
            grads = [torch.empty_like(p) for p in b.leaves]
            b.unpack(full, grads)
            for p, g in zip(b.leaves, grads):
                p.grad = g
            gathered.update(b.index)
        reduced = [i for i in self.replicated if i not in gathered]
        for i, v in zip(reduced, self._average_leaves(reduced)):
            p = self.params[i]
            if p.grad is None:
                p.grad = v.clone()
            else:
                p.grad.copy_(v)
        shard_grads = []
        for b in self.buckets:
            if not b.per_micro:
                self._reduce_scatter_into(b, accumulate=False)
            for s, g in zip(b.shards, b.views(b.grad)):
                s.grad = g
                shard_grads.append(g)
        return [p.grad for p in rep], shard_grads

    def _whole_grads(self) -> List[torch.Tensor]:
        """Every parameter's reduced gradient, whole, on every rank (in
        the parameters' order): the sharded accumulators all-gathered, the
        other gradients all-reduced (AVG) in one flat bucket a dtype."""
        full: List[Optional[torch.Tensor]] = [None] * len(self.params)
        local = []
        for b in self.buckets + self.grad_buckets:
            if not b.per_micro:
                local += b.index
                continue
            whole = torch.empty(self.world * b.size, dtype=b.grad.dtype,
                                device=b.grad.device)
            dist.all_gather_into_tensor(whole, b.grad, group=self.group)
            grads = [torch.empty_like(p) for p in b.leaves]
            b.unpack(whole, grads)
            for i, g in zip(b.index, grads):
                full[i] = g
        local += [i for i in self.replicated if full[i] is None
                  and i not in local]
        local.sort()
        for i, v in zip(local, self._average_leaves(local)):
            full[i] = v
        for p in self.params:
            p.grad = None
        return full

    def _hand_out(self, full: List[torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The contract of :meth:`reduce_for_apply` from whole reduced
        gradients: the leaves stepped whole get theirs as ``.grad``, the
        slices their parts (rank-major, into the buckets' ``grad``)."""
        for i in self.replicated:
            self.params[i].grad = full[i]
        shard_grads = []
        for b in self.buckets:
            rows = b.pack([full[i] for i in b.index]).view(self.world, b.size)
            b.grad.copy_(rows[self.rank])
            for s, g in zip(b.shards, b.views(b.grad)):
                s.grad = g
                shard_grads.append(g)
        return [self.params[i].grad for i in self.replicated], shard_grads

    def drop_grads(self) -> None:
        """Zero the sharded accumulators and drop every gradient."""
        for b in self.buckets + self.grad_buckets:
            b.grad.zero_()
            for s in b.shards:
                s.grad = None
        for p in self.params:
            p.grad = None

    def after_step(self) -> None:
        """After the optimizer step: :meth:`drop_grads`, and (oss, sddp)
        all-gather the updated slices into the parameters; fsdp keeps them
        sharded (in host memory under :meth:`offload_params`)."""
        self.drop_grads()
        self.gather_params([b for b in self.buckets if not b.frees])
        self._spill_own()

    # ------------------------------------------------------------------ #
    # small reductions
    # ------------------------------------------------------------------ #

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A bool tensor ANDed over the ranks, ``across`` included (on the
        device)."""
        f = flag.to(torch.float32)
        dist.all_reduce(f, op=dist.ReduceOp.MIN, group=self.group)
        if self.across is not None:
            dist.all_reduce(f, op=dist.ReduceOp.MIN, group=self.across)
        return f > 0.5

    def reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed, ``op="max"``) over the ranks, in
        place: the parts of the slices, which ``across`` holds alike."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=self.group)
        return t

    def average(self, tree):
        """Each float tensor leaf of ``tree`` averaged over the ranks (one
        collective), detached, on the device."""
        leaves, spec = tree_flatten(tree)
        idx = [i for i, l in enumerate(leaves)
               if torch.is_tensor(l) and l.is_floating_point()]
        if not idx:
            return tree
        flat = torch.cat([leaves[i].detach().float().reshape(-1)
                          for i in idx])
        self._all_reduce_avg(flat)
        out = list(leaves)
        for i, v in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = v.view_as(leaves[i]).to(leaves[i].dtype)
        return tree_unflatten(out, spec)

    # ------------------------------------------------------------------ #
    # what each rank holds
    # ------------------------------------------------------------------ #

    def sliced_dim(self, i: int) -> Optional[int]:
        """The dimension along which the optimizer holds parameter ``i``'s
        slice (oss, sddp, fsdp), or None for a leaf it steps whole."""
        for b in self.buckets:
            if i in b.index:
                return b.dims[b.index.index(i)]
        return None

    def accumulator_dim(self, i: int) -> Optional[int]:
        """The dimension of parameter ``i``'s sharded accumulator (sddp,
        fsdp), or None for a leaf whose ``.grad`` accumulates."""
        for b in self.buckets + self.grad_buckets:
            if b.per_micro and i in b.index:
                return b.dims[b.index.index(i)]
        return None

    @torch.no_grad()
    def gather_slice(self, s: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's slice ``s`` (rank-major along ``dim``) all-gathered
        into the whole leaf; every rank must call it, in the same order."""
        if self.world == 1:
            return s
        out = torch.empty(self.world * s.numel(), dtype=s.dtype,
                          device=s.device)
        dist.all_gather_into_tensor(out, s.contiguous().view(-1),
                                    group=self.group)
        return out.view(self.world, *s.shape).movedim(0, dim).flatten(
            dim, dim + 1)

    def slice_extents(self, n: int) -> List[List[int]]:
        """Each rank's ``[start, stop)`` of a dimension of ``n``."""
        k = n // self.world
        return [[r * k, (r + 1) * k] for r in range(self.world)]

    def accumulator(self, i: int) -> Optional[torch.Tensor]:
        """Parameter ``i``'s slice of the sharded accumulator (sddp,
        fsdp), or None for a leaf whose ``.grad`` accumulates."""
        for b in self.buckets + self.grad_buckets:
            if b.per_micro and i in b.index:
                return b.views(b.grad)[b.index.index(i)]
        return None


@torch.no_grad()
def gather_by_rank(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Each rank's tensor ``t`` (of one shape on every rank of ``group``),
    as a list by rank; every rank must call it, in the same order."""
    world = dist.get_world_size(group)
    if world == 1:
        return [t]
    out = torch.empty(world * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous().view(-1), group=group)
    return list(out.view(world, *t.shape).unbind(0))
