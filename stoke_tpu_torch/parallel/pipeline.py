"""Pipeline parallelism of the port: microbatches streamed through stages
held on the processes of a ``stage`` group.

Counterpart of ``stoke_tpu/parallel/pipeline.py``. Stage ``d`` of S holds
its slices of the stacked stage parameters; each tick every stage applies
its slice to the activation it holds and sends the result to the next
stage (a P2P hop on the group, the ``ppermute`` of the JAX package), so
after a fill of S - 1 ticks all stages compute at once.

Two schedules, one loop (``rounds``):

- ``rounds=1``, GPipe fill-drain: L = S stages, a bubble of
  (S - 1) / (M + S - 1) for M microbatches;
- ``rounds=V > 1``, the circular schedule: L = V·S stages, stage ``d``
  holds ``d, d + S, ..., d + (V - 1)·S`` (``stages[d::S]`` of the stack),
  each microbatch laps the ring V times and stage 0 parks a returning
  activation in its microbatch's slot until its round comes up; a bubble
  of (S - 1) / (V·M + S - 1). It needs M >= S.

The loop is the JAX ``lax.scan`` unrolled tick for tick
(``pipeline.py:118-201``): ``T = V·M + S - 1`` ticks; at tick ``t`` stage
``d`` is at stream position ``p = t - d``, round ``r`` and microbatch
``m`` (host integers, known statically); stage 0 takes microbatch ``m``
in round 0 and the parked activation later; the last stage keeps its
output once ``p >= (V - 1)·M``. The rank choices (``stage == 0``, the
last stage's ``done``, stage 0's ``park``, the emission's mask) are
``torch.where`` on device booleans, never Python branches on the rank: a
branch that left a received activation out of one rank's graph would
skip that hop's backward on that rank, and its neighbour would wait for
it forever. So every rank's graph holds every hop, and autograd runs
their backwards (each the reverse hop) in the same order on every rank,
last tick first. The last tick sends nothing: no stage would read it.

The emission (``pipeline.py:181-201``): where S divides M, a
reduce-scatter of the last stage's ``[M, ...]`` buffer leaves rank ``d``
microbatches ``[d·M/S, (d+1)·M/S)`` (its backward the all-gather);
otherwise an all-reduce leaves every rank all M (its backward the
identity: every rank then computes the same thing from them). The input
stream is replicated over the group (the JAX ``in_specs=P()``), so its
gradient is summed over the group (only stage 0's ingest reaches it).
The JAX ``data_axis`` has no argument here: each process holds its own
rows, so the caller's placement is the data axis.

At a group of one the hops are the identity and no collective runs (a
one-process run captures into CUDA graphs). :func:`virtual_pipeline`
runs all S stages' schedule in one process, each hop a hand-over between
the virtual stages, for the tests and the card's one-process runs.

``remat=True`` recomputes each tick's stage application in backward
(``torch.utils.checkpoint``, non-reentrant; the JAX ``jax.checkpoint``
at ``:116``): the residuals are the wire activations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.checkpoint import checkpoint

from stoke_tpu_torch.ops.attention import _Rotate
from stoke_tpu_torch.parallel.tensor import (
    ModelGroup,
    copy_to_group,
    reduce_from_group,
)


@dataclass(frozen=True)
class Schedule:
    """The tick counts of one schedule: ``stages`` S, ``rounds`` V and
    ``microbatches`` M. Each of the ``ticks`` (V·M + S - 1) every stage
    applies its slice (``applications``); ``useful`` of them carry a
    microbatch (V·M a stage); the rest is the bubble."""

    stages: int
    rounds: int
    microbatches: int

    @property
    def ticks(self) -> int:
        return self.rounds * self.microbatches + self.stages - 1

    @property
    def applications(self) -> int:
        return self.ticks * self.stages

    @property
    def useful(self) -> int:
        return self.rounds * self.microbatches * self.stages

    @property
    def bubble(self) -> float:
        return 1.0 - self.useful / self.applications


def _check_rounds(rounds: int) -> int:
    V = int(rounds)
    if V < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    return V


def _microbatches(xs, S: int, V: int) -> int:
    M = tree_flatten(xs)[0][0].shape[0]
    if V > 1 and M < S:
        # circular timing: a parked activation must be consumed before
        # its slot is parked again, which needs M >= S
        raise ValueError(
            f"circular schedule needs at least S={S} microbatches, got {M}")
    return M


def _check_lead(stacked, V: int, S: int) -> None:
    for a in tree_flatten(stacked)[0]:
        if a.shape[0] != V * S:
            raise ValueError(
                f"stacked params lead dim {a.shape[0]} != rounds×stages "
                f"= {V}×{S}")


def _stage_slices(stacked, d: int, S: int):
    """Stage ``d``'s slices ``stages[d::S]`` of a whole ``[V·S, ...]``
    stack (the JAX ``[V, S, ...]`` reshape sharded on dim 1)."""
    return tree_map(lambda a: a[d::S], stacked)


def _unstack(tree, n: int) -> List[Any]:
    """A tree of ``[n, ...]`` leaves as n trees (one ``unbind`` a leaf:
    its backward stacks the n gradients once, where indexing would
    scatter each into a zero tensor of the whole)."""
    leaves, spec = tree_flatten(tree)
    parts = [a.unbind(0) for a in leaves]
    return [tree_unflatten([p[i] for p in parts], spec) for i in range(n)]


def _where(cond: torch.Tensor, a, b):
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


# --------------------------------------------------------------------------- #
# the emission's reduce-scatter (the hop is sequence parallelism's
# ``_Rotate``, the entry ``copy_to_group``, the all-reduce emission
# ``reduce_from_group``)
# --------------------------------------------------------------------------- #


class _ReduceScatter(torch.autograd.Function):
    """The emission where S divides M: this rank's ``M / S`` rows of the
    sum over the group; its backward all-gathers the rows' cotangents."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.contiguous()
        size = dist.get_world_size(group)
        out = t.new_empty((t.shape[0] // size, *t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        size = dist.get_world_size(ctx.group)
        out = g.new_empty((size * g.shape[0], *g.shape[1:]))
        dist.all_gather_into_tensor(out, g, group=ctx.group)
        return out, None


# --------------------------------------------------------------------------- #
# the schedule
# --------------------------------------------------------------------------- #


def _tick_place(t: int, d: int, M: int, V: int) -> tuple:
    """Stage ``d``'s ``(p, r, m)`` at tick ``t``: stream position, round
    and microbatch, clipped as the JAX loop clips them."""
    p = t - d
    r = min(max(p // M, 0), V - 1)
    m = min(max(p - r * M, 0), M - 1)
    return p, r, m


def _schedule(run_stage: Callable, rounds_of: Dict[int, List[Any]], xs,
              S: int, V: int, send: Callable,
              counts: Optional[dict] = None) -> Dict[int, Any]:
    """The tick loop over the stages ``rounds_of`` holds (this process's
    one, or every virtual stage): each stage's ``[M, ...]`` output buffer
    (zero but on the last stage). ``send(outs)`` takes each held stage's
    output of a tick and returns what each held stage receives."""
    M = _microbatches(xs, S, V)
    T = V * M + S - 1
    leaves = tree_flatten(xs)[0]
    dev = leaves[0].device
    yes = torch.ones((), dtype=torch.bool, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    micro = _unstack(xs, M)
    zero = tree_map(torch.zeros_like, micro[0])
    stages = sorted(rounds_of)
    act = {d: zero for d in stages}
    queue = {d: [zero] * M for d in stages} if V > 1 else None
    slots = {d: [zero] * M for d in stages}
    for t in range(T):
        outs = {}
        for d in stages:
            p, r, m = _tick_place(t, d, M, V)
            # stage 0 sources its input: round 0 ingests microbatch m,
            # later rounds the activation parked in m's slot
            first = micro[m] if V == 1 or r == 0 else queue[d][m]
            inp = _where(yes if d == 0 else no, first, act[d])
            out = run_stage(rounds_of[d][r], inp)
            # the last stage finishing round V-1 emits microbatch m
            done = d == S - 1 and p >= (V - 1) * M
            slots[d][m] = _where(yes if done else no, out, slots[d][m])
            outs[d] = out
            if counts is not None:
                counts["applications"] += 1
                counts["useful"] += int(0 <= p < V * M)
        if counts is not None:
            counts["ticks"] += 1
        if t == T - 1:
            break
        arrived = send(outs)
        # stage 0 parks what arrives from stage S-1 (at S-1's stream
        # position this tick); consumed strictly later, since M >= S
        p_in, _, m_in = _tick_place(t, S - 1, M, V)
        for d in stages:
            act[d] = arrived[d]
            if V > 1:
                park = d == 0 and p_in >= 0
                queue[d][m_in] = _where(yes if park else no, arrived[d],
                                        queue[d][m_in])
    out = {}
    for d in stages:
        buf = tree_map(lambda *a: torch.stack(a), *slots[d])
        # only the last stage holds real outputs
        out[d] = _where(yes if d == S - 1 else no, buf,
                        tree_map(torch.zeros_like, buf))
    return out


def _stage_runner(stage_fn: Callable, remat: bool) -> Callable:
    if not remat:
        return stage_fn
    return lambda p, x: checkpoint(stage_fn, p, x, use_reentrant=False)


def _group_of(group: Optional[ModelGroup]) -> Optional[ModelGroup]:
    """``group``, or None for a group of one; a lone virtual rank of more
    than one has no group to pipeline over."""
    if group is None or group.size == 1:
        return None
    if group.group is None:
        raise ValueError(
            f"pipeline: a virtual stage of {group.size} has no group to "
            f"send over; run the stages of one process with "
            f"virtual_pipeline")
    return group


def local_pipeline(stage_fn: Callable, group: Optional[ModelGroup] = None,
                   *, rounds: int = 1, remat: bool = False) -> Callable:
    """:func:`pipeline` over parameters already cut to this rank's:
    ``pipelined(local_params, xs)`` with every leaf of ``local_params``
    ``[rounds, ...]`` (``stages[d::S]`` of the whole stack, as
    :func:`~stoke_tpu_torch.parallel.tensor.shard_module` cuts it)."""
    V = _check_rounds(rounds)
    g = _group_of(group)
    S, d = (1, 0) if g is None else (g.size, g.rank)
    run_stage = _stage_runner(stage_fn, remat)

    def send(outs):
        if g is None:
            return outs
        return {d: tree_map(lambda a: _Rotate.apply(a, g.group), outs[d])}

    def pipelined(local_params, xs):
        for a in tree_flatten(local_params)[0]:
            if a.shape[0] != V:
                raise ValueError(
                    f"this stage's params lead dim {a.shape[0]} != "
                    f"rounds = {V}")
        if g is not None:
            xs = tree_map(lambda a: copy_to_group(a, g), xs)
        buf = _schedule(run_stage, {d: _unstack(local_params, V)}, xs, S, V,
                        send)[d]
        if g is None:
            return buf
        if tree_flatten(xs)[0][0].shape[0] % S:
            return tree_map(lambda a: reduce_from_group(a, g), buf)
        return tree_map(lambda a: _ReduceScatter.apply(a, g.group), buf)

    return pipelined


def pipeline(stage_fn: Callable, group: Optional[ModelGroup] = None, *,
             rounds: int = 1, remat: bool = False) -> Callable:
    """A pipelined apply of ``stage_fn(stage_params, x) -> y`` (``y`` a
    tree of ``x``'s structure and shapes: the uniform wire) over the stage
    ``group`` (a :class:`~stoke_tpu_torch.parallel.tensor.ModelGroup`, or
    None for S = 1).

    Returns ``pipelined(stacked_params, xs)``: every leaf of
    ``stacked_params`` carries the whole ``[V·S, ...]`` stack (this rank
    runs ``stages[d::S]``), ``xs`` is the microbatch stream (a tree of
    ``[M, micro_batch, ...]``, the same on every rank). Each microbatch
    comes out as all V·S stages applied in order: on rank ``d``
    microbatches ``[d·M/S, (d+1)·M/S)`` where S divides M, else all M."""
    V = _check_rounds(rounds)
    g = _group_of(group)
    S, d = (1, 0) if g is None else (g.size, g.rank)
    run = local_pipeline(stage_fn, group, rounds=V, remat=remat)

    def pipelined(stacked_params, xs):
        _check_lead(stacked_params, V, S)
        return run(_stage_slices(stacked_params, d, S), xs)

    return pipelined


def virtual_pipeline(stage_fn: Callable, stages: int, *, rounds: int = 1,
                     remat: bool = False) -> Callable:
    """The schedule of ``stages`` S virtual stages in one process, each
    hop a hand-over from stage ``d`` to ``d + 1``: ``run(stacked_params,
    xs)`` takes the whole ``[V·S, ...]`` stack (stage ``d`` runs
    ``stages[d::S]``) and returns each stage's emission, by stage (its
    ``M / S`` microbatches where S divides M, else all M), as the S
    processes of :func:`pipeline` would hold them. ``run.counts`` adds up
    the ticks, the stage applications and the useful ones."""
    V = _check_rounds(rounds)
    S = int(stages)
    run_stage = _stage_runner(stage_fn, remat)

    def send(outs):
        return {d: outs[(d - 1) % S] for d in outs}

    def run(stacked_params, xs):
        _check_lead(stacked_params, V, S)
        held = {d: _unstack(_stage_slices(stacked_params, d, S), V)
                for d in range(S)}
        bufs = _schedule(run_stage, held, xs, S, V, send, run.counts)
        total = tree_map(lambda *a: sum(a[1:], a[0]),
                         *[bufs[d] for d in range(S)])
        M = tree_flatten(xs)[0][0].shape[0]
        if M % S:
            return [total] * S
        n = M // S
        return [tree_map(lambda a: a[d * n:(d + 1) * n], total)
                for d in range(S)]

    run.counts = {"ticks": 0, "applications": 0, "useful": 0}
    return run


def pipeline_with_edges(first_fn: Optional[Callable], stage_fn: Callable,
                        last_fn: Optional[Callable],
                        group: Optional[ModelGroup] = None,
                        **pipeline_kwargs) -> Callable:
    """:func:`pipeline` with non-uniform edges outside the rotation:
    ``run((first_params, last_params), stacked_params, xs) ==
    last_fn(last_params, pipeline(stage_fn)(first_fn(first_params,
    xs)))``, ``first_fn(first_params, micro) -> wire`` and
    ``last_fn(last_params, wire) -> out`` applied a microbatch at a time
    (the JAX ``vmap``); None skips an edge. ``last_fn`` runs on this
    rank's emitted microbatches."""
    piped = pipeline(stage_fn, group, **pipeline_kwargs)

    def per_micro(fn, params, xs):
        n = tree_flatten(xs)[0][0].shape[0]
        outs = [fn(params, tree_map(lambda a, i=i: a[i], xs))
                for i in range(n)]
        return tree_map(lambda *a: torch.stack(a), *outs)

    def run(edge_params, stacked_params, xs):
        first_params, last_params = edge_params
        wire = xs if first_fn is None else per_micro(first_fn, first_params,
                                                     xs)
        mid = piped(stacked_params, wire)
        return mid if last_fn is None else per_micro(last_fn, last_params,
                                                     mid)

    return run


def stack_stage_params(param_trees: Sequence[Any]) -> Any:
    """Per-stage parameter trees stacked into one with a leading stage
    dim (the layout :func:`pipeline` takes; for ``rounds=V`` all V·S
    stage trees in order)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *param_trees)
