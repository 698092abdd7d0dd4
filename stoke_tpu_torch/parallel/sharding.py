"""Sharding rules of the port: the ZeRO-1/2/3 ladder as per-leaf choices.

Counterpart of ``stoke_tpu/parallel/sharding.py``. The JAX package turns
each tier into ``NamedSharding`` placements and lets GSPMD derive the
collectives; the port keeps the same placement rule, one leaf at a time,
and :mod:`stoke_tpu_torch.parallel.ladder` runs the collectives by hand:

- tier none (plain DP): params, grads and optimizer state replicated;
  gradients all-reduced at the apply boundary;
- tier oss (ZeRO-1): optimizer state sharded; the step runs on the
  rank's shard and the updated parameters are all-gathered;
- tier sddp (ZeRO-2): also the gradient accumulation buffer; each
  micro-step's gradient is reduce-scattered into the rank's shard;
- tier fsdp (ZeRO-3): also the parameters between steps; they are
  all-gathered before a forward.

A sharded leaf is split along the one dimension the rule picks
(:func:`leaf_partition_spec`), rank ``r`` holding the ``r``-th of ``W``
equal slices, as ``P(..., "data", ...)`` places it in the JAX package.

Partition rules (``PartitionRulesConfig``): :func:`compile_partition_rules`
and :func:`rule_entries` port the JAX package's path-regex overrides
(``compile_partition_rules``, the rule matching of ``sharding_tree``):
the first rule whose pattern a leaf's path matches wins, over the tier's
placement. The port matches them against each tensor's JAX leaf path and
shape; :func:`stoke_tpu_torch.parallel.tensor.apply_partition_rules`
turns what they place into the Megatron, expert and stage splits and the
gathered placements, on any mesh axis: a leaf a rule places stays out of
the tier's buckets, and a placement on the data axis averages its
slice's gradient over that axis itself.

Under the port a process drives one device, so the JAX package's
per-process batch checks (``batch_sharding`` with several local shards a
process, ``test_multiprocess_batch_divisibility``) have no counterpart:
every process's batch is its one shard of the data axis, whatever its
size.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

from stoke_tpu_torch.configs import (
    FSDPConfig,
    OSSConfig,
    SDDPConfig,
    ShardingOptions,
)

#: ``shape -> dim`` to shard along, or None to replicate
DimRule = Callable[[Sequence[int]], Optional[int]]


def _pick_dim(shape: Sequence[int], axis_size: int, min_size: int,
              preference: str) -> Optional[int]:
    """The rule of :func:`leaf_partition_spec` without its guard for an
    axis of one device."""
    if not shape or math.prod(shape) < max(min_size, axis_size):
        return None
    if preference == "first":
        return 0 if shape[0] % axis_size == 0 else None
    divisible = [d for d in range(len(shape)) if shape[d] % axis_size == 0]
    return max(divisible, key=lambda d: shape[d], default=None)


def leaf_partition_spec(shape: Sequence[int], axis_size: int,
                        min_size: int = 0,
                        preference: str = "largest") -> Optional[int]:
    """The dimension of one array to shard over a data axis of
    ``axis_size`` devices, or None to replicate: the JAX package's rule,
    which returns ``P`` with the axis name at that dimension.

    "largest" (default) picks the largest dimension divisible by
    ``axis_size`` (the first of equals), "first" dimension 0 when it is
    divisible. Arrays of fewer than ``max(min_size, axis_size)`` elements,
    scalars and an axis of one device replicate."""
    if axis_size <= 1:
        return None
    return _pick_dim(shape, axis_size, min_size, preference)


def jax_dim_map(shape: Sequence[int], perm: Optional[Sequence[int]],
                jax_shape: Sequence[int]) -> dict:
    """Each dim of a leaf's JAX shape that is a whole dim of the port's
    tensor of ``shape``, to that dim. The JAX leaf is the port's tensor
    permuted by ``perm`` (None: as it is), then reshaped to ``jax_shape``
    (a fused ``qkv``'s flat dim is several JAX dims, none of them whole)."""
    shape = tuple(shape)
    order = tuple(perm) if perm is not None else tuple(range(len(shape)))
    permuted = [shape[d] for d in order]
    out, j = {}, 0
    for k, n in enumerate(permuted):
        start, prod = j, 1
        while j < len(jax_shape) and (prod < n or (n == 1 and j == start)):
            prod *= jax_shape[j]
            j += 1
        if prod != n:
            return out
        if j - start == 1:
            out[start] = order[k]
    return out


def _rule(axis_size: int, min_size: int, preference: str) -> DimRule:
    return lambda shape: _pick_dim(tuple(shape), axis_size, min_size,
                                   preference)


def _replicate(shape: Sequence[int]) -> Optional[int]:
    return None


@dataclass(frozen=True)
class ShardingRules:
    """Which of a run's state shards over the data axis, leaf by leaf:
    ``param_dim``, ``grad_dim`` and ``opt_dim`` map a leaf's shape to the
    dimension its parameter, gradient buffer or optimizer state is split
    along, or None (replicated).

    At ``axis_size`` 1 the JAX rule replicates every leaf. These rules
    split such a leaf into one shard instead, which is the same placement,
    so that a run of one process drives the sharded path and its
    collectives as a run of ``W`` does."""

    tier: ShardingOptions
    axis_size: int
    param_dim: DimRule
    grad_dim: DimRule
    opt_dim: DimRule
    #: the compiled partition rules (:func:`compile_partition_rules`),
    #: which win over the tier for the leaves they match; None without
    overrides: Optional[List[Tuple[Any, tuple]]] = None


def compile_partition_rules(rules) -> Optional[List[Tuple[Any, tuple]]]:
    """``(regex, spec)`` pairs as ``(compiled pattern, entries)``: the JAX
    ``compile_partition_rules``. A trailing ``...`` (or the string
    ``"..."``, for YAML) makes a rule variadic: the dims it does not name
    are replicated. None for no rules."""
    if not rules:
        return None
    return [(re.compile(rx), tuple(Ellipsis if e is Ellipsis or e == "..."
                                   else e for e in spec))
            for rx, spec in rules]


def rule_entries(path: str, shape: Sequence[int], overrides,
                 strict: bool = True) -> Optional[tuple]:
    """The entries (one mesh axis name, tuple of names or None a dim) that
    the first of the compiled ``overrides`` matching ``path`` (``re.search``
    on the ``/``-joined JAX leaf path) gives a leaf of ``shape``, or None
    where no rule matches: the JAX ``sharding_tree``'s rule. A rule of
    another rank raises the JAX package's ``ValueError`` when ``strict``
    (parameters); otherwise the leaf falls back to the tier's placement
    (None: optimizer state, whose leaves share a parameter's path but not
    always its rank)."""
    shape = tuple(shape)
    for rx, entries in overrides or ():
        if not rx.search(path):
            continue
        entries = tuple(entries)
        if entries and entries[-1] is Ellipsis:
            head = entries[:-1]
            if len(head) > len(shape):
                if strict:
                    raise ValueError(
                        f"Stoke -- partition rule {rx.pattern!r} needs at "
                        f"least {len(head)} dims but parameter {path} has "
                        f"shape {shape}")
                return None
            entries = head + (None,) * (len(shape) - len(head))
        if len(entries) != len(shape):
            if strict:
                raise ValueError(
                    f"Stoke -- partition rule {rx.pattern!r} has "
                    f"{len(entries)} entries but parameter {path} has "
                    f"shape {shape}")
            return None
        return entries
    return None


def make_sharding_rules(tier: ShardingOptions, axis_size: int,
                        oss_config: OSSConfig, sddp_config: SDDPConfig,
                        fsdp_config: FSDPConfig,
                        partition_rules=None) -> ShardingRules:
    """The tier's rules (the ladder in the module docstring), with the JAX
    package's thresholds: ``OSSConfig.min_shard_size`` for optimizer
    state, ``SDDPConfig.min_shard_size`` for the gradient buffer, and under
    fsdp ``FSDPConfig.min_weight_size`` and ``shard_axis_preference`` for
    all three (the update is then fully local)."""
    opt = _rule(axis_size, oss_config.min_shard_size, "largest")
    grad = _rule(axis_size, sddp_config.min_shard_size, "largest")
    param = _rule(axis_size, fsdp_config.min_weight_size,
                  fsdp_config.shard_axis_preference)
    rep = _replicate
    by_tier = {
        ShardingOptions.none: (rep, rep, rep),
        ShardingOptions.oss: (rep, rep, opt),
        ShardingOptions.sddp: (rep, grad, opt),
        ShardingOptions.fsdp: (param, param, param),
    }
    if tier not in by_tier:
        raise ValueError(f"unknown sharding tier {tier}")
    return ShardingRules(tier, axis_size, *by_tier[tier],
                         overrides=compile_partition_rules(partition_rules))
