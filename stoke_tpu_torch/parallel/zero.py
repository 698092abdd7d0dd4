"""The weight-update-sharded gradient transport and the transport factory.

Counterpart of ``stoke_tpu/parallel/zero.py``: ``ShardedGradTransport``
(``:56``) and ``make_transport`` (``:330``). The gradient leg is one ring
stage: rank ``r`` owns the contiguous ``r``-th 1/W of each reduced bucket
(the JAX ``psum_scatter(x) / n`` of the replicated bucket), adds its
residual shard, rounds it through the wire format under ``fold_in(key,
r + 1)`` and keeps ``own - wire`` as its new residual, so the residual is
1/W of the padded bucket a rank.

JAX hands the P(axis) shards to GSPMD, which places them where the tier's
optimizer steps them. The port's optimizer steps the ladder's rank-major
per-leaf slices, which are not the bucket's contiguous parts, so every
rank all-gathers the wire format (int8 payload and fp32 scales, or the
bf16 part), dequantizes the whole bucket and takes its slices from it:
the numbers are the JAX package's, and the gather is one int8 stage more
on the wire than the JAX accounting (``bytes_per_step``, which stays the
JAX formula) counts. The residual's remap across topologies
(``zero.py:257-329``) belongs to elastic resume (ROADMAP item 9).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from stoke_tpu_torch.configs import (
    CommConfig,
    ShardingOptions,
    comm_shard_updates,
)
from stoke_tpu_torch.parallel.collectives import GradTransport


class ShardedGradTransport(GradTransport):
    """The sharded schedule (the default under sddp and fsdp).

    Args:
        cfg: the run's ``CommConfig``.
        group: the data axis's process group.
        params_replicated: whether the updated parameters are all-gathered
            after the step (tiers none, oss, sddp) or stay sharded (fsdp);
            only the ``param_gather`` accounting reads it.
    """

    layout_kind = "sharded"

    def __init__(self, cfg: Optional[CommConfig], group=None,
                 params_replicated: bool = True):
        super().__init__(cfg, group)
        self.params_replicated = bool(params_replicated)

    def residual_elems(self, padded: int) -> int:
        return padded // max(self.world, 1)

    def bytes_per_step(self, sizes) -> Optional[Dict[str, int]]:
        """One ring stage in the wire dtype (``onwire``) against fp32
        (``prequant``), and ``param_gather``, the updated parameters'
        fp32 all-gather (0 under fsdp): the JAX formula."""
        if self.cfg is None:
            return None
        layout = self._layout(sizes)
        pre, wire = self._wire_bytes(layout.total_padded_elems, stages=1.0)
        ring = (self.world - 1) / max(self.world, 1)
        gather = ring * 4.0 * sum(sizes) if self.params_replicated else 0.0
        return {"prequant": pre, "onwire": wire, "param_gather": int(gather)}

    def _exchange(self, b: int, flat: torch.Tensor, sub: torch.Tensor,
                  res: Optional[torch.Tensor]) -> torch.Tensor:
        if self.world <= 1:
            x = flat if res is None else flat + res
            y = self._roundtrip(x, sub, (b,))
            if res is not None:
                res.copy_(x - y)
            return y
        n = flat.numel() // self.world
        own = flat[self.rank * n:(self.rank + 1) * n]
        if res is not None:
            own = own + res
        y, wire = self._wire_gather(own, sub, (b, self.rank + 1))
        if res is not None:
            res.copy_(own - wire)
        return y


def make_transport(cfg: Optional[CommConfig], tier: ShardingOptions,
                   group=None) -> GradTransport:
    """The transport of ``cfg`` under ``tier``: the sharded schedule when
    :func:`~stoke_tpu_torch.configs.comm_shard_updates` says so (the rule
    the status layer checks), else the replicated one."""
    if comm_shard_updates(cfg, tier):
        return ShardedGradTransport(
            cfg, group, params_replicated=tier is not ShardingOptions.fsdp)
    return GradTransport(cfg, group)
