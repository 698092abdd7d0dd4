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
JAX formula) counts.

Elastic resume remaps the error-feedback residual across topologies
(:func:`residual_to_flat`, :func:`flat_to_residual`,
:func:`remap_residual`, ``zero.py:255-327``): the residual of either
transport is, whole, one padded fp32 buffer a bucket in the JAX leaf
order (the sharded transport's rank ``r`` holds the ``r``-th contiguous
1/W of each), and the padding follows the world size, so a residual saved
at one world and kind is unpacked to the flat per-element vector under
its saved layout descriptor (``GradTransport.layout_descriptor``) and
repacked under the current one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
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


def residual_to_flat(residual: Sequence[Any],
                     desc: Dict[str, Any]) -> np.ndarray:
    """The flat per-element fp32 vector of a host residual (whole padded
    buckets, or a JAX replicated residual's per-leaf arrays) under its
    layout descriptor."""
    if not residual:
        return np.zeros((0,), np.float32)
    arrays = [np.asarray(r, np.float32).reshape(-1) for r in residual]
    buckets = desc["buckets"]
    if len(arrays) == len(buckets) and all(
            a.size == int(p) for a, (_, p) in zip(arrays, buckets)):
        return np.concatenate([a[:int(e)] for a, (e, _) in
                               zip(arrays, buckets)])
    # per-leaf arrays (the JAX replicated transport's residual)
    return np.concatenate(arrays)


def flat_to_residual(flat: np.ndarray,
                     desc: Dict[str, Any]) -> List[np.ndarray]:
    """The flat residual vector repacked under a target layout
    descriptor: one whole padded fp32 buffer a bucket (zero padding);
    ``ValueError`` when the vector does not cover the target's leaves."""
    flat = np.asarray(flat, np.float32).reshape(-1)
    total = int(sum(desc["leaf_sizes"]))
    if flat.size != total:
        raise ValueError(
            f"Stoke -- residual re-map size mismatch: flat vector has "
            f"{flat.size} elements, target layout covers {total} "
            f"(different model?)"
        )
    out, off = [], 0
    for elems, padded in desc["buckets"]:
        buf = np.zeros((int(padded),), np.float32)
        buf[:elems] = flat[off:off + elems]
        off += elems
        out.append(buf)
    return out


def remap_residual(residual: Sequence[Any], saved_desc: Dict[str, Any],
                   target_desc: Dict[str, Any]) -> List[np.ndarray]:
    """A host residual saved under ``saved_desc`` re-mapped onto
    ``target_desc``'s layout (another world size, bucket padding, or
    replicated/sharded kind), as whole padded buckets. Raises
    ``ValueError`` on an element-count mismatch: a residual of another
    model cannot re-map."""
    flat = residual_to_flat(residual, saved_desc)
    total = int(sum(target_desc["leaf_sizes"]))
    if flat.size != total:
        raise ValueError(
            f"Stoke -- residual re-map: saved residual covers {flat.size} "
            f"elements, current model {total} (incompatible checkpoint)"
        )
    return flat_to_residual(flat, target_desc)


def make_transport(cfg: Optional[CommConfig], tier: ShardingOptions,
                   group=None) -> GradTransport:
    """The transport of ``cfg`` under ``tier``: the sharded schedule when
    :func:`~stoke_tpu_torch.configs.comm_shard_updates` says so (the rule
    the status layer checks), else the replicated one."""
    if comm_shard_updates(cfg, tier):
        return ShardedGradTransport(
            cfg, group, params_replicated=tier is not ShardingOptions.fsdp)
    return GradTransport(cfg, group)
