"""The quantized gradient transports: bucketed wire formats with error
feedback, over the ladder's process group.

Counterpart of ``stoke_tpu/parallel/collectives.py``: ``BucketLayout``
(``:103``) and ``GradTransport`` (``:141``), applied once per optimizer
step at the apply boundary, after the ladder has reduced the gradients
(``Ladder.reduce_for_apply``) and before the clip and the update, as the
JAX engine's apply orders them (``stoke_tpu/engine.py:1440-1466``):

1. **Buckets.** The gradients, in the JAX package's leaf order and layout
   (:class:`JaxLeafOrder`: a ``Dense`` kernel is ``[in, out]``, a conv
   kernel ``[kh, kw, in, out]``, leaves sorted by their flax path), are
   packed into flat fp32 buckets of ``CommConfig.bucket_mb``, each padded
   to a multiple of world x ``chunk_elems``. The layout decides which
   elements share a chunk's absmax, so only this packing gives the JAX
   package's numbers. Under a mesh of several axes the world is the data
   axis's, and the leaves are the JAX package's global ones: a model
   split's slices are gathered over each cut's own group first (the model,
   expert or stage group, or the flattened group of a cut over several
   axes), and each rank takes its slices back from the result.
2. **The exchange** (:meth:`GradTransport._exchange`), the JAX package's
   arithmetic collective by collective. At world 1 the local round trip
   (``_roundtrip_local``); across W ranks, on the bucket the ladder
   reduced (the fp32 all-reduce is the reduce-scatter leg, which the JAX
   simulation carries in fp32 too): ``rs_ag`` quantizes the rank's
   contiguous 1/W of the bucket (JAX's ``psum_scatter(xq) / n`` of equal
   replicas is that part of ``xq``), requantizes it under
   ``fold_in(key, rank + 1)`` and all-gathers the int8 payload and the
   fp32 scales (bf16: the 16-bit part); ``all_reduce`` is one round trip
   of the whole bucket (``psum(xq) / n`` of equal replicas is ``xq``).
3. **Error feedback**: ``residual = x - transport(x)`` with ``x = g +
   residual``, kept as one padded fp32 buffer a bucket and added back next
   step.

Keys: the transport's key is an int64 device tensor (``[0, seed]``, the
JAX ``init_state``'s) split in place at every apply, so a captured window
replays with a fresh key. Every key below that is a ``fold_in`` chain of
the step's sub key (``split(k)`` is ``(fold_in(k, 0), fold_in(k, 1))``),
which the quantize kernel applies itself: bucket ``b`` rounds under
``fold_in(sub, b)`` and its second stage under ``fold_in(., 0 | 1 |
rank + 1)``.

``dtype="fp32"`` is a structural pass-through (``active`` is False): no
state, no collectives, the ladder's own path bit for bit.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from stoke_tpu_torch.configs import CommConfig
from stoke_tpu_torch.ops.quant import dequantize_chunks, quantize_chunks
from stoke_tpu_torch.utils.prng import split_key_data


class BucketLayout:
    """Static flattening plan: which leaves ride which bucket.

    ``buckets`` is a list of (leaf-index list, payload_elems,
    padded_elems); padding rounds each bucket up to a multiple of ``align``
    (world x chunk_elems) so the ranks' parts and the quantization chunks
    tile exactly (the JAX ``BucketLayout``)."""

    def __init__(self, sizes: List[int], bucket_elems: int, align: int):
        self.sizes = list(sizes)
        self.buckets: List[Tuple[List[int], int, int]] = []
        current: List[int] = []
        current_elems = 0
        for i, n in enumerate(sizes):
            if current and current_elems + n > bucket_elems:
                self._close(current, current_elems, align)
                current, current_elems = [], 0
            current.append(i)
            current_elems += n
        if current:
            self._close(current, current_elems, align)

    def _close(self, indices: List[int], elems: int, align: int) -> None:
        padded = -(-elems // align) * align
        self.buckets.append((indices, elems, padded))

    @property
    def total_padded_elems(self) -> int:
        return sum(p for _, _, p in self.buckets)


class JaxLeafOrder:
    """The JAX package's view of a module's trainable parameters: their
    order (the flax params tree's flatten order, by
    :func:`stoke_tpu_torch.convert.jax_paths`) and each one's layout (a
    permutation of the port's tensor, then its JAX shape). A module the
    converter does not know keeps registration order and the port's
    layout.

    Under a model split (``tp``, a
    :class:`~stoke_tpu_torch.parallel.tensor.TensorParallel`) the JAX
    leaves are the global ones, as the JAX transport packs them: each
    split leaf's slices are all-gathered over its own group and joined
    by their cut (a stage stack's strided rows back in the stack's order)
    before the layout, and :meth:`from_jax` gives each rank its own slice
    of the result.

    Args:
        module: the model.
        params: the trainable parameters the engine steps, in its order.
        tp: the model's split, or None.
    """

    def __init__(self, module: nn.Module, params: Sequence[torch.Tensor],
                 tp: Any = None):
        from stoke_tpu_torch.convert import jax_param_layout

        index = {id(p): i for i, p in enumerate(params)}
        names = {id(p): n for n, p in module.named_parameters()}
        cuts = tp.cuts if tp is not None else {}
        try:
            layout = jax_param_layout(
                module, {n: c.full for n, c in cuts.items()})
        except ValueError:
            layout = None
        if layout is None or any(names[id(p)] not in layout for p in params):
            self.order = list(range(len(params)))
            self.perms: List[Optional[Tuple[int, ...]]] = [None] * len(params)
            self.shapes = [tuple(p.shape) for p in params]
            self.names: List[Optional[str]] = [None] * len(params)
            self.tp = None
            return
        by_path = sorted((layout[names[id(p)]][0], index[id(p)],
                          layout[names[id(p)]][1], layout[names[id(p)]][2],
                          names[id(p)]) for p in params)
        self.order = [i for _, i, _, _, _ in by_path]
        self.perms = [perm for _, _, perm, _, _ in by_path]
        self.shapes = [tuple(shape) for _, _, _, shape, _ in by_path]
        #: each leaf's name where the split cut it (None elsewhere)
        self.names = [n if n in cuts else None for _, _, _, _, n in by_path]
        self.tp = tp if cuts else None

    def sizes(self) -> List[int]:
        """Each leaf's element count, in the JAX order (the global leaves'
        under a model split)."""
        return [math.prod(shape) for shape in self.shapes]

    def _whole(self, t: torch.Tensor, name: Optional[str]) -> torch.Tensor:
        return t if name is None else self.tp.gather(name, t)

    def to_jax(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``tensors`` (the engine's order, the port's layout) as the JAX
        leaves, in the JAX order (views where the layout is the port's;
        a split leaf gathered whole, collectively)."""
        out = []
        for i, perm, name in zip(self.order, self.perms, self.names):
            t = self._whole(tensors[i], name)
            out.append(t if perm is None else t.permute(perm))
        return out

    def from_jax(self, leaves: Sequence[torch.Tensor],
                 into: Sequence[torch.Tensor]) -> None:
        """Copy JAX-ordered, JAX-laid-out ``leaves`` into ``into`` (the
        engine's order and the port's layout; a split leaf takes this
        rank's slice)."""
        with torch.no_grad():
            for i, perm, name, leaf in zip(self.order, self.perms,
                                           self.names, leaves):
                if name is None:
                    dst = into[i] if perm is None else into[i].permute(perm)
                    dst.copy_(leaf.view(dst.shape))
                    continue
                cut = self.tp.cuts[name]
                whole = leaf.reshape([cut.full[d] for d in perm]) \
                    if perm is not None else leaf.reshape(cut.full)
                if perm is not None:
                    whole = whole.permute(_inverse(perm))
                into[i].copy_(self.tp.take(name, whole))


def _inverse(perm: Sequence[int]) -> Tuple[int, ...]:
    out = [0] * len(perm)
    for i, p in enumerate(perm):
        out[p] = i
    return tuple(out)


class GradTransport:
    """The replicated gradient transport (``strategy`` ``rs_ag`` or
    ``all_reduce``) over ``group``.

    Args:
        cfg: the run's ``CommConfig`` or None.
        group: the data axis's process group (None at world 1 without
            one).
    """

    #: the residual's layout (``zero.py``'s sharded variant: 1/W a rank)
    layout_kind = "replicated"

    def __init__(self, cfg: Optional[CommConfig], group=None):
        self.cfg = cfg
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self._layout_cache: Dict[Tuple[int, ...], BucketLayout] = {}

    # ------------------------------ state ------------------------------ #

    @property
    def active(self) -> bool:
        """True when the transport changes gradients at all (``fp32`` is a
        pass-through: no state, no collectives)."""
        return self.cfg is not None and self.cfg.dtype != "fp32"

    @property
    def error_feedback(self) -> bool:
        return self.active and bool(self.cfg.error_feedback)

    def init_state(self, sizes: Sequence[int], device,
                   seed: int = 0) -> Dict[str, Any]:
        """The carried state: ``rng``, the key data ``[0, seed]`` as an
        int64 tensor on ``device``, and with error feedback ``residual``,
        one zero fp32 buffer a bucket (:meth:`residual_elems` each). Empty
        when inactive."""
        if not self.active:
            return {}
        state: Dict[str, Any] = {"rng": torch.tensor(
            [0, int(seed) & 0xFFFFFFFF], dtype=torch.int64, device=device)}
        if self.error_feedback:
            state["residual"] = [
                torch.zeros(self.residual_elems(padded),
                            dtype=torch.float32, device=device)
                for _, _, padded in self._layout(sizes).buckets]
        return state

    def residual_elems(self, padded: int) -> int:
        """Elements of one bucket's residual on this rank."""
        return padded

    # --------------------------- accounting ---------------------------- #

    def bytes_per_step(self, sizes: Sequence[int]) -> Optional[Dict[str, int]]:
        """Analytic per-device bytes on the wire of one optimizer step
        (the JAX formula: two ring stages over the padded buckets), in
        fp32 (``prequant``) and in the wire dtype (``onwire``); None
        without a ``CommConfig``. ``sizes``: the leaves' element counts in
        the JAX order."""
        if self.cfg is None:
            return None
        layout = self._layout(sizes)
        pre, wire = self._wire_bytes(layout.total_padded_elems, stages=2.0)
        return {"prequant": pre, "onwire": wire}

    def layout_descriptor(self, sizes: Sequence[int]
                          ) -> Optional[Dict[str, Any]]:
        """The residual's layout (kind, world, error feedback, leaf sizes,
        per-bucket payload and padded counts), as the JAX package's; None
        when inactive."""
        if not self.active:
            return None
        layout = self._layout(sizes)
        return {
            "kind": self.layout_kind,
            "world": int(self.world),
            "error_feedback": bool(self.error_feedback),
            "leaf_sizes": [int(s) for s in sizes],
            "buckets": [[int(e), int(p)] for _, e, p in layout.buckets],
        }

    def _wire_bytes(self, elems: int, stages: float) -> Tuple[int, int]:
        chunks = elems // max(self.cfg.chunk_elems, 1)
        ring = stages * (self.world - 1) / max(self.world, 1)
        pre = ring * 4.0 * elems
        if self.cfg.dtype == "fp32":
            wire = pre
        elif self.cfg.dtype == "bf16":
            wire = ring * 2.0 * elems
        else:  # int8 payload + one f32 scale per chunk
            wire = ring * (1.0 * elems + 4.0 * chunks)
        return int(pre), int(wire)

    def _layout(self, sizes: Sequence[int]) -> BucketLayout:
        key = tuple(int(s) for s in sizes)
        if key not in self._layout_cache:
            cfg = self.cfg
            bucket_elems = max(int(cfg.bucket_mb * 2**20 / 4), 1)
            align = max(self.world, 1) * max(cfg.chunk_elems, 1)
            self._layout_cache[key] = BucketLayout(list(key), bucket_elems,
                                                   align)
        return self._layout_cache[key]

    # ----------------------------- apply ------------------------------- #

    @torch.no_grad()
    def apply(self, leaves: Sequence[torch.Tensor],
              state: Dict[str, Any]) -> List[torch.Tensor]:
        """Transport the reduced gradients ``leaves`` (JAX order and
        layout, the same on every rank); returns the transported leaves
        (fp32, their shapes) and updates ``state`` in place (the key split
        once, the residual to what this step lost)."""
        if not self.active:
            return list(leaves)
        rng = state["rng"]
        new_rng, sub = split_key_data(rng)
        rng.copy_(new_rng)
        residual = state.get("residual")
        layout = self._layout([l.numel() for l in leaves])
        outs: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for b, (indices, elems, padded) in enumerate(layout.buckets):
            flat = torch.cat([leaves[i].reshape(-1).float() for i in indices])
            if padded > elems:
                flat = F.pad(flat, (0, padded - elems))
            out = self._exchange(b, flat, sub,
                                 None if residual is None else residual[b])
            off = 0
            for i in indices:
                n = leaves[i].numel()
                outs[i] = out[off:off + n].view(leaves[i].shape)
                off += n
        return outs

    # ------------------------- flat exchange --------------------------- #

    def _roundtrip(self, x: torch.Tensor, sub: torch.Tensor,
                   folds: Sequence[int], offset: int = 0) -> torch.Tensor:
        """The wire format's round trip of ``x`` (the JAX
        ``_quant_roundtrip``) under ``sub`` folded by ``folds``."""
        cfg = self.cfg
        if cfg.dtype == "bf16":
            return x.to(torch.bfloat16).float()
        q, s = quantize_chunks(x, cfg.chunk_elems, sub,
                               cfg.stochastic_rounding, folds, offset)
        return dequantize_chunks(q, s, cfg.chunk_elems)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(self.world * t.numel(), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def _wire_gather(self, own: torch.Tensor, sub: torch.Tensor,
                     folds: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's ``own`` part through the wire format, all-gathered:
        ``(the bucket as every rank dequantizes it, own's round trip)``."""
        cfg = self.cfg
        if cfg.dtype == "bf16":
            wire = own.to(torch.bfloat16)
            return self._gather(wire).float(), wire.float()
        q, s = quantize_chunks(own, cfg.chunk_elems, sub,
                               cfg.stochastic_rounding, folds)
        full = dequantize_chunks(self._gather(q), self._gather(s),
                                 cfg.chunk_elems)
        return full, dequantize_chunks(q, s, cfg.chunk_elems)

    def _exchange(self, b: int, flat: torch.Tensor, sub: torch.Tensor,
                  res: Optional[torch.Tensor]) -> torch.Tensor:
        """One bucket through the replicated schedule; the residual
        becomes ``x - y`` in place."""
        cfg = self.cfg
        x = flat if res is None else flat + res
        if self.world <= 1:
            if cfg.strategy == "rs_ag":
                y = self._roundtrip(
                    self._roundtrip(x, sub, (b, 0)), sub, (b, 1))
            else:
                y = self._roundtrip(x, sub, (b, 1))
        elif cfg.strategy == "all_reduce":
            y = self._roundtrip(x, sub, (b,))
        else:
            n = x.numel() // self.world
            lo = self.rank * n
            own = self._roundtrip(x[lo:lo + n], sub, (b,), offset=lo)
            y, _ = self._wire_gather(own, sub, (b, self.rank + 1))
        if res is not None:
            res.copy_(x - y)
        return y
