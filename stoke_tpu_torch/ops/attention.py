"""Sequence-parallel attention: ring, zigzag ring and Ulysses.

Counterpart of ``stoke_tpu/ops/attention.py``. Each process of a
sequence-parallel group holds one shard of the sequence of every batch
row (``[B, H, L / S, D]``); these functions run that process's part:

- **Ring** (:func:`ring_attention`): Q stays; K/V (and the key mask)
  rotate around the group, one hop a step, and each hop is a flash call
  with ``return_lse=True`` (kernel #1 on the card). The partial attentions
  merge by log-sum-exp (:func:`_lse_merge`); the merge's LSE cotangent
  runs through the backward kernels (#2, #3). Under ``causal``, a hop whose
  keys all come after this shard's queries gets an all-zero key mask: the
  flash call then gives ``out == 0`` and ``lse == -1e30``, and the merge
  leaves the accumulator as it was.
- **Zigzag ring** (:func:`zigzag_ring_attention`): always causal; shard
  ``d`` holds sequence blocks ``d`` and ``2S-1-d`` (:func:`zigzag_permutation`),
  so every shard does the same causal work at every hop.
- **Ulysses** (:func:`ulysses_attention`): one all-to-all re-shards
  ``[B, H, L/S, D]`` to ``[B, H/S, L, D]``, one flash call runs over the
  whole sequence, and a second all-to-all restores the sequence shards.

A rotation is a P2P exchange on the sequence group inside a
``torch.autograd.Function`` whose backward rotates the cotangents the
other way (the transpose of JAX's ``ppermute``); each all-to-all has the
inverse all-to-all as its backward. The per-shard bodies take the
rotation as an argument (``rotate``), defaulting to the collective, so
one process can drive S virtual shards (:func:`virtual_ring`). A group of
one process runs no collective.

``inner``: ``"flash"`` (the port's :func:`flash_attention`: the kernels on
the card, their plain versions on the CPU), ``"dense"`` (the einsum
reference) or ``"auto"``, which resolves to flash wherever the port's
flash takes the shard (any length; on the card head dims 64 and 128 in
fp32, bf16 or fp16) and dense otherwise. The JAX package's ``"auto"``
follows the TPU kernel's block ladder instead, so a length that no block
divides (e.g. 520) takes flash here and dense there (ROADMAP Queue 3).

The shard a process holds is described by a :class:`SeqShard` (its group,
index, count and layout). ``Stoke`` under ``DataParallelConfig(
shard_seq_dim=d)`` on a ``("data", "seq")`` mesh runs each of its calls
under its process's shard (:func:`using_seq_shard`): the attention
adapters without an explicit mesh, GPT's positions and
:func:`~stoke_tpu_torch.models.gpt.causal_lm_loss` read it. Without one,
the adapters run one shard (plain attention).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from stoke_tpu_torch.ops.flash_attention import (
    _DTYPE_CODES,
    _HEAD_DIMS,
    NEG_INF,
    flash_attention,
)

# --------------------------------------------------------------------------- #
# the process's shard of the sequence
# --------------------------------------------------------------------------- #

#: sequence layouts: contiguous blocks, or the zigzag pairs
LAYOUTS = ("contiguous", "zigzag")


def zigzag_permutation(L: int, size: int) -> np.ndarray:
    """Index permutation from the natural sequence order to the zigzag
    layout: with ``2·size`` blocks of ``L / (2·size)``, shard ``d`` is
    ``concat(block_d, block_{2·size-1-d})``. Apply with
    ``x[..., perm]``; invert with :func:`inverse_permutation`."""
    if L % (2 * size):
        raise ValueError(
            f"zigzag layout needs L divisible by 2*axis_size = {2 * size}, "
            f"got {L}"
        )
    Lb = L // (2 * size)
    blocks = []
    for d in range(size):
        blocks.append(np.arange(d * Lb, (d + 1) * Lb))
        hi = 2 * size - 1 - d
        blocks.append(np.arange(hi * Lb, (hi + 1) * Lb))
    return np.concatenate(blocks)


def inverse_permutation(perm) -> np.ndarray:
    """``x[perm][inverse_permutation(perm)] == x``."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


@dataclass(frozen=True)
class SeqShard:
    """One process's place on the sequence axis: the group (None for a
    group of one), this shard's index and the shard count, and the layout
    of the sequence over the shards."""

    group: Any
    rank: int
    size: int
    layout: str = "contiguous"
    #: zigzag index tensors by (kind, length, device): made at their first
    #: (eager) use, so a captured window copies nothing from the host
    _indices: dict = field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got "
                             f"{self.layout!r}")

    def _zigzag(self, kind: str, L: int, device) -> torch.Tensor:
        key = (kind, L, str(device))
        if key not in self._indices:
            perm = zigzag_permutation(L, self.size)
            idx = perm if kind == "perm" else inverse_permutation(perm)
            self._indices[key] = torch.as_tensor(idx, dtype=torch.long,
                                                 device=device)
        return self._indices[key]

    def global_index(self, local_len: int, device=None) -> torch.Tensor:
        """The global positions of this shard's ``local_len`` tokens."""
        lo = self.rank * local_len
        if self.layout == "zigzag":
            perm = self._zigzag("perm", local_len * self.size, device)
            return perm[lo:lo + local_len]
        return torch.arange(lo, lo + local_len, device=device)

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This shard's part of a whole-sequence tensor along ``dim``."""
        n = x.shape[dim] // self.size
        if self.layout == "contiguous":
            return x.narrow(dim, self.rank * n, n)
        return x.index_select(dim, self.global_index(n, x.device))

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole-sequence tensor, in natural order, from every shard's
        part along ``dim`` (no gradient; every shard gets it)."""
        if self.size == 1:
            return x
        x = x.detach().movedim(dim, 0).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        whole = torch.cat(parts)
        if self.layout == "zigzag":
            whole = whole.index_select(
                0, self._zigzag("inv", whole.shape[0], x.device))
        return whole.movedim(0, dim)


_SEQ_SHARD: Optional[SeqShard] = None


@contextlib.contextmanager
def using_seq_shard(shard: Optional[SeqShard]):
    """Run the block under the sequence shard ``shard`` (None: unsharded)
    and restore the one before it after. ``Stoke`` wraps each of its calls
    that runs the model in its own shard. The shard is process state, not
    thread state: autograd runs a backward (and its recompute) on a
    thread of its own on the card."""
    global _SEQ_SHARD
    prev, _SEQ_SHARD = _SEQ_SHARD, shard
    try:
        yield
    finally:
        _SEQ_SHARD = prev


def seq_shard() -> Optional[SeqShard]:
    """This process's sequence shard, or None."""
    return _SEQ_SHARD


def sharded(shard: Optional[SeqShard]) -> bool:
    """Whether ``shard`` splits the sequence over more than one process."""
    return shard is not None and shard.size > 1


def shard_of(mesh=None, axis_name: str = "seq",
             layout: str = "contiguous") -> SeqShard:
    """The shard on ``mesh``'s ``axis_name`` (a ``DeviceMesh``), or the
    process's shard (:func:`seq_shard`) with ``layout``, or one shard."""
    if mesh is not None:
        group = mesh.get_group(axis_name)
        return SeqShard(group, dist.get_rank(group),
                        dist.get_world_size(group), layout)
    s = seq_shard()
    if s is None:
        return SeqShard(None, 0, 1, layout)
    return s if s.layout == layout else SeqShard(s.group, s.rank, s.size,
                                                 layout)


# --------------------------------------------------------------------------- #
# collectives with their transposes
# --------------------------------------------------------------------------- #


def _shift(t: torch.Tensor, group, forward: bool) -> torch.Tensor:
    """Send ``t`` to the next shard and take the previous one's (or, with
    ``forward=False``, the other way round)."""
    size, r = dist.get_world_size(group), dist.get_rank(group)
    step = 1 if forward else -1
    dst = dist.get_global_rank(group, (r + step) % size)
    src = dist.get_global_rank(group, (r - step) % size)
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One ring hop of a float tensor; its backward rotates the cotangent
    back to the shard it came from."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(t, group, True)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, False), None


def ring_rotation(group) -> Callable:
    """The collective rotation: ``rotate(k, v, km)`` passes K, V and the
    key mask to the next shard of ``group`` and returns the previous
    shard's."""

    def rotate(k, v, km):
        k = _Rotate.apply(k, group)
        v = _Rotate.apply(v, group)
        if km is not None:
            km = _shift(km, group, True)
        return k, v, km

    return rotate


def virtual_ring(ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                 kms: Optional[Sequence[torch.Tensor]], rank: int) -> Callable:
    """The rotation of virtual shard ``rank`` of ``len(ks)`` shards held in
    one process: its t-th call returns shard ``(rank - t) % S``'s K, V
    and key mask, as the t-th collective hop would."""
    size = len(ks)
    hop = [0]

    def rotate(k, v, km):
        hop[0] += 1
        src = (rank - hop[0]) % size
        return ks[src], vs[src], None if kms is None else kms[src]

    return rotate


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over the leading dim (one chunk a shard)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _seq_to_heads_raw(x, group):
    """``[B, H, L/S, D]`` -> ``[B, H/S, L, D]``: heads split over the
    shards, the sequence gathered in shard order."""
    S = dist.get_world_size(group)
    B, H, Ls, D = x.shape
    y = _all_to_all(x.reshape(B, S, H // S, Ls, D).transpose(0, 1), group)
    return y.permute(1, 2, 0, 3, 4).reshape(B, H // S, S * Ls, D)


def _heads_to_seq_raw(y, group):
    """The inverse of :func:`_seq_to_heads_raw`."""
    S = dist.get_world_size(group)
    B, Hs, L, D = y.shape
    x = _all_to_all(y.reshape(B, Hs, S, L // S, D).permute(2, 0, 1, 3, 4),
                    group)
    return x.transpose(0, 1).reshape(B, S * Hs, L // S, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq_raw(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _heads_to_seq_raw(y, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads_raw(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose backward sums the cotangents over it
    (each shard's loss term depends on every shard's keys)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor, shard: SeqShard) -> torch.Tensor:
    """``t`` summed over ``shard``'s group, differentiably."""
    if shard.size == 1:
        return t
    return _AllReduceSum.apply(t, shard.group)


# --------------------------------------------------------------------------- #
# the per-shard bodies
# --------------------------------------------------------------------------- #


def _flash(q, k, v, mask, causal: bool, return_lse: bool = True):
    """The port's flash on contiguous operands (the kernels take dense
    ``[B, H, L, D]`` tensors; a shard's halves and slices are views)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           None if mask is None else mask.contiguous(),
                           causal=causal, return_lse=return_lse)


def _resolve_inner(inner: str, q: torch.Tensor) -> str:
    """``inner`` as given, or for ``"auto"``: flash where the port's flash
    takes ``q`` (the plain version takes any shape on the CPU; the kernels
    take head dims 64 and 128 in fp32, bf16 and fp16), dense otherwise."""
    if inner not in ("auto", "flash", "dense"):
        raise ValueError(
            f"inner must be 'auto', 'flash' or 'dense', got {inner!r}")
    if inner != "auto":
        return inner
    if q.device.type == "cpu":
        return "flash"
    ok = q.shape[-1] in _HEAD_DIMS and q.dtype in _DTYPE_CODES
    return "flash" if ok else "dense"


def _lse_merge(o, lse, o_hop, lse_hop):
    """Log-sum-exp merge of two partial attentions (fp32 accumulator). The
    finite ``NEG_INF`` sentinel keeps every term finite: a fully masked
    hop gets weight ``exp(-huge) == 0`` exactly."""
    lse_new = torch.logaddexp(lse, lse_hop)
    o_new = (o * torch.exp(lse - lse_new)[..., None]
             + o_hop.float() * torch.exp(lse_hop - lse_new)[..., None])
    return o_new, lse_new


def _online_softmax_block(o, m, l, scores, v):
    """Fold one ``[.., Lq, Lk]`` score block into the dense accumulator."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    # fully masked blocks: exp(NEG_INF - NEG_INF) would be 1; force zeros
    p = torch.where(scores > NEG_INF * 0.5, p, torch.zeros_like(p))
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                               v.to(p.dtype))
    return o_new, m_new, l_new


def _hop_mask(km, valid: bool, B: int, Lk: int, device):
    """The key mask of a causal hop whose keys are all visible (``valid``)
    or all later than the queries."""
    vm = torch.full((B, Lk), int(valid), dtype=torch.int32, device=device)
    return vm if km is None else km * vm


def _ring_flash(q, k, v, kmask, *, rank, size, causal, rotate):
    """Ring over the flash inner (JAX ``_ring_shard_flash``): hop 0 on the
    shard's own K/V (causal-local), then one non-causal flash call a hop
    under the hop's key mask, merged by log-sum-exp."""
    B, Lk = q.shape[0], k.shape[2]
    o_hop, lse = _flash(q, k, v, kmask, causal)
    o = o_hop.float()
    km = kmask
    for step in range(1, size):
        k, v, km = rotate(k, v, km)
        mask = (_hop_mask(km, step <= rank, B, Lk, q.device) if causal
                else km)
        o_hop, lse_hop = _flash(q, k, v, mask, False)
        o, lse = _lse_merge(o, lse, o_hop, lse_hop)
    return o.to(q.dtype)


def _ring_dense(q, k, v, kmask, *, rank, size, causal, rotate):
    """Ring over the dense inner (JAX ``_ring_shard``): an fp32 online
    softmax over global positions."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    qf = q.float()
    scale = 1.0 / math.sqrt(D)
    q_pos = rank * Lq + torch.arange(Lq, device=q.device)
    o = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    km = kmask
    for step in range(size):
        if step:
            k, v, km = rotate(k, v, km)
        src = (rank - step) % size
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float()) * scale
        if km is not None:
            s = torch.where(km[:, None, None, :] > 0, s,
                            torch.full_like(s, NEG_INF))
        if causal:
            k_pos = src * Lk + torch.arange(Lk, device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            torch.full_like(s, NEG_INF))
        o, m, l = _online_softmax_block(o, m, l, s, v)
    # fully masked rows (all padding) have l == 0: zeros, not NaN
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    return (o / safe_l[..., None]).to(q.dtype)


def _check_seq(q) -> None:
    if q.ndim != 4:
        raise ValueError(f"expected [B, H, L, D] inputs, got {tuple(q.shape)}")


def ring_attention(q, k, v, kmask=None, *, shard: Optional[SeqShard] = None,
                   causal: bool = False, inner: str = "auto",
                   rotate: Optional[Callable] = None):
    """Ring attention of this process's sequence shard.

    Args:
        q, k, v: ``[B, H, L/S, D]``, this shard's queries, keys and values.
        kmask: optional ``[B, L/S]`` key mask of this shard (1 = attend).
        shard: the sequence shard (default :func:`shard_of`).
        causal: the causal mask over global positions.
        inner: ``"flash"``, ``"dense"`` or ``"auto"`` (module docstring).
        rotate: one ring hop, ``rotate(k, v, km) -> (k, v, km)``; default
            the P2P exchange on the shard's group (:func:`ring_rotation`).

    Returns ``[B, H, L/S, D]`` in q's dtype."""
    shard = shard_of() if shard is None else shard
    _check_seq(q)
    if rotate is None and shard.size > 1:
        rotate = ring_rotation(shard.group)
    body = _ring_flash if _resolve_inner(inner, q) == "flash" else _ring_dense
    return body(q, k, v, kmask, rank=shard.rank, size=shard.size,
                causal=causal, rotate=rotate)


def zigzag_ring_attention(q, k, v, kmask=None, *,
                          shard: Optional[SeqShard] = None,
                          rotate: Optional[Callable] = None):
    """Load-balanced causal ring attention over the zigzag layout (JAX
    ``_zigzag_shard``), flash inner. This shard's ``[B, H, L/S, D]`` holds
    blocks ``(rank, 2S-1-rank)`` of the sequence; the output is in the same
    layout.

    Hop 0 runs the two causal diagonals and the lo-keys x hi-queries pair;
    every later hop three square flash calls (q_lo x k_lo, q_hi x k_lo,
    q_hi x k_hi) under whole-block key masks; the fourth pair (q_lo x k_hi)
    is never visible and is skipped. One shard holds the whole sequence in
    natural order, so a group of one runs one causal flash call."""
    shard = shard_of(layout="zigzag") if shard is None else shard
    _check_seq(q)
    n, my = shard.size, shard.rank
    B, H, Lq2, D = q.shape
    if Lq2 % 2:
        raise ValueError(
            f"zigzag layout needs L divisible by 2*axis_size = {2 * n}, got "
            f"{Lq2 * n}")
    if n == 1:
        return _flash(q, k, v, kmask, True, return_lse=False)
    if rotate is None:
        rotate = ring_rotation(shard.group)
    Lb = Lq2 // 2
    my_lo, my_hi = my, 2 * n - 1 - my
    q_lo, q_hi = q[:, :, :Lb], q[:, :, Lb:]

    def halves(t):
        return (None, None) if t is None else (t[..., :Lb], t[..., Lb:])

    k_lo, k_hi = k[:, :, :Lb], k[:, :, Lb:]
    v_lo, v_hi = v[:, :, :Lb], v[:, :, Lb:]
    m_lo, m_hi = halves(kmask)
    o_lo, lse_lo = _flash(q_lo, k_lo, v_lo, m_lo, True)
    o_hi, lse_hi = _flash(q_hi, k_hi, v_hi, m_hi, True)
    o_hi, lse_hi = _lse_merge(o_hi.float(), lse_hi,
                              *_flash(q_hi, k_lo, v_lo, m_lo, False))
    o_lo = o_lo.float()
    km = kmask
    for step in range(1, n):
        k, v, km = rotate(k, v, km)
        src = (my - step) % n
        src_blks = (src, 2 * n - 1 - src)
        k_h = (k[:, :, :Lb], k[:, :, Lb:])
        v_h = (v[:, :, :Lb], v[:, :, Lb:])
        km_h = halves(km)

        def pair(o, lse, qh, q_blk, half):
            mask = _hop_mask(km_h[half], src_blks[half] < q_blk, B, Lb,
                             q.device)
            return _lse_merge(o, lse, *_flash(qh, k_h[half], v_h[half],
                                                 mask, False))

        # q_lo sees only lo key blocks (hi blocks are always later)
        o_lo, lse_lo = pair(o_lo, lse_lo, q_lo, my_lo, 0)
        o_hi, lse_hi = pair(o_hi, lse_hi, q_hi, my_hi, 0)
        o_hi, lse_hi = pair(o_hi, lse_hi, q_hi, my_hi, 1)
    return torch.cat([o_lo, o_hi], dim=2).to(q.dtype)


def ulysses_attention(q, k, v, kmask=None, *,
                      shard: Optional[SeqShard] = None, causal: bool = False,
                      inner: str = "auto"):
    """DeepSpeed-Ulysses attention of this process's shard (JAX
    ``_ulysses_shard``): all-to-all to ``[B, H/S, L, D]``, one attention
    over the whole sequence (flash or dense), all-to-all back. The head
    count must divide by the shard count."""
    shard = shard_of() if shard is None else shard
    _check_seq(q)
    S = shard.size
    if q.shape[1] % S:
        raise ValueError(
            f"ulysses_attention: heads ({q.shape[1]}) not divisible by "
            f"mesh axis 'seq' size ({S})")
    km = kmask
    if S > 1:
        q, k, v = (_SeqToHeads.apply(t, shard.group) for t in (q, k, v))
        if kmask is not None:
            km = SeqShard(shard.group, shard.rank, S).gather(kmask, 1)
    if _resolve_inner(inner, q) == "flash":
        out = _flash(q, k, v, km, causal, return_lse=False)
    else:
        out = _dense_whole(q, k, v, km, causal)
    if S > 1:
        out = _HeadsToSeq.apply(out, shard.group)
    return out


def _dense_whole(q, k, v, km, causal: bool):
    """Dense softmax attention in fp32 over the whole sequence."""
    L, D = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if km is not None:
        s = torch.where(km[:, None, None, :] > 0, s,
                        torch.full_like(s, NEG_INF))
    if causal:
        tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=q.device))
        s = torch.where(tri[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# --------------------------------------------------------------------------- #
# model hooks
# --------------------------------------------------------------------------- #


def _as_model_attention(impl: Callable, layout: str) -> Callable:
    """Adapt a per-shard body to the models' ``attention_fn(q, k, v, bias,
    dropout=None)`` contract, with the JAX adapter's guards."""

    def attention_fn(q, k, v, bias, dropout=None):
        if dropout is not None:
            raise NotImplementedError(
                "sequence-parallel attention does not support attention-prob "
                "dropout; set attention dropout to 0 (residual dropout is "
                "fine)")
        kmask = None
        if bias is not None:
            if bias.shape[-2] > 1:
                raise ValueError(
                    "sequence-parallel attention received a full [.., L, L] "
                    "attention bias (an in-model causal mask?); these "
                    "adapters support only [B, 1, 1, L] key-padding biases "
                    "— set attention_is_causal=True on the model and let "
                    "the attention enforce causality")
            kmask = (bias[:, 0, 0, :] > -1e8).to(torch.int32)
        return impl(q, k, v, kmask)

    attention_fn.seq_layout = layout
    return attention_fn


def make_ring_attention(mesh=None, axis_name: str = "seq",
                        batch_axis: str = "data", causal: bool = False,
                        inner: str = "auto") -> Callable:
    """A ring ``attention_fn`` for the models' blocks. ``mesh``: a
    ``DeviceMesh`` whose ``axis_name`` axis is the sequence group, or None
    for the process's shard at call time (:func:`seq_shard`).
    ``batch_axis`` is the JAX signature's (each process holds its batch
    rows here)."""
    return _as_model_attention(
        lambda q, k, v, km: ring_attention(
            q, k, v, km, shard=shard_of(mesh, axis_name), causal=causal,
            inner=inner),
        "contiguous")


def make_ulysses_attention(mesh=None, axis_name: str = "seq",
                           batch_axis: str = "data", causal: bool = False,
                           inner: str = "auto") -> Callable:
    """A Ulysses ``attention_fn`` (arguments as :func:`make_ring_attention`)."""
    return _as_model_attention(
        lambda q, k, v, km: ulysses_attention(
            q, k, v, km, shard=shard_of(mesh, axis_name), causal=causal,
            inner=inner),
        "contiguous")


def make_zigzag_ring_attention(mesh=None, axis_name: str = "seq",
                               batch_axis: str = "data") -> Callable:
    """A zigzag-ring ``attention_fn`` (always causal, flash inner). A model
    built with it (``attention_is_causal=True``) under ``Stoke`` takes
    natural-order batches: the placement hands each process its zigzag
    shard, and GPT's positions and the causal LM loss follow the layout."""
    return _as_model_attention(
        lambda q, k, v, km: zigzag_ring_attention(
            q, k, v, km, shard=shard_of(mesh, axis_name, layout="zigzag")),
        "zigzag")


def model_seq_layout(module: torch.nn.Module) -> str:
    """The sequence layout the model's attention functions need: zigzag
    when any block runs the zigzag ring, else contiguous."""
    for m in module.modules():
        fn = getattr(m, "attention_fn", None)
        if getattr(fn, "seq_layout", None) == "zigzag":
            return "zigzag"
    return "contiguous"


__all__: List[str] = [
    "LAYOUTS",
    "SeqShard",
    "all_reduce_sum",
    "inverse_permutation",
    "make_ring_attention",
    "make_ulysses_attention",
    "make_zigzag_ring_attention",
    "model_seq_layout",
    "ring_attention",
    "ring_rotation",
    "seq_shard",
    "shard_of",
    "sharded",
    "ulysses_attention",
    "using_seq_shard",
    "virtual_ring",
    "zigzag_permutation",
    "zigzag_ring_attention",
]
