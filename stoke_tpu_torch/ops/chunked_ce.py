"""Chunked LM-head cross entropy: the loss without the ``[B, L, V]`` logits.

Counterpart of ``stoke_tpu/ops/chunked_ce.py:27-96``. A loop over sequence
chunks, each under ``torch.utils.checkpoint`` (non-reentrant): a chunk's
logits ``[B, chunk, V]`` are computed, reduced to a sum of cross entropies
and dropped, and its backward recomputes them, so at most one chunk's
logits live at a time, forward and backward. Padding when ``chunk`` does
not divide L, an optional 0/1 mask, and the masked mean in fp32, as the
JAX function computes them.

The logits are fp32. With fp32 operands the product is an fp32 ``mm``
(TF32 only where the caller enabled it for all fp32 matmuls). Under the
port's bf16 or fp16 policy the model computes in 16 bits but the engine
casts its outputs to fp32, as the JAX policy does, so the ``(hidden,
embedding)`` pair arrives as fp32 copies of 16-bit values; an fp32 product
of those costs ~2.5 TFLOP a GPT-base step at the card's 67 TFLOP/s of fp32
FMAs. So the step engine runs the loss under :func:`compute_dtype` of its
policy's 16-bit type, and the loss rounds the operands back to it, which
is exact for such copies, and multiplies them on the tensor cores with
fp32 accumulation and an fp32 result: the same products as the fp32
product, summed in another order. Its backward rounds the fp32 gradient
of the logits to the operands' type before its two products (the full
head's bf16 backward does the same), with fp32 accumulation. Under the
fp32 policy, or outside a step, the product stays fp32.

The embedding's rows are padded with zeros to a multiple of
``_VOCAB_ALIGN`` and the padded columns of each chunk's logits set to
-inf, which the softmax gives no weight: exact, and it lets cuBLAS run
its aligned tensor-core tiles, where GPT's odd vocabulary of 50257 makes
every leading dimension of the head's products odd.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Iterator, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# the embedding's rows are padded to a multiple of this
_VOCAB_ALIGN = 64

_COMPUTE_DTYPE: ContextVar[Optional[torch.dtype]] = ContextVar(
    "chunked_ce_compute_dtype", default=None)


@contextmanager
def compute_dtype(dtype: Optional[torch.dtype]) -> Iterator[None]:
    """Within the block, :func:`chunked_softmax_cross_entropy` rounds
    ``hidden`` and ``emb`` to ``dtype`` (a 16-bit type; None: no rounding)
    and multiplies them with an fp32 result. The step engine enters it
    around the loss with its policy's compute dtype, whose values the
    model's fp32 outputs hold exactly."""
    token = _COMPUTE_DTYPE.set(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE.reset(token)


def _mm_fp32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 16-bit 2-D operands with fp32 accumulation and an fp32
    result: one cuBLAS GEMM on the card (``torch.mm(out_dtype=)``); on the
    CPU the fp32 product of the operands' exact fp32 copies."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Logits16(torch.autograd.Function):
    """fp32 logits ``h @ emb.T`` of 16-bit ``h [N, H]`` and ``emb [V, H]``;
    the backward's products take the logits' gradient rounded to their
    type, with fp32 accumulation."""

    @staticmethod
    def forward(ctx, h, emb):
        ctx.save_for_backward(h, emb)
        return _mm_fp32_out(h, emb.t())

    @staticmethod
    def backward(ctx, g):
        h, emb = ctx.saved_tensors
        g = g.to(h.dtype)
        return (_mm_fp32_out(g, emb).to(h.dtype),
                _mm_fp32_out(g.t(), h).to(emb.dtype))


def _chunk_ce_sum(h, emb, t, m, vocab: int):
    """Sum over one chunk of the masked cross entropies; ``emb``'s rows
    from ``vocab`` on are padding."""
    H = h.shape[-1]
    h = h.reshape(-1, H)
    logits = h @ emb.t() if h.dtype == torch.float32 else _Logits16.apply(
        h, emb)
    logits[:, vocab:] = float("-inf")
    ce = F.cross_entropy(logits, t.reshape(-1), reduction="none")
    return (ce * m.reshape(-1)).sum()


def chunked_softmax_cross_entropy(hidden, emb, targets, *, chunk: int = 128,
                                  mask=None):
    """Masked-mean token cross entropy from hidden states and an embedding.

    Args:
        hidden: ``[B, L, H]`` final hidden states.
        emb: ``[V, H]`` (tied) output embedding.
        targets: ``[B, L]`` int target ids.
        chunk: sequence positions per step (one step's logits are
            ``B * chunk * V`` floats).
        mask: optional ``[B, L]`` 0/1 validity; masked positions contribute
            neither loss nor count.

    The product is in the inputs' dtype, or in :func:`compute_dtype`'s
    16-bit type with an fp32 result where the caller (the step engine
    under a bf16 or fp16 policy) entered it. Returns the scalar fp32 mean
    over valid positions."""
    B, L, _ = hidden.shape
    mask = (torch.ones(B, L, device=hidden.device) if mask is None
            else mask.float())
    chunk = max(1, min(int(chunk), L))
    pad = (-L) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    dtype = _COMPUTE_DTYPE.get()
    if dtype is not None:
        hidden, emb = hidden.to(dtype), emb.to(dtype)
    vocab = emb.shape[0]
    emb = F.pad(emb, (0, 0, 0, (-vocab) % _VOCAB_ALIGN))
    targets = targets.long()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, L + pad, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(
            _chunk_ce_sum, hidden[:, sl], emb, targets[:, sl], mask[:, sl],
            vocab, use_reentrant=False, preserve_rng_state=False)
    return total / mask.sum().clamp_min(1.0)


def chunked_causal_lm_loss(out, input_ids, mask=None, *, chunk: int = 128):
    """Next-token cross entropy for ``GPT(chunked_head=True)``'s ``(hidden,
    embedding)`` output: position t predicts token t+1, with an optional
    ``[B, L]`` padding mask (``models.gpt.causal_lm_loss`` without the
    logits)."""
    from stoke_tpu_torch.ops.attention import seq_shard, sharded

    if sharded(seq_shard()):
        from stoke_tpu_torch.status import LATER_SECOND_AXIS

        raise NotImplementedError(
            f"Stoke -- the chunked head under a sequence axis is not ported "
            f"yet: {LATER_SECOND_AXIS}")
    hidden, emb = out
    m = None if mask is None else mask[:, 1:]
    return chunked_softmax_cross_entropy(
        hidden[:, :-1], emb, input_ids[:, 1:], chunk=chunk, mask=m)
