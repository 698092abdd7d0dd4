"""Transformer blocks of the port.

Counterpart of ``stoke_tpu/models/bert.py:28-106``: the size table, dense
attention, multi-head attention and the post-LN transformer block, with
the same numerics as the flax modules:

- attention scores in ``q.dtype``, softmax in fp32 (``bert.py:52-55``);
- GELU is flax's ``nn.gelu``, the tanh approximation (``bert.py:103``);
- both block LayerNorms use eps ``1e-12`` (``bert.py:101,106``);
- dropout after the attention and after the FFN (``bert.py:100,105``),
  and on the attention probabilities inside ``dense_attention``.

Attention is pluggable as in the JAX package: each block takes its
``attention_fn`` at construction, and a call may override it
(``attention_fn=``), since the serving engine's cache hook hands each layer
its own function per call. An ``attention_fn`` is called as
``fn(q, k, v, bias)``, plus ``dropout=`` (a :class:`Dropout` for the
probabilities) only while the block trains with a nonzero rate.

Dropout masks cannot bit-match the JAX package (threefry against Philox):
:class:`Dropout` draws them from its ``generator``, which
``stoke_tpu_torch.Stoke`` seeds from ``Stoke(seed=...)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class BertSize:
    num_layers: int
    hidden: int
    heads: int
    ff: int


BERT_SIZES = {
    "tiny": BertSize(2, 128, 2, 512),
    "mini": BertSize(4, 256, 4, 1024),
    "small": BertSize(4, 512, 8, 2048),
    "medium": BertSize(8, 512, 8, 2048),
    "base": BertSize(12, 768, 12, 3072),
    "large": BertSize(24, 1024, 16, 4096),
}


class Dropout(nn.Module):
    """Inverted dropout (flax ``nn.Dropout``): in training, zero each
    element with probability ``rate`` and scale the rest by
    ``1 / (1 - rate)``; in eval, or at rate 0, the identity. Masks come
    from ``generator`` (None: torch's default generator), which must live
    on the input's device."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, device=x.device,
                          generator=self.generator) >= self.rate
        return x * keep.to(x.dtype) / (1.0 - self.rate)


def dense_attention(q, k, v, bias, dropout=None):
    """Softmax attention on ``[B, H, L, D]``: scores in ``q.dtype``, plus
    ``bias`` (broadcastable to ``[B, H, L, L]``, or None), softmax in fp32,
    then ``dropout`` (a callable, or None) on the probabilities."""
    # sqrt(D) rounded to q's dtype, as the JAX version divides by it
    root = float(torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / root
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    if dropout is not None:
        probs = dropout(probs)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


class MultiHeadAttention(nn.Module):
    """``qkv`` projects to ``[B, L, 3, H, D]`` (flax ``DenseGeneral((3, H,
    D))``); ``out`` maps the heads, re-flattened in ``[B, L, H*D]`` order,
    back to ``hidden``. The probabilities drop out at ``dropout_rate``
    while training."""

    def __init__(self, hidden: int, heads: int, dropout_rate: float = 0.1,
                 attention_fn: Callable = dense_attention, device=None):
        super().__init__()
        self.hidden = hidden
        self.heads = heads
        self.attention_fn = attention_fn
        self.qkv = nn.Linear(hidden, 3 * hidden, device=device)
        self.out = nn.Linear(hidden, hidden, device=device)
        self.prob_dropout = Dropout(dropout_rate)

    def forward(self, x, bias, attention_fn: Optional[Callable] = None):
        B, L, _ = x.shape
        D = self.hidden // self.heads
        fn = self.attention_fn if attention_fn is None else attention_fn
        # [B, L, 3, H, D] -> [3, B, H, L, D]: q, k, v contiguous, as the
        # attention kernels take them
        qkv = self.qkv(x).view(B, L, 3, self.heads, D)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        if self.training and self.prob_dropout.rate > 0.0:
            out = fn(q, k, v, bias, dropout=self.prob_dropout)
        else:
            out = fn(q, k, v, bias)
        out = out.transpose(1, 2).reshape(B, L, self.hidden)
        return self.out(out)


class TransformerBlock(nn.Module):
    """Post-LN block: ``x = LN(x + drop(attn(x))); x = LN(x +
    drop(ffn(x)))``."""

    def __init__(self, hidden: int, heads: int, ff: int,
                 dropout_rate: float = 0.1,
                 attention_fn: Callable = dense_attention, device=None):
        super().__init__()
        self.attention = MultiHeadAttention(hidden, heads, dropout_rate,
                                            attention_fn, device=device)
        self.drop_attn = Dropout(dropout_rate)
        self.ln_attn = nn.LayerNorm(hidden, eps=1e-12, device=device)
        self.ff_in = nn.Linear(hidden, ff, device=device)
        self.ff_out = nn.Linear(ff, hidden, device=device)
        self.drop_ff = Dropout(dropout_rate)
        self.ln_ff = nn.LayerNorm(hidden, eps=1e-12, device=device)

    def forward(self, x, bias, attention_fn: Optional[Callable] = None):
        y = self.drop_attn(self.attention(x, bias, attention_fn))
        x = self.ln_attn(x + y)
        y = self.ff_out(F.gelu(self.ff_in(x), approximate="tanh"))
        return self.ln_ff(x + self.drop_ff(y))
