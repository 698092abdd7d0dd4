"""Transformer blocks of the port (inference).

Counterpart of ``stoke_tpu/models/bert.py:28-106``: the size table, dense
attention, multi-head attention and the post-LN transformer block, with
the same numerics as the flax modules:

- attention scores in ``q.dtype``, softmax in fp32 (``bert.py:52-55``);
- GELU is flax's ``nn.gelu``, the tanh approximation (``bert.py:103``);
- both block LayerNorms use eps ``1e-12`` (``bert.py:101,106``).

The port serves only, so dropout is left out. Attention is pluggable as in
the JAX package, but passed at call time (``attention_fn=``), since the
serving engine's cache hook hands each layer its own function per call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

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


def dense_attention(q, k, v, bias):
    """Softmax attention on ``[B, H, L, D]``: scores in ``q.dtype``, plus
    ``bias`` (broadcastable to ``[B, H, L, L]``, or None), softmax in fp32."""
    # sqrt(D) rounded to q's dtype, as the JAX version divides by it
    root = float(torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / root
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


class MultiHeadAttention(nn.Module):
    """``qkv`` projects to ``[B, L, 3, H, D]`` (flax ``DenseGeneral((3, H,
    D))``); ``out`` maps the heads, re-flattened in ``[B, L, H*D]`` order,
    back to ``hidden``."""

    def __init__(self, hidden: int, heads: int, device=None):
        super().__init__()
        self.hidden = hidden
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden, device=device)
        self.out = nn.Linear(hidden, hidden, device=device)

    def forward(self, x, bias, attention_fn: Callable = dense_attention):
        B, L, _ = x.shape
        D = self.hidden // self.heads
        # [B, L, 3, H, D] -> [3, B, H, L, D]: q, k, v contiguous, as the
        # attention kernels take them
        qkv = self.qkv(x).view(B, L, 3, self.heads, D)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        out = attention_fn(q, k, v, bias)
        out = out.transpose(1, 2).reshape(B, L, self.hidden)
        return self.out(out)


class TransformerBlock(nn.Module):
    """Post-LN block: ``x = LN(x + attn(x)); x = LN(x + ffn(x))``."""

    def __init__(self, hidden: int, heads: int, ff: int, device=None):
        super().__init__()
        self.attention = MultiHeadAttention(hidden, heads, device=device)
        self.ln_attn = nn.LayerNorm(hidden, eps=1e-12, device=device)
        self.ff_in = nn.Linear(hidden, ff, device=device)
        self.ff_out = nn.Linear(ff, hidden, device=device)
        self.ln_ff = nn.LayerNorm(hidden, eps=1e-12, device=device)

    def forward(self, x, bias, attention_fn: Callable = dense_attention):
        x = self.ln_attn(x + self.attention(x, bias, attention_fn))
        y = self.ff_out(F.gelu(self.ff_in(x), approximate="tanh"))
        return self.ln_ff(x + y)
