"""BERT of the port: the transformer blocks, the encoder and sequence
classification.

Counterpart of ``stoke_tpu/models/bert.py``: the size table, dense
attention, multi-head attention and the post-LN transformer block
(``:28-106``), :class:`BertEncoder` and
:class:`BertForSequenceClassification` (``:109-233``), with the same
numerics as the flax modules:

- attention scores in ``q.dtype``, softmax in fp32 (``bert.py:52-55``);
- GELU is flax's ``nn.gelu``, the tanh approximation (``bert.py:103``);
- every LayerNorm uses eps ``1e-12`` (``bert.py:101,106,152``);
- dropout after the attention and after the FFN (``bert.py:100,105``),
  on the attention probabilities inside ``dense_attention``, after the
  embeddings and after the pooler;
- the padding mask's additive bias is built in fp32, then cast to the
  activations' dtype (``bert.py:154-158``; -1e9 is -inf in fp16).

Attention is pluggable as in the JAX package: each block takes its
``attention_fn`` at construction, and a call may override it
(``attention_fn=``), since the serving engine's cache hook hands each layer
its own function per call. An ``attention_fn`` is called as
``fn(q, k, v, bias)``, plus ``dropout=`` (a :class:`Dropout` for the
probabilities) only while the block trains with a nonzero rate.

Random draws cannot bit-match the JAX package (threefry against Philox):
:class:`Dropout` draws its masks and :class:`LayerDrop` its keep decisions
from their ``generator``, which ``stoke_tpu_torch.Stoke`` seeds from
``Stoke(seed=...)``. Train and eval are the module's mode bit, where the
flax modules take ``train=`` per call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
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


_LATER_REMAT = "ROADMAP Queue 1 item 13 (rematerialization)"


def refuse_remat(model: str) -> None:
    """``remat=True`` waits for its ROADMAP item: a recomputed block would
    redraw its dropout masks from the generator."""
    raise NotImplementedError(
        f"{model}(remat=True) is not ported yet: a recomputed block would "
        f"redraw its dropout masks from the Stoke generator; "
        f"{_LATER_REMAT}"
    )


class LayerDrop(nn.Module):
    """The keep decisions of progressive layer drop, one per layer per
    forward, drawn from ``generator`` (None: torch's default generator) on
    the device, so a replayed CUDA graph draws anew."""

    def __init__(self):
        super().__init__()
        self.generator = None

    def keep(self, keep_p: torch.Tensor) -> torch.Tensor:
        """A bool tensor shaped like ``keep_p``: ``uniform < keep_p``, as
        ``jax.random.bernoulli``."""
        u = torch.rand(keep_p.shape, device=keep_p.device,
                       generator=self.generator)
        return u < keep_p


class BertEncoder(nn.Module):
    """Token, position and (with ``token_types``) segment embeddings,
    ``ln_emb``, embedding dropout and ``size.num_layers`` blocks.

    ``token_types`` makes ``seg_emb`` (2 rows): flax creates it only when
    ``init`` saw ``token_type_ids``, so the port's module says at
    construction which of the two variable trees it has.

    Progressive layer drop: in training, layer i's output replaces its
    input with probability ``keep_i = 1 - frac * (i + 1) / N``, where
    ``frac`` is ``layer_drop_rate``, or with ``layer_drop_theta`` set the
    theta/gamma schedule ``1 - ((1 - theta) exp(-gamma t) + theta)`` at the
    forward's ``global_step`` t (:meth:`layer_drop_fraction`).
    ``remat=True`` is refused (ROADMAP Queue 1 item 13)."""

    def __init__(self, vocab_size: int, size: BertSize, max_len: int = 512,
                 dropout_rate: float = 0.1,
                 attention_fn: Callable = dense_attention,
                 remat: bool = False, layer_drop_rate: float = 0.0,
                 layer_drop_theta: Optional[float] = None,
                 layer_drop_gamma: float = 0.001, token_types: bool = False,
                 device=None):
        super().__init__()
        if remat:
            refuse_remat("BertEncoder")
        self.size = size
        self.layer_drop_rate = float(layer_drop_rate)
        self.layer_drop_theta = layer_drop_theta
        self.layer_drop_gamma = float(layer_drop_gamma)
        self.tok_emb = nn.Embedding(vocab_size, size.hidden, device=device)
        self.pos_emb = nn.Embedding(max_len, size.hidden, device=device)
        self.seg_emb = (nn.Embedding(2, size.hidden, device=device)
                        if token_types else None)
        self.ln_emb = nn.LayerNorm(size.hidden, eps=1e-12, device=device)
        self.emb_dropout = Dropout(dropout_rate)
        self.layers = nn.ModuleList(
            TransformerBlock(size.hidden, size.heads, size.ff, dropout_rate,
                             attention_fn, device=device)
            for _ in range(size.num_layers)
        )
        self.layer_drop = LayerDrop()

    def layer_drop_fraction(self, global_step=None) -> torch.Tensor:
        """The depth-linear drop fraction, fp32 on the parameters' device:
        ``layer_drop_rate``, or ``1 - theta_bar(global_step)`` under the
        theta/gamma schedule (``stoke_tpu/models/bert.py:181-190``)."""
        dev = self.tok_emb.weight.device
        if self.layer_drop_theta is None:
            return torch.tensor(self.layer_drop_rate, dtype=torch.float32,
                                device=dev)
        theta = torch.tensor(self.layer_drop_theta, dtype=torch.float32,
                             device=dev)
        t = torch.as_tensor(global_step, dtype=torch.float32, device=dev)
        gamma = torch.tensor(self.layer_drop_gamma, dtype=torch.float32,
                             device=dev)
        return 1.0 - ((1.0 - theta) * torch.exp(-gamma * t) + theta)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                global_step=None):
        B, L = input_ids.shape
        pos = torch.arange(L, device=input_ids.device)
        h = self.tok_emb(input_ids) + self.pos_emb(pos)[None]
        if token_type_ids is not None:
            if self.seg_emb is None:
                raise ValueError(
                    "BertEncoder: token_type_ids given, but the module was "
                    "built without segment embeddings (token_types=False)")
            h = h + self.seg_emb(token_type_ids)
        h = self.emb_dropout(self.ln_emb(h))
        bias = None
        if attention_mask is not None:
            # [B, 1, 1, L], built in fp32 then cast: -1e9 is -inf in fp16
            bias = torch.where(attention_mask[:, None, None, :] > 0,
                               torch.zeros((), device=h.device),
                               torch.full((), -1e9, device=h.device))
            bias = bias.to(h.dtype)
        keep = None
        if self.training and (self.layer_drop_rate > 0.0
                              or self.layer_drop_theta is not None):
            if self.layer_drop_theta is not None and global_step is None:
                raise ValueError(
                    "Stoke -- layer_drop_theta is set (PLD theta/gamma time "
                    "schedule) but the forward was called without the "
                    "global_step kwarg; the schedule would silently never "
                    "engage.  Pass global_step=<optimizer step> (a traced "
                    "scalar), or use the static layer_drop_rate instead."
                )
            n = len(self.layers)
            depth = torch.arange(1, n + 1, dtype=torch.float32,
                                 device=h.device) / n
            keep = self.layer_drop.keep(
                1.0 - self.layer_drop_fraction(global_step) * depth)
        for i, layer in enumerate(self.layers):
            h_new = layer(h, bias)
            h = h_new if keep is None else torch.where(keep[i], h_new, h)
        return h


class BertForSequenceClassification(nn.Module):
    """The encoder, then ``tanh(pooler(h[:, 0]))``, dropout and the
    classifier: ``[B, L]`` token ids (and optionally the ``[B, L]`` mask
    and token types) -> ``[B, num_classes]`` logits.

    Args:
        vocab_size / num_classes / size_name / max_len / dropout_rate /
            attention_fn / layer_drop_rate / layer_drop_theta /
            layer_drop_gamma: as the JAX package's module.
        remat: must be False (ROADMAP Queue 1 item 13).
        token_types: build ``seg_emb`` (the flax tree of a module
            initialised with ``token_type_ids``).
        device: where the parameters are created.

    The parameters start from flax's defaults drawn from seed 0
    (:meth:`init_weights`)."""

    def __init__(self, vocab_size: int = 30522, num_classes: int = 2,
                 size_name: str = "base", max_len: int = 512,
                 dropout_rate: float = 0.1,
                 attention_fn: Callable = dense_attention,
                 remat: bool = False, layer_drop_rate: float = 0.0,
                 layer_drop_theta: Optional[float] = None,
                 layer_drop_gamma: float = 0.001, token_types: bool = False,
                 device=None):
        super().__init__()
        if remat:
            refuse_remat("BertForSequenceClassification")
        size = BERT_SIZES[size_name]
        self.encoder = BertEncoder(
            vocab_size, size, max_len, dropout_rate, attention_fn,
            layer_drop_rate=layer_drop_rate,
            layer_drop_theta=layer_drop_theta,
            layer_drop_gamma=layer_drop_gamma, token_types=token_types,
            device=device)
        self.pooler = nn.Linear(size.hidden, size.hidden, device=device)
        self.cls_dropout = Dropout(dropout_rate)
        self.classifier = nn.Linear(size.hidden, num_classes, device=device)
        self.init_weights(0)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """flax's default initialisation drawn by a generator seeded with
        ``seed`` on the parameters' device: ``lecun_normal`` dense kernels,
        zero biases, LayerNorm scale 1 and shift 0, embeddings from
        N(0, 1/hidden)."""
        from stoke_tpu_torch.models.resnet import init_flax_defaults

        init_flax_defaults(self, seed)
        dev = self.pooler.weight.device
        if dev.type == "meta":
            return
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        for m in self.encoder.modules():
            if isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                                 generator=gen)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                global_step=None):
        h = self.encoder(input_ids, attention_mask, token_type_ids,
                         global_step)
        cls = torch.tanh(self.pooler(h[:, 0]))
        return self.classifier(self.cls_dropout(cls))


BertBase = partial(BertForSequenceClassification, size_name="base")
BertTiny = partial(BertForSequenceClassification, size_name="tiny")
