"""GPT-style decoder-only causal language model, and its loss.

Counterpart of ``stoke_tpu/models/gpt.py:30-219``: learned token and
position embeddings, embedding dropout, the post-LN blocks of :mod:`.bert`,
``ln_final`` (eps ``1e-5``) and the head tied to the token embedding
(``logits = h @ tok_emb.T``) or, with ``tie_embeddings=False``, flax's
``lm_head`` Dense with a bias; or with ``chunked_head=True`` the
``(hidden, embedding)`` pair that
:func:`stoke_tpu_torch.ops.chunked_causal_lm_loss` takes instead of the
logits; :func:`causal_lm_loss`. Parameter names
follow the flax tree (``layers.<i>`` for ``layer_<i>``), so
:mod:`stoke_tpu_torch.convert` maps one onto the other.

Training path: ``attention_fn`` (default :func:`.bert.dense_attention`)
goes to every block; with ``attention_is_causal=True`` (for
``make_flash_attention(causal=True)``) the forward builds no causal bias.
``remat=True`` recomputes each block in backward
(:func:`~stoke_tpu_torch.models.bert.run_block`).
Train and eval are the module's mode bit (``model.train()`` /
``model.eval()``), where the JAX package takes ``train=`` per call.

Sequence parallelism: under a process's sequence shard of more than one
(:func:`stoke_tpu_torch.ops.attention.seq_shard`, set by ``Stoke``
around its calls under ``shard_seq_dim`` on a ``("data", "seq")`` mesh)
the forward takes this shard's tokens, its
default positions are their global positions (the shard's range, or its
zigzag slice), and whole-sequence ``positions`` are cut to the shard;
:func:`causal_lm_loss` then shifts across the shards' edges and takes the
mean over the global count, so the loss and each shard's logits are those
of the whole sequence.

Sparse FFN: ``moe_num_experts > 0`` makes every ``moe_every``-th block a
:class:`~stoke_tpu_torch.models.moe.MoETransformerBlock` (the JAX
``moe_*`` options, their validation messages), its router noise drawn
from the Stoke's generator; ``remat`` covers those blocks too. The paged
serving path refuses such a model (the JAX package's message).

Serving path: ``kv_cache`` is a per-call paged-cache hook
(:class:`stoke_tpu_torch.serving.kv_cache.PagedAttentionHook`) that gives
each layer its attention function (``layer_attention(i)``); ``decode=True``
marks the single-token incremental forward, with each slot's position in
``positions``. Masking is then the hook's job, so no causal bias is built.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from stoke_tpu_torch.ops.attention import all_reduce_sum, seq_shard, sharded
from stoke_tpu_torch.models.bert import (
    BERT_SIZES,
    Dropout,
    TransformerBlock,
    dense_attention,
    run_block,
)
from stoke_tpu_torch.models.moe import MoETransformerBlock

#: the JAX package's refusal of the paged cache for a MoE GPT
MOE_KV_CACHE = ("GPT: the paged KV-cache serving path supports dense FFN "
                "blocks only (no MoE routing state in the cache)")


class GPT(nn.Module):
    """Decoder-only LM over the ``BERT_SIZES`` width table.

    Args:
        vocab_size / size_name / max_len / attention_fn /
            attention_is_causal: as the JAX package's ``GPT``.
        tie_embeddings: the head is the token embedding transposed; False
            makes ``lm_head``, a ``Linear`` with a bias (flax's
            ``nn.Dense(vocab, name="lm_head")``). False with
            ``chunked_head`` raises the JAX package's message.
        remat: recompute each block in backward.
        chunked_head: return ``(hidden, tok_emb.weight)`` instead of the
            logits, for :func:`stoke_tpu_torch.ops.chunked_causal_lm_loss`.
        dropout_rate: embedding, residual and attention-probability
            dropout while training.
        moe_num_experts / moe_every / moe_capacity_factor /
            moe_router_noise / moe_top_k: the switch MoE in every
            ``moe_every``-th block (0 experts: dense everywhere), as the
            JAX package's options.
        device: where the parameters are created.

    The full-sequence forward runs ``attention_fn`` (with an in-model
    causal bias unless ``attention_is_causal``); the serving forward takes
    each layer's attention from the cache hook.
    """

    def __init__(self, vocab_size: int = 50257, size_name: str = "tiny",
                 max_len: int = 1024, dropout_rate: float = 0.1,
                 attention_fn: Callable = dense_attention,
                 attention_is_causal: bool = False,
                 tie_embeddings: bool = True, chunked_head: bool = False,
                 remat: bool = False, moe_num_experts: int = 0,
                 moe_every: int = 2, moe_capacity_factor: float = 1.25,
                 moe_router_noise: float = 0.0, moe_top_k: int = 1,
                 device=None):
        super().__init__()
        if chunked_head and not tie_embeddings:
            raise ValueError(
                "GPT: chunked_head requires tie_embeddings=True (the "
                "chunked loss re-applies the tied embedding per chunk)"
            )
        size = BERT_SIZES[size_name]
        self.vocab_size = vocab_size
        self.size_name = size_name
        self.max_len = max_len
        self.attention_is_causal = attention_is_causal
        self.chunked_head = chunked_head
        self.tie_embeddings = tie_embeddings
        self.remat = bool(remat)
        self.moe_num_experts = moe_num_experts
        if moe_num_experts > 0:
            if moe_every < 1:
                raise ValueError(
                    f"GPT: moe_every must be >= 1, got {moe_every}")
            if size.num_layers // moe_every == 0:
                raise ValueError(
                    f"GPT: moe_every={moe_every} selects no layer in a "
                    f"{size.num_layers}-layer model — the MoE option would "
                    f"silently train fully dense")
        self.tok_emb = nn.Embedding(vocab_size, size.hidden, device=device)
        self.pos_emb = nn.Embedding(max_len, size.hidden, device=device)
        self.emb_dropout = Dropout(dropout_rate)

        def block(i):
            if moe_num_experts > 0 and (i + 1) % moe_every == 0:
                return MoETransformerBlock(
                    size.hidden, size.heads, size.ff, moe_num_experts,
                    dropout_rate, moe_capacity_factor, attention_fn,
                    moe_router_noise, moe_top_k, device=device)
            return TransformerBlock(size.hidden, size.heads, size.ff,
                                    dropout_rate, attention_fn, device=device)

        self.layers = nn.ModuleList(block(i) for i in range(size.num_layers))
        self.ln_final = nn.LayerNorm(size.hidden, eps=1e-5, device=device)
        self.lm_head = (None if tie_embeddings else
                        nn.Linear(size.hidden, vocab_size, device=device))

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded random init with flax's default scales: weight matrices
        from N(0, 1/fan_in), embeddings from N(0, 1/hidden), biases 0,
        LayerNorm scale 1 and shift 0, drawn by a generator on the
        parameters' device. The experts' stacked ``[E, in, out]`` kernels
        take lecun_normal's fan-in, ``E * in``."""
        dev = self.tok_emb.weight.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, p in self.named_parameters():
            if ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                fan_in = p.shape[1] * (p.shape[0] if p.dim() == 3 else 1)
                p.normal_(0.0, fan_in ** -0.5, generator=gen)

    def forward(self, input_ids, positions=None, *, decode: bool = False,
                kv_cache=None):
        """``input_ids [B, L]`` -> logits ``[B, L, vocab]`` (with
        ``chunked_head``, the final hidden states ``[B, L, hidden]`` and the
        tied embedding ``[vocab, hidden]``).

        ``positions`` ([L] or [B, L] int) overrides the default ``arange``
        position ids; required with ``decode=True``."""
        B, L = input_ids.shape
        if decode and kv_cache is None:
            raise ValueError(
                "GPT: decode=True needs a kv_cache hook (the incremental "
                "forward reads and writes the paged KV cache)"
            )
        if decode and L != 1:
            raise ValueError(
                f"GPT: decode=True is single-token incremental decode; got "
                f"sequence length {L}"
            )
        if decode and positions is None:
            raise ValueError(
                "GPT: decode=True needs explicit positions (each slot's "
                "cache position selects its position embedding)"
            )
        if kv_cache is not None and self.moe_num_experts > 0:
            raise NotImplementedError(MOE_KV_CACHE)
        shard = seq_shard() if kv_cache is None else None
        shards = shard.size if sharded(shard) else 1
        if L * shards > self.max_len:
            raise ValueError(
                f"GPT: sequence length {L * shards} exceeds "
                f"max_len={self.max_len}"
            )
        dev = input_ids.device
        if positions is None:
            pos = (torch.arange(L, device=dev) if shards == 1
                   else shard.global_index(L, dev))[None, :]
        else:
            pos = torch.as_tensor(positions, device=dev)
            if pos.ndim == 1:
                pos = pos[None, :]
            if shards > 1 and pos.shape[-1] == L * shards:
                pos = shard.take(pos, pos.ndim - 1)
            # an out-of-range id would fault the embedding on the card;
            # positions on the card are the engine's, checked on the host
            if pos.device.type == "cpu" and int(pos.max()) >= self.max_len:
                raise ValueError(
                    f"GPT: positions contain id {int(pos.max())} >= "
                    f"max_len={self.max_len}"
                )
        h = self.emb_dropout(self.tok_emb(input_ids) + self.pos_emb(pos))
        if self.attention_is_causal or kv_cache is not None:
            # the attention function (or the cache hook) masks causally
            bias = None
        else:
            causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=dev))
            # built in fp32 and cast, as the JAX package builds it: -1e9
            # is -inf in fp16
            bias = torch.where(causal, 0.0, -1e9)[None, None].to(h.dtype)
        for i, layer in enumerate(self.layers):
            fn = None if kv_cache is None else kv_cache.layer_attention(i)
            h = run_block(layer, self.remat and kv_cache is None, h, bias,
                          fn)
        h = self.ln_final(h)
        if self.chunked_head:
            return h, self.tok_emb.weight
        if self.lm_head is not None:
            return self.lm_head(h)
        return h @ self.tok_emb.weight.T


def causal_lm_loss(logits, input_ids, mask=None):
    """Next-token cross entropy in fp32: position t predicts token t+1.
    The mean over the ``[B, L-1]`` targets, or with ``mask`` (``[B, L]``
    0/1, padding 0) the mean over the kept targets,
    ``sum(loss * w) / max(sum(w), 1)``.

    Under a sequence shard of more than one, ``logits`` and ``input_ids``
    are this shard's; the whole sequence's ids are gathered, each token's
    target is the token after it in the whole sequence, and the loss is
    the whole batch row's (the same value on every shard)."""
    shard = seq_shard()
    if sharded(shard):
        return _sharded_causal_lm_loss(logits, input_ids, mask, shard)
    targets = input_ids[:, 1:].long()
    logits = logits[:, :-1].float()
    losses = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
        reduction="none",
    ).view(targets.shape)
    if mask is not None:
        w = mask[:, 1:].to(losses.dtype)
        return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)
    return losses.mean()


def _sharded_causal_lm_loss(logits, input_ids, mask, shard):
    """:func:`causal_lm_loss` of this shard's tokens: the sum of its
    targets' cross entropies, summed over the shards (whose backward sums
    the cotangents: each shard's term depends on every shard's keys),
    over the whole sequence's target count."""
    B, Ls = input_ids.shape
    L = Ls * shard.size
    ids = shard.gather(input_ids, 1).long()
    pos = shard.global_index(Ls, input_ids.device)
    nxt = torch.clamp(pos + 1, max=L - 1)
    w = (pos < L - 1).to(torch.float32)[None, :].expand(B, Ls)
    if mask is not None:
        w = w * shard.gather(mask, 1)[:, nxt].to(torch.float32)
    losses = F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]),
        ids[:, nxt].reshape(-1), reduction="none").view(B, Ls)
    total = all_reduce_sum((losses * w).sum(), shard)
    if mask is None:
        return total / float(B * (L - 1))
    count = all_reduce_sum(w.sum(), shard).detach()
    return total / torch.clamp(count, min=1.0)
