"""GPT-style decoder-only causal language model, and its loss.

Counterpart of ``stoke_tpu/models/gpt.py:30-219``: learned token and
position embeddings, embedding dropout, the post-LN blocks of :mod:`.bert`,
``ln_final`` (eps ``1e-5``) and the head tied to the token embedding
(``logits = h @ tok_emb.T``), or with ``chunked_head=True`` the
``(hidden, embedding)`` pair that
:func:`stoke_tpu_torch.ops.chunked_causal_lm_loss` takes instead of the
logits; :func:`causal_lm_loss`. Parameter names
follow the flax tree (``layers.<i>`` for ``layer_<i>``), so
:mod:`stoke_tpu_torch.convert` maps one onto the other.

Training path: ``attention_fn`` (default :func:`.bert.dense_attention`)
goes to every block; with ``attention_is_causal=True`` (for
``make_flash_attention(causal=True)``) the forward builds no causal bias.
Train and eval are the module's mode bit (``model.train()`` /
``model.eval()``), where the JAX package takes ``train=`` per call.

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

from stoke_tpu_torch.models.bert import (
    BERT_SIZES,
    Dropout,
    TransformerBlock,
    dense_attention,
)


class GPT(nn.Module):
    """Decoder-only LM over the ``BERT_SIZES`` width table.

    Args:
        vocab_size / size_name / max_len / attention_fn /
            attention_is_causal: as the JAX package's ``GPT``.
        tie_embeddings: must be True: the port has the tied head only;
            False raises (with ``chunked_head``, the JAX package's
            message).
        chunked_head: return ``(hidden, tok_emb.weight)`` instead of the
            logits, for :func:`stoke_tpu_torch.ops.chunked_causal_lm_loss`.
        dropout_rate: embedding, residual and attention-probability
            dropout while training.
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
                 device=None):
        super().__init__()
        if chunked_head and not tie_embeddings:
            raise ValueError(
                "GPT: chunked_head requires tie_embeddings=True (the "
                "chunked loss re-applies the tied embedding per chunk)"
            )
        if not tie_embeddings:
            raise ValueError(
                "GPT: the port has the tied head only (tie_embeddings=False "
                "is not ported)"
            )
        size = BERT_SIZES[size_name]
        self.vocab_size = vocab_size
        self.size_name = size_name
        self.max_len = max_len
        self.attention_is_causal = attention_is_causal
        self.chunked_head = chunked_head
        self.tok_emb = nn.Embedding(vocab_size, size.hidden, device=device)
        self.pos_emb = nn.Embedding(max_len, size.hidden, device=device)
        self.emb_dropout = Dropout(dropout_rate)
        self.layers = nn.ModuleList(
            TransformerBlock(size.hidden, size.heads, size.ff, dropout_rate,
                             attention_fn, device=device)
            for _ in range(size.num_layers)
        )
        self.ln_final = nn.LayerNorm(size.hidden, eps=1e-5, device=device)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded random init with flax's default scales: weight matrices
        from N(0, 1/fan_in), embeddings from N(0, 1/hidden), biases 0,
        LayerNorm scale 1 and shift 0, drawn by a generator on the
        parameters' device."""
        dev = self.tok_emb.weight.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, p in self.named_parameters():
            if ".ln_" in name or name.startswith("ln_"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)

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
        if L > self.max_len:
            raise ValueError(
                f"GPT: sequence length {L} exceeds max_len={self.max_len}"
            )
        dev = input_ids.device
        if positions is None:
            pos = torch.arange(L, device=dev)[None, :]
        else:
            pos = torch.as_tensor(positions, device=dev)
            if pos.ndim == 1:
                pos = pos[None, :]
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
            h = layer(h, bias, fn)
        h = self.ln_final(h)
        if self.chunked_head:
            return h, self.tok_emb.weight
        return h @ self.tok_emb.weight.T


def causal_lm_loss(logits, input_ids, mask=None):
    """Next-token cross entropy in fp32: position t predicts token t+1.
    The mean over the ``[B, L-1]`` targets, or with ``mask`` (``[B, L]``
    0/1, padding 0) the mean over the kept targets,
    ``sum(loss * w) / max(sum(w), 1)``."""
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
