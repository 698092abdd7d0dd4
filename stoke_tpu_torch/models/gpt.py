"""GPT-style decoder-only causal language model (inference).

Counterpart of ``stoke_tpu/models/gpt.py:30-201``: learned token and
position embeddings, the post-LN blocks of :mod:`.bert`, ``ln_final``
(eps ``1e-5``) and the head tied to the token embedding
(``logits = h @ tok_emb.T``). Parameter names follow the flax tree
(``layers.<i>`` for ``layer_<i>``), so :mod:`stoke_tpu_torch.convert`
maps one onto the other.

Serving path: ``kv_cache`` is a per-call paged-cache hook
(:class:`stoke_tpu_torch.serving.kv_cache.PagedAttentionHook`) that gives
each layer its attention function (``layer_attention(i)``); ``decode=True``
marks the single-token incremental forward, with each slot's position in
``positions``. Masking is then the hook's job, so no causal bias is built.
"""

from __future__ import annotations

import torch
from torch import nn

from stoke_tpu_torch.models.bert import (
    BERT_SIZES,
    TransformerBlock,
    dense_attention,
)


class GPT(nn.Module):
    """Decoder-only LM over the ``BERT_SIZES`` width table.

    Args:
        vocab_size / size_name / max_len: as the JAX package's ``GPT``.
        device: where the parameters are created.

    The full-sequence forward runs dense attention with an in-model causal
    bias; the serving forward takes each layer's attention from the cache
    hook.
    """

    def __init__(self, vocab_size: int = 50257, size_name: str = "tiny",
                 max_len: int = 1024, device=None):
        super().__init__()
        size = BERT_SIZES[size_name]
        self.vocab_size = vocab_size
        self.size_name = size_name
        self.max_len = max_len
        self.tok_emb = nn.Embedding(vocab_size, size.hidden, device=device)
        self.pos_emb = nn.Embedding(max_len, size.hidden, device=device)
        self.layers = nn.ModuleList(
            TransformerBlock(size.hidden, size.heads, size.ff, device=device)
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
        """``input_ids [B, L]`` -> logits ``[B, L, vocab]``.

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
        h = self.tok_emb(input_ids) + self.pos_emb(pos)
        if kv_cache is not None:
            bias = None
        else:
            causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=dev))
            bias = torch.zeros(1, 1, L, L, dtype=h.dtype, device=dev)
            bias.masked_fill_(~causal, -1e9)
        for i, layer in enumerate(self.layers):
            fn = (dense_attention if kv_cache is None
                  else kv_cache.layer_attention(i))
            h = layer(h, bias, fn)
        h = self.ln_final(h)
        return h @ self.tok_emb.weight.T
