"""Configuration of the port: ``ServeConfig``.

The same field names and defaults as ``stoke_tpu.configs.ServeConfig``, so
one config describes a serve run in either package. The port's
:class:`~stoke_tpu_torch.serving.ServingEngine` serves the greedy path
(paged KV cache, continuous batching, ``attention`` "dense" or "flash",
``decode_kernel`` "reference" or "pallas"); the fields of features that
later slices port (sampling, speculative decoding, chunked prefill,
weight quantization, SLO and cost accounting) are kept so configs carry
over, and the engine refuses them with ``NotImplementedError`` until then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ServeConfig:
    """Serving engine configuration (continuous batching over a paged KV
    cache).

    Attributes:
        max_seqs: decode slot count; every decode step runs this batch.
        kv_block_size: tokens per KV block.
        kv_blocks: blocks in the pool, scratch block 0 included; ``None``
            sizes it to ``max_seqs`` full-length sequences plus scratch.
        max_seq_len: per-request prompt + output cap.
        max_new_tokens: default per-request generation cap.
        prefill_pad_multiple: prompts are zero-padded to a multiple of this
            before prefill.
        attention: prefill attention, "dense" (causal bias, fp32 softmax)
            or "flash" (the flash forward kernel, ``causal=True``).
        decode_kernel: decode attention, "reference" (gather + einsum +
            softmax in PyTorch) or "pallas" (the paged-decode kernel; the
            name is the JAX package's, kept so one config means one path
            in both packages).
        kv_dtype: KV-cache storage dtype, "float32" or "bfloat16".
        eos_id: token id that finishes a request early (None = run to the
            cap).
        log_every_n_steps: engine iterations between gauge refreshes.
        decode_pages_per_block / decode_block_h / verify_pages_per_block /
            verify_block_h: the TPU kernels' block knobs; the CUDA kernels
            choose their own tiles, so the port refuses them.
        prefill_chunk_tokens, sampling, temperature, top_k, top_p,
            sampling_seed, quant, quant_chunk_elems, quant_stochastic,
            quant_min_size, slo_ttft_target_s, slo_tpot_target_s,
            speculative_k, speculative_ngram_max, speculative_ngram_min,
            cost_cards: features of later slices (see the JAX package's
            ``ServeConfig`` for their meaning).
    """

    max_seqs: int = 8
    kv_block_size: int = 16
    kv_blocks: Optional[int] = None
    max_seq_len: int = 512
    max_new_tokens: int = 64
    prefill_pad_multiple: int = 64
    attention: str = "dense"
    decode_kernel: str = "reference"
    decode_pages_per_block: Optional[int] = None
    decode_block_h: Optional[int] = None
    prefill_chunk_tokens: Optional[int] = None
    sampling: bool = False
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    sampling_seed: int = 0
    kv_dtype: str = "float32"
    quant: str = "none"
    quant_chunk_elems: int = 128
    quant_stochastic: bool = False
    quant_min_size: int = 1024
    eos_id: Optional[int] = None
    log_every_n_steps: int = 8
    slo_ttft_target_s: Optional[float] = None
    slo_tpot_target_s: Optional[float] = None
    speculative_k: Optional[int] = None
    speculative_ngram_max: int = 3
    speculative_ngram_min: int = 1
    verify_pages_per_block: Optional[int] = None
    verify_block_h: Optional[int] = None
    cost_cards: bool = False
