"""Attention kernels of the port (CUDA, with plain PyTorch versions), the
per-chunk int8 quantize pair of the gradient transports and the serving
weights, and the chunked LM-head cross entropy."""

from stoke_tpu_torch.ops.chunked_ce import (
    chunked_causal_lm_loss,
    chunked_softmax_cross_entropy,
)
from stoke_tpu_torch.ops.flash_attention import (
    BWD_ROW_RTOL_BF16,
    BWD_RTOL_BF16,
    FWD_ATOL_BF16,
    FWD_ATOL_FP16,
    LAUNCHES,
    NEG_INF,
    bwd_row_err,
    dense_reference,
    ds_bound,
    ds_scale,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
    make_flash_attention,
    paged_decode_attention,
    paged_decode_attention_pallas,
    paged_prefill_chunk_attention,
    paged_verify_attention,
    paged_verify_attention_pallas,
    reset_launches,
)
from stoke_tpu_torch.ops.quant import (
    dequantize_chunks,
    dequantize_chunks_plain,
    quantize_chunks,
    quantize_chunks_plain,
)

__all__ = [
    "BWD_ROW_RTOL_BF16",
    "BWD_RTOL_BF16",
    "FWD_ATOL_BF16",
    "FWD_ATOL_FP16",
    "LAUNCHES",
    "NEG_INF",
    "bwd_row_err",
    "chunked_causal_lm_loss",
    "chunked_softmax_cross_entropy",
    "dense_reference",
    "dequantize_chunks",
    "dequantize_chunks_plain",
    "ds_bound",
    "ds_scale",
    "flash_attention",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_attention_bwd_plain",
    "flash_attention_plain",
    "make_flash_attention",
    "paged_decode_attention",
    "paged_decode_attention_pallas",
    "paged_prefill_chunk_attention",
    "paged_verify_attention",
    "paged_verify_attention_pallas",
    "quantize_chunks",
    "quantize_chunks_plain",
    "reset_launches",
]
