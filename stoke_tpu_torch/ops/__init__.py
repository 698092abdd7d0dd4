"""Attention kernels of the port (CUDA, with plain PyTorch versions)."""

from stoke_tpu_torch.ops.flash_attention import (
    BWD_RTOL_BF16,
    FWD_ATOL_BF16,
    LAUNCHES,
    NEG_INF,
    dense_reference,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
    make_flash_attention,
    paged_decode_attention,
    paged_decode_attention_pallas,
    reset_launches,
)

__all__ = [
    "BWD_RTOL_BF16",
    "FWD_ATOL_BF16",
    "LAUNCHES",
    "NEG_INF",
    "dense_reference",
    "flash_attention",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "flash_attention_bwd_plain",
    "flash_attention_plain",
    "make_flash_attention",
    "paged_decode_attention",
    "paged_decode_attention_pallas",
    "reset_launches",
]
