"""Attention kernels of the port (CUDA, with plain PyTorch versions)."""

from stoke_tpu_torch.ops.flash_attention import (
    FWD_ATOL_BF16,
    LAUNCHES,
    NEG_INF,
    dense_reference,
    flash_attention,
    flash_attention_plain,
    paged_decode_attention,
    paged_decode_attention_pallas,
    reset_launches,
)

__all__ = [
    "FWD_ATOL_BF16",
    "LAUNCHES",
    "NEG_INF",
    "dense_reference",
    "flash_attention",
    "flash_attention_plain",
    "paged_decode_attention",
    "paged_decode_attention_pallas",
    "reset_launches",
]
