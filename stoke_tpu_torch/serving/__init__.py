"""Serving stack of the port: paged KV cache, continuous batching, sampling,
speculative decoding, int8 and bf16 weights, engine."""

from stoke_tpu_torch.serving.engine import ServingEngine
from stoke_tpu_torch.serving.kv_cache import (
    SCRATCH_BLOCK,
    BlockAllocator,
    PagedAttentionHook,
    PagedKVCache,
    resolve_device,
)
from stoke_tpu_torch.serving.quant import (
    QuantizedTensor,
    compression_stats,
    dequantize_params,
    param_bytes,
    quantize_params,
)
from stoke_tpu_torch.serving.sampling import SamplingParams
from stoke_tpu_torch.serving.scheduler import Request, Scheduler
from stoke_tpu_torch.serving.speculative import propose_draft
from stoke_tpu_torch.serving.telemetry import ServeMetrics

__all__ = [
    "SCRATCH_BLOCK",
    "BlockAllocator",
    "PagedAttentionHook",
    "PagedKVCache",
    "QuantizedTensor",
    "Request",
    "SamplingParams",
    "Scheduler",
    "ServeMetrics",
    "ServingEngine",
    "compression_stats",
    "dequantize_params",
    "param_bytes",
    "propose_draft",
    "quantize_params",
    "resolve_device",
]
