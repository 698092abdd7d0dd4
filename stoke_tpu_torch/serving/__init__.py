"""Serving stack of the port: paged KV cache, continuous batching, engine."""

from stoke_tpu_torch.serving.engine import ServingEngine, resolve_device
from stoke_tpu_torch.serving.kv_cache import (
    SCRATCH_BLOCK,
    BlockAllocator,
    PagedAttentionHook,
    PagedKVCache,
)
from stoke_tpu_torch.serving.scheduler import Request, SamplingParams, Scheduler
from stoke_tpu_torch.serving.telemetry import ServeMetrics

__all__ = [
    "SCRATCH_BLOCK",
    "BlockAllocator",
    "PagedAttentionHook",
    "PagedKVCache",
    "Request",
    "SamplingParams",
    "Scheduler",
    "ServeMetrics",
    "ServingEngine",
    "resolve_device",
]
