"""Metrics registry of the port (a stdlib copy of stoke_tpu's)."""

from stoke_tpu_torch.telemetry.registry import MetricsRegistry

__all__ = ["MetricsRegistry"]
