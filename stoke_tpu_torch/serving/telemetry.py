"""Per-request serving telemetry over the port's metrics registry.

Counterpart of ``stoke_tpu/serving/telemetry.py``: TTFT (arrival -> first
generated token, queue time included) and TPOT (mean time per output token
over the decode tokens) as registry histograms plus exact p50/p99 from
trailing reservoirs, the capacity gauges (queue depth, KV-block occupancy,
batch fill), and the goodput split of serve wall time into queue/idle,
prefill and decode, the chunked-prefill and sampled-token counters, and
the speculative-decoding counters (created only for a speculative engine).
Instrument names and ``event_fields`` keys are the JAX package's, so
records from either package read the same.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from stoke_tpu_torch.telemetry.registry import MetricsRegistry

#: sample cap of the exact-percentile reservoirs (beyond it the oldest
#: samples age out; p50/p99 then describe the trailing window)
_MAX_SAMPLES = 8192

#: latency buckets of the TTFT/TPOT histograms (finer below 100 ms than
#: the registry's default ladder)
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class _Reservoir:
    """Sorted trailing-window sample store for exact percentiles."""

    def __init__(self, cap: int = _MAX_SAMPLES):
        self._sorted: List[float] = []
        self._fifo: List[float] = []
        self._cap = cap

    def add(self, v: float) -> None:
        v = float(v)
        if len(self._fifo) >= self._cap:
            old = self._fifo.pop(0)
            self._sorted.pop(bisect.bisect_left(self._sorted, old))
        self._fifo.append(v)
        bisect.insort(self._sorted, v)

    def percentile(self, p: float) -> Optional[float]:
        if not self._sorted:
            return None
        idx = min(
            len(self._sorted) - 1, int(round(p * (len(self._sorted) - 1)))
        )
        return self._sorted[idx]


class ServeMetrics:
    """Serving-side instrument bundle over one registry."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.ttft = registry.histogram(
            "serve/ttft_s",
            help="time to first token (arrival -> prefill token)",
            buckets=LATENCY_BUCKETS,
        )
        self.tpot = registry.histogram(
            "serve/tpot_s",
            help="time per output token (decode tokens)",
            buckets=LATENCY_BUCKETS,
        )
        self._ttft_samples = _Reservoir()
        self._tpot_samples = _Reservoir()
        self.requests = registry.counter(
            "serve/requests_total", help="requests submitted"
        )
        self.completed = registry.counter(
            "serve/completed_total", help="requests completed"
        )
        self.tokens_out = registry.counter(
            "serve/tokens_out_total", help="generated tokens"
        )
        self.prefills = registry.counter(
            "serve/prefills_total", help="prefill dispatches"
        )
        self.prefill_chunks = registry.counter(
            "serve/prefill_chunks_total",
            help="chunked-prefill dispatches",
        )
        self.decode_steps = registry.counter(
            "serve/decode_steps_total", help="decode dispatches"
        )
        self.sampled_tokens = registry.counter(
            "serve/sampled_tokens_total",
            help="tokens drawn through the sampling path "
            "(temperature > 0; greedy tokens excluded)",
        )
        self.prefill_s = registry.counter(
            "serve/goodput_prefill_s_total",
            help="serve wall seconds spent in prefill dispatch",
        )
        self.decode_s = registry.counter(
            "serve/goodput_decode_s_total",
            help="serve wall seconds spent in decode dispatch",
        )
        self.queue_s = registry.counter(
            "serve/goodput_queue_s_total",
            help="serve wall seconds spent queued/idle (wall - prefill - decode)",
        )
        self.queue_depth = registry.gauge(
            "serve/queue_depth", help="requests waiting for a slot"
        )
        self.active_seqs = registry.gauge(
            "serve/active_seqs", help="occupied decode slots"
        )
        self.batch_fill = registry.gauge(
            "serve/batch_fill", help="active_seqs / max_seqs"
        )
        self.kv_blocks_used = registry.gauge(
            "serve/kv_blocks_used", help="KV blocks owned by live requests"
        )
        self.kv_occupancy = registry.gauge(
            "serve/kv_block_occupancy",
            help="owned / allocatable KV blocks",
        )
        self.quant_compression = registry.gauge(
            "serve/quant_compression",
            help="param bytes fp / param bytes as-served",
        )
        self._p = {
            "ttft_p50": registry.gauge("serve/ttft_p50_s"),
            "ttft_p99": registry.gauge("serve/ttft_p99_s"),
            "tpot_p50": registry.gauge("serve/tpot_p50_s"),
            "tpot_p99": registry.gauge("serve/tpot_p99_s"),
        }
        # speculative counters: created by enable_speculative(), so a
        # non-speculative engine's registry carries no speculative series
        self.spec_active = False
        self.spec_draft_tokens = None
        self.spec_accepted_tokens = None

    def enable_speculative(self) -> None:
        """Arm the speculative-decoding counters (a speculative engine
        calls it at construction). ``accepted / drafted`` is the acceptance
        rate; ``tokens_out / decode_steps`` the tokens per dispatch."""
        if self.spec_active:
            return
        self.spec_active = True
        self.spec_draft_tokens = self.registry.counter(
            "serve/spec_draft_tokens_total",
            help="draft tokens scored by verify dispatches",
        )
        self.spec_accepted_tokens = self.registry.counter(
            "serve/spec_accepted_tokens_total",
            help="draft tokens accepted into the output stream",
        )

    def observe_ttft(self, seconds: float) -> None:
        self.ttft.observe(seconds)
        self._ttft_samples.add(seconds)

    def observe_tpot(self, seconds: float) -> None:
        self.tpot.observe(seconds)
        self._tpot_samples.add(seconds)

    def latency_percentiles(self) -> Dict[str, Optional[float]]:
        """Exact order statistics of the trailing reservoirs."""
        return {
            "ttft_p50_s": self._ttft_samples.percentile(0.50),
            "ttft_p99_s": self._ttft_samples.percentile(0.99),
            "tpot_p50_s": self._tpot_samples.percentile(0.50),
            "tpot_p99_s": self._tpot_samples.percentile(0.99),
        }

    def refresh_percentiles(self) -> None:
        for name, v in self.latency_percentiles().items():
            if v is not None:
                self._p[name[: -len("_s")]].set(v)

    def event_fields(self) -> Dict[str, object]:
        """The ``serve/*`` block of one JSONL step event (the keys the JAX
        package emits for the features this slice serves)."""
        self.refresh_percentiles()
        pct = self.latency_percentiles()
        out = {
            "serve/requests": self.requests.value,
            "serve/completed": self.completed.value,
            "serve/tokens_out": self.tokens_out.value,
            "serve/queue_depth": self.queue_depth.value,
            "serve/active_seqs": self.active_seqs.value,
            "serve/batch_fill": self.batch_fill.value,
            "serve/kv_blocks_used": self.kv_blocks_used.value,
            "serve/kv_block_occupancy": self.kv_occupancy.value,
            "serve/ttft_p50_s": pct["ttft_p50_s"],
            "serve/ttft_p99_s": pct["ttft_p99_s"],
            "serve/tpot_p50_s": pct["tpot_p50_s"],
            "serve/tpot_p99_s": pct["tpot_p99_s"],
            "serve/goodput_queue_s": self.queue_s.value,
            "serve/goodput_prefill_s": self.prefill_s.value,
            "serve/goodput_decode_s": self.decode_s.value,
            "serve/prefill_chunks": self.prefill_chunks.value,
            "serve/sampled_tokens": self.sampled_tokens.value,
            "serve/quant_compression": (
                self.quant_compression.value
                if self.quant_compression.has_value else None),
        }
        if self.spec_active:
            # absent, not null, without a speculative config
            out["serve/spec_draft_tokens"] = self.spec_draft_tokens.value
            out["serve/spec_accepted_tokens"] = (
                self.spec_accepted_tokens.value
            )
        return out
