"""The serve roofline observatory: per-dispatch cost cards, the decode
roofline and achieved-against-attainable accounting (the port's
counterpart of ``stoke_tpu/serving/roofline.py``).

The engine's dispatches (prefill, chunk, packed chunk, decode, verify)
run under :meth:`ServeCostObservatory.dispatch`: the first run of each
(program, input signature) is counted by the attribution funnel
(:func:`stoke_tpu_torch.telemetry.attribution.counting`: FLOPs by
``FlopCounterMode``, bytes by the dispatched ops, the paged decode and
verify kernels at their formulas, the pool pages they read), and every
dispatch adds its card to the ``serve/cost/*`` counters. From those:

- arithmetic intensity per program (FLOPs / byte);
- the attainable TPOT (``max(bytes / bandwidth, FLOPs / peak)`` of the
  decode-family program) against the achieved decode wall per dispatch;
- the decode program's bound (memory or compute);
- MFU and HBM bandwidth utilization over the dispatch-busy seconds;
- model FLOPs per emitted token, which the SLO tracker turns into its
  TFLOP-goodput column.

A card is the count of its signature's first run: later dispatches of the
same shapes reuse it, whatever their contexts (as the JAX package's card,
a lowered program's, is the same for every dispatch). The JAX package also
lowers, for a speculative engine, the plain-decode program it never
dispatches, as the baseline of the verify program's intensity uplift; an
eager engine has no program to lower, so the port's uplift stays None
there.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

from stoke_tpu_torch.telemetry.attribution import (
    CostCard,
    CostCardCache,
    roofline_time_s,
)

#: the ``serve/cost_*`` JSONL field block
COST_FIELDS = (
    "serve/cost_flops",
    "serve/cost_bytes",
    "serve/cost_flops_per_token",
    "serve/cost_mfu",
    "serve/cost_hbm_bw_util",
    "serve/cost_attainable_tpot_s",
    "serve/cost_achieved_tpot_s",
    "serve/cost_decode_intensity",
    "serve/cost_verify_intensity",
    "serve/cost_decode_bound",
    "serve/cost_cards",
)


def program_bound(card: Optional[CostCard], peak_tflops: float,
                  peak_hbm_gbps: float) -> Optional[str]:
    """One program's roofline bound: ``"memory"`` when its bytes over the
    bandwidth take at least its FLOPs over the peak, else ``"compute"``;
    None without both peaks or counted bytes."""
    if (card is None or not card.bytes_accessed or card.flops <= 0
            or peak_tflops <= 0 or peak_hbm_gbps <= 0):
        return None
    memory_s = card.bytes_accessed / (peak_hbm_gbps * 1e9)
    compute_s = card.flops / (peak_tflops * 1e12)
    return "memory" if memory_s >= compute_s else "compute"


class ServeCostObservatory:
    """Cost accounting over one serving engine's dispatches (built by the
    engine with ``ServeConfig.cost_cards``, with the run's
    ``AttributionConfig`` peaks)."""

    #: the decode-family programs, in the order the TPOT ceiling prefers
    #: them (a speculative engine dispatches verify instead of decode)
    _DECODE_FAMILY = ("serve_verify", "serve_decode")

    def __init__(self, metrics, peak_tflops: float = 0.0,
                 peak_hbm_gbps: float = 0.0):
        self.metrics = metrics
        self.registry = metrics.registry
        self.peak_tflops = float(peak_tflops)
        self.peak_hbm_gbps = float(peak_hbm_gbps)
        # registers the serve/cost/* counters: an engine without cost
        # cards has none
        self.cache = CostCardCache(metrics.registry, peak_tflops,
                                   peak_hbm_gbps, counter_prefix="serve/cost")
        #: dispatches per (program, signature): with the cards they
        #: recombine exactly into the counters' totals
        self.dispatch_counts: Dict[Tuple[str, Any], int] = {}
        #: the most recent card of each program
        self.program_cards: Dict[str, CostCard] = {}

    @contextlib.contextmanager
    def dispatch(self, program: str, sig):
        """One dispatch of ``program`` at ``sig`` inside the block: counted
        on its signature's first run, its card booked every time."""
        key = (program, sig)
        with self.cache.dispatch(key, program):
            yield
        self.dispatch_counts[key] = self.dispatch_counts.get(key, 0) + 1
        card = self.cache.cards.get(key)
        if card is not None and card.flops > 0:
            self.program_cards[program] = card

    # ----------------------------- derived ----------------------------- #

    def _decode_card(self) -> Optional[CostCard]:
        for program in self._DECODE_FAMILY:
            card = self.program_cards.get(program)
            if card is not None:
                return card
        return None

    def flops_total(self) -> float:
        return self.registry.counter("serve/cost/flops_total").value

    def bytes_total(self) -> float:
        return self.registry.counter("serve/cost/bytes_total").value

    def cards_total(self) -> int:
        return int(self.registry.counter("serve/cost/cost_cards_total").value)

    def flops_per_token(self) -> Optional[float]:
        """Counted FLOPs per emitted token (prefill included)."""
        tokens = self.metrics.tokens_out.value
        flops = self.flops_total()
        if tokens <= 0 or flops <= 0:
            return None
        return flops / tokens

    def attainable_tpot_s(self) -> Optional[float]:
        """Roofline-optimal seconds of one decode-family dispatch."""
        card = self._decode_card()
        if card is None:
            return None
        return roofline_time_s(card.flops, card.bytes_accessed,
                               self.peak_tflops, self.peak_hbm_gbps)

    def achieved_tpot_s(self) -> Optional[float]:
        """Measured decode wall per dispatch."""
        steps = self.metrics.decode_steps.value
        if steps <= 0:
            return None
        return self.metrics.decode_s.value / steps

    def decode_intensity(self) -> Optional[float]:
        card = self.program_cards.get("serve_decode")
        return card.intensity if card is not None else None

    def verify_intensity(self) -> Optional[float]:
        card = self.program_cards.get("serve_verify")
        return card.intensity if card is not None else None

    def decode_bound(self) -> Optional[str]:
        return program_bound(self._decode_card(), self.peak_tflops,
                             self.peak_hbm_gbps)

    def _busy_s(self) -> float:
        return self.metrics.prefill_s.value + self.metrics.decode_s.value

    def mfu(self) -> Optional[float]:
        """Counted FLOPs over the dispatch-busy seconds (prefill and
        decode; an idle engine is idle, not slow) against the peak."""
        busy, flops = self._busy_s(), self.flops_total()
        if busy <= 0 or flops <= 0 or self.peak_tflops <= 0:
            return None
        return flops / busy / 1e12 / self.peak_tflops

    def hbm_bw_util(self) -> Optional[float]:
        """Counted bytes over the dispatch-busy seconds against the
        bandwidth."""
        busy, nbytes = self._busy_s(), self.bytes_total()
        if busy <= 0 or nbytes <= 0 or self.peak_hbm_gbps <= 0:
            return None
        return nbytes / busy / (self.peak_hbm_gbps * 1e9)

    # ----------------------------- outputs ----------------------------- #

    def refresh_gauges(self) -> None:
        reg = self.registry
        for name, v in (
            ("serve/cost/mfu", self.mfu()),
            ("serve/cost/hbm_bw_util", self.hbm_bw_util()),
            ("serve/cost/attainable_tpot_s", self.attainable_tpot_s()),
            ("serve/cost/achieved_tpot_s", self.achieved_tpot_s()),
            ("serve/cost/flops_per_token", self.flops_per_token()),
            ("serve/cost/decode_intensity", self.decode_intensity()),
            ("serve/cost/verify_intensity", self.verify_intensity()),
        ):
            if v is not None:
                reg.gauge(name).set(v)

    def event_fields(self) -> Dict[str, Any]:
        """The ``serve/cost_*`` block of one serve record."""
        return {
            "serve/cost_flops": self.flops_total(),
            "serve/cost_bytes": self.bytes_total(),
            "serve/cost_flops_per_token": self.flops_per_token(),
            "serve/cost_mfu": self.mfu(),
            "serve/cost_hbm_bw_util": self.hbm_bw_util(),
            "serve/cost_attainable_tpot_s": self.attainable_tpot_s(),
            "serve/cost_achieved_tpot_s": self.achieved_tpot_s(),
            "serve/cost_decode_intensity": self.decode_intensity(),
            "serve/cost_verify_intensity": self.verify_intensity(),
            "serve/cost_decode_bound": self.decode_bound(),
            "serve/cost_cards": float(self.cards_total()),
        }

    def summary(self) -> Dict[str, Any]:
        """The cost block of ``ServingEngine.summary()``."""
        decode_i = self.decode_intensity()
        verify_i = self.verify_intensity()
        return {
            "active": True,
            "peak_tflops": self.peak_tflops,
            "peak_hbm_gbps": self.peak_hbm_gbps,
            "flops_total": self.flops_total(),
            "bytes_total": self.bytes_total(),
            "flops_per_token": self.flops_per_token(),
            "mfu": self.mfu(),
            "hbm_bw_util": self.hbm_bw_util(),
            "attainable_tpot_s": self.attainable_tpot_s(),
            "achieved_tpot_s": self.achieved_tpot_s(),
            "decode_bound": self.decode_bound(),
            "decode_intensity": decode_i,
            "verify_intensity": verify_i,
            "verify_intensity_uplift": (verify_i / decode_i
                                        if verify_i is not None and decode_i
                                        else None),
            "cards": {program: card.to_dict() for program, card
                      in sorted(self.program_cards.items())},
            # the JAX engine's lowered plain-decode card: no program to
            # lower in an eager engine (see the module docstring)
            "baseline_decode_card": None,
        }
