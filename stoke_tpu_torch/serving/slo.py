"""The serve SLO observatory: per-request deadlines, violation attribution
and goodput under SLO (the port's copy of ``stoke_tpu/serving/slo.py``,
which is host logic and ports whole).

- :class:`RequestSLO`: a request's priority class and TTFT / TPOT targets,
  validated at ``submit()`` like ``SamplingParams``; unset targets come
  from ``ServeConfig.slo_ttft_target_s`` / ``slo_tpot_target_s``.
- :class:`SLOTracker`: per-class TTFT / TPOT attainment, goodput under
  SLO (tokens of requests that met their deadline, per second), the
  deadline headroom of requests still waiting for their first token, a
  queue-ETA forecast from the admission waits, and the **violation
  attribution** (:func:`attribute_request`), which splits a request's
  end-to-end latency into queue-wait, prefill-blocked and
  decode-contention buckets that sum to it, refined by the request's own
  ``serve/prefill`` / ``serve/prefill_chunk`` / ``serve/decode`` spans
  when a trace recorder runs.

All of it is host bookkeeping: no dispatch sees it, and an engine that
never sees an SLO-tagged request registers no ``serve/slo_*`` instrument.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional

from stoke_tpu_torch.serving.telemetry import LATENCY_BUCKETS, _Reservoir

#: span names whose wall belongs to the prefill phase of a request's
#: timeline (the request track)
_PREFILL_SPANS = ("serve/prefill", "serve/prefill_chunk")

#: finished-request attributions kept per tracker (oldest evicted) — the
#: bounded-ring discipline every other host-side store here follows
_MAX_ATTRIBUTIONS = 4096


@dataclass(frozen=True)
class RequestSLO:
    """Per-request service-level objective (validated at ``submit()``).

    Attributes:
        priority: the request's priority class name — the key every
            per-class attainment/goodput/queue-ETA series is bucketed
            under (e.g. ``"interactive"`` vs ``"batch"``).  Classes are a
            small closed set chosen by the caller; the tracker's gauge
            cardinality follows it.
        ttft_target_s: time-to-first-token deadline in seconds (arrival →
            first generated token, queue time included).  ``None`` =
            resolve from ``ServeConfig.slo_ttft_target_s``.
        tpot_target_s: time-per-output-token target in seconds (mean over
            the decode tokens).  ``None`` = resolve from
            ``ServeConfig.slo_tpot_target_s``.
    """

    priority: str = "default"
    ttft_target_s: Optional[float] = None
    tpot_target_s: Optional[float] = None


def validate_request_slo(slo: RequestSLO) -> None:
    """Reject an impossible SLO at submit time, not mid-decode (the
    ``SamplingParams`` contract)."""
    if not isinstance(slo.priority, str) or not slo.priority:
        raise ValueError(
            f"RequestSLO.priority must be a non-empty class name, got "
            f"{slo.priority!r}"
        )
    for field in ("ttft_target_s", "tpot_target_s"):
        v = getattr(slo, field)
        if v is not None and not v > 0.0:
            raise ValueError(
                f"RequestSLO.{field} must be > 0 when set, got {v} "
                f"(None = resolve from the ServeConfig default)"
            )


def resolve_request_slo(
    slo: RequestSLO,
    ttft_default: Optional[float],
    tpot_default: Optional[float],
) -> RequestSLO:
    """Validate ``slo`` and fill its unset targets from the ServeConfig
    defaults; a deadline-free SLO (no target anywhere) is rejected —
    nothing about it could ever be attained or violated."""
    validate_request_slo(slo)
    resolved = replace(
        slo,
        ttft_target_s=(
            slo.ttft_target_s
            if slo.ttft_target_s is not None
            else ttft_default
        ),
        tpot_target_s=(
            slo.tpot_target_s
            if slo.tpot_target_s is not None
            else tpot_default
        ),
    )
    if resolved.ttft_target_s is None and resolved.tpot_target_s is None:
        raise ValueError(
            "RequestSLO carries no deadline: set ttft_target_s/"
            "tpot_target_s on the RequestSLO or configure "
            "ServeConfig.slo_ttft_target_s / slo_tpot_target_s defaults "
            "(an SLO with no target can never be attained or violated)"
        )
    return resolved


def attribute_request(
    req, spans: List[Any], dropped: int
) -> Dict[str, Any]:
    """Re-walk one finished request's span timeline into latency buckets.

    The three buckets — queue-wait (arrival → admission), prefill-blocked
    (admission → first token: the request's own prefill dispatches plus
    the time it sat blocked behind co-batched work), decode-contention
    (first token → finish: the shared batch decode interval) — come from
    the request's lifecycle timestamps, so they sum to the measured
    end-to-end latency by construction.  The request's spans refine them:
    ``prefill_active_s`` / ``decode_active_s`` are the wall the request's
    OWN ``serve/prefill``/``serve/prefill_chunk``/``serve/decode`` spans
    dispatched (the remainder of each bucket is contention), and the
    ``serve/admission`` span cross-checks the queue bucket.

    ``span_coverage`` is honest about the ring: ``"full"`` only when the
    recorder dropped nothing and every expected span of this request is
    present; ``"partial"`` when spans were evicted or missing (a
    truncated ring must not masquerade as a complete attribution);
    ``"none"`` when no recorder was active (the timestamp buckets still
    hold — only the active/contention split is unavailable).
    """
    queue_wait = max(req.admit_ts - req.arrival_ts, 0.0)
    prefill_blocked = max(req.first_token_ts - req.admit_ts, 0.0)
    decode_contention = max(req.finish_ts - req.first_token_ts, 0.0)
    out: Dict[str, Any] = {
        "rid": req.rid,
        "priority": req.slo.priority if req.slo is not None else None,
        "queue_wait_s": queue_wait,
        "prefill_blocked_s": prefill_blocked,
        "decode_contention_s": decode_contention,
        "e2e_s": queue_wait + prefill_blocked + decode_contention,
        "tokens": len(req.tokens),
        "prefill_active_s": None,
        "decode_active_s": None,
    }
    if not spans:
        out["span_coverage"] = "none"
        out["partial"] = True
        return out
    admission = [s for s in spans if s.name == "serve/admission"]
    prefills = [s for s in spans if s.name in _PREFILL_SPANS]
    decodes = [s for s in spans if s.name == "serve/decode"]
    out["prefill_active_s"] = sum(s.dur_s for s in prefills)
    out["decode_active_s"] = sum(s.dur_s for s in decodes)
    # decode slices exist only when the request decoded past its TTFT
    # token; a cap-1/eos-at-prefill request legitimately has none
    expect_decode = len(req.tokens) >= 2
    complete = (
        dropped == 0
        and bool(admission)
        and bool(prefills)
        and (bool(decodes) or not expect_decode)
    )
    out["span_coverage"] = "full" if complete else "partial"
    out["partial"] = not complete
    return out


class _ClassStats:
    """Running per-priority-class accounting (host-side, lock-free: the
    engine loop is single-threaded)."""

    __slots__ = (
        "requests", "finished", "ttft_ok", "tpot_ok", "attained",
        "violated", "goodput_tokens", "tokens", "waits",
    )

    def __init__(self):
        self.requests = 0
        self.finished = 0
        self.ttft_ok = 0
        self.tpot_ok = 0
        self.attained = 0
        self.violated = 0
        self.goodput_tokens = 0
        self.tokens = 0
        self.waits = _Reservoir()

    def queue_eta_s(self) -> Optional[float]:
        """The class's queue-ETA forecast: the median of its running
        admission-wait histogram — the signal a preempt-and-requeue
        admission would consume."""
        return self.waits.percentile(0.50)


class SLOTracker:
    """Per-priority-class SLO accounting over one engine's lifetime.

    Fed by the engine at submit / admit / finish; purely host-side (never
    enters a dispatch), and inert until the first SLO-tagged request
    arrives — an SLO-free engine registers no ``serve/slo_*`` instruments
    and contributes zero JSONL fields (:meth:`event_fields` returns
    ``{}``).
    """

    def __init__(self, registry):
        self.registry = registry
        self.by_class: Dict[str, _ClassStats] = {}
        self.attributions: Dict[int, Dict[str, Any]] = {}
        self.partial_attributions = 0
        self._inflight: Dict[int, Any] = {}
        self._instruments = None
        self._class_gauges: Dict[str, Dict[str, Any]] = {}
        self._t0: Optional[float] = None
        # model-FLOPs-per-token from the cost observatory:
        # None without ServeConfig.cost_cards, so the TFLOP-goodput
        # column stays absent and SLO-only records remain byte-identical
        # to an engine's without cost cards
        self._flops_per_token: Optional[float] = None

    # ----------------------------- state ------------------------------- #

    @property
    def active(self) -> bool:
        """True once any SLO-tagged request has been submitted — the
        gate on every ``serve/slo_*`` surface (default-OFF contract)."""
        return self._t0 is not None

    def _totals(self) -> _ClassStats:
        total = _ClassStats()
        for st in self.by_class.values():
            total.requests += st.requests
            total.finished += st.finished
            total.ttft_ok += st.ttft_ok
            total.tpot_ok += st.tpot_ok
            total.attained += st.attained
            total.violated += st.violated
            total.goodput_tokens += st.goodput_tokens
            total.tokens += st.tokens
        return total

    def goodput_tokens_per_s(self, now: Optional[float] = None):
        """Goodput under SLO: tokens of ATTAINED requests per second of
        SLO-tracked wall clock (first SLO submit → now)."""
        if self._t0 is None:
            return None
        now = time.perf_counter() if now is None else now
        wall = max(now - self._t0, 1e-9)
        return self._totals().goodput_tokens / wall

    def set_flops_per_token(self, v: Optional[float]) -> None:
        """Install the cost observatory's model-FLOPs-per-token (engine
        gauge cadence) — arms the SLO-aware TFLOP-goodput
        column in :meth:`event_fields` / :meth:`summary`."""
        self._flops_per_token = v

    def goodput_tflops_per_s(self, now: Optional[float] = None):
        """SLO-aware TFLOP goodput: model TFLOPs of tokens whose request
        MET its deadline, per second of SLO-tracked wall clock — the
        utilization-denominated goodput the cost observatory arms (None
        without ``ServeConfig.cost_cards`` or before any tokens)."""
        if self._flops_per_token is None:
            return None
        gp = self.goodput_tokens_per_s(now)
        if gp is None:
            return None
        return gp * self._flops_per_token / 1e12

    # ------------------------------ feeds ------------------------------ #

    def _ensure_instruments(self) -> None:
        if self._instruments is not None or self.registry is None:
            return
        reg = self.registry
        self._instruments = {
            "requests": reg.counter(
                "serve/slo_requests_total",
                help="SLO-tagged requests submitted",
            ),
            "attained": reg.counter(
                "serve/slo_attained_total",
                help="finished requests that met every set SLO target",
            ),
            "violated": reg.counter(
                "serve/slo_violated_total",
                help="finished requests that missed a set SLO target",
            ),
            "partial": reg.counter(
                "serve/slo_partial_attributions_total",
                help="violation attributions degraded by a truncated or "
                "inactive span ring (never vacuously attributed)",
            ),
            "wait": reg.histogram(
                "serve/slo_admission_wait_s",
                help="admission wait of SLO-tagged requests (the "
                "queue-ETA forecaster's raw signal)",
                buckets=LATENCY_BUCKETS,
            ),
            "ttft_attainment": reg.gauge(
                "serve/slo_ttft_attainment",
                help="fraction of finished SLO requests meeting their "
                "TTFT target",
            ),
            "tpot_attainment": reg.gauge(
                "serve/slo_tpot_attainment",
                help="fraction of finished SLO requests meeting their "
                "TPOT target",
            ),
            "goodput": reg.gauge(
                "serve/slo_goodput_tokens_per_s",
                help="tokens/s from requests that met their SLO "
                "(goodput under SLO)",
            ),
            "headroom": reg.gauge(
                "serve/slo_headroom_min_s",
                help="min TTFT deadline headroom over in-flight "
                "requests still awaiting their first token (negative = "
                "already busted)",
            ),
            "queue_eta": reg.gauge(
                "serve/slo_queue_eta_s",
                help="median admission wait over all SLO classes (the "
                "queue-ETA forecast)",
            ),
        }

    def _class_gauge(self, cls: str, name: str):
        gauges = self._class_gauges.setdefault(cls, {})
        g = gauges.get(name)
        if g is None and self.registry is not None:
            g = self.registry.gauge(f"serve/slo/{cls}/{name}")
            gauges[name] = g
        return g

    def on_submit(self, req) -> None:
        """Register one SLO-tagged request (its ``slo`` is already
        resolved + validated by the engine)."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        self._ensure_instruments()
        cls = req.slo.priority
        st = self.by_class.setdefault(cls, _ClassStats())
        st.requests += 1
        self._inflight[req.rid] = req
        if self._instruments is not None:
            self._instruments["requests"].inc()

    def on_admit(self, req) -> None:
        """Record the admission wait into the class's running histogram
        (the queue-ETA forecaster's raw signal)."""
        if req.slo is None or req.rid not in self._inflight:
            return
        wait = max(req.admit_ts - req.arrival_ts, 0.0)
        self.by_class[req.slo.priority].waits.add(wait)
        if self._instruments is not None:
            self._instruments["wait"].observe(wait)

    def on_finish(self, req, spans: List[Any], dropped: int) -> Dict[str, Any]:
        """Finalize one SLO-tagged request: attainment vs its resolved
        targets, goodput accounting, and the span-walked violation
        attribution (marked partial when the ring dropped spans)."""
        self._inflight.pop(req.rid, None)
        slo = req.slo
        st = self.by_class.setdefault(slo.priority, _ClassStats())
        st.finished += 1
        st.tokens += len(req.tokens)
        ttft_ok = (
            True
            if slo.ttft_target_s is None
            else (req.ttft_s is not None and req.ttft_s <= slo.ttft_target_s)
        )
        # a single-token request has no decode tokens: nothing to violate
        tpot = req.tpot_s
        tpot_ok = (
            True
            if slo.tpot_target_s is None or tpot is None
            else tpot <= slo.tpot_target_s
        )
        attained = ttft_ok and tpot_ok
        st.ttft_ok += int(ttft_ok)
        st.tpot_ok += int(tpot_ok)
        if attained:
            st.attained += 1
            st.goodput_tokens += len(req.tokens)
        else:
            st.violated += 1
        attribution = attribute_request(req, spans, dropped)
        attribution.update(
            ttft_s=req.ttft_s, tpot_s=tpot, ttft_ok=ttft_ok,
            tpot_ok=tpot_ok, attained=attained,
        )
        if attribution["partial"]:
            self.partial_attributions += 1
        if len(self.attributions) >= _MAX_ATTRIBUTIONS:
            self.attributions.pop(next(iter(self.attributions)))
        self.attributions[req.rid] = attribution
        if self._instruments is not None:
            key = "attained" if attained else "violated"
            self._instruments[key].inc()
            if attribution["partial"]:
                self._instruments["partial"].inc()
        return attribution

    # ----------------------------- gauges ------------------------------ #

    def headroom_min_s(self, now: Optional[float] = None):
        """Min TTFT deadline headroom over in-flight SLO requests still
        awaiting their first token — the preempt-and-requeue admission
        signal.  Negative means a deadline is already busted; ``None``
        when nothing with a TTFT target is awaiting its first token."""
        now = time.perf_counter() if now is None else now
        headrooms = [
            req.slo.ttft_target_s - (now - req.arrival_ts)
            for req in self._inflight.values()
            if req.first_token_ts is None
            and req.slo.ttft_target_s is not None
        ]
        return min(headrooms) if headrooms else None

    def queue_eta_s(self) -> Optional[float]:
        """Median admission wait pooled over every class (per-class
        forecasts live in :meth:`summary` / the per-class gauges)."""
        pooled = _Reservoir()
        for st in self.by_class.values():
            for v in st.waits._sorted:
                pooled.add(v)
        return pooled.percentile(0.50)

    def refresh_gauges(self, now: Optional[float] = None) -> None:
        """Publish the registry gauges (engine gauge-refresh cadence)."""
        if not self.active or self._instruments is None:
            return
        now = time.perf_counter() if now is None else now
        total = self._totals()
        ins = self._instruments
        if total.finished:
            ins["ttft_attainment"].set(total.ttft_ok / total.finished)
            ins["tpot_attainment"].set(total.tpot_ok / total.finished)
        gp = self.goodput_tokens_per_s(now)
        if gp is not None:
            ins["goodput"].set(gp)
        tf = self.goodput_tflops_per_s(now)
        if tf is not None:
            # registered lazily: the series exists only when the cost
            # observatory armed a per-token cost (default off)
            self.registry.gauge(
                "serve/slo_goodput_tflops_per_s",
                help="TFLOPs/s from requests that met their SLO",
            ).set(tf)
        hr = self.headroom_min_s(now)
        if hr is not None:
            ins["headroom"].set(hr)
        eta = self.queue_eta_s()
        if eta is not None:
            ins["queue_eta"].set(eta)
        for cls, st in self.by_class.items():
            if st.finished:
                self._class_gauge(cls, "ttft_attainment").set(
                    st.ttft_ok / st.finished
                )
                self._class_gauge(cls, "tpot_attainment").set(
                    st.tpot_ok / st.finished
                )
                self._class_gauge(cls, "attainment").set(
                    st.attained / st.finished
                )
            eta = st.queue_eta_s()
            if eta is not None:
                self._class_gauge(cls, "queue_eta_s").set(eta)

    # --------------------------- JSONL fields --------------------------- #

    def event_fields(self) -> Dict[str, Any]:
        """The conditional ``serve/slo_*`` block of one JSONL serve
        record — ``{}`` until the first SLO-tagged request, so an
        SLO-free engine's records carry ZERO new fields
        (``build_step_event`` honors the omission)."""
        if not self.active:
            return {}
        now = time.perf_counter()
        total = self._totals()
        out: Dict[str, Any] = {
            "serve/slo_requests": float(total.requests),
            "serve/slo_finished": float(total.finished),
            "serve/slo_violations": float(total.violated),
            "serve/slo_ttft_attainment": (
                total.ttft_ok / total.finished if total.finished else None
            ),
            "serve/slo_tpot_attainment": (
                total.tpot_ok / total.finished if total.finished else None
            ),
            "serve/slo_attainment": (
                total.attained / total.finished if total.finished else None
            ),
            "serve/slo_goodput_tokens_per_s": self.goodput_tokens_per_s(now),
            "serve/slo_queue_eta_s": self.queue_eta_s(),
            "serve/slo_headroom_min_s": self.headroom_min_s(now),
            "serve/slo_partial_attributions": float(
                self.partial_attributions
            ),
        }
        if self._flops_per_token is not None:
            # TFLOP-goodput column: rides only when the cost
            # observatory armed a per-token cost, so an SLO-only engine's
            # records stay byte-identical to an engine's without cost cards
            out["serve/slo_goodput_tflops_per_s"] = (
                self.goodput_tflops_per_s(now)
            )
        return out

    # ----------------------------- summary ----------------------------- #

    def summary(self) -> Dict[str, Any]:
        """The SLO block of ``ServingEngine.summary()`` (and through it
        ``Stoke.serve()`` results): overall + per-class attainment,
        goodput under SLO, queue-ETA forecasts, and attribution
        partiality."""
        if not self.active:
            return {"active": False}
        total = self._totals()
        out: Dict[str, Any] = {
            "active": True,
            "requests": total.requests,
            "finished": total.finished,
            "attained": total.attained,
            "violated": total.violated,
            "ttft_attainment": (
                total.ttft_ok / total.finished if total.finished else None
            ),
            "tpot_attainment": (
                total.tpot_ok / total.finished if total.finished else None
            ),
            "attainment": (
                total.attained / total.finished if total.finished else None
            ),
            "goodput_tokens_per_s": self.goodput_tokens_per_s(),
            "queue_eta_s": self.queue_eta_s(),
            "headroom_min_s": self.headroom_min_s(),
            "partial_attributions": self.partial_attributions,
            "by_class": {
                cls: {
                    "requests": st.requests,
                    "finished": st.finished,
                    "attained": st.attained,
                    "violated": st.violated,
                    "ttft_attainment": (
                        st.ttft_ok / st.finished if st.finished else None
                    ),
                    "tpot_attainment": (
                        st.tpot_ok / st.finished if st.finished else None
                    ),
                    "attainment": (
                        st.attained / st.finished if st.finished else None
                    ),
                    "goodput_tokens": st.goodput_tokens,
                    "queue_eta_s": st.queue_eta_s(),
                }
                for cls, st in sorted(self.by_class.items())
            },
        }
        if self._flops_per_token is not None:
            out["goodput_tflops_per_s"] = self.goodput_tflops_per_s()
        return out
