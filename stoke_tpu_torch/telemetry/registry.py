"""Metrics registry: counters, gauges, histograms (stdlib only).

The port's own copy of ``stoke_tpu/telemetry/registry.py`` (the port
imports nothing of the JAX package). Every metric lives under a
``/``-separated name (``serve/ttft_s``); instrument creation is cached by
name and recording is one lock-guarded float op; all state reads back
through ``value`` / ``snapshot()``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple


class Counter:
    """Monotonically increasing value (``_total`` convention in sinks)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                f"Counter {self.name!r} cannot decrease (inc({amount}))"
            )
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value, settable up or down."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._set = False
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._set = True

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount
            self._set = True

    @property
    def value(self) -> float:
        return self._value

    @property
    def has_value(self) -> bool:
        """False until the first ``set``/``inc`` — sinks skip unset gauges
        (a 0.0 HBM gauge on a backend without memory_stats would be a lie)."""
        return self._set


#: default histogram buckets: exponential seconds ladder covering sub-ms
#: dispatch times up to minute-scale compiles
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Cumulative-bucket histogram plus an EMA of observations.

    The buckets serve Prometheus exposition; the EMA serves the step-event
    JSONL (a smoothed "current" step time without retaining samples).
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
        ema_weight: float = 0.1,
    ):
        self.name = name
        self.help = help
        bs = tuple(sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        # finite positive bounds only: +Inf is implicit (the overflow
        # bucket), and a non-positive or -Inf bound can never be a
        # meaningful "le" for the durations/sizes recorded here
        if not bs or any(b <= 0 or math.isinf(b) for b in bs):
            raise ValueError(
                f"Histogram {name!r}: buckets must be finite and positive"
            )
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._ema = 0.0
        self._ema_init = False
        self._ema_weight = float(ema_weight)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            self._min = min(self._min, value)
            self._max = max(self._max, value)
            if self._ema_init:
                w = self._ema_weight
                self._ema = (1.0 - w) * self._ema + w * value
            else:
                self._ema = value
                self._ema_init = True
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def min(self) -> Optional[float]:
        return self._min if self._count else None

    @property
    def max(self) -> Optional[float]:
        return self._max if self._count else None

    @property
    def ema(self) -> Optional[float]:
        return self._ema if self._ema_init else None

    @property
    def mean(self) -> Optional[float]:
        return self._sum / self._count if self._count else None

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """``[(le, cumulative_count), ...]`` ending with ``(inf, count)`` —
        the Prometheus ``_bucket`` series."""
        out = []
        cum = 0
        for b, c in zip(self.buckets, self._counts):
            cum += c
            out.append((b, cum))
        out.append((math.inf, self._count))
        return out


class _Timer:
    """Context manager accumulating elapsed seconds into a Counter and
    (optionally) observing into a Histogram."""

    __slots__ = ("_counter", "_hist", "_t0")

    def __init__(self, counter: Counter, hist: Optional[Histogram] = None):
        self._counter = counter
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._counter.inc(dt)
        if self._hist is not None:
            self._hist.observe(dt)
        return False


class MetricsRegistry:
    """Named instrument factory + snapshot source for sinks.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent by
    name); asking for an existing name with a different kind raises — two
    subsystems silently sharing a name under different semantics is the
    classic metrics bug.
    """

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}"
                )
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help=help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Optional[Sequence[float]] = None,
    ) -> Histogram:
        return self._get_or_create(name, Histogram, help=help, buckets=buckets)

    def timer(self, name: str, histogram: Optional[str] = None) -> _Timer:
        """Accumulating wall-clock timer: seconds land in counter ``name``;
        with ``histogram=<name>`` each timing is also observed there."""
        hist = self.histogram(histogram) if histogram else None
        return _Timer(self.counter(name), hist)

    def get(self, name: str):
        return self._instruments.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> Dict[str, dict]:
        """Point-in-time dump every sink renders from:
        ``{name: {kind, value|count/sum/ema/min/max/buckets, help}}``.

        The lock acquire is bounded: the flight recorder calls this from a
        signal handler running ON the main thread, which may have been
        interrupted while holding the lock — blocking would deadlock the
        crash dump.  On timeout, fall back to a lockless list() of the
        instrument dict (atomic enough under the GIL; instruments are
        never removed)."""
        if self._lock.acquire(timeout=1.0):
            try:
                instruments = list(self._instruments.values())
            finally:
                self._lock.release()
        else:  # pragma: no cover - signal-context fallback
            instruments = list(self._instruments.values())
        out: Dict[str, dict] = {}
        for inst in instruments:
            if isinstance(inst, Counter):
                out[inst.name] = {
                    "kind": "counter", "value": inst.value, "help": inst.help,
                }
            elif isinstance(inst, Gauge):
                if not inst.has_value:
                    continue
                out[inst.name] = {
                    "kind": "gauge", "value": inst.value, "help": inst.help,
                }
            elif isinstance(inst, Histogram):
                out[inst.name] = {
                    "kind": "histogram",
                    "count": inst.count,
                    "sum": inst.sum,
                    "ema": inst.ema,
                    "mean": inst.mean,
                    "buckets": inst.cumulative_buckets(),
                    "help": inst.help,
                }
        return out
