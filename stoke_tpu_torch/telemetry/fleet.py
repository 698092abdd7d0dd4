"""Fleet observability: cross-host skew aggregation, straggler detection
and barrier-wait attribution (the port's copy of
``stoke_tpu/telemetry/fleet.py``).

- **Packed signal vector.** Each process packs a fixed-layout float32
  vector of window-local signals (:data:`FLEET_SIGNALS`: step wall time,
  dispatches, loader wait, starvation, kernel-build time, barrier wait,
  the goodput buckets, health anomalies, gradient-wire bytes). The layout
  is a wire format, the JAX package's in its order: never reorder, only
  append.
- **The exchange.** Every ``FleetConfig.window_steps`` optimizer steps,
  at the telemetry record, one all-gather of that vector gives every
  process the ``[n_processes, N]`` matrix. It runs over a gloo side group
  of CPU tensors (:func:`fleet_group`), made once when the monitor is
  built: the collective never touches the card, never enters a
  CUDA-graph capture (the record runs on the host after a window's
  replay) and never takes a place in the sequence of the NCCL
  communicator that the captured windows replay. A run of one process
  exchanges nothing.
- **Aggregated views.** min / median / max / p99 and the argmax process
  per signal (``fleet/*`` gauges), step-time skew against the fleet
  median, a loader-versus-compute skew class, and barrier-wait
  attribution (the wait charged to the last arrival), in the step events'
  ``fleet/*`` fields, ``Stoke.fleet_summary`` and the flight recorder's
  ``fleet.json``.
- **Straggler detector.** ``fleet_straggler`` fires when one process lags
  beyond the z-score or relative threshold for K consecutive windows; a
  health-registry detector with a ``HealthConfig``, a warning otherwise.
  A loader-classified streak proposes a bounded share shift to the input
  rebalancer (:class:`stoke_tpu_torch.data.InputRebalancer`) when
  ``FleetConfig.rebalance`` is on.

Without a ``FleetConfig`` nothing here runs but the barrier-wait timing
(:func:`timed_sync`): ``Stoke.barrier`` and the checkpoint syncs time
their waits into ``sync/barrier_wait_s`` / ``sync/barriers_total`` (and
``sync/<tag>_wait_s`` per source) of every live registry.
"""

from __future__ import annotations

import contextlib
import time
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from stoke_tpu_torch.telemetry.events import (
    FLEET_REBALANCE_FIELDS,
    FLEET_STEP_FIELDS,
)
from stoke_tpu_torch.telemetry.health import Detector as _HealthDetector

#: the goodput buckets mirrored into the packed vector (equal to
#: attribution.GOODPUT_BUCKETS, asserted in the tests, not imported)
_GOODPUT_BUCKETS = (
    "productive", "compile", "recompile", "loader", "checkpoint", "halt",
)

#: packed per-host signal vector layout: field name -> index.  This is the
#: WIRE FORMAT of the cross-host exchange; never reorder or remove, only
#: append (hosts on mixed code versions would silently misread each other).
FLEET_SIGNALS = (
    "step",                  # optimizer step the window ends at
    "wall_s",                # window wall seconds on this host
    "dispatches",            # engine compiled-program dispatches this window
    "loader_wait_s",         # host seconds blocked on the data loader
    "starvation_s",          # post-warmup loader wait (device-starving part)
    "compile_s",             # kernel-build and capture seconds this window
    "barrier_wait_s",        # seconds waiting inside cross-process syncs
    "goodput_productive_s",  # goodput ledger buckets (0 without attribution)
    "goodput_compile_s",
    "goodput_recompile_s",
    "goodput_loader_s",
    "goodput_checkpoint_s",
    "goodput_halt_s",
    "health_anomalies",      # health detector firings this window
    "comm_bytes_onwire",     # gradient-transport bytes this window
)
FLEET_INDEX = {name: i for i, name in enumerate(FLEET_SIGNALS)}
N_FLEET_SIGNALS = len(FLEET_SIGNALS)

#: fleet fields of the JSONL step event (the schema in events.py is the
#: one source); :meth:`FleetMonitor.window_stats` returns exactly these
#: keys, less the rebalance subset when ``FleetConfig.rebalance`` is off
FLEET_EVENT_FIELDS = FLEET_STEP_FIELDS

#: the fleet fields every FleetConfig run emits (rebalance keys ride only
#: with the actuator configured)
FLEET_BASE_FIELDS = tuple(
    f for f in FLEET_STEP_FIELDS if f not in FLEET_REBALANCE_FIELDS
)

#: below this fraction of the median window wall, skew is reported as
#: class "none" (measurement noise, not a straggler signal)
_SKEW_NOISE_FRAC = 0.02


# --------------------------------------------------------------------------- #
# packed vector
# --------------------------------------------------------------------------- #


def pack_fleet_vector(signals: Dict[str, float]) -> np.ndarray:
    """``{signal: value}`` → the fixed-layout ``[N_FLEET_SIGNALS]`` f32
    vector (missing signals pack as 0; unknown keys raise — a typo must not
    silently drop a signal on the floor)."""
    unknown = set(signals) - set(FLEET_SIGNALS)
    if unknown:
        raise ValueError(f"unknown fleet signals {sorted(unknown)}")
    vec = np.zeros(N_FLEET_SIGNALS, np.float32)
    for name, value in signals.items():
        vec[FLEET_INDEX[name]] = np.float32(value or 0.0)
    return vec


def unpack_fleet_vector(vec) -> Dict[str, float]:
    """Host-side view of one packed row as ``{signal: float}``."""
    arr = np.asarray(vec, np.float64).reshape(-1)
    if arr.shape[0] != N_FLEET_SIGNALS:
        raise ValueError(
            f"fleet vector has {arr.shape[0]} entries; expected "
            f"{N_FLEET_SIGNALS} (mixed code versions across hosts?)"
        )
    return {name: float(arr[i]) for i, name in enumerate(FLEET_SIGNALS)}


# --------------------------------------------------------------------------- #
# aggregation / skew math (pure functions, the JAX package's: held to it
# on the same matrices in the tests)
# --------------------------------------------------------------------------- #


def fleet_aggregates(matrix: np.ndarray) -> Dict[str, Dict[str, float]]:
    """Per-signal fleet aggregates of a ``[n_hosts, N_FLEET_SIGNALS]``
    matrix: ``{signal: {min, median, max, p99, argmax_host}}``."""
    m = np.asarray(matrix, np.float64)
    if m.ndim != 2 or m.shape[1] != N_FLEET_SIGNALS:
        raise ValueError(
            f"fleet matrix must be [n_hosts, {N_FLEET_SIGNALS}], got "
            f"{m.shape}"
        )
    out: Dict[str, Dict[str, float]] = {}
    for name, i in FLEET_INDEX.items():
        col = m[:, i]
        out[name] = {
            "min": float(col.min()),
            "median": float(np.median(col)),
            "max": float(col.max()),
            "p99": float(np.percentile(col, 99)),
            "argmax_host": int(col.argmax()),
        }
    return out


def straggler_verdict(
    matrix: np.ndarray,
    *,
    rel_threshold: float = 0.2,
    zscore_threshold: float = 3.0,
) -> Dict[str, Any]:
    """Who (if anyone) is dragging this fleet window, and why.

    Per-host **lag** combines the three ways a host can be late:

        lag_h = (wall_h - median(wall))            # step-time skew
              + (loader_h - median(loader))        # input-pipeline skew
              + (max(barrier) - barrier_h)         # barrier lateness

    The barrier term is the attribution flip: the host that waited LEAST
    inside cross-process syncs is the one everyone else was waiting FOR,
    so the fleet's barrier wait is charged to it, not to the waiters.

    A host is flagged as straggler when its lag exceeds
    ``rel_threshold x median(wall)`` (meaningful at any fleet size) or
    when its **leave-one-out** lag z-score — the host against the mean/
    std of the OTHER hosts, with the std floored at 0.1% of the median
    wall so a tight fleet doesn't divide by zero — exceeds
    ``zscore_threshold``.  Leave-one-out matters: an all-host z-score is
    mathematically bounded by sqrt(n_hosts - 1), so on small fleets a
    3-sigma threshold could never fire.  The z path needs >= 3 hosts (a
    1-sample "rest of the fleet" has no spread to speak of) and a lag
    above the noise floor; with 2 hosts the relative threshold is the
    only live signal.

    Returns a dict: flagged, host, lag_s, lag_frac, zscore, step_skew_s,
    loader_skew_s, barrier_wait_s, barrier_charged_host, skew_class
    ("none" | "loader" | "compute"), wall_median_s, wall_max_s, hosts.
    """
    m = np.asarray(matrix, np.float64)
    if m.ndim != 2 or m.shape[1] != N_FLEET_SIGNALS:
        raise ValueError(
            f"fleet matrix must be [n_hosts, {N_FLEET_SIGNALS}], got "
            f"{m.shape}"
        )
    n_hosts = m.shape[0]
    wall = m[:, FLEET_INDEX["wall_s"]]
    loader = m[:, FLEET_INDEX["loader_wait_s"]]
    barrier = m[:, FLEET_INDEX["barrier_wait_s"]]
    wall_median = float(np.median(wall))
    wall_skew = wall - np.median(wall)
    loader_skew = loader - np.median(loader)
    barrier_late = barrier.max() - barrier  # lateness: last arrival waits 0
    lag = wall_skew + loader_skew + barrier_late
    host = int(lag.argmax())
    lag_s = float(lag[host])
    denom = max(wall_median, 1e-9)
    lag_frac = lag_s / denom
    z: Optional[float] = None
    if n_hosts >= 3:
        # leave-one-out needs a "rest of the fleet" with actual spread;
        # below 3 hosts the value would be statistically meaningless and
        # reporting it (JSONL, warnings) would invite misreading — None
        others = np.delete(lag, host)
        std = max(float(others.std()), 1e-3 * denom)
        z = (lag_s - float(others.mean())) / std
    flagged = n_hosts > 1 and (
        lag_frac >= rel_threshold
        or (
            z is not None
            and z >= zscore_threshold
            and lag_frac >= _SKEW_NOISE_FRAC
        )
    )
    # classification: does the straggler's lag come from its input
    # pipeline or from its compute/step time?  Below the noise floor the
    # honest answer is "none".
    loader_part = max(float(loader_skew[host]), 0.0)
    compute_part = max(float(wall_skew[host]), 0.0)
    if lag_s <= _SKEW_NOISE_FRAC * denom or n_hosts <= 1:
        skew_class = "none"
    elif loader_part >= 0.5 * max(loader_part + compute_part, 1e-12):
        skew_class = "loader"
    else:
        skew_class = "compute"
    barrier_max = float(barrier.max())
    # barrier-wait attribution: the cost is what the earliest arrival
    # paid; it is charged to the LAST arrival (min wait), who is the
    # host the fleet was actually waiting for.  Charging needs SPREAD:
    # when every host waited equally (the sync's own coordination
    # round-trip), nobody was late and naming argmin (always host 0 on
    # ties) would send triage after an innocent host.
    barrier_spread = barrier_max - float(barrier.min())
    return {
        "hosts": n_hosts,
        "flagged": bool(flagged),
        "host": host,
        "lag_s": lag_s,
        "lag_frac": lag_frac,
        "zscore": z,
        "step_skew_s": float(wall_skew[host]),
        "loader_skew_s": float(loader_skew[host]),
        "skew_class": skew_class,
        "wall_median_s": wall_median,
        "wall_max_s": float(wall.max()),
        "barrier_wait_s": barrier_max,
        "barrier_charged_host": (
            int(barrier.argmin())
            if barrier_spread > _SKEW_NOISE_FRAC * denom
            else None
        ),
    }


# --------------------------------------------------------------------------- #
# barrier-wait timing (always on: visible without a FleetConfig)
# --------------------------------------------------------------------------- #

#: live telemetry registries receiving cross-process sync timings; a
#: WeakSet so a dropped Telemetry/Stoke never leaks its registry here
_SYNC_REGISTRIES: "weakref.WeakSet" = weakref.WeakSet()


def unregister_sync_registry(registry) -> None:
    """Unsubscribe a registry from sync timings (``Telemetry.close``
    calls this — a closed run's counters must not keep accruing later
    runs' barrier waits into its post-run summary).  Idempotent."""
    _SYNC_REGISTRIES.discard(registry)


def register_sync_registry(registry) -> None:
    """Subscribe a metrics registry to cross-process sync timings (every
    ``Telemetry`` registers its registry at construction).  Idempotent."""
    _SYNC_REGISTRIES.add(registry)
    # pre-register so scrapes/breakdowns carry zeros before the first sync
    registry.counter(
        "sync/barrier_wait_s",
        help="host seconds spent inside cross-process barriers "
        "(Stoke.barrier + checkpoint sync_global_devices)",
    )
    registry.counter(
        "sync/barriers_total", help="cross-process barrier crossings"
    )


def observe_sync_wait(seconds: float, tag: Optional[str] = None) -> None:
    """Record one completed cross-process sync into every live registry:
    the aggregate ``sync/barrier_wait_s`` / ``sync/barriers_total`` pair
    always, plus a per-source ``sync/<tag>_wait_s`` when the caller names
    one. Process-scoped by design: concurrent Stoke instances in one
    process each see the process's total sync time."""
    seconds = max(float(seconds), 0.0)
    for registry in list(_SYNC_REGISTRIES):
        registry.counter("sync/barrier_wait_s").inc(seconds)
        registry.counter("sync/barriers_total").inc()
        if tag:
            registry.counter(f"sync/{tag}_wait_s").inc(seconds)


@contextlib.contextmanager
def timed_sync(tag: Optional[str] = None):
    """Bracket a cross-process sync: the elapsed host wall time — the
    barrier wait, near zero for the last arrival and the full skew for the
    first — lands in ``sync/barrier_wait_s`` (and ``sync/<tag>_wait_s``)
    of every registered registry."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        observe_sync_wait(time.perf_counter() - t0, tag)


# --------------------------------------------------------------------------- #
# the monitor
# --------------------------------------------------------------------------- #

#: registry counters FleetMonitor deltas per window, keyed by signal name
_COUNTER_SOURCES = {
    "loader_wait_s": "data/loader_wait_s",
    "starvation_s": "data/starvation_s",
    "compile_s": "cuda/compile_time_s",
    "barrier_wait_s": "sync/barrier_wait_s",
    "health_anomalies": "health/anomalies_total",
    **{
        f"goodput_{b}_s": f"goodput/{b}_s_total" for b in _GOODPUT_BUCKETS
    },
}

#: warnings emitted by the self-applied (health-less) straggler action
#: before degrading to record-only
_MAX_STRAGGLER_WARNINGS = 5

#: straggler verdict dicts retained for the end-of-run summary / bundles
_RECENT_STRAGGLERS_MAX = 64


def fleet_group():
    """The gloo side group the exchange runs over: every process of the
    default group, CPU tensors only. Collective: every rank calls it, at
    the same point (the facade builds the monitor in its constructor).
    None without a process group or at world 1."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_world_size() <= 1:
        return None
    return dist.new_group(backend="gloo")


class FleetMonitor:
    """Owns the per-window signal accumulator, the exchange, the
    aggregated views, and the straggler streak state.

    The facade builds one per run with a ``FleetConfig`` and attaches it to
    the telemetry pipeline; ``Telemetry.record_step`` calls
    :meth:`window_stats` with the window wall time and the registry deltas
    it collected. The exchange fires only when ``step`` crosses a
    ``window_steps`` boundary: one all-gather of a ``[N]`` float32 vector
    over ``group`` (:func:`fleet_group`) a fleet window, nothing a step.
    """

    def __init__(
        self,
        cfg,
        registry,
        *,
        rank: int = 0,
        n_processes: int = 1,
        dispatch_count_fn: Optional[Callable[[], int]] = None,
        group=None,
    ):
        self.cfg = cfg
        self.registry = registry
        self.rank = int(rank)
        self.n_processes = max(int(n_processes), 1)
        self.group = group
        self._dispatch_count_fn = dispatch_count_fn
        self._acc = np.zeros(N_FLEET_SIGNALS, np.float64)
        self._last_counters: Dict[str, float] = {}
        self._last_dispatches = (
            float(dispatch_count_fn()) if dispatch_count_fn else 0.0
        )
        self._last_bucket: Optional[int] = None
        self.windows = 0
        self.last_matrix: Optional[np.ndarray] = None
        self.last_aggregates: Optional[Dict[str, Dict[str, float]]] = None
        self.last_verdict: Optional[Dict[str, Any]] = None
        # straggler streak state: K consecutive flagged windows on the
        # SAME host before the detector fires (one anomaly per streak)
        self._streak = 0
        self._streak_host: Optional[int] = None
        self._pending_straggler: Optional[Dict[str, Any]] = None
        self._straggler_events: List[Dict[str, Any]] = []
        self._warnings = 0
        # skew-reactive input rebalancing: the actuator is a
        # data.InputRebalancer that Stoke.DataLoader attaches; None
        # (rebalance off, or no loader built) leaves every path below as
        # it is without one
        self.rebalancer = None
        self._rebalance_on = bool(getattr(cfg, "rebalance", False))
        self._event_keys = (
            FLEET_EVENT_FIELDS if self._rebalance_on else FLEET_BASE_FIELDS
        )
        self._last_shift: Optional[Dict[str, int]] = None
        # pre-register so scrapes carry zeros before the first exchange
        registry.counter(
            "fleet/windows_total", help="fleet exchange windows completed"
        )
        registry.counter(
            "fleet/straggler_windows_total",
            help="windows with a flagged straggler host",
        )
        registry.counter(
            "fleet/anomalies_total",
            help="fleet_straggler detector firings (streak >= K windows)",
        )
        if self._rebalance_on:
            registry.counter(
                "fleet/rebalance_shifts_total",
                help="input-rebalance actuations (loader-classified "
                "straggler streaks acted on)",
            )
            registry.counter(
                "fleet/rebalance_rows_moved_total",
                help="per-slice read rows moved off straggler hosts",
            )

    # ------------------------------ window ----------------------------- #

    def _counter_delta(self, name: str) -> float:
        inst = self.registry.get(name)
        now = inst.value if inst is not None else 0.0
        prev = self._last_counters.get(name, 0.0)
        self._last_counters[name] = now
        return max(0.0, now - prev)

    def _accumulate(
        self,
        step: int,
        wall_s: Optional[float],
        loader_wait_s: Optional[float],
        comm_bytes_onwire: Optional[float],
    ) -> None:
        acc = self._acc
        acc[FLEET_INDEX["step"]] = float(step)
        if wall_s:
            acc[FLEET_INDEX["wall_s"]] += float(wall_s)
        # loader wait arrives pre-delta'd from record_step (the telemetry
        # pipeline already consumed the counter delta); the rest are
        # delta'd here against our own snapshots
        if loader_wait_s:
            acc[FLEET_INDEX["loader_wait_s"]] += float(loader_wait_s)
        for signal, counter in _COUNTER_SOURCES.items():
            if signal == "loader_wait_s":
                continue
            acc[FLEET_INDEX[signal]] += self._counter_delta(counter)
        if self._dispatch_count_fn is not None:
            now = float(self._dispatch_count_fn())
            acc[FLEET_INDEX["dispatches"]] += max(
                0.0, now - self._last_dispatches
            )
            self._last_dispatches = now
        if comm_bytes_onwire:
            acc[FLEET_INDEX["comm_bytes_onwire"]] += float(comm_bytes_onwire)

    def _exchange(self, vec: np.ndarray) -> np.ndarray:
        """One all-gather of the packed vector over the gloo side group:
        the full ``[n_processes, N]`` matrix on every process. A run of one
        process skips the collective (a fleet of one)."""
        if self.n_processes <= 1:
            return vec[None, :].astype(np.float32)
        import torch
        import torch.distributed as dist

        mine = torch.from_numpy(np.ascontiguousarray(vec, np.float32))
        rows = [torch.empty_like(mine) for _ in range(self.n_processes)]
        dist.all_gather(rows, mine, group=self.group)
        return torch.stack(rows).numpy()

    def window_stats(
        self,
        *,
        step: int,
        wall_s: Optional[float],
        loader_wait_s: Optional[float] = None,
        comm_bytes_onwire: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Accumulate one telemetry record into the current fleet window
        and — when ``step`` crosses a ``window_steps`` boundary — run the
        exchange and return the populated ``fleet/*`` JSONL fields.
        Between boundaries every field is None (the schema keys stay
        present so consumers see a stable shape)."""
        self._accumulate(step, wall_s, loader_wait_s, comm_bytes_onwire)
        bucket = int(step) // max(int(self.cfg.window_steps), 1)
        if self._last_bucket is None:
            # first record: anchor the cadence AND discard the warm-up
            # accumulation — its wall covers init->first-record time
            # (warm-up compiles), and hosts compile at different speeds
            # (cold caches), so folding it into the first closed window
            # would hand the first cross-host verdict pure compile skew
            # and could seed a spurious straggler streak.  Applies at
            # every window_steps, 1 included: the first verdict is always
            # steady-state.
            self._last_bucket = bucket
            self._acc = np.zeros(N_FLEET_SIGNALS, np.float64)
            return {k: None for k in self._event_keys}
        if bucket <= self._last_bucket:
            return {k: None for k in self._event_keys}
        self._last_bucket = bucket
        return self._close_window()

    def _close_window(self) -> Dict[str, Any]:
        vec = self._acc.astype(np.float32)
        self._acc = np.zeros(N_FLEET_SIGNALS, np.float64)
        matrix = self._exchange(vec)
        self.windows += 1
        self.registry.counter("fleet/windows_total").inc()
        aggregates = fleet_aggregates(matrix)
        verdict = straggler_verdict(
            matrix,
            rel_threshold=self.cfg.straggler_rel_frac,
            zscore_threshold=self.cfg.straggler_zscore,
        )
        self.last_matrix = matrix
        self.last_aggregates = aggregates
        self.last_verdict = verdict
        self._publish_gauges(aggregates)
        self._update_streak(verdict)
        return self._event_fields(verdict)

    def _publish_gauges(
        self, aggregates: Dict[str, Dict[str, float]]
    ) -> None:
        g = self.registry.gauge
        for signal, stats in aggregates.items():
            if signal == "step":
                continue
            for stat in ("min", "median", "max", "p99"):
                g(f"fleet/{signal}_{stat}").set(stats[stat])
            g(f"fleet/{signal}_argmax_host").set(stats["argmax_host"])

    def _update_streak(self, verdict: Dict[str, Any]) -> None:
        if not verdict["flagged"]:
            self._streak = 0
            self._streak_host = None
            return
        self.registry.counter("fleet/straggler_windows_total").inc()
        if verdict["host"] == self._streak_host:
            self._streak += 1
        else:
            self._streak_host = verdict["host"]
            self._streak = 1
        if self._streak < max(int(self.cfg.straggler_windows), 1):
            return
        # fire once per streak, then re-arm (a permanently-slow host must
        # not fire every window for a 3-day run)
        self._streak = 0
        self._streak_host = None
        event = {
            **verdict,
            "window": self.windows,
            "step": int(self.last_matrix[verdict["host"],
                                         FLEET_INDEX["step"]]),
            "windows_in_streak": int(self.cfg.straggler_windows),
        }
        self._straggler_events.append(event)
        del self._straggler_events[:-_RECENT_STRAGGLERS_MAX]
        self.registry.counter("fleet/anomalies_total").inc()
        self._pending_straggler = event
        self._maybe_rebalance(event)
        self._self_apply(event)

    def attach_rebalancer(self, rebalancer) -> None:
        """Attach the run's input-rebalance actuator (called by
        ``Stoke.DataLoader`` when ``FleetConfig.rebalance`` is on).  The
        monitor only PROPOSES share shifts — the rebalancer owns the
        bounded shares and the agreement protocol that makes every host
        apply them at the same fetch index."""
        self.rebalancer = rebalancer

    def _maybe_rebalance(self, event: Dict[str, Any]) -> None:
        """Act on a completed loader-classified straggler streak (the
        K-window hysteresis IS the actuation gate): shift
        ``rebalance_rows`` of per-slice read work from the flagged host to
        the host with the least loader wait this window.  Every host runs
        this on the IDENTICAL exchanged matrix, so the decision — and the
        share state it evolves — is deterministic fleet-wide without any
        extra collective."""
        rb = self.rebalancer
        if (
            rb is None
            or not self._rebalance_on
            or self.n_processes <= 1
            or event.get("skew_class") != "loader"
            or self.last_matrix is None
        ):
            return
        slow = int(event["host"])
        loader_col = self.last_matrix[:, FLEET_INDEX["loader_wait_s"]]
        fast = int(loader_col.argmin())
        if fast == slow:
            return
        moved = rb.propose_shift(
            slow, fast, int(getattr(self.cfg, "rebalance_rows", 1))
        )
        if not moved:
            return  # bound reached: the share floor/ceiling holds
        self._last_shift = {"rows": moved, "from": slow, "to": fast}
        self.registry.counter("fleet/rebalance_shifts_total").inc()
        self.registry.counter("fleet/rebalance_rows_moved_total").inc(moved)
        self.registry.gauge(
            "fleet/rebalance_share_self",
            help="this host's per-slice read share (rows)",
        ).set(float(rb.share_of(self.rank)))

    def _self_apply(self, event: Dict[str, Any]) -> None:
        """Warn-path fallback when no health registry will consume the
        pending event (the facade clears ``_pending_straggler`` through
        :class:`FleetStragglerDetector` when a ``HealthConfig`` is
        present; this warning is the only surfacing otherwise)."""
        if self.cfg.straggler_action == "record":
            return
        if self._warnings >= _MAX_STRAGGLER_WARNINGS:
            return
        self._warnings += 1
        warnings.warn(
            f"Stoke -- fleet: {self._describe(event)} "
            f"(see docs/observability.md 'Fleet view & stragglers')"
        )

    @staticmethod
    def _describe(event: Dict[str, Any]) -> str:
        z = event.get("zscore")
        return (
            f"host {event['host']} straggled "
            f"{event['windows_in_streak']} consecutive windows "
            f"(lag {event['lag_s']:.3f}s = {event['lag_frac']:.0%} of the "
            f"median window{f', z={z:.1f}' if z is not None else ''}; "
            f"skew class: {event['skew_class']})"
        )

    def consume_straggler(self) -> Optional[Dict[str, Any]]:
        """Pop the pending straggler event (the
        :class:`FleetStragglerDetector` adapter drains this into the
        health anomaly pipeline)."""
        event, self._pending_straggler = self._pending_straggler, None
        return event

    def _event_fields(self, verdict: Dict[str, Any]) -> Dict[str, Any]:
        flagged = verdict["flagged"]
        out = self._base_event_fields(verdict, flagged)
        if self._rebalance_on:
            rb = self.rebalancer
            shift = self._last_shift
            self._last_shift = None  # report each actuation exactly once
            out.update({
                "fleet/rebalance_share_self": (
                    None if rb is None else float(rb.share_of(self.rank))
                ),
                "fleet/rebalance_shift_rows": (
                    None if shift is None else shift["rows"]
                ),
                "fleet/rebalance_from_host": (
                    None if shift is None else shift["from"]
                ),
                "fleet/rebalance_to_host": (
                    None if shift is None else shift["to"]
                ),
                "fleet/rebalance_shifts": (
                    None if rb is None else float(rb.shifts)
                ),
            })
        return out

    def _base_event_fields(
        self, verdict: Dict[str, Any], flagged: bool
    ) -> Dict[str, Any]:
        return {
            "fleet/hosts": verdict["hosts"],
            "fleet/window": self.windows,
            "fleet/wall_median_s": verdict["wall_median_s"],
            "fleet/wall_max_s": verdict["wall_max_s"],
            "fleet/step_skew_s": verdict["step_skew_s"],
            "fleet/loader_skew_s": verdict["loader_skew_s"],
            "fleet/lag_s": verdict["lag_s"],
            "fleet/lag_frac": verdict["lag_frac"],
            "fleet/straggler_host": verdict["host"] if flagged else None,
            "fleet/straggler_zscore": verdict["zscore"],
            "fleet/skew_class": verdict["skew_class"],
            "fleet/barrier_wait_s": verdict["barrier_wait_s"],
            "fleet/barrier_charged_host": verdict["barrier_charged_host"],
        }

    # ----------------------------- summary ----------------------------- #

    def snapshot(self) -> Dict[str, Any]:
        """Bundle/summary payload: the latest per-host matrix (as
        ``{host: {signal: value}}`` rows), its aggregates, the latest
        straggler verdict, and the recent straggler events — "which host
        was slow at time of death"."""
        rows = None
        if self.last_matrix is not None:
            rows = {
                str(h): unpack_fleet_vector(self.last_matrix[h])
                for h in range(self.last_matrix.shape[0])
            }
        return {
            "rank": self.rank,
            "n_processes": self.n_processes,
            "windows": self.windows,
            "window_steps": int(self.cfg.window_steps),
            "last_matrix": rows,
            "last_aggregates": self.last_aggregates,
            "last_verdict": self.last_verdict,
            "straggler_events": list(self._straggler_events),
        }

    def summary(self) -> Dict[str, Any]:
        """End-of-run fleet accounting (the ``Stoke.fleet_summary``
        surface)."""
        out = self.snapshot()
        out["straggler_windows"] = int(
            self.registry.counter("fleet/straggler_windows_total").value
        )
        out["straggler_anomalies"] = int(
            self.registry.counter("fleet/anomalies_total").value
        )
        if self._rebalance_on:
            rb = self.rebalancer
            out["rebalance"] = {
                "shifts": int(
                    self.registry.counter(
                        "fleet/rebalance_shifts_total"
                    ).value
                ),
                "rows_moved": int(
                    self.registry.counter(
                        "fleet/rebalance_rows_moved_total"
                    ).value
                ),
                "shares": None if rb is None else list(rb.shares),
            }
        return out


class FleetStragglerDetector(_HealthDetector):
    """Health-registry adapter (the detector contract): when the fleet
    monitor completed a flagged straggler streak since the last health
    observation, surface it as a ``fleet_straggler`` anomaly (action from
    ``FleetConfig.straggler_action``) so it lands in the anomaly counters,
    the flight-recorder ring, and post-mortem bundles."""

    name = "fleet_straggler"

    def __init__(self, monitor: FleetMonitor, action: str = "warn"):
        super().__init__(action)
        self.monitor = monitor
        # the monitor's own warn fallback would double-report next to the
        # health pipeline's warning
        monitor._warnings = _MAX_STRAGGLER_WARNINGS

    def check(self, step, sentinels, ctx):
        event = self.monitor.consume_straggler()
        if event is None:
            return None
        return self._fire(
            step,
            f"fleet straggler: {FleetMonitor._describe(event)}",
            value=float(event["lag_s"]),
        )
