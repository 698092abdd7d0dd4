"""The port's telemetry: one pipeline from the facade, engine, data and
serving layers to files (the counterpart of ``stoke_tpu/telemetry``).

    registry (counters/gauges/histograms)
        <- facade phase timers, data-loader wait/starvation, compile
           tracking (kernel builds, CUDA-graph captures), device-memory
           watermarks, user scalars
    -> sinks at the logging cadence:
         JSONL structured step events (events.py schema, one line/window)
         Prometheus text exposition (atomic scrape file)
         TensorBoard (utils/tb_writer.py format)

Beside it: host span tracing (:mod:`~stoke_tpu_torch.telemetry.tracing`),
the health monitor (:mod:`~stoke_tpu_torch.telemetry.health`) and its
flight recorder (:mod:`~stoke_tpu_torch.telemetry.recorder`), and the
observatories whose fields ride each step event: step-time attribution
(:mod:`~stoke_tpu_torch.telemetry.attribution`), per-layer numerics
(:mod:`~stoke_tpu_torch.telemetry.numerics`) and device memory
(:mod:`~stoke_tpu_torch.telemetry.memory`).

Enable by passing ``TelemetryConfig`` to ``Stoke(configs=[...])``; the
:class:`Telemetry` object is also usable standalone (scripts, tests):

    from stoke_tpu_torch.telemetry import Telemetry
    from stoke_tpu_torch import TelemetryConfig

    t = Telemetry(TelemetryConfig(output_dir="/tmp/run1"), rank=0)
    with t.phase("step"):
        ...
    t.record_step(step=1, window_steps=1, ema_loss=2.3)
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from stoke_tpu_torch.telemetry.collectors import (
    CompileTracker,
    hbm_stats,
    set_xprof_enabled,
    update_hbm_gauges,
    xprof_span,
)
from stoke_tpu_torch.telemetry.events import (
    STEP_EVENT_SCHEMA,
    build_step_event,
    read_step_events,
    validate_step_event,
)
from stoke_tpu_torch.telemetry.fleet import (
    FLEET_EVENT_FIELDS,
    FLEET_INDEX,
    FLEET_SIGNALS,
    FleetMonitor,
    FleetStragglerDetector,
    fleet_aggregates,
    pack_fleet_vector,
    register_sync_registry,
    straggler_verdict,
    timed_sync,
    unpack_fleet_vector,
    unregister_sync_registry,
)
from stoke_tpu_torch.telemetry.health import (
    SENTINEL_FIELDS,
    WATCHDOG_EXIT_CODE,
    Anomaly,
    HangWatchdog,
    HealthHaltError,
    HealthMonitor,
    leaf_path_names,
    unpack_sentinels,
)
from stoke_tpu_torch.telemetry.recorder import FlightRecorder
from stoke_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from stoke_tpu_torch.telemetry.sinks import (
    JsonlSink,
    PrometheusSink,
    Sink,
    TensorBoardSink,
    host_labels,
    render_prometheus,
)
from stoke_tpu_torch.telemetry.tracing import (
    TRACE_EVENT_KEYS,
    Span,
    TraceRecorder,
    register_recorder,
    trace_add,
    trace_point,
    trace_span,
    tracing_active,
    unregister_recorder,
)

__all__ = [
    "Telemetry",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "Sink",
    "JsonlSink",
    "PrometheusSink",
    "TensorBoardSink",
    "render_prometheus",
    "CompileTracker",
    "hbm_stats",
    "update_hbm_gauges",
    "xprof_span",
    "set_xprof_enabled",
    "STEP_EVENT_SCHEMA",
    "build_step_event",
    "validate_step_event",
    "read_step_events",
    "register_sync_registry",
    "unregister_sync_registry",
    "timed_sync",
    "FLEET_EVENT_FIELDS",
    "FLEET_INDEX",
    "FLEET_SIGNALS",
    "FleetMonitor",
    "FleetStragglerDetector",
    "fleet_aggregates",
    "pack_fleet_vector",
    "straggler_verdict",
    "unpack_fleet_vector",
    "SENTINEL_FIELDS",
    "WATCHDOG_EXIT_CODE",
    "Anomaly",
    "HangWatchdog",
    "HealthHaltError",
    "HealthMonitor",
    "FlightRecorder",
    "leaf_path_names",
    "unpack_sentinels",
    "TRACE_EVENT_KEYS",
    "Span",
    "TraceRecorder",
    "register_recorder",
    "unregister_recorder",
    "trace_span",
    "trace_point",
    "trace_add",
    "tracing_active",
]


class Telemetry:
    """Orchestrator: owns the registry, collectors, and sinks (the JAX
    package's ``Telemetry``).

    Constructed with ``config=None`` it is a *disabled* pipeline: the
    registry still works (the facade's wall-clock breakdown rides on it)
    but no collectors attach and ``record_step`` is a no-op — zero IO,
    zero listeners, zero device touches.

    Across processes: sinks default to rank 0 only; ``jsonl_all_ranks``
    adds a per-rank JSONL stream (``steps.rank<N>.jsonl``) and
    ``prometheus_all_ranks`` a per-rank scrape file.

    ``attribution``, ``fleet``, ``resilience``, ``numerics`` and
    ``memory`` are the monitors the facade assigns with their configs;
    without one its step-event fields ride as ``null`` or stay absent, as
    the JAX hub writes them.
    """

    def __init__(
        self,
        config=None,
        rank: int = 0,
        extra_sinks: Optional[List[Sink]] = None,
    ):
        self.config = config
        self.rank = int(rank)
        self.registry = MetricsRegistry()
        self.sinks: List[Sink] = list(extra_sinks or [])
        self.compile_tracker: Optional[CompileTracker] = None
        self.attribution = None
        self.fleet = None
        self.resilience = None
        self.numerics = None
        self.memory = None
        # cross-process sync timings (Stoke.barrier / checkpoint barriers)
        # land in this registry even when no TelemetryConfig drives sinks
        register_sync_registry(self.registry)
        self._last_record: Dict[str, float] = {}
        # seeded now so the FIRST record's rates cover init->record wall
        # time (includes the warm-up builds and captures)
        self._last_record_ts: Optional[float] = time.time()
        self._last_loss_scale = None
        self._closed = False
        if config is None:
            return
        # annotation gating is process-global; only ever *disable* from a
        # config (never re-enable) so a later default-config instance
        # cannot clobber an earlier instance's explicit opt-out
        if not config.xprof_annotations:
            set_xprof_enabled(False)
        if config.track_compiles:
            self.compile_tracker = CompileTracker(self.registry)
        is_rank0 = self.rank == 0
        out = config.output_dir
        if config.jsonl and (is_rank0 or config.jsonl_all_ranks):
            name = (
                "steps.jsonl"
                if is_rank0 and not config.jsonl_all_ranks
                else f"steps.rank{self.rank}.jsonl"
            )
            self.sinks.append(JsonlSink(os.path.join(out, name)))
        if config.prometheus and (is_rank0 or config.prometheus_all_ranks):
            prom_name = (
                "metrics.prom"
                if is_rank0 and not config.prometheus_all_ranks
                else f"metrics.rank{self.rank}.prom"
            )
            self.sinks.append(
                PrometheusSink(
                    os.path.join(out, prom_name),
                    # host/process_index labels: per-host expositions
                    # scraped into one Prometheus must not collide
                    labels={
                        "rank": str(self.rank),
                        "run": config.run_name,
                        **host_labels(self.rank),
                    },
                )
            )
        if config.tensorboard and is_rank0:
            self.sinks.append(TensorBoardSink(os.path.join(out, "tb")))

    # ------------------------------------------------------------------ #
    # emit surface (facade / data / user)
    # ------------------------------------------------------------------ #

    @property
    def enabled(self) -> bool:
        """True when a ``TelemetryConfig`` drives sinks (the registry works
        regardless)."""
        return self.config is not None

    def phase(self, name: str, annotate: bool = True):
        """Timer for a facade phase: seconds accumulate into
        ``facade/<name>_s`` (the wall-clock breakdown), the section is
        named in ``torch.profiler`` traces, AND — with a trace recorder
        registered — the same section lands in the host span ring as
        ``stoke/<name>`` on the ``facade`` track."""
        timer = self.registry.timer(f"facade/{name}_s")
        if not annotate:
            return timer
        return trace_span(f"stoke/{name}", track="facade", timer=timer)

    def log_scalar(self, tag: str, value: float) -> None:
        """User scalar -> gauge ``user/<tag>`` (mirrored to sinks at the
        next cadence)."""
        self.registry.gauge(f"user/{tag}").set(float(value))

    def add_samples(self, n: int) -> None:
        self.registry.counter("data/samples_total").inc(n)

    def add_tokens(self, n: int) -> None:
        self.registry.counter("data/tokens_total").inc(n)

    def observe_device_step(self, seconds: float) -> None:
        """Record one sampled device-step time (a step bracketed by device
        synchronizes, see the facade)."""
        self.registry.histogram("device/step_s").observe(seconds)

    def will_sample_device(self) -> bool:
        return self.enabled and self.config.sample_device_time

    def wall_clock_breakdown(self) -> Dict[str, float]:
        """``{phase: cumulative host seconds}`` from the registry-backed
        facade timers, plus ``sync/barrier_wait`` once any cross-process
        barrier wait accrued."""
        out = {}
        for name in self.registry.names():
            if name.startswith("facade/") and name.endswith("_s"):
                out[name[len("facade/"):-2]] = self.registry.get(name).value
        sync = self.registry.get("sync/barrier_wait_s")
        if sync is not None and sync.value > 0:
            out["sync/barrier_wait"] = sync.value
        if self.attribution is not None:
            from stoke_tpu_torch.telemetry.attribution import GOODPUT_BUCKETS

            summary = self.attribution.goodput_summary()
            for b in GOODPUT_BUCKETS:
                out[f"goodput/{b}"] = summary[f"{b}_s"]
        return out

    def goodput_summary(self) -> Optional[dict]:
        """The goodput accounting (bucket seconds and shares, aggregate
        achieved TFLOP/s and MFU, captures); None without attribution."""
        if self.attribution is None:
            return None
        return self.attribution.goodput_summary()

    def fleet_summary(self) -> Optional[dict]:
        """End-of-run fleet accounting (windows, the latest per-process
        matrix, its aggregates and straggler verdict, the straggler
        counts); None without a ``FleetConfig``."""
        if self.fleet is None:
            return None
        return self.fleet.summary()

    # ------------------------------------------------------------------ #
    # step records
    # ------------------------------------------------------------------ #

    def _counter_value(self, name: str) -> float:
        inst = self.registry.get(name)
        return inst.value if inst is not None else 0.0

    def _delta(self, name: str) -> float:
        """Per-window delta of a cumulative counter (vs the last record)."""
        now = self._counter_value(name)
        prev = self._last_record.get(name, 0.0)
        self._last_record[name] = now
        return max(0.0, now - prev)

    def note_loss_scale(self, scale) -> int:
        """Track dynamic-loss-scale transitions; returns the cumulative
        transition (backoff+growth) count."""
        events = self.registry.counter("precision/loss_scale_events_total")
        if scale is not None and self._last_loss_scale is not None:
            prev, cur = self._last_loss_scale, scale
            prev_l = prev if isinstance(prev, list) else [prev]
            cur_l = cur if isinstance(cur, list) else [cur]
            changed = len(prev_l) != len(cur_l) or any(
                a != b for a, b in zip(prev_l, cur_l)
            )
            if changed:
                events.inc()
        if scale is not None:
            self._last_loss_scale = scale
        return int(events.value)

    def record_step(
        self,
        step: int,
        window_steps: int = 1,
        *,
        ema_loss: Optional[float] = None,
        step_loss: Optional[float] = None,
        grad_norm: Optional[float] = None,
        loss_scale=None,
        skipped_steps: float = 0.0,
        comm_residual_norm: Optional[float] = None,
        param_norm: Optional[float] = None,
        update_ratio: Optional[float] = None,
        nonfinite_leaves: Optional[float] = None,
        health_anomalies: Optional[float] = None,
        tokens_hint: Optional[float] = None,
        ts: Optional[float] = None,
    ) -> Optional[dict]:
        """Assemble one structured step event from the registry state and
        fan it to every sink.  Called by the facade at the logging cadence;
        safe to call directly from scripts.  Returns the record (None when
        telemetry is disabled)."""
        if not self.enabled or self._closed:
            return None
        now = time.time() if ts is None else ts
        wall_dt = (
            None
            if self._last_record_ts is None
            else max(now - self._last_record_ts, 1e-9)
        )
        self._last_record_ts = now

        if self.config.track_hbm:
            update_hbm_gauges(self.registry)

        # host dispatch seconds this window: sum of facade phase deltas
        # (checkpoint IO also feeds the goodput ledger)
        host_dispatch = 0.0
        ckpt_io = 0.0
        for name in self.registry.names():
            if name.startswith("facade/") and name.endswith("_s"):
                d = self._delta(name)
                host_dispatch += d
                if name in ("facade/save_s", "facade/load_s"):
                    ckpt_io += d
        loader_wait = self._delta("data/loader_wait_s")
        samples_delta = self._delta("data/samples_total")
        tokens_delta = self._delta("data/tokens_total")
        samples_total = self._counter_value("data/samples_total")

        samples_per_s = (
            samples_delta / wall_dt if wall_dt and samples_delta else None
        )
        tokens = tokens_delta if tokens_delta else (tokens_hint or 0.0)
        tokens_per_s = tokens / wall_dt if wall_dt and tokens else None

        dev_hist = self.registry.get("device/step_s")
        device_step_s = (
            dev_hist.ema if isinstance(dev_hist, Histogram) else None
        )

        # gradient-transport bytes: per-window deltas of the analytic
        # bytes-on-wire counters the facade increments per optimizer step;
        # null when no transport is configured
        if self.registry.get("comm/grad_bytes_prequant_total") is not None:
            comm_pre = self._delta("comm/grad_bytes_prequant_total")
            comm_wire = self._delta("comm/grad_bytes_onwire_total")
            comm_ratio = comm_pre / comm_wire if comm_wire else None
        else:
            comm_pre = comm_wire = comm_ratio = None
        # the sharded transport's second wire leg (the updated-parameter
        # all-gather); absent, the field rides null
        if self.registry.get("comm/param_gather_bytes_total") is not None:
            comm_gather = self._delta("comm/param_gather_bytes_total")
        else:
            comm_gather = None

        if self.compile_tracker is not None:
            compiles = self.compile_tracker.compiles
            recompiles = self.compile_tracker.recompiles
            compile_time = self.compile_tracker.compile_time_s
        else:
            compiles = recompiles = 0
            compile_time = 0.0

        # the observatories: MFU / roofline / goodput from this window's
        # deltas, the latest per-group numerics, the memory ledger
        attr_fields: dict = {}
        if self.attribution is not None:
            attr_fields = self.attribution.window_stats(
                step=step, wall_s=wall_dt, host_dispatch_s=host_dispatch,
                loader_wait_s=loader_wait, ckpt_io_s=ckpt_io,
                comm_bytes_onwire=comm_wire)
        # the fleet view: this record's deltas join the current fleet
        # window; at a window boundary one all-gather yields the
        # per-process matrix and the fleet/* fields (nulls in between)
        fleet_fields = None
        if self.fleet is not None:
            fleet_fields = self.fleet.window_stats(
                step=step, wall_s=wall_dt, loader_wait_s=loader_wait,
                comm_bytes_onwire=comm_wire)
        numerics_fields = (self.numerics.event_fields()
                           if self.numerics is not None else None)
        memory_fields = None
        if self.memory is not None:
            memory_fields = self.memory.event_fields()
            self.memory.refresh_gauges(memory_fields)

        hbm = hbm_stats() if self.config.track_hbm else None
        record = build_step_event(
            ts=now,
            step=step,
            rank=self.rank,
            window_steps=window_steps,
            host_dispatch_s=host_dispatch,
            device_step_s=device_step_s,
            loader_wait_s=loader_wait,
            samples_per_s=samples_per_s,
            tokens_per_s=tokens_per_s,
            samples_total=samples_total,
            ema_loss=ema_loss,
            step_loss=step_loss,
            grad_norm=grad_norm,
            loss_scale=loss_scale,
            loss_scale_events=self.note_loss_scale(loss_scale),
            skipped_steps=skipped_steps,
            comm_bytes_prequant=comm_pre,
            comm_bytes_onwire=comm_wire,
            comm_bytes_param_gather=comm_gather,
            comm_compression=comm_ratio,
            comm_residual_norm=comm_residual_norm,
            param_norm=param_norm,
            update_ratio=update_ratio,
            nonfinite_leaves=nonfinite_leaves,
            health_anomalies=health_anomalies,
            compiles_total=compiles,
            recompiles=recompiles,
            compile_time_s=compile_time,
            hbm_bytes_in_use=(hbm or {}).get("bytes_in_use"),
            hbm_peak_bytes=(hbm or {}).get("peak_bytes_in_use"),
            hbm_bytes_limit=(hbm or {}).get("bytes_limit"),
            resilience=(self.resilience.event_fields()
                        if self.resilience is not None else None),
            fleet=fleet_fields,
            numerics=numerics_fields,
            memory=memory_fields,
            **attr_fields,
        )
        snapshot = self.registry.snapshot()
        for sink in self.sinks:
            sink.emit(record, snapshot)
        return record

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # stop receiving other runs' barrier waits: a closed pipeline's
        # counters are a finished run's record, not a live subscriber
        unregister_sync_registry(self.registry)
        if self.attribution is not None:
            try:
                self.attribution.close()  # stop an auto-capture in flight
            except Exception:
                pass
        for sink in self.sinks:
            try:
                sink.close()
            except Exception:
                pass
