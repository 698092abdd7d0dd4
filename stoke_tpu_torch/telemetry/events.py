"""Structured step-event schema: one JSONL record per logged step window.

The port's own copy of ``stoke_tpu/telemetry/events.py`` (the port imports
nothing of the JAX package): the same schema identifier, fields and kinds,
so a record written by either package validates and reads back in the
other (:func:`validate_step_event`, :func:`read_step_events`). The field
names follow ``stoke_tpu/analysis/manifests/wire_formats.json``.

Field semantics (all times in seconds, all rates per second):

- ``step``: optimizer step the window ENDS at.
- ``window_steps``: optimizer steps covered by this record (a train_steps
  segment emits ONE record covering the whole segment when any cadence
  boundary was crossed inside it, window > 1).
- ``host_dispatch_s``: host wall-clock spent inside facade phases since the
  previous record (enqueue cost, NOT device time: CUDA work is async).
- ``device_step_s``: sampled device time of one optimizer step, measured by
  bracketing a step with a device synchronize at the logging cadence;
  ``null`` when sampling is disabled or no sample landed in the window.
- ``loader_wait_s``: host time the training loop spent blocked on the data
  loader since the previous record (starvation indicator — compare against
  ``host_dispatch_s``).
- ``samples_per_s`` / ``tokens_per_s``: window rates from the data-layer
  counters (tokens only when a sequence pipeline reports them).
- ``grad_norm``: global gradient norm at the boundary (only when
  ``TelemetryConfig.grad_norm``).
- ``loss_scale`` / ``loss_scale_events``: fp16 dynamic scale and the count
  of backoff/growth transitions observed so far (``null``/0 outside fp16).
- ``compiles_total`` / ``recompiles`` / ``compile_time_s``: in the port,
  CUDA-graph captures of a training window and first-use ``nvcc`` builds
  (recompiles = a window captured again for a signature or learning rate
  it had captured before).
- ``hbm_*``: the device's ``torch.cuda`` memory statistics (``null`` on
  the CPU, which reports none).

Fields of the observatories the port does not run yet (attribution,
fleet, numerics, memory, resilience, the compile cache) ride as ``null``
or stay absent, exactly as the JAX hub writes them without their monitor.
"""
from __future__ import annotations

import json
import numbers
from typing import Any, Dict, List, Optional

#: schema identifier embedded in every record
STEP_EVENT_SCHEMA = "stoke_tpu.telemetry.step/v1"

#: field -> (required, allowed python kinds); "number" accepts int/float,
#: "nullable_number" also accepts None
STEP_EVENT_FIELDS: Dict[str, tuple] = {
    "schema": (True, "string"),
    "ts": (True, "number"),
    "step": (True, "int"),
    "rank": (True, "int"),
    "window_steps": (True, "int"),
    "host_dispatch_s": (True, "number"),
    "device_step_s": (False, "nullable_number"),
    "loader_wait_s": (True, "number"),
    "samples_per_s": (False, "nullable_number"),
    "tokens_per_s": (False, "nullable_number"),
    "samples_total": (True, "number"),
    "ema_loss": (False, "nullable_number"),
    "step_loss": (False, "nullable_number"),
    "grad_norm": (False, "nullable_number"),
    "loss_scale": (False, "nullable_number_or_list"),
    "loss_scale_events": (False, "int"),
    "skipped_steps": (False, "number"),
    "compiles_total": (True, "int"),
    "recompiles": (True, "int"),
    "compile_time_s": (True, "number"),
    # gradient-transport accounting (null without a CommConfig):
    # per-window bytes the gradient exchange moves per device — prequant is
    # the fp32 schedule's bytes, onwire the configured wire dtype's;
    # compression = prequant/onwire; residual_norm gauges the carried
    # error-feedback residual (the SHARDED residual's global norm under the
    # weight-update-sharded path — same units, 1/N of it per
    # replica).  param_gather (null unless the sharded path is
    # active) is the second wire leg: the updated-parameter all-gather back
    # to the replicated tier placement after the shard-local step
    "comm_bytes_prequant": (False, "nullable_number"),
    "comm_bytes_onwire": (False, "nullable_number"),
    "comm_bytes_param_gather": (False, "nullable_number"),
    "comm_compression": (False, "nullable_number"),
    "comm_residual_norm": (False, "nullable_number"),
    # health sentinels (null without a HealthConfig): per-step
    # diagnostics computed inside the compiled step — param_norm is the
    # global norm of the updated parameters, update_ratio the step's
    # ||delta param|| / ||param||, nonfinite_leaves the count of gradient
    # leaves carrying any non-finite value; health_anomalies is the
    # cumulative detector-firing count
    "param_norm": (False, "nullable_number"),
    "update_ratio": (False, "nullable_number"),
    "nonfinite_leaves": (False, "nullable_number"),
    "health_anomalies": (False, "nullable_number"),
    # step-time attribution (null without an AttributionConfig):
    # per-window achieved TFLOP/s and MFU from the analytic CostCard
    # FLOPs of every dispatched program, HBM-bandwidth utilization
    # against the configured peak, and the compute/memory/comm/host
    # bound classification
    "achieved_tflops": (False, "nullable_number"),
    "mfu": (False, "nullable_number"),
    "hbm_bw_util": (False, "nullable_number"),
    "bound": (False, "nullable_string"),
    # goodput ledger: this window's wall clock partitioned
    # into productive compute vs accounted losses; the buckets sum to
    # the window wall time (ts delta to the previous record)
    "goodput_productive_s": (False, "nullable_number"),
    "goodput_compile_s": (False, "nullable_number"),
    # compile split (additive): the compile+recompile seconds
    # partitioned into fresh XLA backend compiles vs AOT-compile-cache
    # warm-start loads (fresh + cached == compile + recompile within
    # rounding); null without an AttributionConfig
    "goodput_compile_fresh_s": (False, "nullable_number"),
    "goodput_compile_cached_s": (False, "nullable_number"),
    "goodput_recompile_s": (False, "nullable_number"),
    "goodput_loader_s": (False, "nullable_number"),
    "goodput_checkpoint_s": (False, "nullable_number"),
    "goodput_halt_s": (False, "nullable_number"),
    # persistent compile cache (additive, null without a
    # CompileConfig): cumulative AOT hit/miss counts and the original
    # compile seconds the cache's hits reclaimed this run
    "compile_cache_hits": (False, "nullable_number"),
    "compile_cache_misses": (False, "nullable_number"),
    "compile_cache_saved_s": (False, "nullable_number"),
    # fleet view (keys absent without a FleetConfig, null between
    # exchange windows): cross-host skew aggregates derived from the
    # in-band per-host signal exchange — hosts/window identify the
    # exchange, wall_median/max the fleet step-time spread, step/loader
    # skew + lag the straggler's excess over the fleet median,
    # straggler_host/zscore/skew_class the verdict ("loader" = input-
    # pipeline-bound host, "compute" = slow step), and barrier fields the
    # barrier-wait attribution (the max wait, charged to the LAST arrival
    # — the host the fleet was waiting for, not the waiters)
    "fleet/hosts": (False, "nullable_number"),
    "fleet/window": (False, "nullable_number"),
    "fleet/wall_median_s": (False, "nullable_number"),
    "fleet/wall_max_s": (False, "nullable_number"),
    "fleet/step_skew_s": (False, "nullable_number"),
    "fleet/loader_skew_s": (False, "nullable_number"),
    "fleet/lag_s": (False, "nullable_number"),
    "fleet/lag_frac": (False, "nullable_number"),
    "fleet/straggler_host": (False, "nullable_number"),
    "fleet/straggler_zscore": (False, "nullable_number"),
    "fleet/skew_class": (False, "nullable_string"),
    "fleet/barrier_wait_s": (False, "nullable_number"),
    "fleet/barrier_charged_host": (False, "nullable_number"),
    # skew-reactive input rebalancing (keys absent unless
    # FleetConfig.rebalance is ON — a rebalance-off fleet run's records
    # are byte-identical to earlier ones): share_self is this host's
    # current per-slice read share (rows), shift_rows/from/to describe the
    # actuation applied at THIS window close (null between actuations),
    # shifts the cumulative actuation count
    "fleet/rebalance_share_self": (False, "nullable_number"),
    "fleet/rebalance_shift_rows": (False, "nullable_number"),
    "fleet/rebalance_from_host": (False, "nullable_number"),
    "fleet/rebalance_to_host": (False, "nullable_number"),
    "fleet/rebalance_shifts": (False, "nullable_number"),
    # resilience (keys absent without a ResilienceConfig):
    # cumulative preemption notices honored, emergency checkpoints
    # written, corrupt tags quarantined at resume; restarts is the
    # supervisor attempt number this process is (0 = first run);
    # resumed_step the optimizer step this run restored from (null until
    # a resume happens), lost_steps the steps a newer-but-invalid tag
    # had recorded beyond the resumed one; elastic_resumes the
    # resumes that re-sharded state saved on a DIFFERENT topology
    "resilience/preemptions": (False, "nullable_number"),
    "resilience/emergency_saves": (False, "nullable_number"),
    "resilience/quarantined": (False, "nullable_number"),
    "resilience/restarts": (False, "nullable_number"),
    "resilience/resumed_step": (False, "nullable_number"),
    "resilience/lost_steps": (False, "nullable_number"),
    "resilience/elastic_resumes": (False, "nullable_number"),
    # serving engine (keys absent without a ServingEngine emit —
    # training records NEVER carry them): cumulative request/token
    # counters, capacity gauges (queue depth, decode-slot fill, KV-block
    # occupancy), exact p50/p99 of the TTFT/TPOT reservoirs, the
    # queue/prefill/decode goodput split of the serve wall clock
    # (sums-to-wall, like the training goodput ledger), and the weight-
    # quantization compression ratio (param bytes fp / as-served)
    "serve/requests": (False, "nullable_number"),
    "serve/completed": (False, "nullable_number"),
    "serve/tokens_out": (False, "nullable_number"),
    "serve/queue_depth": (False, "nullable_number"),
    "serve/active_seqs": (False, "nullable_number"),
    "serve/batch_fill": (False, "nullable_number"),
    "serve/kv_blocks_used": (False, "nullable_number"),
    "serve/kv_block_occupancy": (False, "nullable_number"),
    "serve/ttft_p50_s": (False, "nullable_number"),
    "serve/ttft_p99_s": (False, "nullable_number"),
    "serve/tpot_p50_s": (False, "nullable_number"),
    "serve/tpot_p99_s": (False, "nullable_number"),
    "serve/goodput_queue_s": (False, "nullable_number"),
    "serve/goodput_prefill_s": (False, "nullable_number"),
    "serve/goodput_decode_s": (False, "nullable_number"),
    "serve/quant_compression": (False, "nullable_number"),
    # serve fast path: chunked-prefill dispatch count and
    # tokens drawn through the sampling path (both 0 for a greedy,
    # unchunked engine — the fields still ride every serve record)
    "serve/prefill_chunks": (False, "nullable_number"),
    "serve/sampled_tokens": (False, "nullable_number"),
    # speculative decoding (keys absent without a speculative
    # config — ServeMetrics omits them until enable_speculative(), so a
    # non-speculative engine's records are byte-identical to earlier
    # ones): draft tokens scored by verify dispatches and draft tokens
    # accepted into the output stream (accepted/drafted = accept rate)
    "serve/spec_draft_tokens": (False, "nullable_number"),
    "serve/spec_accepted_tokens": (False, "nullable_number"),
    # SLO observatory (keys absent until a request carries a
    # RequestSLO — an SLO-free engine's records are byte-identical to
    # earlier ones): submitted/finished/violated counts over
    # SLO-tagged requests, TTFT/TPOT/overall attainment fractions (null
    # before the first SLO-tagged finish), goodput under SLO (tokens/s
    # from requests that met their deadline — the arXiv:2605.25645
    # measuring stick), the pooled queue-ETA forecast (median admission
    # wait), min TTFT deadline headroom over in-flight requests (null
    # when none is awaiting its first token; negative = busted), and the
    # count of attributions degraded by a truncated/inactive span ring
    "serve/slo_requests": (False, "nullable_number"),
    "serve/slo_finished": (False, "nullable_number"),
    "serve/slo_violations": (False, "nullable_number"),
    "serve/slo_ttft_attainment": (False, "nullable_number"),
    "serve/slo_tpot_attainment": (False, "nullable_number"),
    "serve/slo_attainment": (False, "nullable_number"),
    "serve/slo_goodput_tokens_per_s": (False, "nullable_number"),
    "serve/slo_queue_eta_s": (False, "nullable_number"),
    "serve/slo_headroom_min_s": (False, "nullable_number"),
    "serve/slo_partial_attributions": (False, "nullable_number"),
    # SLO-aware TFLOP goodput (key absent unless BOTH the SLO
    # observatory is active AND ServeConfig.cost_cards armed a per-token
    # cost — an SLO-only engine's records stay byte-identical to
    # earlier ones)
    "serve/slo_goodput_tflops_per_s": (False, "nullable_number"),
    # serve roofline / cost accounting (keys absent without
    # ServeConfig.cost_cards — an unconfigured engine's records are
    # byte-identical to earlier ones): cumulative analytic FLOPs /
    # bytes dispatched (XLA cost analysis per program signature, fed per
    # dispatch), model-FLOPs-per-emitted-token, MFU and HBM-bandwidth
    # utilization over dispatch-busy seconds, the decode roofline's
    # attainable per-dispatch TPOT (max of the compute- and bandwidth-
    # limited bounds at the AttributionConfig peaks) vs the achieved
    # decode wall per dispatch, arithmetic intensity of plain decode and
    # of the speculative verify program (the k-token uplift,
    # measured), the decode-family program's analytic bound class
    # ("memory"/"compute"), and the count of distinct programs analyzed
    "serve/cost_flops": (False, "nullable_number"),
    "serve/cost_bytes": (False, "nullable_number"),
    "serve/cost_flops_per_token": (False, "nullable_number"),
    "serve/cost_mfu": (False, "nullable_number"),
    "serve/cost_hbm_bw_util": (False, "nullable_number"),
    "serve/cost_attainable_tpot_s": (False, "nullable_number"),
    "serve/cost_achieved_tpot_s": (False, "nullable_number"),
    "serve/cost_decode_intensity": (False, "nullable_number"),
    "serve/cost_verify_intensity": (False, "nullable_number"),
    "serve/cost_decode_bound": (False, "nullable_string"),
    "serve/cost_cards": (False, "nullable_number"),
    # serve KV-headroom forecast (key absent without a
    # MemoryConfig — a memory-free engine's records are byte-identical
    # to earlier ones): free KV-pool bytes minus the worst-case
    # blocks-to-completion of every in-flight request (negative =
    # admission has over-committed the pool)
    "serve/mem_headroom_bytes": (False, "nullable_number"),
    # per-layer numerics observatory (keys absent without a
    # NumericsConfig): groups is the fixed group count of the run's param
    # tree; per_group the nullable {group: {stat: value}} block (grad/
    # param/update rms, absmax, nonfinite element count, plus wire_err /
    # quant_err when those signal families observed anything) the offline
    # numerics_diff.py aligns between runs; provenance_* name the FIRST
    # module group a non-finite value was attributed to (null while the
    # run is clean); quant_err_* the serving-weight dequant error of the
    # worst-quantized module (null without int8-served weights)
    "numerics/groups": (False, "nullable_number"),
    "numerics/per_group": (False, "nullable_group_block"),
    "numerics/provenance_group": (False, "nullable_number"),
    "numerics/provenance_name": (False, "nullable_string"),
    "numerics/provenance_field": (False, "nullable_string"),
    "numerics/quant_err_max": (False, "nullable_number"),
    "numerics/quant_err_group": (False, "nullable_string"),
    # HBM capacity ledger (keys absent without a MemoryConfig
    # — an unconfigured run's records are byte-identical to earlier
    # ones): the analytic per-subsystem resident ledger (per-device
    # bytes from shape/dtype/sharding trees — the five components
    # recombine EXACTLY into resident_bytes; unregistered subsystems are
    # null, empty ones 0), the max-over-programs memory_analysis temp
    # peak, the predicted peak (resident + temp), device capacity
    # (MemoryConfig.capacity_bytes override or live bytes_limit; null on
    # the CPU simulator), headroom = capacity - predicted peak, and the
    # reconciliation gauge: live bytes-in-use minus the analytic
    # resident total (fragmentation / unledgered subsystems; null
    # without memory_stats)
    "mem/params_bytes": (False, "nullable_number"),
    "mem/opt_state_bytes": (False, "nullable_number"),
    "mem/transport_bytes": (False, "nullable_number"),
    "mem/kv_cache_bytes": (False, "nullable_number"),
    "mem/snapshot_bytes": (False, "nullable_number"),
    "mem/resident_bytes": (False, "nullable_number"),
    "mem/temp_peak_bytes": (False, "nullable_number"),
    "mem/predicted_peak_bytes": (False, "nullable_number"),
    "mem/capacity_bytes": (False, "nullable_number"),
    "mem/headroom_bytes": (False, "nullable_number"),
    "mem/unattributed_bytes": (False, "nullable_number"),
    "hbm_bytes_in_use": (False, "nullable_number"),
    "hbm_peak_bytes": (False, "nullable_number"),
    "hbm_bytes_limit": (False, "nullable_number"),
}

#: the fleet-view subset of the schema (populated via ``build_step_event``'s
#: ``fleet=`` dict; stoke_tpu_torch.telemetry.fleet.FLEET_EVENT_FIELDS must match)
FLEET_STEP_FIELDS = tuple(
    f for f in STEP_EVENT_FIELDS if f.startswith("fleet/")
)

#: the rebalance subset: emitted ONLY when
#: ``FleetConfig.rebalance`` is on — the monitor omits these keys from its
#: window dict otherwise, and ``build_step_event`` honors the omission, so
#: a rebalance-off run adds zero JSONL fields
FLEET_REBALANCE_FIELDS = tuple(
    f for f in FLEET_STEP_FIELDS if f.startswith("fleet/rebalance_")
)

#: the resilience subset of the schema (populated via ``build_step_event``'s
#: ``resilience=`` dict; ResilienceMonitor.event_fields must match)
RESILIENCE_STEP_FIELDS = tuple(
    f for f in STEP_EVENT_FIELDS if f.startswith("resilience/")
)

#: the serving subset of the schema (populated via ``build_step_event``'s
#: ``serve=`` dict; ServeMetrics.event_fields must match)
SERVE_STEP_FIELDS = tuple(
    f for f in STEP_EVENT_FIELDS if f.startswith("serve/")
)

#: the SLO subset: emitted ONLY once a request carries a
#: RequestSLO — the tracker omits these keys from its block otherwise,
#: and ``build_step_event`` honors the omission, so an SLO-free engine
#: adds zero JSONL fields (the FLEET_REBALANCE_FIELDS discipline)
SERVE_SLO_FIELDS = tuple(
    f for f in SERVE_STEP_FIELDS if f.startswith("serve/slo_")
)

#: the speculative-decoding subset: emitted ONLY by engines
#: with ``ServeConfig.speculative_k`` set — ServeMetrics omits these keys
#: until ``enable_speculative()``, and ``build_step_event`` honors the
#: omission (the SERVE_SLO_FIELDS discipline)
SERVE_SPEC_FIELDS = tuple(
    f for f in SERVE_STEP_FIELDS if f.startswith("serve/spec_")
)

#: the cost/roofline subset: emitted ONLY by engines with
#: ``ServeConfig.cost_cards`` on — the ServeCostObservatory's block is
#: merged into the serve dict only when it exists, and
#: ``build_step_event`` honors the omission (the SERVE_SLO_FIELDS
#: discipline)
SERVE_COST_FIELDS = tuple(
    f for f in SERVE_STEP_FIELDS if f.startswith("serve/cost_")
)

#: the serve memory-headroom subset: emitted ONLY by engines
#: with a MemoryConfig — the MemoryObservatory's field is merged into
#: the serve dict only when it exists, and ``build_step_event`` honors
#: the omission (the SERVE_SLO_FIELDS discipline)
SERVE_MEM_FIELDS = tuple(
    f for f in SERVE_STEP_FIELDS if f.startswith("serve/mem_")
)

#: the HBM capacity-ledger subset (populated via
#: ``build_step_event``'s ``memory=`` dict; MemoryObservatory
#: .event_fields must match)
MEM_STEP_FIELDS = tuple(
    f for f in STEP_EVENT_FIELDS if f.startswith("mem/")
)

#: the per-layer-numerics subset (populated via ``build_step_event``'s
#: ``numerics=`` dict; NumericsMonitor.event_fields must match)
NUMERICS_STEP_FIELDS = tuple(
    f for f in STEP_EVENT_FIELDS if f.startswith("numerics/")
)


def _kind_ok(value: Any, kind: str) -> bool:
    if kind == "string":
        return isinstance(value, str)
    if kind == "int":
        return isinstance(value, numbers.Integral) and not isinstance(value, bool)
    if kind == "number":
        return isinstance(value, numbers.Real) and not isinstance(value, bool)
    if kind == "nullable_number":
        return value is None or _kind_ok(value, "number")
    if kind == "nullable_string":
        return value is None or isinstance(value, str)
    if kind == "nullable_number_or_list":
        if value is None or _kind_ok(value, "number"):
            return True
        return isinstance(value, list) and all(
            _kind_ok(v, "number") for v in value
        )
    if kind == "nullable_group_block":
        # {group_name: {stat_name: number-or-null}} — the per-layer
        # numerics block; group/stat sets vary per model, so
        # only the SHAPE is schema-checked here (the stat names are the
        # numerics module's wire format, drift-guarded in its own tests)
        if value is None:
            return True
        return isinstance(value, dict) and all(
            isinstance(k, str)
            and isinstance(v, dict)
            and all(
                isinstance(sk, str) and _kind_ok(sv, "nullable_number")
                for sk, sv in v.items()
            )
            for k, v in value.items()
        )
    raise AssertionError(f"unknown schema kind {kind!r}")


def validate_step_event(record: Dict[str, Any]) -> None:
    """Raise ``ValueError`` when ``record`` violates the v1 step schema
    (missing required field, wrong type, unknown field, wrong version)."""
    if not isinstance(record, dict):
        raise ValueError(f"step event must be a dict, got {type(record).__name__}")
    if record.get("schema") != STEP_EVENT_SCHEMA:
        raise ValueError(
            f"unknown step-event schema {record.get('schema')!r} "
            f"(expected {STEP_EVENT_SCHEMA!r})"
        )
    for field, (required, kind) in STEP_EVENT_FIELDS.items():
        if field not in record:
            if required:
                raise ValueError(f"step event missing required field {field!r}")
            continue
        if not _kind_ok(record[field], kind):
            raise ValueError(
                f"step event field {field!r} has invalid value "
                f"{record[field]!r} (expected {kind})"
            )
    unknown = set(record) - set(STEP_EVENT_FIELDS)
    if unknown:
        raise ValueError(f"step event has unknown fields {sorted(unknown)}")


def read_step_events(path: str, validate: bool = True) -> List[Dict[str, Any]]:
    """Load a JSONL step-event file back into records (the consumer half of
    the schema contract; round-tripped in tests/test_telemetry.py)."""
    out = []
    with open(path) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{line_no}: invalid JSON ({e})") from e
            if validate:
                try:
                    validate_step_event(rec)
                except ValueError as e:
                    raise ValueError(f"{path}:{line_no}: {e}") from e
            out.append(rec)
    return out


def _round(value: Optional[float], digits: int = 6):
    if value is None:
        return None
    return round(float(value), digits)


def build_step_event(
    *,
    ts: float,
    step: int,
    rank: int,
    window_steps: int,
    host_dispatch_s: float,
    loader_wait_s: float,
    samples_total: float,
    compiles_total: int,
    recompiles: int,
    compile_time_s: float,
    device_step_s: Optional[float] = None,
    samples_per_s: Optional[float] = None,
    tokens_per_s: Optional[float] = None,
    ema_loss: Optional[float] = None,
    step_loss: Optional[float] = None,
    grad_norm: Optional[float] = None,
    loss_scale=None,
    loss_scale_events: int = 0,
    skipped_steps: float = 0.0,
    comm_bytes_prequant: Optional[float] = None,
    comm_bytes_onwire: Optional[float] = None,
    comm_bytes_param_gather: Optional[float] = None,
    comm_compression: Optional[float] = None,
    comm_residual_norm: Optional[float] = None,
    param_norm: Optional[float] = None,
    update_ratio: Optional[float] = None,
    nonfinite_leaves: Optional[float] = None,
    health_anomalies: Optional[float] = None,
    achieved_tflops: Optional[float] = None,
    mfu: Optional[float] = None,
    hbm_bw_util: Optional[float] = None,
    bound: Optional[str] = None,
    goodput_productive_s: Optional[float] = None,
    goodput_compile_s: Optional[float] = None,
    goodput_compile_fresh_s: Optional[float] = None,
    goodput_compile_cached_s: Optional[float] = None,
    goodput_recompile_s: Optional[float] = None,
    goodput_loader_s: Optional[float] = None,
    goodput_checkpoint_s: Optional[float] = None,
    goodput_halt_s: Optional[float] = None,
    compile_cache_hits: Optional[int] = None,
    compile_cache_misses: Optional[int] = None,
    compile_cache_saved_s: Optional[float] = None,
    hbm_bytes_in_use: Optional[int] = None,
    hbm_peak_bytes: Optional[int] = None,
    hbm_bytes_limit: Optional[int] = None,
    fleet: Optional[Dict[str, Any]] = None,
    resilience: Optional[Dict[str, Any]] = None,
    serve: Optional[Dict[str, Any]] = None,
    numerics: Optional[Dict[str, Any]] = None,
    memory: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble + validate a v1 step event (single construction point so the
    schema cannot drift from the writer)."""
    record = {
        "schema": STEP_EVENT_SCHEMA,
        "ts": float(ts),
        "step": int(step),
        "rank": int(rank),
        "window_steps": int(window_steps),
        "host_dispatch_s": _round(host_dispatch_s),
        "device_step_s": _round(device_step_s),
        "loader_wait_s": _round(loader_wait_s),
        "samples_per_s": _round(samples_per_s, 3),
        "tokens_per_s": _round(tokens_per_s, 3),
        "samples_total": float(samples_total),
        "ema_loss": _round(ema_loss),
        "step_loss": _round(step_loss),
        "grad_norm": _round(grad_norm),
        "loss_scale": (
            [float(v) for v in loss_scale]
            if isinstance(loss_scale, (list, tuple))
            else (None if loss_scale is None else float(loss_scale))
        ),
        "loss_scale_events": int(loss_scale_events),
        "skipped_steps": float(skipped_steps),
        "compiles_total": int(compiles_total),
        "recompiles": int(recompiles),
        "compile_time_s": _round(compile_time_s),
        "comm_bytes_prequant": (
            None if comm_bytes_prequant is None else float(comm_bytes_prequant)
        ),
        "comm_bytes_onwire": (
            None if comm_bytes_onwire is None else float(comm_bytes_onwire)
        ),
        "comm_bytes_param_gather": (
            None
            if comm_bytes_param_gather is None
            else float(comm_bytes_param_gather)
        ),
        "comm_compression": _round(comm_compression, 4),
        "comm_residual_norm": _round(comm_residual_norm),
        "param_norm": _round(param_norm),
        "update_ratio": _round(update_ratio, 8),
        "nonfinite_leaves": (
            None if nonfinite_leaves is None else float(nonfinite_leaves)
        ),
        "health_anomalies": (
            None if health_anomalies is None else float(health_anomalies)
        ),
        # 9 digits: CPU-scale smoke runs produce sub-micro TFLOP/s values
        # that 4-digit rounding would collapse to a lying 0.0
        "achieved_tflops": _round(achieved_tflops, 9),
        "mfu": _round(mfu, 9),
        "hbm_bw_util": _round(hbm_bw_util, 9),
        "bound": bound,
        # goodput buckets are rounded uniformly so their sum stays within
        # rounding distance of the window wall clock (the acceptance
        # contract: buckets sum to wall time within 1%)
        "goodput_productive_s": _round(goodput_productive_s),
        "goodput_compile_s": _round(goodput_compile_s),
        "goodput_compile_fresh_s": _round(goodput_compile_fresh_s),
        "goodput_compile_cached_s": _round(goodput_compile_cached_s),
        "goodput_recompile_s": _round(goodput_recompile_s),
        "goodput_loader_s": _round(goodput_loader_s),
        "goodput_checkpoint_s": _round(goodput_checkpoint_s),
        "goodput_halt_s": _round(goodput_halt_s),
        "compile_cache_hits": (
            None if compile_cache_hits is None else int(compile_cache_hits)
        ),
        "compile_cache_misses": (
            None if compile_cache_misses is None
            else int(compile_cache_misses)
        ),
        "compile_cache_saved_s": _round(compile_cache_saved_s),
        "hbm_bytes_in_use": hbm_bytes_in_use,
        "hbm_peak_bytes": hbm_peak_bytes,
        "hbm_bytes_limit": hbm_bytes_limit,
    }
    if fleet is not None:
        # fleet view: keys appear only when a FleetMonitor is
        # attached; the slash-named fields cannot be python kwargs, so
        # they arrive as one dict — unknown keys fail validation below
        for key in FLEET_STEP_FIELDS:
            if key in FLEET_REBALANCE_FIELDS and key not in fleet:
                # rebalance keys ride only when the actuator is configured
                # (default-OFF contract: zero new JSONL fields)
                continue
            value = fleet.get(key)
            if key == "fleet/skew_class":
                record[key] = value
            elif key in ("fleet/hosts", "fleet/window",
                         "fleet/straggler_host",
                         "fleet/barrier_charged_host",
                         "fleet/rebalance_from_host",
                         "fleet/rebalance_to_host"):
                record[key] = None if value is None else int(value)
            else:
                record[key] = _round(value)
        unknown = set(fleet) - set(FLEET_STEP_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown fleet step-event fields {sorted(unknown)}"
            )
    if resilience is not None:
        # resilience counters: keys appear only when a
        # ResilienceMonitor is attached; slash-named fields arrive as one
        # dict like the fleet view's — unknown keys fail validation
        for key in RESILIENCE_STEP_FIELDS:
            value = resilience.get(key)
            record[key] = None if value is None else float(value)
        unknown = set(resilience) - set(RESILIENCE_STEP_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown resilience step-event fields {sorted(unknown)}"
            )
    if serve is not None:
        # serving fields: keys appear only when a ServingEngine
        # emits the record — a training run's JSONL never carries them
        for key in SERVE_STEP_FIELDS:
            if (
                key in SERVE_SLO_FIELDS
                or key in SERVE_COST_FIELDS
                or key in SERVE_MEM_FIELDS
            ) and key not in serve:
                # SLO keys ride only once a request carried a RequestSLO
                # (default-OFF contract: zero new JSONL fields);
                # cost keys only with ServeConfig.cost_cards,
                # memory headroom only with a MemoryConfig —
                # same contract
                continue
            value = serve.get(key)
            if key == "serve/cost_decode_bound":
                # the one string-kind serve field ("memory"/"compute")
                record[key] = value
            else:
                record[key] = (
                    None if value is None else _round(float(value))
                )
        unknown = set(serve) - set(SERVE_STEP_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown serve step-event fields {sorted(unknown)}"
            )
    if numerics is not None:
        # per-layer numerics: keys appear only when a
        # NumericsMonitor is attached; the per_group block and string
        # provenance fields pass through, numbers round like the rest
        for key in NUMERICS_STEP_FIELDS:
            value = numerics.get(key)
            if key == "numerics/per_group":
                # round the inner numbers when the block is well-formed;
                # anything else passes through untouched so the schema
                # validation below rejects it with a ValueError instead
                # of this function crashing mid-comprehension
                if isinstance(value, dict) and all(
                    isinstance(stats, dict) for stats in value.values()
                ):
                    record[key] = {
                        g: {s: _round(v, 9) for s, v in stats.items()}
                        for g, stats in value.items()
                    }
                else:
                    record[key] = value
            elif key in (
                "numerics/provenance_name",
                "numerics/provenance_field",
                "numerics/quant_err_group",
            ):
                record[key] = value
            elif key in ("numerics/groups", "numerics/provenance_group"):
                record[key] = None if value is None else int(value)
            else:
                record[key] = _round(value, 9)
        unknown = set(numerics) - set(NUMERICS_STEP_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown numerics step-event fields {sorted(unknown)}"
            )
    if memory is not None:
        # HBM capacity ledger: keys appear only when a
        # MemoryObservatory is attached; slash-named fields arrive as
        # one dict like the fleet view's — unknown keys fail validation
        for key in MEM_STEP_FIELDS:
            value = memory.get(key)
            record[key] = None if value is None else float(value)
        unknown = set(memory) - set(MEM_STEP_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown memory step-event fields {sorted(unknown)}"
            )
    validate_step_event(record)
    return record
