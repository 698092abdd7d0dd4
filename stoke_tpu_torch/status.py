"""State and validation layer of the port: ``StokeStatus``.

Counterpart of ``stoke_tpu/status.py``: the flags and config objects become
one validated status before any device work happens. Enum values are
coerced with the JAX package's aliases and "valid options" messages,
configs are deduplicated by class name, and every rule of the JAX
package's table (``StokeStatus._rules``) is checked in its order with its
message, letter for letter. A rule that reads the process index reads
``torch.distributed``'s rank (0 when no process group is initialised).
``to_dict`` and ``__repr__`` give the JAX keys and values; a checkpoint's
``meta.json`` carries the dict.

Legality comes first (``StokeValidationError``). Only then does
:meth:`StokeStatus._refuse_later_slices` refuse, with
``NotImplementedError`` naming the ROADMAP item, a config class the port
does not run yet (:data:`LATER_CONFIGS`, empty now: ``CompileConfig``
runs the port's compile cache, :mod:`stoke_tpu_torch.compile_cache`,
under the JAX legality rules). ``distributed``
(``"dp"`` and its aliases), the oss/sddp/fsdp tiers, the gradient
transports and the sharded checkpoint format run on a mesh of any
number of axes, with or without the data axis and with ``dcn_axes`` (a
``seq`` axis with ``DataParallelConfig.shard_seq_dim``, model, expert
and stage axes with ``PartitionRulesConfig``: tensor, expert and
pipeline parallelism), and every other config class runs. The JAX
legality rules of a mesh (duplicate axes, a shape against the axes, a
rule naming an unknown axis) stay; a rule may place a dim on any axis of
the mesh, the data, seq and stage axes included
(:mod:`stoke_tpu_torch.parallel.tensor`).

:func:`serve_config_error` holds the serving rules with the JAX package's
messages, but for the rule that refuses the TPU decode kernel on the CPU:
the port's decode kernel runs its plain version there, so
``decode_kernel='pallas'`` is legal on either device. ``ServingEngine``
and ``Stoke.serve`` check their config with it.
"""

from __future__ import annotations

import os
import signal
import uuid
import warnings
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from stoke_tpu_torch.configs import (
    ALL_CONFIG_CLASSES,
    COMM_DTYPES,
    COMM_STRATEGIES,
    FLEET_ACTIONS,
    HEALTH_ACTIONS,
    REMAT_POLICIES,
    SERVE_ATTENTION_KERNELS,
    SERVE_DECODE_KERNELS,
    SERVE_KV_DTYPES,
    SERVE_QUANT_MODES,
    ActivationCheckpointingConfig,
    AttributionConfig,
    CheckpointConfig,
    CheckpointFormat,
    ClipGradConfig,
    ClipGradNormConfig,
    CommConfig,
    CompileConfig,
    DataParallelConfig,
    DeviceOptions,
    DistributedInitConfig,
    DistributedOptions,
    FleetConfig,
    FSDPConfig,
    HealthConfig,
    MemoryConfig,
    MeshConfig,
    NumericsConfig,
    OpsPlaneConfig,
    OSSConfig,
    PrecisionConfig,
    PrecisionOptions,
    ProfilerConfig,
    ResilienceConfig,
    SDDPConfig,
    ServeConfig,
    ShardingOptions,
    TelemetryConfig,
    TensorboardConfig,
    TraceConfig,
    asdict_config,
    comm_shard_updates,
)
from stoke_tpu_torch.resilience import (
    _WATCHDOG_EXIT_CODE,
    CHAOS_ENV,
    parse_chaos,
)

#: the config classes the port refuses after the legality rules, with the
#: ROADMAP Queue 1 item that ports each (every class is honoured now)
LATER_CONFIGS: Dict[str, str] = {}

#: the health watchdog's exit code and the fault injector's variable, from
#: their one source (:mod:`stoke_tpu_torch.resilience`)
WATCHDOG_EXIT_CODE = _WATCHDOG_EXIT_CODE


class StokeValidationError(ValueError):
    """Raised when constructor flags form an illegal combination."""


# aliases of the JAX package (status.py:82-103): the reference's
# distributed backends all mean data parallelism, its fp16 flavours bf16
_DISTRIBUTED_ALIASES = {
    "ddp": DistributedOptions.dp,
    "horovod": DistributedOptions.dp,
    "deepspeed": DistributedOptions.dp,
    "dp": DistributedOptions.dp,
    "xla": DistributedOptions.dp,
}
_PRECISION_ALIASES = {
    "full": PrecisionOptions.full,
    "fp32": PrecisionOptions.full,
    "bf16": PrecisionOptions.bf16,
    "bfloat16": PrecisionOptions.bf16,
    "fp16": PrecisionOptions.fp16,
    "float16": PrecisionOptions.fp16,
    "amp": PrecisionOptions.bf16,
    "apex_O1": PrecisionOptions.bf16,
    "apex_O2": PrecisionOptions.bf16,
    "deepspeed": PrecisionOptions.bf16,
}


def _coerce(value, enum_cls, aliases, what):
    if value is None:
        return None
    if isinstance(value, enum_cls):
        return value
    if isinstance(value, str):
        if value in aliases:
            return aliases[value]
        try:
            return enum_cls(value)
        except ValueError:
            pass
    raise StokeValidationError(
        f"Unknown {what} option {value!r}; valid: "
        f"{sorted({*aliases, *[e.value for e in enum_cls]})}"
    )


def process_rank() -> int:
    """This process's rank in ``torch.distributed``, 0 without a process
    group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _probe_writable(target: str) -> Optional[OSError]:
    """Create ``target`` and write (and remove) a probe file there: the
    OSError on failure, None on success. The directory stays created, so
    the first write of a run cannot fail on a missing path."""
    try:
        os.makedirs(target, exist_ok=True)
        probe = os.path.join(target,
                             f".stoke-write-probe-{uuid.uuid4().hex[:8]}")
        with open(probe, "wb") as f:
            f.write(b"ok")
        os.remove(probe)
        return None
    except OSError as e:
        return e


def _rank0_only(message: str):
    """A sink-path failure matters on the writing process only."""
    return message if process_rank() == 0 else False


class StokeStatus:
    """Single source of truth for the run configuration.

    Args:
        batch_size_per_device: micro-batch size (>= 1).
        grad_accum: micro-batches per optimizer step (None = 1; >= 1).
        grad_clip: ``ClipGradConfig``, ``ClipGradNormConfig`` or None.
        device: "cuda" (default) or "cpu".
        distributed: None, or "dp" and its aliases (a process group of
            one device a process; see ``stoke_tpu_torch.parallel``).
        precision: None/"full"/"fp32", "bf16" or "fp16" (and the JAX
            package's aliases).
        oss / sddp / fsdp: the sharding tiers (ZeRO-1/2/3).
        configs: config objects of ``ALL_CONFIG_CLASSES``, deduplicated by
            class name (the last one of a class wins, with a warning).
    """

    def __init__(
        self,
        batch_size_per_device: Optional[int],
        grad_accum: Optional[int] = None,
        grad_clip: Optional[Union[ClipGradConfig, ClipGradNormConfig]] = None,
        device: Union[str, DeviceOptions] = DeviceOptions.cuda,
        distributed: Optional[Union[str, DistributedOptions]] = None,
        precision: Optional[Union[str, PrecisionOptions]] = None,
        oss: bool = False,
        sddp: bool = False,
        fsdp: bool = False,
        configs: Optional[Sequence[Any]] = None,
    ):
        self._configs = self._set_configs(configs)
        self._status: Dict[str, Any] = {
            "batch_size_per_device": batch_size_per_device,
            "grad_accum": 1 if grad_accum is None else int(grad_accum),
            "grad_clip": grad_clip,
            "device": _coerce(device, DeviceOptions, {}, "device"),
            "distributed": _coerce(
                distributed, DistributedOptions, _DISTRIBUTED_ALIASES,
                "distributed",
            ),
            "precision": _coerce(
                precision, PrecisionOptions, _PRECISION_ALIASES, "precision"
            ) or PrecisionOptions.full,
            "oss": bool(oss),
            "sddp": bool(sddp),
            "fsdp": bool(fsdp),
            "world_size": None,
            "n_devices": None,
            "n_processes": None,
            "effective_batch_size": None,
        }
        self._check_all_raised_combinations()
        self._refuse_later_slices()

    @staticmethod
    def _set_configs(configs: Optional[Sequence[Any]]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for cfg in configs or ():
            name = type(cfg).__name__
            if not isinstance(cfg, ALL_CONFIG_CLASSES):
                raise StokeValidationError(
                    f"Unrecognized config object of type {name}; expected "
                    f"one of {[c.__name__ for c in ALL_CONFIG_CLASSES]}"
                )
            if name in out:
                warnings.warn(
                    f"Stoke -- Duplicate config {name} supplied; keeping the "
                    f"last one"
                )
            out[name] = cfg
        return out

    # ------------------------------------------------------------------ #
    # the legality table (stoke_tpu/status.py:215-1595)
    # ------------------------------------------------------------------ #

    def _mesh_axes(self) -> Tuple[str, ...]:
        """Axis names of the mesh this run would build (default
        ``("data",)``)."""
        mc = self._configs.get("MeshConfig")
        return tuple(mc.axes) if mc is not None else ("data",)

    def _data_axis(self) -> str:
        dp = self._configs.get("DataParallelConfig")
        return dp.axis_name if dp is not None else "data"

    def _seq_axis(self) -> str:
        dp = self._configs.get("DataParallelConfig")
        return dp.seq_axis_name if dp is not None else "seq"

    def _ignored_without_distributed(self, cfg_name: str) -> Callable:
        def rule(s):
            return cfg_name in self._configs and s["distributed"] is None
        return rule

    def _mesh_shape_mismatch(self, s):
        mc = self._configs.get("MeshConfig")
        if mc is None:
            return False
        if len(set(mc.axes)) != len(mc.axes):
            return f"MeshConfig has duplicate axis names {mc.axes}"
        if mc.shape is not None and len(mc.shape) != len(mc.axes):
            return (
                f"MeshConfig shape {mc.shape} has {len(mc.shape)} entries "
                f"but axes {mc.axes} has {len(mc.axes)}"
            )
        return False

    def _partition_rule_axis_unknown(self, s):
        prc = self._configs.get("PartitionRulesConfig")
        if prc is None or s["distributed"] is None:
            return False
        axes = set(self._mesh_axes())
        for rx, spec in prc.rules:
            for entry in spec:
                # multi-axis dims may arrive as tuples or (from YAML) lists
                names = (tuple(entry) if isinstance(entry, (tuple, list))
                         else (entry,))
                for n in names:
                    if isinstance(n, str) and n != "..." and n not in axes:
                        return (
                            f"partition rule {rx!r} names mesh axis "
                            f"{n!r} but the mesh only has axes "
                            f"{sorted(axes)} — add it to MeshConfig.axes "
                            f"or fix the rule"
                        )
        return False

    def _seq_axis_missing(self, s):
        dp = self._configs.get("DataParallelConfig")
        if dp is None or dp.shard_seq_dim is None:
            return False
        if s["distributed"] is None:
            return (
                "DataParallelConfig.shard_seq_dim is set but "
                "distributed=None; it would be silently ignored"
            )
        if dp.seq_axis_name not in self._mesh_axes():
            return (
                f"DataParallelConfig.shard_seq_dim is set but the mesh "
                f"has no {dp.seq_axis_name!r} axis (axes: "
                f"{list(self._mesh_axes())}) — add it to MeshConfig.axes"
            )
        return False

    def _tier_axis_missing(self, s):
        if not (s["oss"] or s["sddp"] or s["fsdp"]):
            return False
        axis = self._data_axis()
        if axis not in self._mesh_axes():
            tier = "fsdp" if s["fsdp"] else ("sddp" if s["sddp"] else "oss")
            return (
                f"{tier} shards state over mesh axis {axis!r} but the "
                f"mesh only has axes {list(self._mesh_axes())} — the "
                f"tier would silently do nothing"
            )
        return False

    def _tensorboard_writable(self, s):
        cfg = self._configs.get("TensorboardConfig")
        if cfg is None:
            return False
        err = _probe_writable(os.path.join(cfg.output_path, cfg.job_name))
        if err is None:
            return False
        return _rank0_only(
            f"TensorboardConfig output path "
            f"{cfg.output_path!r}/{cfg.job_name!r} is not writable: {err}"
        )

    def _telemetry_invalid(self, s):
        cfg = self._configs.get("TelemetryConfig")
        if cfg is None:
            return False
        if cfg.log_every_n_steps < 1:
            return (
                f"TelemetryConfig.log_every_n_steps must be >= 1, got "
                f"{cfg.log_every_n_steps}"
            )
        if cfg.prometheus or cfg.tensorboard or cfg.jsonl:
            err = _probe_writable(cfg.output_dir)
            if err is not None:
                msg = (
                    f"TelemetryConfig.output_dir {cfg.output_dir!r} is "
                    f"not writable: {err}"
                )
                # all-rank sinks write on every process
                if (cfg.jsonl and cfg.jsonl_all_ranks) or (
                    cfg.prometheus and cfg.prometheus_all_ranks
                ):
                    return msg
                return _rank0_only(msg)
        return False

    def _profiler_invalid(self, s):
        cfg = self._configs.get("ProfilerConfig")
        if cfg is None or cfg.trace_dir is None:
            return False
        err = _probe_writable(cfg.trace_dir)
        if err is None:
            return False
        return (
            f"ProfilerConfig.trace_dir {cfg.trace_dir!r} is not "
            f"writable: {err}"
        )

    def _comm_invalid(self, s):
        cfg = self._configs.get("CommConfig")
        if cfg is None:
            return False
        if s["distributed"] is None:
            return (
                "CommConfig supplied but distributed=None; the gradient "
                "transport would be silently ignored — set "
                "distributed='dp' or drop the config"
            )
        if cfg.dtype not in COMM_DTYPES:
            return (
                f"CommConfig.dtype {cfg.dtype!r} unknown; valid: "
                f"{list(COMM_DTYPES)}"
            )
        if cfg.strategy not in COMM_STRATEGIES:
            return (
                f"CommConfig.strategy {cfg.strategy!r} unknown; valid: "
                f"{list(COMM_STRATEGIES)}"
            )
        if cfg.bucket_mb <= 0:
            return f"CommConfig.bucket_mb must be > 0, got {cfg.bucket_mb}"
        if cfg.chunk_elems < 1:
            return (
                f"CommConfig.chunk_elems must be >= 1, got "
                f"{cfg.chunk_elems}"
            )
        if cfg.dtype == "fp32":
            return False  # exact pass-through composes with everything
        if s["precision"] is PrecisionOptions.fp16:
            return (
                f"CommConfig(dtype={cfg.dtype!r}) with precision='fp16' "
                f"is unsupported — the dynamic loss scaler interacts "
                f"with lossy gradient transport; use bf16 (the TPU "
                f"path) or full precision"
            )
        tier = self.sharding_tier
        if comm_shard_updates(cfg, tier):
            if tier is ShardingOptions.none:
                return (
                    f"CommConfig(dtype={cfg.dtype!r}, shard_updates="
                    f"True) needs a sharded tier — the weight-update-"
                    f"sharded transport partitions the optimizer step "
                    f"over the data axis; enable oss/sddp/fsdp or drop "
                    f"shard_updates"
                )
            if cfg.strategy != "rs_ag":
                return (
                    f"CommConfig(strategy={cfg.strategy!r}) cannot "
                    f"shard weight updates — the sharded path IS the "
                    f"rs_ag schedule (quantized reduce-scatter + param "
                    f"all-gather); the single-stage all_reduce assumes "
                    f"every replica consumes the full gradient"
                )
        elif s["sddp"] or s["fsdp"]:
            tier_name = "fsdp" if s["fsdp"] else "sddp"
            return (
                f"CommConfig(dtype={cfg.dtype!r}, shard_updates=False) "
                f"forces the replicated gradient exchange under "
                f"{tier_name} gradient sharding — the replicated "
                f"transport needs the replicated grad buffer of tiers "
                f"none/oss; drop shard_updates to use the sharded "
                f"weight-update path"
            )
        axis = self._data_axis()
        if axis not in self._mesh_axes():
            return (
                f"CommConfig(dtype={cfg.dtype!r}) exchanges gradients "
                f"over mesh axis {axis!r} but the mesh only has axes "
                f"{list(self._mesh_axes())} — add it to MeshConfig.axes"
            )
        return False

    def _health_invalid(self, s):
        cfg = self._configs.get("HealthConfig")
        if cfg is None:
            return False
        if cfg.sentinels and "TelemetryConfig" not in self._configs:
            return (
                "HealthConfig(sentinels=True) requires a TelemetryConfig"
                " — the sentinel values surface through the telemetry "
                "step events; add one or set sentinels=False"
            )
        if cfg.ring_size < 1:
            return (
                f"HealthConfig.ring_size must be >= 1, got "
                f"{cfg.ring_size}"
            )
        if cfg.detector_warmup_steps < 1:
            return (
                f"HealthConfig.detector_warmup_steps must be >= 1, got "
                f"{cfg.detector_warmup_steps}"
            )
        for field in (
            "loss_spike_action", "grad_spike_action", "nonfinite_action",
            "scaler_skip_action", "recompile_storm_action",
            "starvation_action", "comm_residual_action",
        ):
            action = getattr(cfg, field)
            if action not in HEALTH_ACTIONS:
                return (
                    f"HealthConfig.{field} {action!r} unknown; valid: "
                    f"{list(HEALTH_ACTIONS)}"
                )
        if (cfg.nonfinite_action == "halt"
                and s["precision"] is PrecisionOptions.fp16):
            return (
                "HealthConfig(nonfinite_action='halt') is incompatible "
                "with precision='fp16' — the dynamic loss scaler "
                "tolerates transient infs by skipping the step; use "
                "'record'/'warn'/'dump', or bf16/full precision"
            )
        if cfg.watchdog and cfg.watchdog_timeout_s <= 0:
            return (
                f"HealthConfig.watchdog requires watchdog_timeout_s > 0,"
                f" got {cfg.watchdog_timeout_s}"
            )
        if not (0.0 < cfg.ema_alpha <= 1.0):
            return (
                f"HealthConfig.ema_alpha must be in (0, 1], got "
                f"{cfg.ema_alpha}"
            )
        for field in ("loss_spike_zscore", "grad_spike_zscore",
                      "comm_residual_factor"):
            if getattr(cfg, field) <= 0:
                return (
                    f"HealthConfig.{field} must be > 0, got "
                    f"{getattr(cfg, field)}"
                )
        for field in ("scaler_skip_streak", "recompile_storm_threshold",
                      "recompile_storm_window", "starvation_streak"):
            if getattr(cfg, field) < 1:
                return (
                    f"HealthConfig.{field} must be >= 1, got "
                    f"{getattr(cfg, field)}"
                )
        if cfg.max_dumps < 0:
            return (
                f"HealthConfig.max_dumps must be >= 0 (0 disables "
                f"capped dumps), got {cfg.max_dumps}"
            )
        if cfg.watchdog_compile_grace_s < 0:
            return (
                f"HealthConfig.watchdog_compile_grace_s must be >= 0,"
                f" got {cfg.watchdog_compile_grace_s}"
            )
        return False

    def _attribution_invalid(self, s):
        cfg = self._configs.get("AttributionConfig")
        if cfg is None:
            return False
        if "TelemetryConfig" not in self._configs:
            return (
                "AttributionConfig requires a TelemetryConfig — the "
                "MFU/goodput attribution surfaces through the telemetry "
                "step events; add one or drop the config"
            )
        if cfg.peak_tflops <= 0:
            return (
                f"AttributionConfig.peak_tflops must be > 0 (MFU's "
                f"denominator — measure it with scripts/flops_probe.py "
                f"or use the datasheet number), got {cfg.peak_tflops}"
            )
        if cfg.peak_hbm_gbps < 0 or cfg.ici_gbps < 0:
            return (
                "AttributionConfig.peak_hbm_gbps/ici_gbps must be >= 0 "
                "(0 disables that roofline leg)"
            )
        if not (0.0 < cfg.ema_alpha <= 1.0):
            return (
                f"AttributionConfig.ema_alpha must be in (0, 1], got "
                f"{cfg.ema_alpha}"
            )
        if cfg.capture_warmup_windows < 0:
            return (
                f"AttributionConfig.capture_warmup_windows must be "
                f">= 0, got {cfg.capture_warmup_windows}"
            )
        if cfg.auto_capture:
            pc = self._configs.get("ProfilerConfig")
            if pc is None or pc.trace_dir is None:
                return (
                    "AttributionConfig(auto_capture=True) requires "
                    "ProfilerConfig.trace_dir — the captured xprof "
                    "trace windows are written there; set it or "
                    "disable auto_capture"
                )
            if cfg.max_captures < 1 or cfg.capture_steps < 1:
                return (
                    "AttributionConfig auto-capture needs "
                    "max_captures >= 1 and capture_steps >= 1"
                )
            if cfg.capture_mfu_below <= 0 and cfg.capture_step_zscore <= 0:
                return (
                    "AttributionConfig(auto_capture=True) with both "
                    "triggers disabled (capture_mfu_below <= 0 and "
                    "capture_step_zscore <= 0) would never capture — "
                    "enable at least one trigger"
                )
        # 'halt' is excluded: a diagnostic capture must never kill a run
        valid_capture = [a for a in HEALTH_ACTIONS if a != "halt"]
        if cfg.capture_action not in valid_capture:
            return (
                f"AttributionConfig.capture_action "
                f"{cfg.capture_action!r} invalid; valid: "
                f"{valid_capture} (halt is not allowed — a profiler "
                f"capture is diagnostic, not fatal)"
            )
        return False

    def _fleet_invalid(self, s):
        cfg = self._configs.get("FleetConfig")
        if cfg is None:
            return False
        if "TelemetryConfig" not in self._configs:
            return (
                "FleetConfig requires a TelemetryConfig — the fleet "
                "view surfaces through the telemetry step events; add "
                "one or drop the config"
            )
        if cfg.window_steps < 1:
            return (
                f"FleetConfig.window_steps must be >= 1, got "
                f"{cfg.window_steps}"
            )
        if cfg.straggler_zscore <= 0:
            return (
                f"FleetConfig.straggler_zscore must be > 0, got "
                f"{cfg.straggler_zscore}"
            )
        if cfg.straggler_rel_frac <= 0:
            return (
                f"FleetConfig.straggler_rel_frac must be > 0, got "
                f"{cfg.straggler_rel_frac}"
            )
        if cfg.straggler_windows < 1:
            return (
                f"FleetConfig.straggler_windows must be >= 1, got "
                f"{cfg.straggler_windows}"
            )
        if cfg.straggler_action not in FLEET_ACTIONS:
            return (
                f"FleetConfig.straggler_action "
                f"{cfg.straggler_action!r} unknown; valid: "
                f"{list(FLEET_ACTIONS)} (halt is not allowed — a "
                f"straggler is a performance diagnosis, not fatal)"
            )
        if cfg.rebalance:
            if cfg.rebalance_rows < 1:
                return (
                    f"FleetConfig.rebalance_rows must be >= 1, got "
                    f"{cfg.rebalance_rows}"
                )
            if not (0.0 < cfg.rebalance_max_frac < 1.0):
                return (
                    f"FleetConfig.rebalance_max_frac must be in "
                    f"(0, 1) — a host sheds at most that fraction of "
                    f"its read share, never all of it; got "
                    f"{cfg.rebalance_max_frac}"
                )
        return False

    def _numerics_invalid(self, s):
        cfg = self._configs.get("NumericsConfig")
        if cfg is None:
            return False
        if "TelemetryConfig" not in self._configs:
            return (
                "NumericsConfig requires a TelemetryConfig — the "
                "per-layer numerics surface through the telemetry step "
                "events; add one or drop the config"
            )
        if cfg.provenance_action not in HEALTH_ACTIONS:
            return (
                f"NumericsConfig.provenance_action "
                f"{cfg.provenance_action!r} unknown; valid: "
                f"{list(HEALTH_ACTIONS)}"
            )
        if (cfg.provenance_action == "halt"
                and s["precision"] is PrecisionOptions.fp16):
            return (
                "NumericsConfig(provenance_action='halt') is "
                "incompatible with precision='fp16' — the dynamic loss "
                "scaler tolerates transient infs by skipping the step; "
                "use 'record'/'warn'/'dump', or bf16/full precision"
            )
        if cfg.top_k < 1:
            return f"NumericsConfig.top_k must be >= 1, got {cfg.top_k}"
        if not (cfg.grad_stats or cfg.wire_error):
            return (
                "NumericsConfig with grad_stats=False and "
                "wire_error=False observes nothing — enable at least "
                "one signal family or drop the config"
            )
        if not cfg.grad_stats and cfg.provenance_action in ("dump", "halt"):
            return (
                f"NumericsConfig(provenance_action="
                f"{cfg.provenance_action!r}) requires grad_stats=True "
                f"— NaN provenance is derived from the per-group "
                f"stats matrix, so with grad_stats=False it can "
                f"never fire; enable grad_stats or drop the "
                f"escalated action"
            )
        return False

    def _memory_invalid(self, s):
        cfg = self._configs.get("MemoryConfig")
        if cfg is None:
            return False
        if "TelemetryConfig" not in self._configs:
            return (
                "MemoryConfig requires a TelemetryConfig — the HBM "
                "capacity ledger surfaces through the telemetry step "
                "events; add one or drop the config"
            )
        if not (0.0 < cfg.oom_margin_frac <= 1.0):
            return (
                f"MemoryConfig.oom_margin_frac must be in (0, 1] — "
                f"the pre-flight warns when predicted peak crosses "
                f"that fraction of capacity; got "
                f"{cfg.oom_margin_frac}"
            )
        if cfg.capacity_bytes is not None and cfg.capacity_bytes <= 0:
            return (
                f"MemoryConfig.capacity_bytes must be a positive "
                f"byte count when set (None reads the live "
                f"memory_stats limit); got {cfg.capacity_bytes}"
            )
        return False

    def _opsplane_invalid(self, s):
        cfg = self._configs.get("OpsPlaneConfig")
        if cfg is None:
            return False
        if "TelemetryConfig" not in self._configs:
            return (
                "OpsPlaneConfig requires a TelemetryConfig — the "
                "plane serves the telemetry registry and reuses its "
                "Prometheus sink labels; add one or drop the config"
            )
        if not (0 <= cfg.port <= 65535):
            return (
                f"OpsPlaneConfig.port must be in 0..65535 (0 binds "
                f"an ephemeral port; rank r binds port + r); got "
                f"{cfg.port}"
            )
        if not isinstance(cfg.host, str) or not cfg.host:
            return (
                f"OpsPlaneConfig.host must be a non-empty bind "
                f"address (loopback '127.0.0.1' by default; "
                f"'0.0.0.0' to expose to fleet scrapers); got "
                f"{cfg.host!r}"
            )
        if cfg.profile_max_seconds <= 0:
            return (
                f"OpsPlaneConfig.profile_max_seconds must be > 0 — "
                f"it is the hard per-capture ceiling /profile clamps "
                f"to; got {cfg.profile_max_seconds}"
            )
        if not (0 < cfg.profile_default_seconds <= cfg.profile_max_seconds):
            return (
                f"OpsPlaneConfig.profile_default_seconds must be in "
                f"(0, profile_max_seconds={cfg.profile_max_seconds}] "
                f"— /profile without ?seconds= uses it, and a "
                f"default above the ceiling would silently clamp; "
                f"got {cfg.profile_default_seconds}"
            )
        if cfg.requests_limit < 1:
            return (
                f"OpsPlaneConfig.requests_limit must be >= 1 — it "
                f"caps the /requests table (the response marks "
                f"itself truncated past it); got {cfg.requests_limit}"
            )
        return False

    def _checkpoint_invalid(self, s):
        """The periodic save must be able to fire, ``save_rank`` is a
        rank, and offload staging is for async consolidated saves only."""
        cfg = self._configs.get("CheckpointConfig")
        if cfg is None:
            return False
        if cfg.save_every_n_steps is not None:
            if cfg.save_every_n_steps < 1:
                return (
                    f"CheckpointConfig.save_every_n_steps must be "
                    f">= 1 or None, got {cfg.save_every_n_steps}"
                )
            if not cfg.auto_path:
                return (
                    "CheckpointConfig.save_every_n_steps is set but "
                    "auto_path is not — the periodic auto-save would "
                    "silently never write; set auto_path or drop the "
                    "cadence"
                )
        if cfg.save_rank < 0:
            return (
                f"CheckpointConfig.save_rank must be >= 0 (taken "
                f"modulo the process count), got {cfg.save_rank}"
            )
        if not cfg.offload_staging:
            return False
        if not cfg.async_save:
            return (
                "CheckpointConfig.offload_staging requires "
                "async_save=True — staging hands device references to "
                "the background writer; a synchronous save has none. "
                "Enable async_save or drop offload_staging"
            )
        if cfg.format is CheckpointFormat.sharded:
            return (
                "CheckpointConfig.offload_staging applies to the "
                "consolidated format only — the sharded (orbax) async "
                "path stages its own device→host copy. Use "
                "format='consolidated' or drop offload_staging"
            )
        return False

    def _resilience_invalid(self, s):
        cfg = self._configs.get("ResilienceConfig")
        if cfg is None:
            return False
        if not (0 < cfg.exit_code < 256):
            return (
                f"ResilienceConfig.exit_code must be 1..255 (a process "
                f"exit status), got {cfg.exit_code}"
            )
        if cfg.exit_code == WATCHDOG_EXIT_CODE:
            return (
                f"ResilienceConfig.exit_code {cfg.exit_code} collides "
                f"with the health watchdog's exit code — supervisors "
                f"classify 'drained cleanly' vs 'hung and self-killed' "
                f"on that difference; pick another code"
            )
        if not cfg.preempt_signals:
            return (
                "ResilienceConfig.preempt_signals is empty — the "
                "preemption handler would never arm; name at least one "
                "signal or drop the config"
            )
        for name in cfg.preempt_signals:
            if not isinstance(name, str) or getattr(signal, name,
                                                    None) is None:
                return (
                    f"ResilienceConfig.preempt_signals names unknown "
                    f"signal {name!r} (e.g. 'SIGTERM', 'SIGUSR1')"
                )
        if cfg.max_to_keep is not None and cfg.max_to_keep < 1:
            return (
                f"ResilienceConfig.max_to_keep must be >= 1 or None, "
                f"got {cfg.max_to_keep}"
            )
        ckpt = self._configs.get("CheckpointConfig")
        if (ckpt is not None and ckpt.auto_path
                and cfg.save_name == ckpt.auto_name
                and os.path.abspath(cfg.save_path)
                == os.path.abspath(ckpt.auto_path)):
            return (
                f"ResilienceConfig.save_name {cfg.save_name!r} "
                f"collides with CheckpointConfig.auto_name under the "
                f"same directory — the two save cadences would prune "
                f"each other's tags; rename one or separate the paths"
            )
        spec = cfg.chaos if cfg.chaos is not None else os.environ.get(
            CHAOS_ENV)
        try:
            parse_chaos(spec)
        except ValueError as e:
            return str(e)
        err = _probe_writable(cfg.save_path)
        if err is not None:
            return (
                f"ResilienceConfig.save_path {cfg.save_path!r} is not "
                f"writable: {err}"
            )
        return False

    def _compile_invalid(self, s):
        cfg = self._configs.get("CompileConfig")
        if cfg is None:
            return False
        if cfg.min_compile_time_s < 0:
            return (
                f"CompileConfig.min_compile_time_s must be >= 0, got "
                f"{cfg.min_compile_time_s}"
            )
        if not (cfg.aot or cfg.xla_cache):
            return (
                "CompileConfig with aot=False and xla_cache=False "
                "caches nothing — enable a layer or drop the config"
            )
        err = _probe_writable(cfg.cache_dir)
        if err is not None:
            return (
                f"CompileConfig.cache_dir {cfg.cache_dir!r} is not "
                f"writable: {err}"
            )
        return False

    def _serve_invalid(self, s):
        """:func:`serve_config_error`, then the cost cards' need of an
        ``AttributionConfig`` with a memory ceiling."""
        cfg = self._configs.get("ServeConfig")
        if cfg is None:
            return False
        err = serve_config_error(cfg)
        if err is not None:
            return err
        if cfg.cost_cards:
            attr = self._configs.get("AttributionConfig")
            if attr is None:
                return (
                    "ServeConfig.cost_cards=True requires an "
                    "AttributionConfig — the serve roofline divides "
                    "by its peak_tflops / peak_hbm_gbps ceilings; "
                    "add one or drop cost_cards"
                )
            if attr.peak_hbm_gbps <= 0:
                return (
                    f"ServeConfig.cost_cards=True needs "
                    f"AttributionConfig.peak_hbm_gbps > 0 (the "
                    f"memory leg of the decode roofline — attainable "
                    f"TPOT is bandwidth-bound), got "
                    f"{attr.peak_hbm_gbps}"
                )
        return False

    def _trace_invalid(self, s):
        cfg = self._configs.get("TraceConfig")
        if cfg is None:
            return False
        if cfg.ring_size < 1:
            return (
                f"TraceConfig.ring_size must be >= 1, got "
                f"{cfg.ring_size}"
            )
        if cfg.export_on_close:
            err = _probe_writable(cfg.output_dir)
            if err is not None:
                return (
                    f"TraceConfig.output_dir {cfg.output_dir!r} is not "
                    f"writable: {err}"
                )
        return False

    def _remat_invalid(self, s):
        """The policy must name one of :data:`REMAT_POLICIES`, the JAX
        package's message (it lists the same four)."""
        cfg = self._configs.get("ActivationCheckpointingConfig")
        if cfg is None:
            return False
        if not isinstance(cfg.policy, str) or cfg.policy not in REMAT_POLICIES:
            return (
                f"ActivationCheckpointingConfig.policy {cfg.policy!r} "
                f"is not a jax.checkpoint_policies member — use e.g. "
                f"'nothing_saveable', 'dots_saveable', "
                f"'dots_with_no_batch_dims_saveable', or "
                f"'everything_saveable'"
            )
        return False

    def _precision_scaler_invalid(self, s):
        cfg = self._configs.get("PrecisionConfig")
        if cfg is None:
            return False
        if cfg.init_scale <= 0 or cfg.min_scale <= 0:
            return (
                f"PrecisionConfig.init_scale/min_scale must be > 0, "
                f"got {cfg.init_scale}/{cfg.min_scale}"
            )
        if cfg.growth_factor < 1.0:
            return (
                f"PrecisionConfig.growth_factor must be >= 1 (growth "
                f"never shrinks the scale), got {cfg.growth_factor}"
            )
        if not (0.0 < cfg.backoff_factor <= 1.0):
            return (
                f"PrecisionConfig.backoff_factor must be in (0, 1] "
                f"(backoff never grows the scale), got "
                f"{cfg.backoff_factor}"
            )
        if cfg.growth_interval < 1:
            return (
                f"PrecisionConfig.growth_interval must be >= 1, got "
                f"{cfg.growth_interval}"
            )
        return False

    def _fsdp_pref_invalid(self, s):
        cfg = self._configs.get("FSDPConfig")
        if cfg is None:
            return False
        if cfg.shard_axis_preference not in ("largest", "first"):
            return (
                f"FSDPConfig.shard_axis_preference "
                f"{cfg.shard_axis_preference!r} unknown; valid: "
                f"['largest', 'first'] — any other value would "
                f"silently act as 'largest'"
            )
        return False

    def _offload_cpu_no_fallback(self, s):
        for name in ("OffloadOptimizerConfig", "OffloadParamsConfig"):
            cfg = self._configs.get(name)
            if (cfg is not None and not cfg.fallback_to_device
                    and s["device"] is DeviceOptions.cpu):
                return (
                    f"{name}(fallback_to_device=False) on device='cpu': "
                    f"the CPU runtime has no pinned_host memory kind; "
                    f"allow fallback or use device='tpu'"
                )
        return False

    def _rules(self) -> List[Tuple[Callable[[Dict[str, Any]], Any], str]]:
        """(predicate, message) pairs in the JAX package's order; a truthy
        predicate is an illegal combination, and a predicate that returns a
        string names the rule itself."""
        pc = self._configs.get("PrecisionConfig")
        return [
            (lambda s: s["batch_size_per_device"] is None
             or s["batch_size_per_device"] < 1,
             "batch_size_per_device must be >= 1"),
            (lambda s: s["grad_accum"] < 1, "grad_accum must be >= 1"),
            (lambda s: s["grad_clip"] is not None and not isinstance(
                s["grad_clip"], (ClipGradConfig, ClipGradNormConfig)),
             "grad_clip must be ClipGradConfig, ClipGradNormConfig, or None"),
            (lambda s: isinstance(s["grad_clip"], ClipGradConfig)
             and s["grad_clip"].clip_value <= 0,
             "ClipGradConfig.clip_value must be > 0 (an elementwise "
             "bound of 0 zeroes every gradient)"),
            (lambda s: isinstance(s["grad_clip"], ClipGradNormConfig)
             and (s["grad_clip"].max_norm <= 0
                  or s["grad_clip"].norm_type < 1),
             "ClipGradNormConfig needs max_norm > 0 and norm_type >= 1 "
             "(inf is legal)"),
            (lambda s: pc is not None and pc.num_losses != 1 and (
                pc.num_losses < 1
                or s["precision"] is not PrecisionOptions.fp16),
             "PrecisionConfig.num_losses > 1 (per-loss scalers) requires "
             "precision='fp16' and num_losses >= 1 — reference Apex "
             "num_losses, fp16.py:656-691"),
            (lambda s: s["sddp"] and not s["oss"],
             "sddp (gradient sharding) requires oss (optimizer-state "
             "sharding) — reference status.py:240-243"),
            (lambda s: s["fsdp"] and (s["oss"] or s["sddp"]),
             "fsdp (fully-sharded) already shards optimizer state and "
             "gradients; combining with oss/sddp is illegal — reference "
             "status.py:244-263"),
            (lambda s: (s["oss"] or s["sddp"] or s["fsdp"])
             and s["distributed"] is None,
             "sharding tiers (oss/sddp/fsdp) require distributed='dp' — "
             "reference status.py:231-263"),
            (self._ignored_without_distributed("MeshConfig"),
             "MeshConfig supplied but distributed=None; the mesh would be "
             "silently ignored — set distributed='dp' or drop the config"),
            (self._ignored_without_distributed("PartitionRulesConfig"),
             "PartitionRulesConfig supplied but distributed=None; the "
             "rules would be silently ignored — set distributed='dp' or "
             "drop the config"),
            (self._mesh_shape_mismatch, "MeshConfig axes/shape inconsistent"),
            (self._partition_rule_axis_unknown,
             "partition rule names an unknown mesh axis"),
            (self._seq_axis_missing,
             "sequence-dim sharding configured without a seq mesh axis"),
            (self._tier_axis_missing,
             "sharding tier's data axis missing from the mesh"),
            (self._tensorboard_writable,
             "TensorboardConfig output path is not writable"),
            (self._telemetry_invalid, "TelemetryConfig is invalid"),
            (self._profiler_invalid,
             "ProfilerConfig.trace_dir is not writable"),
            (self._comm_invalid,
             "CommConfig is invalid for this combination"),
            (self._health_invalid,
             "HealthConfig is invalid for this combination"),
            (self._attribution_invalid,
             "AttributionConfig is invalid for this combination"),
            (self._fleet_invalid,
             "FleetConfig is invalid for this combination"),
            (self._numerics_invalid,
             "NumericsConfig is invalid for this combination"),
            (self._memory_invalid,
             "MemoryConfig is invalid for this combination"),
            (self._opsplane_invalid,
             "OpsPlaneConfig is invalid for this combination"),
            (self._checkpoint_invalid, "CheckpointConfig is invalid"),
            (self._resilience_invalid, "ResilienceConfig is invalid"),
            (self._compile_invalid, "CompileConfig is invalid"),
            (self._serve_invalid, "ServeConfig is invalid"),
            (self._trace_invalid, "TraceConfig is invalid"),
            (self._remat_invalid,
             "ActivationCheckpointingConfig.policy is invalid"),
            (self._precision_scaler_invalid,
             "PrecisionConfig scaler knobs are invalid"),
            (self._fsdp_pref_invalid,
             "FSDPConfig.shard_axis_preference is invalid"),
            (self._offload_cpu_no_fallback,
             "offload config with fallback_to_device=False on device='cpu'"),
            (lambda s: "OffloadParamsConfig" in self._configs
             and not s["fsdp"],
             "OffloadParamsConfig requires fsdp=True — parameter offload "
             "is a ZeRO-3 feature (reference DeepspeedOffloadParamConfig "
             "legal only at stage 3, configs.py:346-372)"),
            (lambda s: "OffloadDiskConfig" in self._configs
             and "OffloadOptimizerConfig" in self._configs,
             "OffloadDiskConfig and OffloadOptimizerConfig are mutually "
             "exclusive — one offload tier per state (reference: a single "
             "offload_optimizer device choice, configs.py:309-343)"),
        ]

    def _check_all_raised_combinations(self) -> None:
        for predicate, message in self._rules():
            result = predicate(self._status)
            if result:
                msg = result if isinstance(result, str) else message
                raise StokeValidationError(
                    f"Stoke -- illegal combination: {msg}"
                )

    def _refuse_later_slices(self) -> None:
        """After the legality rules: ``NotImplementedError`` naming the
        ROADMAP item of the first config class that the port does not run
        yet."""
        for name, item in LATER_CONFIGS.items():
            if name in self._configs:
                raise NotImplementedError(
                    f"Stoke -- {name} is not ported yet: {item}"
                )

    def set_post_init_values(self, world_size: int,
                             n_processes: int = 1) -> None:
        """Record the device and process counts once the process group
        exists (under the port one device a process, so they are equal);
        the effective batch is per-device batch x devices x grad_accum."""
        self._status["world_size"] = world_size
        self._status["n_devices"] = world_size
        self._status["n_processes"] = n_processes
        self._status["effective_batch_size"] = (
            self._status["batch_size_per_device"] * world_size
            * self._status["grad_accum"]
        )

    # ------------------------------------------------------------------ #
    # flags
    # ------------------------------------------------------------------ #

    @property
    def status(self) -> Dict[str, Any]:
        return dict(self._status)

    @property
    def batch_size(self) -> int:
        return self._status["batch_size_per_device"]

    @property
    def effective_batch_size(self) -> Optional[int]:
        return self._status["effective_batch_size"]

    @property
    def grad_accum(self) -> int:
        return self._status["grad_accum"]

    @property
    def grad_clip(self):
        return self._status["grad_clip"]

    @property
    def device(self) -> DeviceOptions:
        return self._status["device"]

    @property
    def distributed(self) -> Optional[DistributedOptions]:
        return self._status["distributed"]

    @property
    def is_distributed(self) -> bool:
        return self._status["distributed"] is not None

    @property
    def precision(self) -> PrecisionOptions:
        return self._status["precision"]

    @property
    def is_scaled_precision(self) -> bool:
        return self._status["precision"] is PrecisionOptions.fp16

    @property
    def oss(self) -> bool:
        return self._status["oss"]

    @property
    def sddp(self) -> bool:
        return self._status["sddp"]

    @property
    def fsdp(self) -> bool:
        return self._status["fsdp"]

    @property
    def sharding_tier(self) -> ShardingOptions:
        """The three booleans as one rung of the ladder."""
        if self._status["fsdp"]:
            return ShardingOptions.fsdp
        if self._status["sddp"]:
            return ShardingOptions.sddp
        if self._status["oss"]:
            return ShardingOptions.oss
        return ShardingOptions.none

    @property
    def world_size(self) -> Optional[int]:
        return self._status["world_size"]

    # ------------------------------------------------------------------ #
    # configs: defaults made on first read, or None unless supplied
    # ------------------------------------------------------------------ #

    def _get_or_default(self, cls):
        if cls.__name__ not in self._configs:
            self._configs[cls.__name__] = cls()
        return self._configs[cls.__name__]

    @property
    def precision_config(self) -> PrecisionConfig:
        return self._get_or_default(PrecisionConfig)

    @property
    def dp_config(self) -> DataParallelConfig:
        return self._get_or_default(DataParallelConfig)

    @property
    def mesh_config(self) -> MeshConfig:
        return self._get_or_default(MeshConfig)

    @property
    def dist_init_config(self) -> DistributedInitConfig:
        return self._get_or_default(DistributedInitConfig)

    @property
    def oss_config(self) -> OSSConfig:
        return self._get_or_default(OSSConfig)

    @property
    def sddp_config(self) -> SDDPConfig:
        return self._get_or_default(SDDPConfig)

    @property
    def fsdp_config(self) -> FSDPConfig:
        return self._get_or_default(FSDPConfig)

    @property
    def checkpoint_config(self) -> CheckpointConfig:
        return self._get_or_default(CheckpointConfig)

    @property
    def profiler_config(self) -> ProfilerConfig:
        return self._get_or_default(ProfilerConfig)

    @property
    def comm_config(self) -> Optional[CommConfig]:
        return self._configs.get("CommConfig")

    @property
    def partition_rules_config(self):
        return self._configs.get("PartitionRulesConfig")

    @property
    def offload_optimizer_config(self):
        return self._configs.get("OffloadOptimizerConfig")

    @property
    def offload_params_config(self):
        return self._configs.get("OffloadParamsConfig")

    @property
    def offload_disk_config(self):
        return self._configs.get("OffloadDiskConfig")

    @property
    def activation_checkpointing_config(
            self) -> Optional[ActivationCheckpointingConfig]:
        return self._configs.get("ActivationCheckpointingConfig")

    @property
    def tensorboard_config(self) -> Optional[TensorboardConfig]:
        """None unless supplied (metrics logging is opt-in)."""
        return self._configs.get("TensorboardConfig")

    @property
    def health_config(self) -> Optional[HealthConfig]:
        return self._configs.get("HealthConfig")

    @property
    def attribution_config(self) -> Optional[AttributionConfig]:
        return self._configs.get("AttributionConfig")

    @property
    def fleet_config(self) -> Optional[FleetConfig]:
        return self._configs.get("FleetConfig")

    @property
    def numerics_config(self) -> Optional[NumericsConfig]:
        return self._configs.get("NumericsConfig")

    @property
    def memory_config(self) -> Optional[MemoryConfig]:
        return self._configs.get("MemoryConfig")

    @property
    def opsplane_config(self) -> Optional[OpsPlaneConfig]:
        return self._configs.get("OpsPlaneConfig")

    @property
    def resilience_config(self) -> Optional[ResilienceConfig]:
        return self._configs.get("ResilienceConfig")

    @property
    def compile_config(self) -> Optional[CompileConfig]:
        return self._configs.get("CompileConfig")

    @property
    def serve_config(self) -> Optional[ServeConfig]:
        """None unless supplied (serving is opt-in; only ``Stoke.serve``
        reads it)."""
        return self._configs.get("ServeConfig")

    @property
    def telemetry_config(self) -> Optional[TelemetryConfig]:
        return self._configs.get("TelemetryConfig")

    @property
    def trace_config(self) -> Optional[TraceConfig]:
        return self._configs.get("TraceConfig")

    def to_dict(self) -> Dict[str, Any]:
        """The status as JSON-friendly values, with the JAX package's keys
        and values (a checkpoint's ``meta.json`` carries it): enums by
        value, a clip config as ``{"type": name, **fields}``, and every
        config supplied or read so far under ``configs``."""
        out = {}
        for k, v in self._status.items():
            if isinstance(v, Enum):
                v = v.value
            elif isinstance(v, (ClipGradConfig, ClipGradNormConfig)):
                v = {"type": type(v).__name__, **asdict_config(v)}
            out[k] = v
        out["configs"] = {k: asdict_config(v)
                          for k, v in self._configs.items()}
        return out

    def __repr__(self) -> str:
        lines = ["Stoke -- Status:"]
        for k, v in self.to_dict().items():
            lines.append(f"  {k}: {v}")
        return "\n".join(lines)


def serve_config_error(cfg: ServeConfig) -> Optional[str]:
    """The first serve rule that ``cfg`` breaks, as the JAX package's
    message, or None: sizes, kernel and dtype names, the block knobs,
    chunked prefill, the sampling knobs, quantization, the pool's
    capacity, SLO targets and speculative decoding, in the JAX package's
    order. Knobs that a disabled feature would silently ignore are
    rejected, never ignored."""
    for field in ("max_seqs", "kv_block_size", "max_seq_len",
                  "max_new_tokens", "prefill_pad_multiple",
                  "log_every_n_steps"):
        if getattr(cfg, field) < 1:
            return (
                f"ServeConfig.{field} must be >= 1, got "
                f"{getattr(cfg, field)}"
            )
    if cfg.attention not in SERVE_ATTENTION_KERNELS:
        return (
            f"ServeConfig.attention {cfg.attention!r} unknown; "
            f"valid: {list(SERVE_ATTENTION_KERNELS)}"
        )
    if cfg.decode_kernel not in SERVE_DECODE_KERNELS:
        return (
            f"ServeConfig.decode_kernel {cfg.decode_kernel!r} "
            f"unknown; valid: {list(SERVE_DECODE_KERNELS)}"
        )
    for field in ("decode_pages_per_block", "decode_block_h"):
        v = getattr(cfg, field)
        if v is not None and v < 1:
            return f"ServeConfig.{field} must be >= 1 when set, got {v}"
        if v is not None and cfg.decode_kernel != "pallas":
            return (
                f"ServeConfig.{field}={v} set but decode_kernel="
                f"{cfg.decode_kernel!r} — only the pallas "
                f"streaming kernel reads the block knobs; set "
                f"decode_kernel='pallas' or drop the knob"
            )
    if cfg.prefill_chunk_tokens is not None:
        c = cfg.prefill_chunk_tokens
        if c < 1:
            return (
                f"ServeConfig.prefill_chunk_tokens must be >= 1, got {c}"
            )
        if c % cfg.prefill_pad_multiple:
            return (
                f"ServeConfig.prefill_chunk_tokens={c} must be a multiple "
                f"of prefill_pad_multiple={cfg.prefill_pad_multiple} — "
                f"chunk shapes ride the same bucket discipline that bounds "
                f"compiled-program count"
            )
        if c > cfg.max_seq_len:
            return (
                f"ServeConfig.prefill_chunk_tokens={c} exceeds "
                f"max_seq_len={cfg.max_seq_len} — no prompt could ever be "
                f"chunked"
            )
    if cfg.temperature < 0.0:
        return f"ServeConfig.temperature must be >= 0, got {cfg.temperature}"
    if cfg.top_k is not None and cfg.top_k < 1:
        return f"ServeConfig.top_k must be >= 1 when set, got {cfg.top_k}"
    if cfg.top_p is not None and not (0.0 < cfg.top_p <= 1.0):
        return (
            f"ServeConfig.top_p must be in (0, 1] when set, got {cfg.top_p}"
        )
    if not cfg.sampling and (
        cfg.temperature != 0.0 or cfg.top_k is not None
        or cfg.top_p is not None
    ):
        return (
            "ServeConfig sampling knobs set (temperature/top_k/top_p) but "
            "sampling=False — the greedy programs would silently ignore "
            "them; set sampling=True or drop the knobs"
        )
    if cfg.quant not in SERVE_QUANT_MODES:
        return (
            f"ServeConfig.quant {cfg.quant!r} unknown; valid: "
            f"{list(SERVE_QUANT_MODES)}"
        )
    if cfg.kv_dtype not in SERVE_KV_DTYPES:
        return (
            f"ServeConfig.kv_dtype {cfg.kv_dtype!r} unknown; "
            f"valid: {list(SERVE_KV_DTYPES)}"
        )
    if cfg.quant_chunk_elems < 1:
        return (
            f"ServeConfig.quant_chunk_elems must be >= 1, got "
            f"{cfg.quant_chunk_elems}"
        )
    if cfg.quant_min_size < 0:
        return (
            f"ServeConfig.quant_min_size must be >= 0 (leaves "
            f"below it stay unquantized), got {cfg.quant_min_size}"
        )
    if cfg.eos_id is not None and cfg.eos_id < 0:
        return (
            f"ServeConfig.eos_id must be a token id >= 0 when "
            f"set (None = run to the token cap), got {cfg.eos_id}"
        )
    if cfg.prefill_pad_multiple > cfg.max_seq_len:
        return (
            f"ServeConfig.prefill_pad_multiple "
            f"{cfg.prefill_pad_multiple} exceeds max_seq_len "
            f"{cfg.max_seq_len} — every padded prompt would be "
            f"rejected"
        )
    if cfg.kv_blocks is not None:
        need = -(-cfg.max_seq_len // cfg.kv_block_size) + 1
        if cfg.kv_blocks < need:
            return (
                f"ServeConfig.kv_blocks={cfg.kv_blocks} cannot "
                f"hold one max_seq_len={cfg.max_seq_len} sequence "
                f"(needs {need} blocks of {cfg.kv_block_size} "
                f"tokens incl. the reserved scratch block 0) — no "
                f"request could ever be admitted"
            )
    for field in ("slo_ttft_target_s", "slo_tpot_target_s"):
        v = getattr(cfg, field)
        if v is not None and not v > 0.0:
            return (
                f"ServeConfig.{field} must be > 0 seconds when "
                f"set, got {v} (None = requests carry their own "
                f"RequestSLO targets)"
            )
    k = cfg.speculative_k
    if k is not None:
        if k < 1:
            return (
                f"ServeConfig.speculative_k must be >= 1 when set (None = "
                f"speculative decoding off), got {k}"
            )
        if not cfg.sampling:
            return (
                f"ServeConfig.speculative_k={k} needs sampling=True — the "
                f"verify program rides the key-threaded sampling programs "
                f"(temperature=0.0 keeps exact greedy streams); set "
                f"sampling=True or drop speculative_k"
            )
        if (cfg.prefill_chunk_tokens is not None
                and k + 1 > cfg.prefill_chunk_tokens):
            return (
                f"ServeConfig.speculative_k={k} puts the verify query width "
                f"(k+1={k + 1}) over the chunk budget prefill_chunk_tokens="
                f"{cfg.prefill_chunk_tokens} — the multi-token programs "
                f"share that per-iteration bound; shrink speculative_k or "
                f"raise prefill_chunk_tokens"
            )
        if cfg.speculative_ngram_min < 1:
            return (
                f"ServeConfig.speculative_ngram_min must be >= 1, got "
                f"{cfg.speculative_ngram_min}"
            )
        if cfg.speculative_ngram_max < cfg.speculative_ngram_min:
            return (
                f"ServeConfig.speculative_ngram_max="
                f"{cfg.speculative_ngram_max} < speculative_ngram_min="
                f"{cfg.speculative_ngram_min} — the drafter's n-gram range "
                f"is empty"
            )
    elif cfg.speculative_ngram_max != 3 or cfg.speculative_ngram_min != 1:
        return (
            "ServeConfig speculative drafter knobs set "
            "(speculative_ngram_max/speculative_ngram_min) but "
            "speculative_k=None — the non-speculative engine would silently "
            "ignore them; set speculative_k or drop the knobs"
        )
    for field in ("verify_pages_per_block", "verify_block_h"):
        v = getattr(cfg, field)
        if v is None:
            continue
        if v < 1:
            return f"ServeConfig.{field} must be >= 1 when set, got {v}"
        if k is None:
            return (
                f"ServeConfig.{field}={v} set but speculative_k=None — only "
                f"the speculative verify kernel reads the verify block "
                f"knobs; set speculative_k or drop the knob"
            )
        if cfg.decode_kernel != "pallas":
            return (
                f"ServeConfig.{field}={v} set but decode_kernel="
                f"{cfg.decode_kernel!r} — the verify block knobs feed the "
                f"pallas verify kernel; set decode_kernel='pallas' or drop "
                f"the knob"
            )
    return None
