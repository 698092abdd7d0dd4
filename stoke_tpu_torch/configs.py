"""Configuration of the port: the option enums, every config class of the
JAX package (``ALL_CONFIG_CLASSES``), ``StokeOptimizer`` and
``asdict_config``.

Field names, types and defaults are those of ``stoke_tpu.configs``, so one
config describes a run in either package (and one YAML document builds
both: :mod:`stoke_tpu_torch.utils.yaml_config`). ``DeviceOptions`` is
``cpu`` or ``cuda`` where the JAX package has ``cpu`` or ``tpu``.

The port honours ``PrecisionConfig``, ``ClipGradConfig``,
``ClipGradNormConfig``, ``CheckpointConfig``, ``ServeConfig`` (read by
``Stoke.serve``), ``TensorboardConfig``, the data parallel configs,
``CommConfig`` and the telemetry configs (``TelemetryConfig``,
``TraceConfig``, ``HealthConfig``, ``ProfilerConfig``). Every other class
passes the JAX package's legality rules in
:class:`~stoke_tpu_torch.status.StokeStatus` and is then refused with ``NotImplementedError`` naming the ROADMAP item
that ports it, as each class's docstring says.

``ServeConfig`` describes a serve run. The port's
:class:`~stoke_tpu_torch.serving.ServingEngine` serves the greedy,
sampled and speculative paths (paged KV cache, continuous batching,
chunked prefill, ``attention`` "dense" or "flash", ``decode_kernel``
"reference" or "pallas"); weight quantization, SLO targets and cost cards
are kept so configs carry over, and the engine refuses them with
``NotImplementedError`` until their items land.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Optional, Sequence, Tuple


class DeviceOptions(Enum):
    """Compute device: the CPU, or the CUDA card."""

    cpu = "cpu"
    cuda = "cuda"


class DistributedOptions(Enum):
    """Distributed strategy: data parallelism over a process group, one
    device a process (:mod:`stoke_tpu_torch.parallel`)."""

    dp = "dp"


class PrecisionOptions(Enum):
    """Precision: ``full`` (fp32), ``bf16`` (fp32 master params, the model
    run in bfloat16) or ``fp16`` (the same in float16, with a dynamic loss
    scaler)."""

    full = "full"
    bf16 = "bf16"
    fp16 = "fp16"


class ShardingOptions(Enum):
    """The sharding ladder (ZeRO-1/2/3) that the ``oss``, ``sddp`` and
    ``fsdp`` flags select (:mod:`stoke_tpu_torch.parallel.sharding`)."""

    none = "none"
    oss = "oss"
    sddp = "sddp"
    fsdp = "fsdp"


class LossReduction(Enum):
    """How per-replica losses combine (``DataParallelConfig``)."""

    mean = "mean"
    sum = "sum"


class ParamNormalize(Enum):
    """Divisors for printing parameter counts
    (``Stoke.num_model_parameters``)."""

    BILLION = 1e9
    GIGA = 2**30
    KILO = 2**10
    MEGA = 2**20
    MILLION = 1e6
    THOUSAND = 1e3


class CheckpointFormat(Enum):
    """Checkpoint layouts: ``consolidated`` (one ``.npz`` a state key,
    written by one process) or ``sharded`` (every process writes its
    shards; not ported yet)."""

    consolidated = "consolidated"
    sharded = "sharded"


@dataclass
class PrecisionConfig:
    """Precision policy and loss-scaler tunables.

    Attributes:
        param_dtype: dtype of the master copy of the parameters.
        output_dtype: dtype the model's outputs are cast to under bf16.
        init_scale / growth_factor / backoff_factor / growth_interval /
            min_scale / num_losses: the fp16 loss scaler's
            (``num_losses > 1``, one scaler a loss, needs fp16).
    """

    param_dtype: str = "float32"
    output_dtype: str = "float32"
    init_scale: float = 2.0**16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    min_scale: float = 1.0
    num_losses: int = 1


@dataclass
class ClipGradConfig:
    """Clip gradients element-wise to ``[-clip_value, clip_value]``."""

    clip_value: float = 1.0


@dataclass
class ClipGradNormConfig:
    """Scale all gradients by ``min(1, max_norm / (norm + 1e-6))``, with
    ``norm`` their global ``norm_type``-norm (``inf``: the largest
    magnitude)."""

    max_norm: float = 1.0
    norm_type: float = 2.0


@dataclass
class CheckpointConfig:
    """How ``Stoke.save`` writes and when the step path saves on its own.

    Attributes:
        format: the layout: ``consolidated`` (the writer gathers every
            slice and writes whole leaves) or ``sharded`` (each rank
            writes its own slices, the writer the replicated leaves);
            either loads at any world size.
        max_to_keep: the newest tags of a name kept under a path; older
            ones are deleted after each save (None keeps all).
        async_save: copy the state to the host on the calling thread and
            write the files on a background thread
            (``Stoke.wait_for_checkpoint`` waits for it and raises its
            failure).
        save_every_n_steps / auto_path / auto_name: save under
            ``auto_path`` with the name ``auto_name`` after every
            ``save_every_n_steps`` optimizer steps (``Stoke.maybe_resume``
            loads the newest such tag).
        save_rank: the process that writes the whole leaves and
            ``meta.json`` (modulo the number of processes).
        offload_staging: stage an async consolidated save through pinned
            host buffers (a device-to-device copy, then asynchronous copies
            on a side stream; :func:`stoke_tpu_torch.offload.stage_tree`)
            instead of copying the state to the host on the step path.
    """

    format: CheckpointFormat = CheckpointFormat.consolidated
    max_to_keep: Optional[int] = None
    async_save: bool = False
    save_every_n_steps: Optional[int] = None
    auto_path: Optional[str] = None
    auto_name: str = "auto"
    save_rank: int = 0
    offload_staging: bool = False


class StokeOptimizer(dict):
    """An uninstantiated ``torch.optim`` optimizer: ``optimizer`` is its
    class (or any callable taking the parameters first) and
    ``optimizer_kwargs`` its keyword arguments. The facade builds it over
    the model's parameters.

    ``StokeOptimizer(torch.optim.AdamW, lr=3e-4)`` and
    ``StokeOptimizer(optimizer=torch.optim.AdamW,
    optimizer_kwargs={"lr": 3e-4})`` are the same; the keys are those of
    the JAX package's ``StokeOptimizer`` dict."""

    def __init__(self, optimizer: Callable[..., Any],
                 optimizer_kwargs: Optional[Dict[str, Any]] = None,
                 **kwargs):
        super().__init__(optimizer=optimizer,
                         optimizer_kwargs={**(optimizer_kwargs or {}),
                                           **kwargs})


#: the serving vocabularies ``ServeConfig`` takes (validated by the status
#: layer)
SERVE_ATTENTION_KERNELS: Tuple[str, ...] = ("dense", "flash")
SERVE_DECODE_KERNELS: Tuple[str, ...] = ("reference", "pallas")
SERVE_QUANT_MODES: Tuple[str, ...] = ("none", "bf16", "int8")
SERVE_KV_DTYPES: Tuple[str, ...] = ("float32", "bfloat16")


@dataclass
class ServeConfig:
    """Serving engine configuration (continuous batching over a paged KV
    cache).

    Attributes:
        max_seqs: decode slot count; every decode step runs this batch.
        kv_block_size: tokens per KV block.
        kv_blocks: blocks in the pool, scratch block 0 included; ``None``
            sizes it to ``max_seqs`` full-length sequences plus scratch.
        max_seq_len: per-request prompt + output cap.
        max_new_tokens: default per-request generation cap.
        prefill_pad_multiple: prompts are zero-padded to a multiple of this
            before prefill.
        attention: prefill attention, "dense" (causal bias, fp32 softmax)
            or "flash" (the flash forward kernel, ``causal=True``).
        decode_kernel: decode attention, "reference" (gather + einsum +
            softmax in PyTorch) or "pallas" (the paged-decode kernel; the
            name is the JAX package's, kept so one config means one path
            in both packages).
        kv_dtype: KV-cache storage dtype, "float32" or "bfloat16".
        eos_id: token id that finishes a request early (None = run to the
            cap).
        log_every_n_steps: engine iterations between gauge refreshes.
        decode_pages_per_block / decode_block_h / verify_pages_per_block /
            verify_block_h: the TPU kernels' block knobs; the CUDA kernels
            choose their own tiles, so the port refuses them.
        prefill_chunk_tokens, sampling, temperature, top_k, top_p,
            sampling_seed, quant, quant_chunk_elems, quant_stochastic,
            quant_min_size, slo_ttft_target_s, slo_tpot_target_s,
            speculative_k, speculative_ngram_max, speculative_ngram_min,
            cost_cards: features of later slices (see the JAX package's
            ``ServeConfig`` for their meaning).
    """

    max_seqs: int = 8
    kv_block_size: int = 16
    kv_blocks: Optional[int] = None
    max_seq_len: int = 512
    max_new_tokens: int = 64
    prefill_pad_multiple: int = 64
    attention: str = "dense"
    decode_kernel: str = "reference"
    decode_pages_per_block: Optional[int] = None
    decode_block_h: Optional[int] = None
    prefill_chunk_tokens: Optional[int] = None
    sampling: bool = False
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    sampling_seed: int = 0
    kv_dtype: str = "float32"
    quant: str = "none"
    quant_chunk_elems: int = 128
    quant_stochastic: bool = False
    quant_min_size: int = 1024
    eos_id: Optional[int] = None
    log_every_n_steps: int = 8
    slo_ttft_target_s: Optional[float] = None
    slo_tpot_target_s: Optional[float] = None
    speculative_k: Optional[int] = None
    speculative_ngram_max: int = 3
    speculative_ngram_min: int = 1
    verify_pages_per_block: Optional[int] = None
    verify_block_h: Optional[int] = None
    cost_cards: bool = False


# --------------------------------------------------------------------------- #
# data parallelism and the sharding ladder
# --------------------------------------------------------------------------- #


@dataclass
class DataParallelConfig:
    """Data-parallel knobs: the mesh axis batches and gradients shard over,
    cross-replica BatchNorm statistics, how per-replica losses combine, and
    an optional sequence-dimension sharding of the inputs over the mesh's
    ``seq_axis_name`` axis (``shard_seq_dim``: each process takes its
    ``seq`` slice of that dim of every batch leaf that has it and whose
    length the axis divides; :mod:`stoke_tpu_torch.ops.attention`). Under
    ``distributed="dp"`` the port's
    BatchNorm always takes the global batch's moments, as the JAX package
    does; ``sync_batch_stats`` and ``convert_to_sync_batchnorm`` inform
    only. ``loss_reduction`` is what ``Stoke.detach_and_sync_loss``
    applies."""

    axis_name: str = "data"
    sync_batch_stats: bool = True
    loss_reduction: LossReduction = LossReduction.mean
    convert_to_sync_batchnorm: bool = False
    shard_seq_dim: Optional[int] = None
    seq_axis_name: str = "seq"


#: wire dtypes of the gradient transport (validated by the status layer)
COMM_DTYPES: Tuple[str, ...] = ("fp32", "bf16", "int8")
#: collective schedules of the gradient transport
COMM_STRATEGIES: Tuple[str, ...] = ("rs_ag", "all_reduce")


@dataclass
class CommConfig:
    """The quantized gradient transport: wire ``dtype`` ("fp32"
    pass-through, "bf16" or "int8" with one fp32 scale a ``chunk_elems``
    chunk), ``bucket_mb`` flat buckets, error feedback, the ``strategy``
    ("rs_ag" or "all_reduce") and whether updates are sharded
    (``shard_updates``; None resolves from the tier, see
    :func:`comm_shard_updates`). Needs ``distributed='dp'``; run by
    :mod:`stoke_tpu_torch.parallel.collectives` and ``parallel.zero``."""

    dtype: str = "fp32"
    bucket_mb: float = 25.0
    error_feedback: bool = True
    strategy: str = "rs_ag"
    chunk_elems: int = 512
    stochastic_rounding: bool = True
    shard_updates: Optional[bool] = None


def comm_shard_updates(cfg: Optional["CommConfig"],
                       tier: "ShardingOptions") -> bool:
    """``CommConfig.shard_updates`` resolved against the sharding tier:
    True when the apply boundary would run the sharded weight-update path
    (sddp and fsdp by default), False for the replicated exchange, and
    always False without a lossy transport (no config, or fp32)."""
    if cfg is None or cfg.dtype == "fp32":
        return False
    if cfg.shard_updates is not None:
        return bool(cfg.shard_updates)
    return tier in (ShardingOptions.sddp, ShardingOptions.fsdp)


@dataclass
class MeshConfig:
    """The device mesh: axis names, devices per axis (``-1`` inferred,
    None ``(n, 1, ...)``), an explicit device list and the axes that cross
    hosts. Needs ``distributed='dp'``. The port builds a ``DeviceMesh`` of
    these axes over the process group (one device a process, so
    ``devices`` must be None), with a data axis of 1 in front when
    ``axes`` lacks it (:func:`stoke_tpu_torch.parallel.mesh.build_mesh`).
    ``dcn_axes`` is accepted and has no effect, as in the JAX package:
    the launcher orders the ranks and NCCL picks each pair's
    transport."""

    axes: Tuple[str, ...] = ("data",)
    shape: Optional[Tuple[int, ...]] = None
    devices: Optional[Any] = None
    dcn_axes: Tuple[str, ...] = ()


@dataclass
class DistributedInitConfig:
    """Multi-process rendezvous (coordinator address, process count and
    id, local devices, timeout). The port's counterpart is
    ``torch.distributed.init_process_group`` at
    ``tcp://coordinator_address`` (:func:`stoke_tpu_torch.parallel.mesh
    .initialize_distributed`); ``local_device_ids`` names the one device
    of the process; ``auto_initialize=False`` leaves the group to the
    caller."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[Sequence[int]] = None
    initialization_timeout: int = 300
    auto_initialize: bool = True


@dataclass
class OSSConfig:
    """Optimizer-state sharding (ZeRO-1): leaves under ``min_shard_size``
    elements stay replicated."""

    min_shard_size: int = 2**10


@dataclass
class SDDPConfig:
    """Gradient and optimizer-state sharding (ZeRO-2): leaves under
    ``min_shard_size`` elements keep a replicated gradient buffer;
    ``broadcast_buffers`` is a parity field with no effect."""

    min_shard_size: int = 2**10
    broadcast_buffers: bool = True


@dataclass
class FSDPConfig:
    """Fully sharded parameters (ZeRO-3): parameters under
    ``min_weight_size`` stay replicated; ``shard_axis_preference``
    "largest" or "first". ``reshard_after_forward`` is a parity field: the
    port gathers the whole model before a micro-step's forward and frees
    it after its backward."""

    min_weight_size: int = 2**10
    shard_axis_preference: str = "largest"
    reshard_after_forward: bool = True


@dataclass
class PartitionRulesConfig:
    """Tensor-parallel partition rules, ``(path_regex, spec)`` pairs with
    one mesh axis name (or None, or a tuple of names, or "...") per
    dimension, matched against each parameter's JAX leaf path. Needs
    ``distributed='dp'``; the port splits the Megatron, expert and stage
    sets over their axes and gathers any other placement, on any mesh
    axis, before each use (:mod:`stoke_tpu_torch.parallel.tensor`); a
    placement on the data or seq axis averages its slice's gradient over
    that axis in the backward, and wins over the tier there."""

    rules: Tuple[Tuple[str, Tuple], ...] = ()


# --------------------------------------------------------------------------- #
# offload and activation checkpointing
# --------------------------------------------------------------------------- #


@dataclass
class OffloadOptimizerConfig:
    """Optimizer state kept in pinned host memory between steps (ZeRO
    offload) and streamed through the card at the update
    (:class:`stoke_tpu_torch.offload.HostOptimizerState`). ``pin_memory``
    is a parity field: the host state is always pinned. On the CPU there is
    no host tier: ``fallback_to_device`` warns and keeps the state where it
    is, else the status layer refuses the run."""

    pin_memory: bool = True
    fallback_to_device: bool = True


@dataclass
class OffloadParamsConfig:
    """fsdp-sharded parameters kept in pinned host memory between steps
    (ZeRO-3 offload; needs ``fsdp=True``): this rank's slices return to the
    card for a forward's gather and leave after the optimizer step.
    ``pin_memory`` is a parity field (always pinned); on the CPU,
    ``fallback_to_device`` warns and keeps them where they are."""

    pin_memory: bool = True
    fallback_to_device: bool = True


@dataclass
class OffloadDiskConfig:
    """Optimizer state spilled to memory-mapped files under ``path`` (or a
    temp dir) between steps, its device memory freed (one offload tier:
    exclusive with ``OffloadOptimizerConfig``;
    :class:`stoke_tpu_torch.offload.DiskOptimizerStore`). The spill is file
    IO, so on the card a window runs its steps uncaptured."""

    path: Optional[str] = None


#: the rematerialization policies ``ActivationCheckpointingConfig`` names
#: (the JAX package's ``jax.checkpoint_policies`` members it documents)
REMAT_POLICIES: Tuple[str, ...] = (
    "nothing_saveable", "dots_saveable", "dots_with_no_batch_dims_saveable",
    "everything_saveable",
)


@dataclass
class ActivationCheckpointingConfig:
    """Rematerialization of the model step under a saving ``policy`` (one
    of :data:`REMAT_POLICIES`; :mod:`stoke_tpu_torch.remat`). The
    recompute replays the dropout masks its forward drew from the Stoke
    generator. ``prevent_cse`` is a parity field: eager PyTorch has no
    common-subexpression pass to prevent."""

    policy: str = "nothing_saveable"
    prevent_cse: bool = True


# --------------------------------------------------------------------------- #
# observability: TensorBoard, telemetry, tracing, health and the profiler
# and the observatories, the fleet and the ops plane (all honoured)
# --------------------------------------------------------------------------- #


@dataclass
class TensorboardConfig:
    """TensorBoard scalars, honoured: ``Stoke`` writes the loss metrics
    (``loss/ema``, ``loss/micro``, under fp16 the loss scale and skipped
    steps, ``counters/backward_steps``) every ``log_every_n_steps``
    optimizer steps on rank 0 into ``output_path/job_name``
    (:class:`~stoke_tpu_torch.utils.tb_writer.TBEventWriter`), and
    ``Stoke.log_scalar`` writes user scalars. The device-to-host reads
    happen at that cadence only."""

    output_path: str = "tensorboard"
    job_name: str = "stoke"
    log_every_n_steps: int = 10


@dataclass
class TelemetryConfig:
    """The telemetry pipeline: a metrics registry drained every
    ``log_every_n_steps`` into JSONL step events, a Prometheus file and a
    TensorBoard stream under ``output_dir``, with device-time samples,
    gradient norms, compile and memory tracking and profiler annotations
    (:class:`stoke_tpu_torch.telemetry.Telemetry`; compiles are the
    port's kernel builds and CUDA-graph captures)."""

    output_dir: str = "telemetry"
    run_name: str = "stoke"
    log_every_n_steps: int = 10
    jsonl: bool = True
    jsonl_all_ranks: bool = False
    prometheus: bool = True
    prometheus_all_ranks: bool = False
    tensorboard: bool = False
    sample_device_time: bool = True
    grad_norm: bool = False
    track_compiles: bool = True
    track_hbm: bool = True
    xprof_annotations: bool = True


@dataclass
class TraceConfig:
    """Host span tracing into a ring of ``ring_size`` spans, exported as
    ``trace.rank<N>.json`` under ``output_dir``
    (:class:`stoke_tpu_torch.telemetry.tracing.TraceRecorder`)."""

    output_dir: str = "trace"
    ring_size: int = 4096
    export_on_close: bool = True


#: actions a health detector may take when it fires
HEALTH_ACTIONS: Tuple[str, ...] = ("record", "warn", "dump", "halt")


@dataclass
class HealthConfig:
    """The training health monitor: per-step numerics sentinels, spike,
    non-finite, scaler-skip, recompile-storm, starvation and residual
    detectors (each with an action of :data:`HEALTH_ACTIONS`), a flight
    recorder and a hang watchdog
    (:class:`stoke_tpu_torch.telemetry.health.HealthMonitor`)."""

    sentinels: bool = True
    ring_size: int = 256
    bundle_dir: Optional[str] = None
    detector_warmup_steps: int = 20
    ema_alpha: float = 0.02
    loss_spike_zscore: float = 6.0
    loss_spike_action: str = "warn"
    grad_spike_zscore: float = 6.0
    grad_spike_action: str = "warn"
    nonfinite_action: str = "dump"
    scaler_skip_streak: int = 8
    scaler_skip_action: str = "warn"
    recompile_storm_threshold: int = 3
    recompile_storm_window: int = 20
    recompile_storm_action: str = "warn"
    starvation_streak: int = 5
    starvation_action: str = "record"
    comm_residual_factor: float = 10.0
    comm_residual_action: str = "warn"
    max_dumps: int = 3
    dump_on_exception: bool = True
    dump_signals: bool = True
    watchdog: bool = False
    watchdog_timeout_s: float = 300.0
    watchdog_compile_grace_s: float = 600.0
    watchdog_kill: bool = False


@dataclass
class AttributionConfig:
    """Step-time attribution: MFU and roofline gauges against
    ``peak_tflops`` / ``peak_hbm_gbps`` / ``ici_gbps``, a goodput ledger
    and anomaly-triggered profiler captures. Needs a ``TelemetryConfig``
    (:mod:`stoke_tpu_torch.telemetry.attribution`)."""

    peak_tflops: float = 0.0
    peak_hbm_gbps: float = 0.0
    ici_gbps: float = 0.0
    ema_alpha: float = 0.1
    auto_capture: bool = False
    capture_mfu_below: float = 0.0
    capture_step_zscore: float = 4.0
    capture_warmup_windows: int = 5
    capture_steps: int = 2
    max_captures: int = 3
    capture_action: str = "record"


#: actions of the straggler detector ("halt" is excluded: a slow host is
#: a diagnosis)
FLEET_ACTIONS: Tuple[str, ...] = ("record", "warn", "dump")


@dataclass
class FleetConfig:
    """Fleet observability: a cross-host exchange every ``window_steps``
    optimizer steps, straggler detection and skew-reactive input
    rebalancing (``rebalance``). Needs a ``TelemetryConfig``
    (:mod:`stoke_tpu_torch.telemetry.fleet`; the rebalancer is
    :class:`stoke_tpu_torch.data.InputRebalancer`)."""

    window_steps: int = 10
    straggler_zscore: float = 3.0
    straggler_rel_frac: float = 0.25
    straggler_windows: int = 3
    straggler_action: str = "warn"
    rebalance: bool = False
    rebalance_rows: int = 1
    rebalance_max_frac: float = 0.25


@dataclass
class NumericsConfig:
    """The per-layer numerics observatory: per-module gradient and update
    statistics, NaN provenance and quantization-error attribution. Needs a
    ``TelemetryConfig`` (:mod:`stoke_tpu_torch.telemetry.numerics`)."""

    grad_stats: bool = True
    provenance_action: str = "warn"
    wire_error: bool = True
    per_group_jsonl: bool = True
    top_k: int = 5


@dataclass
class MemoryConfig:
    """The device-memory observatory: a per-subsystem ledger, an OOM
    pre-flight at ``oom_margin_frac`` of ``capacity_bytes`` (None reads
    the device) and per-program peaks. Needs a ``TelemetryConfig``
    (:mod:`stoke_tpu_torch.telemetry.memory`)."""

    oom_margin_frac: float = 0.9
    capacity_bytes: Optional[int] = None
    program_peaks: bool = True
    preflight: bool = True


@dataclass
class OpsPlaneConfig:
    """The live ops plane: a read-only HTTP observatory on ``host:port +
    rank`` (metrics, health, status, requests, trace, bounded profiles).
    Needs a ``TelemetryConfig`` (:mod:`stoke_tpu_torch.telemetry.opsplane`)."""

    port: int = 9200
    host: str = "127.0.0.1"
    profile_default_seconds: float = 2.0
    profile_max_seconds: float = 30.0
    requests_limit: int = 256


@dataclass
class ProfilerConfig:
    """Profiling: traces into ``trace_dir``, a FLOP estimate of the step
    and per-phase host timing of the facade's calls. The port's profiler
    is ``torch.profiler`` (``Stoke.profile_trace``)."""

    trace_dir: Optional[str] = None
    flops_estimate: bool = False
    wall_clock_breakdown: bool = False


# --------------------------------------------------------------------------- #
# resilience and the compile cache (ROADMAP item 11)
# --------------------------------------------------------------------------- #


@dataclass
class ResilienceConfig:
    """Preemption-aware emergency checkpoints under ``save_path``, digest
    manifests, verified resume with quarantine, and the ``STOKE_CHAOS``
    fault injector (``chaos`` overrides the variable)
    (:mod:`stoke_tpu_torch.resilience`). Its SIGTERM disposition (drain
    and save) supersedes the flight recorder's dump-and-die one."""

    save_path: str = "resilience_ckpts"
    save_name: str = "emergency"
    preempt_signals: Tuple[str, ...] = ("SIGTERM",)
    exit_code: int = 114
    exit_on_preempt: bool = True
    manifest: bool = True
    verify_on_resume: bool = True
    quarantine: bool = True
    max_to_keep: Optional[int] = 3
    chaos: Optional[str] = None


@dataclass
class CompileConfig:
    """The persistent compile cache under ``cache_dir``
    (:mod:`stoke_tpu_torch.compile_cache`): with ``xla_cache`` the kernel
    libraries are built into ``<cache_dir>/kernels`` and loaded from there
    by later processes (builds under ``min_compile_time_s`` seconds are
    not kept); with ``aot`` each library a process loads is booked: a
    hit, crediting its recorded build seconds, where it was there, a miss
    where the process built it. ``serialize_executables`` is
    accepted without effect: a CUDA graph cannot be serialised, and the
    kernel library is already the artifact."""

    cache_dir: str = "compile_cache"
    aot: bool = True
    xla_cache: bool = True
    serialize_executables: bool = True
    min_compile_time_s: float = 0.0


#: every config class the status layer takes, by class name (the JAX
#: package's tuple, in its order)
ALL_CONFIG_CLASSES: Tuple[type, ...] = (
    AttributionConfig,
    PrecisionConfig,
    ClipGradConfig,
    ClipGradNormConfig,
    CommConfig,
    CompileConfig,
    DataParallelConfig,
    MeshConfig,
    DistributedInitConfig,
    OSSConfig,
    SDDPConfig,
    FSDPConfig,
    OffloadOptimizerConfig,
    OffloadParamsConfig,
    OffloadDiskConfig,
    PartitionRulesConfig,
    ActivationCheckpointingConfig,
    CheckpointConfig,
    FleetConfig,
    HealthConfig,
    MemoryConfig,
    NumericsConfig,
    OpsPlaneConfig,
    ProfilerConfig,
    ResilienceConfig,
    ServeConfig,
    TelemetryConfig,
    TensorboardConfig,
    TraceConfig,
)


def asdict_config(cfg: Any) -> Dict[str, Any]:
    """A config dataclass as a plain dict with enums by value."""
    if cfg is None:
        return {}
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = v.value if isinstance(v, Enum) else v
    return out
