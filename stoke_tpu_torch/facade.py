"""The ``Stoke`` facade of the port: one device, or one device a process
of a data-parallel run.

Counterpart of ``stoke_tpu/facade.py``: the constructor (``:229-804``, the
parts the port takes), the four-call contract and ``train_step``
(``:973-1278``), ``train_step_window`` and ``train_steps``
(``:2446-2729``) with the segment memory guard (``:94-115``), ``reset``
(``:2731``), loss tracking and its helpers (``:2743-2838``), the rank and
print helpers (``:2840-2907``), ``estimate_step_flops`` (``:2972``),
``DataLoader`` (``:3047-3101``, with a sampler), TensorBoard metrics and
``log_scalar`` (``:1281-1346``), ``serve`` (``:3103``), checkpoints
(``save``, ``load``, ``maybe_resume``, ``wait_for_checkpoint`` and the
periodic auto-save, ``:1869-1915``, ``:3219-3398``), ``print_status``
(``:3399``), the counters, flags, loss scale and configuration accessors
(``:3440-3581``), the parameter counts (``:3602-3628``), and the
telemetry, tracing and health surface: the constructor's blocks
(``:439-468``, ``:510-600``), ``_health_guarded`` (``:133-176``) on every
step path, the device-time sample at the logging cadence, the step events
(``:1746``), ``health``, ``tracer``, ``trace_summary``, ``export_trace``
(``:1551-1640``), ``dispatch_count`` (``:1731``), ``close_telemetry``
(``:1822``), the wall-clock breakdown and ``profile_trace``
(``:2901-2970``).

The JAX facade defers the forward (``model()`` returns a
``DeferredOutput``; forward, loss and grad run fused in ``loss()``)
because JAX must trace them together. The port does what PyTorch does:

- ``model()`` runs the forward eagerly under autograd and returns it;
- ``loss()`` returns the losses divided by ``grad_accum``;
- ``backward()`` runs autograd into the accumulated fp32 gradients;
- ``step()`` applies at the accumulation boundary, and before it does
  nothing.

``train_step(model_args, loss_args)`` computes the same as the four calls,
``train_step_window`` a whole accumulation window and ``train_steps`` n
of them (on the card each window is a replayed CUDA graph:
``StepEngine.window``). In eval mode ``model()`` runs under
``torch.no_grad()``; train and eval are the module's mode bit.

Under fp16, ``loss()`` keeps the objective and ``backward()`` runs it
times the dynamic loss scale (or, with per-loss scalers, one seeded
backward a loss); the apply unscales, skips a step whose gradients are
not finite and updates the scale (``StepEngine.apply``).

A checkpoint (:mod:`stoke_tpu_torch.io_ops`) holds the module's state
dict (the fp32 masters and the buffers), the optimizer's state keyed by
parameter name, the scaler state, the three counters, the masters'
gradients when saved mid-window, and the dropout generator's state.
``load`` copies into the live tensors, so a window captured as a CUDA
graph replays from the loaded state. Across processes every rank takes
part in ``save``, ``load``, ``maybe_resume`` and the periodic auto-save:
the consolidated format gathers the slices of oss, sddp and fsdp to
whole leaves and ``CheckpointConfig.save_rank`` writes them; the sharded
format has every rank write its own slices. Either loads at any world
size, and in one process. As in the JAX package, a plain save does not
hold the gradient transport's error-feedback residual or its key (a run
resumed from one with a ``CommConfig`` starts from a zero residual and
the initial key); an emergency save's extras do (below).

``distributed="dp"`` joins a process group (the launcher's, an explicit
``DistributedInitConfig`` rendezvous, or a one-process group;
:mod:`stoke_tpu_torch.parallel.mesh`), drives ``cuda:LOCAL_RANK``, and
runs the tier the ``oss`` / ``sddp`` / ``fsdp`` flags select through the
step engine's :class:`~stoke_tpu_torch.parallel.ladder.Ladder`, with the
gradient transport of a ``CommConfig`` at its apply
(:mod:`stoke_tpu_torch.parallel.collectives`). Rank 0's
parameters and buffers are broadcast at construction. Each rank draws
its dropout masks from its own seed (``seed + rank``): the JAX package
draws one mask over the global batch, so the masks cannot match its bit
for bit. The losses ``loss()`` reports are the global batch's.

Tensor and expert parallelism: a mesh of model or expert axes beside
the data axis (``("data", "model")``, ``("data", "model", "expert")``,
``("model", "expert")`` built with a data axis of 1 in front, a ``seq``
axis beside them) with a ``PartitionRulesConfig`` whose rules name them
(the Megatron rules of ``bert_tensor_parallel_rules``,
``moe_expert_parallel_rules``, or any other placement on those axes, a
gathered placement) cuts the whole model, after the broadcast, into this
process's slices (:func:`~stoke_tpu_torch.parallel.tensor
.apply_partition_rules`, one group a mesh axis); the ladder then runs
over the data sub-group, each rank's generator is seeded by its data
coordinate (``seed + data rank``; under ``seq``'s sharded view by its
place in the (data, seq) plane: a model group draws the same masks),
``DataLoader`` shards a ``BucketedDistributedSampler`` built with the
world's defaults by the data coordinate, the parameter counts and
``dump_model_parameter_info`` report the whole model, and a consolidated
save gathers the slices into the whole arrays (the tag a dp run of the
same parameters writes), which ``load`` cuts again. A model's auxiliary
losses (MoE) join the objective as ``aux_loss_weight * sum(aux)``;
``aux_losses`` holds the last forward's, and no checkpoint does.

Under any mesh of several axes the tiers shard over the data axis alone,
as the JAX rules place them (under ``seq``'s sharded view the ladder
also averages over the data row), a ``CommConfig`` packs the JAX
package's global leaves and exchanges over the data sub-group, and the
sharded format writes each slice once with the mesh and a placed leaf's
cut in its layout. ``MeshConfig.dcn_axes`` is accepted and changes
nothing, as in the JAX package. On every such mesh the rows go by the
data coordinate (``DataLoader``), and ``FleetConfig(rebalance=True)``
takes the data rows for its hosts, as a JAX host owns whole data-axis
shards: the straggler verdict runs on the exchanged matrix folded to one
entry a row (:func:`~stoke_tpu_torch.telemetry.fleet.reduce_to_rows`),
and the read payloads go over the data sub-group, so each process of a
row reads the same share and yields the same rows.

Sequence parallelism: on a mesh with a ``seq`` axis (``("data",
"seq")``, or beside a model axis) each call runs under a view of the
sequence (:mod:`stoke_tpu_torch.ops.attention`), which GPT's positions,
the causal LM loss and the ring, zigzag and Ulysses adapters read.

- With ``DataParallelConfig(shard_seq_dim=d)`` each input's dim ``d`` is
  cut to this process's shard (the sharded view), the layout the
  model's attention needs (zigzag for the zigzag ring); the ladder
  averages over the data sub-group and then over the data row. A call
  whose inputs the shards do not divide keeps every leaf whole and runs
  under the global view, as the JAX placement leaves such a leaf whole;
  the model's outputs carry their view, so ``loss()`` neither cuts them
  again nor mixes views. Under that view the gradients are equal across
  the row, and the row's average keeps them (with dropout the masks are
  each process's own there).
- Without it (the JAX facade's batch sharded over ``data`` only) every
  process of a data row runs the model on the row's whole sequences and
  computes the same values (the global view): the adapters take their
  block at the JAX ``shard_map`` boundary and gather the output. The
  ladder runs over the data sub-group alone, the generator is seeded by
  the data coordinate and an MoE's batch means go over the data
  sub-group, so a row's processes hold bit-equal weights. Zigzag there
  takes what the JAX one takes: zigzag-ordered sequences with
  ``positions=perm``.

Pipeline parallelism: a ``("data", "stage")`` mesh, or a ``("stage",)``
one (built as ``(1, n)``: every process takes the same rows), with
``pipeline_parallel_rules`` cuts a ``PipelinedLM``'s stage-stacked
tensors to this rank's ``stages[d::S]`` and gives the model its stage
group, the same way; the processes of one data row take the same rows.
Beside a model axis (``("data", "stage", "model")``) a rule that also
places a stacked leaf on ``model`` cuts it in a second level, gathered
over the model group before each forward.

``TelemetryConfig`` writes ``steps.jsonl`` (the JAX step-event schema),
``metrics.prom`` and a TensorBoard stream under its ``output_dir`` at its
cadence; ``TraceConfig`` keeps a ring of host spans (``stoke/<phase>`` on
the facade track, ``stoke/accum`` / ``stoke/dispatch`` / ``stoke/step`` on
the step track, ``stoke/io`` for the loader and checkpoints) exported as
``trace.rank<N>.json``; ``HealthConfig`` computes the sentinel row in every
apply (a replayed window's too), runs the detectors on it once the call's
rows are read back (one readback a call), writes post-mortem bundles and
arms the hang watchdog across each step call; ``ProfilerConfig.trace_dir``
is where :meth:`profile_trace` writes ``torch.profiler`` traces. Without
these configs no sink, recorder, tracer or snapshot exists and the device
work is the same.

``ResilienceConfig`` installs the preemption handlers
(:class:`~stoke_tpu_torch.resilience.ResilienceMonitor`): at every
optimizer-step boundary (after a call's steps, its telemetry and its
periodic save) the facade drives the fault injector and, when a notice
arrived, drains the async saves and writes an emergency checkpoint whose
extras hold the generator state, the loss EMA, the skipped steps and the
error-feedback residual with its layout, then exits with the resumable
code or raises :class:`~stoke_tpu_torch.resilience.PreemptedError`. Every
save then carries a digest manifest with the run's
:meth:`topology_descriptor`, and :meth:`resume` restores the newest tag
that verifies (the emergency root first), quarantining the others; a
residual saved at another world size or transport kind is remapped
(:func:`~stoke_tpu_torch.parallel.zero.remap_residual`). Across processes
rank 0 picks the tag and broadcasts it, and each boundary all-reduces the
preemption flag.

``OffloadOptimizerConfig`` keeps the optimizer state in pinned host memory
between steps and streams it through the card at the update;
``OffloadDiskConfig`` spills it to files between steps (its windows run
uncaptured); ``OffloadParamsConfig`` keeps fsdp's parameter slices in
pinned host memory between steps (:meth:`Ladder.offload_params
<stoke_tpu_torch.parallel.ladder.Ladder.offload_params>`);
``CheckpointConfig(offload_staging=True)`` stages an async save through
pinned buffers (:mod:`stoke_tpu_torch.offload`). On the CPU the host
tiers have nothing to offload to: with ``fallback_to_device`` they warn
and the state stays where it is.

The observatories: ``AttributionConfig`` (cost cards counted at each
program's first run, MFU and bandwidth gauges, goodput, auto-captured
profiles; :meth:`Stoke.estimate_step_cost`), ``NumericsConfig`` (per-group
statistics computed in the apply, NaN provenance, the wire and int8
errors by group; :meth:`Stoke.numerics_summary`) and ``MemoryConfig``
(the device-memory ledger, program peaks and the OOM pre-flight;
:attr:`Stoke.memory_summary`). ``ActivationCheckpointingConfig`` recomputes
the training forward in backward (:mod:`stoke_tpu_torch.remat`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import math
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils._pytree import tree_leaves, tree_map

from stoke_tpu_torch import io_ops, offload
from stoke_tpu_torch.configs import (
    CheckpointConfig,
    CheckpointFormat,
    comm_shard_updates,
    ClipGradConfig,
    ClipGradNormConfig,
    DeviceOptions,
    DistributedOptions,
    LossReduction,
    ParamNormalize,
    PrecisionConfig,
    PrecisionOptions,
)
from stoke_tpu_torch.data import StokeDataLoader, place
from stoke_tpu_torch.engine import PrecisionPolicy, StepEngine, build_optimizer
from stoke_tpu_torch.models.bert import Dropout, LayerDrop
from stoke_tpu_torch.models.moe import MoEFFN
from stoke_tpu_torch.models.resnet import BatchNorm
from stoke_tpu_torch.ops.attention import (
    SeqShard,
    model_seq_layout,
    sharded,
    using_seq_shard,
)
from stoke_tpu_torch.parallel.ladder import Ladder, gather_by_rank
from stoke_tpu_torch.parallel.mesh import (
    axis_coordinates,
    build_mesh,
    initialize_distributed,
    local_rank,
    one_process_group,
)
from stoke_tpu_torch.parallel.sharding import make_sharding_rules
from stoke_tpu_torch.parallel.tensor import (
    TensorParallel,
    apply_partition_rules,
)
from stoke_tpu_torch.serving.engine import resolve_device
from stoke_tpu_torch.parallel.zero import make_transport, remap_residual
from stoke_tpu_torch.resilience import (
    ResilienceMonitor,
    find_latest_valid_checkpoint,
    list_checkpoints,
    read_manifest,
)
from stoke_tpu_torch.status import StokeStatus, StokeValidationError
from stoke_tpu_torch.telemetry import Telemetry
from stoke_tpu_torch.telemetry.fleet import timed_sync
from stoke_tpu_torch.telemetry.health import (
    SENTINEL_INDEX,
    HealthHaltError,
    HealthMonitor,
    leaf_path_names,
    unpack_sentinels,
)
from stoke_tpu_torch.telemetry.recorder import FlightRecorder
from stoke_tpu_torch.telemetry.tracing import (
    TraceRecorder,
    register_recorder,
    trace_span,
    unregister_recorder,
)
from stoke_tpu_torch.utils.printing import unrolled_print
from stoke_tpu_torch.utils.tb_writer import TBEventWriter
from stoke_tpu_torch.utils.trees import tree_count_params

#: param-group keys that say how an optimizer runs on this device, not
#: what it computes; ``load`` keeps the live values
_DEVICE_FLAGS = ("capturable", "foreach", "fused", "differentiable")


def _device_memory_stats(device: torch.device) -> Optional[dict]:
    """``{"bytes_limit", "bytes_in_use"}`` of a CUDA device from
    ``torch.cuda.mem_get_info``; None on the CPU, which has no stats."""
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    return {"bytes_limit": total, "bytes_in_use": total - free}


def _check_segment_memory(seg_bytes: int, stats: Optional[dict]) -> None:
    """Raise an actionable error when a ``train_steps`` segment obviously
    cannot fit in device memory (the JAX facade's guard): only the stacked
    inputs that still have to reach the device are counted, and the guard
    fires when they alone exceed 90% of free memory. No stats, no guard."""
    if not stats:
        return
    limit = stats.get("bytes_limit")
    if not limit:
        return
    free = limit - stats.get("bytes_in_use", 0)
    if seg_bytes > 0.9 * free:
        raise ValueError(
            f"Stoke -- train_steps() segment stacks {seg_bytes / 1e9:.2f} GB "
            f"of inputs but the device has only {free / 1e9:.2f} GB free "
            f"(limit {limit / 1e9:.2f} GB). Pass segment_size=<c> to stream "
            f"the segment host->device in chunks of c optimizer steps, or "
            f"stack fewer steps per call."
        )


def _timed(phase: str):
    """Method decorator feeding the wall-clock breakdown (``facade/<phase>_s``
    and, with a ``TraceConfig``, a ``stoke/<phase>`` span); one null context
    when neither is on."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            with self._clock(phase):
                return fn(self, *args, **kwargs)

        return wrapper

    return deco


def _health_guarded(fn):
    """Method decorator for the step paths (the JAX facade's): arms the
    hang watchdog across the call, which ends with the sentinel readback
    (an eager step returns before the card finishes; the readback waits
    for it), and writes a post-mortem bundle when the call dies on an
    uncaught exception. Nothing without a ``HealthConfig``."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        h = self._health
        if h is None:
            return fn(self, *args, **kwargs)
        h.arm_watchdog()
        try:
            return fn(self, *args, **kwargs)
        except HealthHaltError:
            raise  # the halt path already dumped its bundle
        except Exception as e:
            # one bundle per exception (nested guarded calls re-raise
            # through several wrappers), at most max_dumps a run
            if (
                h.cfg.dump_on_exception
                and not getattr(e, "_stoke_health_dumped", False)
                and h.note_exception_dump()
            ):
                try:
                    e._stoke_health_dumped = True
                except Exception:
                    pass
                h.dump(
                    "exception",
                    extra={"method": fn.__name__, "error": repr(e)[:500]},
                )
            raise
        finally:
            h.disarm_watchdog()

    return wrapper


def _leading(tree, sl: slice):
    """``tree`` with ``sl`` applied to the leading axis of each leaf that
    has one."""
    return tree_map(
        lambda t: t[sl] if getattr(t, "shape", ()) else t, tree)


class Stoke:
    """Declarative training over one ``nn.Module`` on one device.

    Args:
        model: the ``nn.Module``; it is moved to the device and its
            floating parameters to ``PrecisionConfig.param_dtype``.
        optimizer: a :class:`~stoke_tpu_torch.configs.StokeOptimizer`.
        loss: ``loss(model_output, *loss_args)`` -> a scalar, or a tuple,
            list or dict of scalars.
        params: a state dict to load into ``model``, or None to keep the
            module's own parameters.
        batch_size_per_device: micro-batch size (``DataLoader`` batches).
        grad_accum: micro-batches per optimizer step (None = 1).
        grad_clip: ``ClipGradConfig``, ``ClipGradNormConfig`` or None.
        device: "cuda" (default; raises when there is no card) or "cpu".
            Under ``distributed`` the card is ``cuda:LOCAL_RANK``.
        distributed: None, or "dp" (and the JAX package's aliases): data
            parallelism over a process group, one device a process
            (NCCL on the card, gloo on the CPU).
        oss / sddp / fsdp: the sharding tier under ``distributed``
            (ZeRO-1/2/3; :mod:`stoke_tpu_torch.parallel.sharding`).
        precision: None/"full", "bf16" (the whole model in bfloat16 over
            fp32 master parameters) or "fp16" (in float16, with the dynamic
            loss scaler of ``PrecisionConfig``).
        configs: objects of the JAX package's config classes
            (``configs.ALL_CONFIG_CLASSES``). Honoured: ``PrecisionConfig``,
            ``CheckpointConfig`` (how ``save`` writes, the periodic
            auto-save), ``ServeConfig`` (what ``serve`` builds),
            ``TensorboardConfig`` (the loss metrics and ``log_scalar``),
            the data parallel ones and ``CommConfig``,
            ``TelemetryConfig``, ``TraceConfig``, ``HealthConfig`` and
            ``ProfilerConfig``, and ``ResilienceConfig`` and the three
            offload configs; the status layer refuses the others, naming
            their ROADMAP item. A YAML document or dict builds the
            same run through
            :func:`stoke_tpu_torch.utils.yaml_config.stoke_from_config`.
        model_train_kwargs / model_eval_kwargs: keyword arguments the
            forward gets in train / eval mode (only when given).
        loss_weights: weights shaped like the loss result; the objective
            is ``sum(w_i * loss_i)``, the reported losses stay unweighted.
        aux_loss_weight: the weight of the model's auxiliary losses (an
            MoE block's load-balancing term) in the objective,
            ``aux_loss_weight * sum(aux)`` (0 leaves them out; default
            0.01, the Switch Transformer's); ``aux_losses`` holds them.
        seed: seeds the ``torch.Generator`` that draws the model's
            dropout masks (each :class:`~stoke_tpu_torch.models.bert
            .Dropout` of the model uses it, and an MoE router's noise);
            rank ``r`` of a data-parallel run seeds it with ``seed + r``,
            ``r`` the data coordinate under a model or expert axis and
            under a seq axis's global view.
        ema_weight: weight of the newest micro loss in ``ema_loss``.
        verbose: kept for the JAX signature; the port prints nothing.
        model_rng_keys: the JAX package's random stream names (e.g.
            ``("dropout", "layer_drop")``), recorded as
            ``Stoke.model_rng_keys``: the port draws every stream (dropout
            masks, BERT's layer-drop decisions) from the one generator
            that ``seed`` seeds.
    """

    def __init__(
        self,
        model: nn.Module,
        optimizer: Any,
        loss: Callable,
        params: Optional[dict] = None,
        batch_size_per_device: Optional[int] = None,
        grad_accum: Optional[int] = None,
        grad_clip: Optional[Union[ClipGradConfig, ClipGradNormConfig]] = None,
        device: Union[str, DeviceOptions] = "cuda",
        distributed: Optional[Union[str, DistributedOptions]] = None,
        precision: Optional[Union[str, PrecisionOptions]] = None,
        oss: bool = False,
        sddp: bool = False,
        fsdp: bool = False,
        configs: Optional[Sequence[Any]] = None,
        model_train_kwargs: Optional[dict] = None,
        model_eval_kwargs: Optional[dict] = None,
        loss_weights: Optional[Any] = None,
        aux_loss_weight: float = 0.01,
        seed: int = 0,
        ema_weight: float = 0.1,
        verbose: bool = True,
        model_rng_keys: Sequence[str] = ("dropout",),
    ):
        self._status_obj = StokeStatus(
            batch_size_per_device=batch_size_per_device,
            grad_accum=grad_accum,
            grad_clip=grad_clip,
            device=device,
            distributed=distributed,
            precision=precision,
            oss=oss,
            sddp=sddp,
            fsdp=fsdp,
            configs=configs,
        )
        st = self._status_obj
        self._device = resolve_device(st.device.value)
        self._group = None
        self._mesh = None
        #: this process's view of the sequence under a mesh with a seq
        #: axis: its shard with ``shard_seq_dim``, else the global view
        #: (GPT's positions, the causal LM loss and the sequence-parallel
        #: attention read it inside this Stoke's calls; None without one)
        self._seq_shard: Optional[SeqShard] = None
        #: the global view of the same seq group, which a call under
        #: ``shard_seq_dim`` takes when the shards do not divide an input
        self._seq_whole: Optional[SeqShard] = None
        #: the view of the objective ``loss()`` kept for ``backward()``
        self._pending_view: Optional[SeqShard] = None
        #: the data sub-group on a mesh of several axes (the ladder's
        #: group, the rows' and the rebalancer's hosts; None: the run's
        #: group is the data axis)
        self._data_group = None
        #: under seq's sharded view, the ladder's groups: the data
        #: sub-group and this process's data row (None otherwise)
        self._seq_groups = None
        #: under seq's sharded view, the flattened (data, seq) sub-group:
        #: the processes that hold other tokens (None otherwise: the data
        #: sub-group or the world)
        self._rows_group = None
        #: the model's Megatron or expert split (None without rules)
        self._tp: Optional[TensorParallel] = None
        if st.is_distributed:
            self._join_process_group(model)
        world = (dist.get_world_size(self._group) if self._group is not None
                 else 1)
        data_group = next((g for g in (self._rows_group, self._data_group,
                                        self._group) if g is not None),
                          None)
        data_rank = (dist.get_rank(data_group)
                     if data_group is not None else 0)
        ladder_group, across = data_group, None
        if self._seq_groups is not None:
            ladder_group, across = self._seq_groups
        ladder_world = (dist.get_world_size(ladder_group)
                        if ladder_group is not None else 1)
        st.set_post_init_values(world_size=world, n_processes=world)
        if not isinstance(model, nn.Module):
            raise TypeError(
                f"Stoke -- model must be a torch.nn.Module, got "
                f"{type(model).__name__}"
            )
        if not callable(loss):
            raise TypeError("Stoke -- loss must be callable")
        self._precision = PrecisionPolicy.make(st.precision,
                                               st.precision_config)
        self._module = model.to(device=self._device,
                                dtype=self._precision.param_dtype)
        if params is not None:
            self._module.load_state_dict(params)
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed + data_rank)
        for m in self._module.modules():
            if isinstance(m, (Dropout, LayerDrop, MoEFFN)):
                m.generator = self._generator
            if isinstance(m, MoEFFN):
                m.data_group = data_group
            if isinstance(m, BatchNorm):
                m.sync_group = self._group
        if isinstance(model_rng_keys, str) or not all(
                isinstance(k, str) for k in model_rng_keys):
            raise TypeError(
                f"Stoke -- model_rng_keys must be a sequence of stream "
                f"names, got {model_rng_keys!r}")
        self.model_rng_keys = tuple(model_rng_keys)
        self._tb_writer_obj: Optional[TBEventWriter] = None
        #: the pinned buffers of staged saves, freed at close_telemetry
        self._staging_pool = offload.PinnedPool()
        self._train_kwargs = dict(model_train_kwargs or {})
        self._eval_kwargs = dict(model_eval_kwargs or {})
        self._ladder: Optional[Ladder] = None
        opt_params = self._module.parameters()
        prc = st.partition_rules_config
        self._rules = make_sharding_rules(
            st.sharding_tier, ladder_world, st.oss_config, st.sddp_config,
            st.fsdp_config, prc.rules if prc is not None else None)
        if self._group is not None:
            if world > 1:
                with torch.no_grad():
                    for t in self._module.state_dict().values():
                        dist.broadcast(t, 0, group=self._group)
            if self._rules.overrides:
                self._tp = self._split_model(prc.rules)
            params = [p for p in self._module.parameters() if p.requires_grad]
            names = {id(p): n for n, p in self._module.named_parameters()}
            placed = ({id(p) for n, p in self._module.named_parameters()
                       if n in self._tp.placed} if self._tp else set())
            dpc = st.dp_config
            # the reductions a data or seq placement made in the backward
            averaged = {} if self._tp is None else {
                i: {k for k, a in (("group", dpc.axis_name),
                                   ("across", dpc.seq_axis_name))
                    if a in self._tp.mean_axes(names[id(p)])}
                for i, p in enumerate(params)}
            self._ladder = Ladder(
                params, self._rules, ladder_group,
                keep_whole=[i for i, p in enumerate(params)
                            if id(p) in placed], across=across,
                jax_layout=self._jax_layout(params), averaged=averaged)
            opt_params = self._ladder.opt_params
        self._engine = StepEngine(
            self._module, loss, build_optimizer(optimizer, opt_params),
            self._precision, grad_accum=st.grad_accum,
            grad_clip=st.grad_clip, loss_weights=loss_weights,
            precision_config=st.precision_config, generator=self._generator,
            ladder=self._ladder,
            transport=make_transport(st.comm_config, st.sharding_tier,
                                     ladder_group),
            sentinels=(st.health_config is not None
                       and st.health_config.sentinels),
            remat=st.activation_checkpointing_config,
            numerics=(st.numerics_config is not None
                      and st.numerics_config.grad_stats),
            aux_loss_weight=aux_loss_weight, tp=self._tp,
        )
        self._skipped_steps = torch.zeros((), dtype=torch.float32,
                                          device=self._device)

        self._grad_accum_counter = 0
        self._optimizer_steps = 0
        self._backward_steps = 0
        self._pending: Optional[torch.Tensor] = None
        self._ema_weight = float(ema_weight)
        self._rolling_mean_loss: Optional[torch.Tensor] = None
        self._last_step_loss: Optional[torch.Tensor] = None
        self._agg_loss: Optional[torch.Tensor] = None
        self._agg_count = 0
        # the lost-goodput accounting of a preemption bundle
        self._last_save_step = 0
        self._step_wall_ema: Optional[float] = None
        self._last_boundary_t: Optional[float] = None
        self._build_offload()
        self._build_telemetry()
        self._build_resilience()
        self.train()

    def _build_offload(self) -> None:
        """The offload tiers: the optimizer state in pinned host memory on
        the card (``OffloadOptimizerConfig``) or in files
        (``OffloadDiskConfig``) under ``path/proc<rank>`` or a temp dir,
        and fsdp's parameter slices in pinned host memory
        (``OffloadParamsConfig``). On the CPU there is no host tier: with
        ``fallback_to_device`` a warning, and the state stays where it
        is."""
        import warnings

        st = self._status_obj
        cuda = self._device.type == "cuda"
        ocfg = st.offload_optimizer_config
        if ocfg is not None:
            if cuda:
                # pinned on the card whatever pin_memory says (a parity
                # field): the copies must be asynchronous to sit inside a
                # captured window
                self._engine.host_state = offload.HostOptimizerState(
                    self._engine.optimizer, self._device)
            else:
                warnings.warn(
                    "Stoke -- optimizer-state host offload unsupported on "
                    "this runtime; keeping state on device"
                )
        if st.offload_params_config is not None:
            if cuda:
                self._ladder.offload_params()
            else:
                warnings.warn(
                    "Stoke -- parameter host offload unsupported on this "
                    "runtime; keeping state on device"
                )
        dcfg = st.offload_disk_config
        if dcfg is not None:
            import tempfile

            if dcfg.path is not None:
                base = os.path.join(dcfg.path, f"proc{self.rank}")
                os.makedirs(base, exist_ok=True)
                # a killed run cannot clean its spill: reclaim siblings
                # whose recorded pid is dead before adding ours
                offload.reclaim_stale_spills(base)
                spill_dir = tempfile.mkdtemp(prefix="run-", dir=base)
            else:
                spill_dir = tempfile.mkdtemp(prefix="stoke-optspill-")
            with open(os.path.join(spill_dir, "pid"), "w") as f:
                f.write(str(os.getpid()))
            self._engine.disk_store = offload.DiskOptimizerStore(
                os.path.join(spill_dir, "opt"), cleanup_root=spill_dir)

    def _build_resilience(self) -> None:
        """The resilience monitor of a ``ResilienceConfig``, built after
        the health monitor: with resilience on, the preemption signals
        mean "drain and save", so its handlers supersede the flight
        recorder's dump-and-die disposition (``close_telemetry``
        uninstalls them first)."""
        self._resilience: Optional[ResilienceMonitor] = None
        rcfg = self._status_obj.resilience_config
        if rcfg is None:
            return
        self._resilience = ResilienceMonitor(
            rcfg, self._telemetry.registry,
            recorder=(self._health.recorder if self._health is not None
                      else None))
        self._telemetry.resilience = self._resilience
        if self._resilience.chaos.active:
            self._engine.chaos = self._resilience.chaos

    def _build_telemetry(self) -> None:
        """The telemetry pipeline (its registry always; sinks with a
        ``TelemetryConfig``), the trace recorder (``TraceConfig``) and the
        health monitor with its flight recorder and watchdog
        (``HealthConfig``), as the JAX constructor builds them."""
        st = self._status_obj
        self._telemetry = Telemetry(st.telemetry_config, rank=self.rank)
        self._engine.compile_tracker = self._telemetry.compile_tracker
        self._last_grad_norm: Optional[float] = None
        self._tracer: Optional[TraceRecorder] = None
        if st.trace_config is not None:
            self._tracer = TraceRecorder(st.trace_config, rank=self.rank,
                                         registry=self._telemetry.registry)
            register_recorder(self._tracer)
        self._health: Optional[HealthMonitor] = None
        self._last_sentinels: Optional[np.ndarray] = None
        self._fleet = None
        self._opsplane = None
        self._numerics = None
        self._memory_obs = None
        self._wire_error_warned = False
        # the persistent compile cache (a ``CompileConfig``; the JAX
        # constructor builds it before the attribution): the kernel
        # libraries kept across processes and booked as they load. The
        # engine runs exactly as without one
        self._compile_cache = None
        ccfg = st.compile_config
        if ccfg is not None:
            from stoke_tpu_torch.compile_cache import CompileCache

            self._compile_cache = CompileCache(ccfg,
                                               self._telemetry.registry)
        # step-time attribution: the cost cards counted at each program's
        # first run and the per-window gauges (the JAX constructor's order:
        # before the health monitor, whose bundles carry its summary)
        self._attribution = None
        acfg = st.attribution_config
        if acfg is not None:
            from stoke_tpu_torch.telemetry.attribution import (
                AttributionMonitor,
            )

            self._attribution = AttributionMonitor(
                acfg, self._telemetry.registry,
                trace_dir=st.profiler_config.trace_dir, rank=self.rank,
                cuda=self._device.type == "cuda")
            self._telemetry.attribution = self._attribution
            self._engine.cost_cards = self._attribution.cost_cards
        hcfg = st.health_config
        if hcfg is not None:
            bundle_dir = hcfg.bundle_dir
            if bundle_dir is None:
                base = (st.telemetry_config.output_dir
                        if st.telemetry_config is not None else "health")
                bundle_dir = os.path.join(base, "postmortem")
            recorder = FlightRecorder(
                bundle_dir,
                ring_size=hcfg.ring_size,
                status_dict=st.to_dict(),
                mesh_info=self._mesh_info(),
                snapshot_fn=self._telemetry.registry.snapshot,
                install_signal_handlers=hcfg.dump_signals,
                # the span ring at time of death
                trace_fn=(self._tracer.to_trace_events
                          if self._tracer is not None else None),
                # utilization at time of death: the goodput summary and
                # the last cost cards
                goodput_fn=(self._telemetry.goodput_summary
                            if self._attribution is not None else None),
                cost_cards_fn=(self._attribution.cost_cards.last_cards
                               if self._attribution is not None else None),
                # which layer was bad at time of death (late-bound: the
                # monitor is built below)
                numerics_fn=lambda: (self._numerics.snapshot()
                                     if self._numerics is not None
                                     else None),
                # which process was slow at time of death (late-bound:
                # bundles before the first exchange carry none)
                fleet_fn=lambda: (self._fleet.snapshot()
                                  if self._fleet is not None else None),
            )
            self._health = HealthMonitor(
                hcfg, self._telemetry.registry, recorder,
                compile_tracker=self._telemetry.compile_tracker)
            # the NonFiniteDetector names the first bad leaf by its JAX path
            self._health.leaf_paths = leaf_path_names(self._module,
                                                      self._engine.params)
            if self._attribution is not None:
                from stoke_tpu_torch.telemetry.attribution import (
                    AutoCaptureDetector,
                )

                self._health.detectors.append(AutoCaptureDetector(
                    self._attribution,
                    st.attribution_config.capture_action))
        self._build_fleet()
        self._build_observatories()
        self._build_opsplane()
        self._wall_clock_enabled = (
            st.profiler_config.wall_clock_breakdown
            or self._telemetry.enabled
            or self._tracer is not None
        )

    def _build_fleet(self) -> None:
        """The fleet monitor (``FleetConfig``): its exchange over a gloo
        side group of every process (made here, on every rank), its
        straggler detector in the health registry, or a warning without
        one, as the JAX constructor builds them."""
        fcfg = self._status_obj.fleet_config
        if fcfg is None:
            return
        from stoke_tpu_torch.telemetry.fleet import (
            FleetMonitor,
            FleetStragglerDetector,
            fleet_group,
        )

        group = fleet_group() if self.n_processes > 1 else None
        rows = row_group = None
        if group is not None and self._data_group is not None:
            # a host of the verdict and the rebalancer is a data row, whose
            # read payloads go over a gloo data sub-group
            rows, row_lists = self._data_rows()
            if fcfg.rebalance:
                row_group = dist.new_subgroups_by_enumeration(
                    row_lists, backend="gloo")[0]
        self._fleet = FleetMonitor(
            fcfg, self._telemetry.registry, rank=self.rank,
            n_processes=self.n_processes,
            dispatch_count_fn=lambda: self._engine.dispatch_count,
            group=group, rows=rows,
            row_group=group if row_group is None else row_group)
        self._telemetry.fleet = self._fleet
        if self._health is not None:
            self._health.detectors.append(
                FleetStragglerDetector(self._fleet, fcfg.straggler_action))

    def _data_rows(self):
        """``(each world rank's data coordinate, the world ranks of every
        data sub-group)`` of the mesh."""
        ranks = self._mesh.mesh
        axis = self._mesh.mesh_dim_names.index(
            self._status_obj.dp_config.axis_name)
        coord = torch.empty(ranks.numel(), dtype=torch.long)
        coord[ranks.flatten()] = torch.arange(ranks.shape[axis]).view(
            [-1 if i == axis else 1 for i in range(ranks.ndim)]).expand(
            ranks.shape).flatten()
        lists = ranks.movedim(axis, -1).reshape(-1, ranks.shape[axis])
        return coord.tolist(), lists.tolist()

    def _build_opsplane(self) -> None:
        """The live ops plane (``OpsPlaneConfig``), bound and serving
        before the first step."""
        ocfg = self._status_obj.opsplane_config
        if ocfg is None:
            return
        from stoke_tpu_torch.telemetry.opsplane import OpsPlane

        plane = OpsPlane(ocfg, self._telemetry, rank=self.rank)
        if self._health is not None:
            plane.attach_health(self._health)
        if self._tracer is not None:
            plane.attach_tracer(self._tracer)
        if self._attribution is not None:
            plane.attach_attribution(self._attribution)
        plane.attach_training(
            goodput=(self._telemetry.goodput_summary
                     if self._attribution is not None else None),
            memory=(self._memory_obs.summary
                    if self._memory_obs is not None else None),
            trace_summary=(self._tracer.summary
                           if self._tracer is not None else None))
        plane.start()
        self._opsplane = plane

    def _build_observatories(self) -> None:
        """The numerics monitor (``NumericsConfig``: its groups are the
        engine's, the JAX tree's top-level entries) and the memory
        observatory (``MemoryConfig``: the ledger's components registered,
        the pre-flight run before the first step), as the JAX constructor
        builds them."""
        st = self._status_obj
        ncfg = st.numerics_config
        if ncfg is not None:
            from stoke_tpu_torch.telemetry.numerics import (
                NumericsMonitor,
                NumericsProvenanceDetector,
                module_groups,
            )

            groups = (self._engine.groups if self._engine.groups is not None
                      else module_groups(self._module, self._engine.params))
            self._numerics = NumericsMonitor(
                ncfg, self._telemetry.registry, groups, rank=self.rank)
            self._telemetry.numerics = self._numerics
            if self._health is not None:
                self._health.detectors.append(NumericsProvenanceDetector(
                    self._numerics, ncfg.provenance_action))
        mcfg = st.memory_config
        if mcfg is not None:
            from stoke_tpu_torch.telemetry.memory import MemoryObservatory

            obs = MemoryObservatory(mcfg, self._telemetry.registry,
                                    device=self._device)
            obs.set_component("params", self._params_bytes)
            obs.set_component("opt_state", self._opt_state_bytes)
            obs.set_component("transport", self._transport_bytes)
            obs.set_component("snapshot", self._snapshot_bytes)
            self._memory_obs = obs
            self._telemetry.memory = obs
            self._engine.memory = obs
            obs.preflight("build")

    def _resident(self, tensors) -> int:
        from stoke_tpu_torch.telemetry.memory import tensors_resident_bytes

        return tensors_resident_bytes(
            tensors, self._device if self._device.type == "cpu" else None)

    def _params_bytes(self) -> int:
        """The model's parameters and buffers, a tier's slices, and the
        accumulated gradients while a window is open."""
        eng = self._engine
        tensors = [*self._module.parameters(), *self._module.buffers(),
                   *eng.opt_params]
        tensors += [p.grad for p in (*eng.params, *eng.opt_params)]
        return self._resident(tensors)

    def _opt_state_bytes(self) -> int:
        """The optimizer's state on the device (what the host or disk tier
        holds counts 0) and the host tier's streaming buffer."""
        eng = self._engine
        tensors = [v for state in eng.optimizer.state.values()
                   for v in state.values()]
        out = self._resident(tensors)
        if eng.host_state is not None and self._device.type != "cpu":
            out += eng.host_state.buffer_bytes
        return out

    def _transport_bytes(self) -> int:
        """The transport's error-feedback residual and key."""
        state = self._engine.comm_state
        return self._resident([state.get("rng"),
                               *(state.get("residual") or [])])

    def _snapshot_bytes(self) -> int:
        """In-flight staged snapshots and the engine's copy of the
        parameters from before the step (sentinels, numerics, fp16's
        skip)."""
        return (offload.staged_nbytes()
                + self._resident(list(self._engine._snapshot.values())))

    def _mesh_info(self) -> dict:
        """The run's topology for post-mortem bundles."""
        return {
            "axes": list(self._status_obj.mesh_config.axes),
            "world": self.world_size,
            "device": str(self._device),
            "device_kind": (torch.cuda.get_device_name(self._device)
                            if self._device.type == "cuda" else "cpu"),
            "n_processes": self.n_processes,
        }

    def _join_process_group(self, model) -> None:
        """Join the run's process group (or make a one-process group),
        drive ``cuda:LOCAL_RANK`` on the card, and build the mesh (and,
        with a sequence axis, this process's views of the sequence in the
        layout that ``model``'s attention needs)."""
        st = self._status_obj
        if self._device.type == "cuda":
            self._device = torch.device("cuda",
                                        local_rank(st.dist_init_config))
            torch.cuda.set_device(self._device)
        joined = (st.dist_init_config.auto_initialize
                  and initialize_distributed(st.dist_init_config,
                                             self._device))
        if not joined and not dist.is_initialized():
            one_process_group(self._device)
        dpc = st.dp_config
        self._mesh = build_mesh(st.mesh_config, self._device, dpc.axis_name)
        names = tuple(self._mesh.mesh_dim_names)
        if self._mesh.ndim == 1:
            self._group = self._mesh.get_group()
            return
        # io and the broadcast span the world; the ladder reduces over the
        # data sub-group (and, under seq's sharded view, then over the
        # data row, whose seq sub-group also carries the ring and Ulysses
        # collectives); the rows go by the data coordinate
        self._group = dist.group.WORLD
        data = axis_coordinates(self._mesh, dpc.axis_name)[0]
        self._data_group = data
        if dpc.seq_axis_name not in names:
            return
        seq, n_seq, _ = axis_coordinates(self._mesh, dpc.seq_axis_name)
        layout = (model_seq_layout(model) if isinstance(model, nn.Module)
                  else "contiguous")
        self._seq_whole = SeqShard(seq, dist.get_rank(seq), n_seq, layout,
                                   whole=True)
        if dpc.shard_seq_dim is None:
            # the global view: every process of a data row holds its
            # whole sequences, draws its masks and takes its MoE batch
            # means by the data coordinate, and holds the same gradients
            self._seq_shard = self._seq_whole
            return
        self._seq_groups = (data, seq)
        # the processes that hold other tokens: the (data, seq) plane
        # (beside model, expert or stage axes, whose groups draw the same
        # dropout masks)
        self._rows_group = (dist.group.WORLD if self._mesh.ndim == 2
                            else axis_coordinates(
                                self._mesh,
                                (dpc.axis_name, dpc.seq_axis_name))[0])
        self._seq_shard = SeqShard(seq, dist.get_rank(seq), n_seq, layout)

    def _split_model(self, rules) -> TensorParallel:
        """Cut the (broadcast) whole model by the partition rules over the
        mesh's axes (a placement on the data or seq axis is a ``mean``
        level: its gradient averaged over that axis in the backward)."""
        dpc = self._status_obj.dp_config
        return apply_partition_rules(self._module, rules, self._mesh,
                                     dpc.axis_name, dpc.seq_axis_name)

    def _jax_layout(self, params) -> Optional[List[tuple]]:
        """Each of ``params``' JAX shape and the JAX dims that are whole
        dims of it (the ladder places a leaf as the JAX package does), or
        None for a module the converters do not know."""
        from stoke_tpu_torch.convert import jax_param_layout
        from stoke_tpu_torch.parallel.sharding import jax_dim_map

        try:
            layout = jax_param_layout(self._module)
        except ValueError:
            return None
        names = {id(p): n for n, p in self._module.named_parameters()}
        out = []
        for p in params:
            entry = layout.get(names.get(id(p)))
            out.append(None if entry is None else (
                entry[2], jax_dim_map(p.shape, entry[1], entry[2])))
        return out

    def _whole_params(self):
        """The module's parameters whole inside the block (under fsdp
        gathered, and freed again after)."""
        return (self._ladder.whole() if self._ladder is not None
                else contextlib.nullcontext())

    # ------------------------------------------------------------------ #
    # mode toggles
    # ------------------------------------------------------------------ #

    def train(self) -> "Stoke":
        self._module.train()
        return self

    def eval(self) -> "Stoke":
        self._module.eval()
        return self

    @property
    def training(self) -> bool:
        return self._module.training

    # ------------------------------------------------------------------ #
    # the four-call contract and the fused step
    # ------------------------------------------------------------------ #

    def _place_call(self, *trees, stacked: bool = False):
        """``(view, trees)``: the call's inputs on the device, and the view
        of the sequence the call runs under (:func:`using_seq_shard`).

        Under ``DataParallelConfig.shard_seq_dim = d`` with more than one
        sequence shard the view is decided a call at a time, as the JAX
        placement decides where each leaf lives (it never changes the
        values): when every tensor leaf that has dim ``d`` (of a
        micro-batch: ``d + 1`` for ``stacked`` window inputs) divides by
        the shard count, each such leaf is cut to this process's shard
        (the sharded view); otherwise every leaf stays whole and the call
        runs under the global view. A tensor :meth:`model` returned keeps
        the view it was made under, and is not cut again. Otherwise the
        view is the Stoke's own (the global view without ``shard_seq_dim``,
        whose inputs stay whole) and nothing is cut."""
        trees = place(trees, self._device)
        view = self._seq_shard
        d = self._status_obj.dp_config.shard_seq_dim
        if d is None or d == 0 or not sharded(view):
            return view, trees
        d += int(stacked)
        leaves = [x for x in tree_leaves(trees) if isinstance(x, torch.Tensor)]
        made = {id(v): v for v in (getattr(x, "_stoke_seq_view", None)
                                   for x in leaves) if v is not None}
        if len(made) > 1:
            raise ValueError(
                "Stoke -- a call mixes model outputs of the sharded and of "
                "the global view of the sequence")
        fresh = [x for x in leaves
                 if x.ndim > d and not hasattr(x, "_stoke_seq_view")]
        indivisible = [x for x in fresh if x.shape[d] % view.size]
        if made:
            view = next(iter(made.values()))
        elif indivisible:
            view = self._seq_whole
        if view.whole:
            return view, trees
        if indivisible:
            raise ValueError(
                f"Stoke -- an input of shape {tuple(indivisible[0].shape)} "
                f"beside model outputs of the sharded view: the "
                f"{view.size} sequence shards do not divide its dim {d}")

        def leaf(x):
            if (not isinstance(x, torch.Tensor) or x.ndim <= d
                    or hasattr(x, "_stoke_seq_view")):
                return x
            return view.take(x, d)

        return view, tree_map(leaf, trees)

    def _seq_local(self, out, view: Optional[SeqShard]):
        """``out`` with its tensors marked with the view they were made
        under, so that :meth:`loss` neither cuts them again (the JAX facade
        passes an array it placed through as it is) nor mixes views. Only
        under ``shard_seq_dim``, where a call's view can differ from the
        next one's."""
        d = self._status_obj.dp_config.shard_seq_dim
        if d is None or d == 0 or not sharded(self._seq_shard):
            return out

        def mark(x):
            if isinstance(x, torch.Tensor):
                x._stoke_seq_view = view
            return x

        return tree_map(mark, out)

    @_timed("model")
    def model(self, *args, **kwargs):
        """The forward on ``args`` (placed on the device): under autograd
        in train mode, under ``torch.no_grad()`` in eval mode."""
        view, (args, kwargs) = self._place_call(args, kwargs)
        with using_seq_shard(view):
            if self.training:
                return self._seq_local(self._engine.forward(
                    args, {**self._train_kwargs, **kwargs}), view)
            with torch.no_grad():
                return self._seq_local(self._engine.forward(
                    args, {**self._eval_kwargs, **kwargs}), view)

    @_health_guarded
    @_timed("loss")
    def loss(self, *args, **kwargs):
        """``loss(*args, **kwargs)``; in train mode the losses are returned
        divided by ``grad_accum`` and the objective is kept for
        :meth:`backward` (when it has a gradient: a loss of a detached
        output gives ``backward()`` nothing to commit)."""
        view, (args, kwargs) = self._place_call(args, kwargs)
        with using_seq_shard(view):
            result = self._engine.loss(*args, **kwargs)
        if not self.training:
            return (result if self._ladder is None
                    else self._ladder.average(result))
        objective, report = self._engine.objective(result)
        self._pending = objective if objective.requires_grad else None
        self._pending_view = view
        self._update_loss_tracking(report)
        return report

    @_health_guarded
    @_timed("backward")
    def backward(self, loss: Any = None) -> None:
        """Autograd of the last ``loss()`` into the accumulated gradients.
        ``loss`` is accepted for the reference signature; the objective
        is the one ``loss()`` kept."""
        if not self.training:
            raise RuntimeError("Stoke -- backward() called in eval mode")
        if self._pending is None:
            raise RuntimeError(
                "Stoke -- backward() called without a preceding loss() on a "
                "model() output"
            )
        objective, self._pending = self._pending, None
        # the view of its forward: remat's recompute reads it
        with using_seq_shard(self._pending_view):
            self._engine.backward(objective)
        self._grad_accum_counter += 1
        self._backward_steps += 1

    @_health_guarded
    @_timed("step")
    def step(self) -> None:
        """At the accumulation boundary: (under fp16, unscale and check)
        clip, optimizer step (skipped when not finite), zero the gradients
        (and update the loss scale); before it, nothing."""
        if self._grad_accum_counter < self._status_obj.grad_accum:
            return
        will_record = self._telemetry_will_record()
        # the grad norm of a logged step without sentinels: the apply's
        # own pre-clip norm (the JAX facade's extra reduction)
        probe = (will_record and self._telemetry.config.grad_norm
                 and not self._engine.sentinels)
        t0 = self._device_clock_start(will_record)
        finite = self._engine.apply(self._health_loss_input(),
                                    probe_grad_norm=probe)
        self._device_clock_stop(t0)
        if probe:
            self._last_grad_norm = float(self._engine.grad_norm)
            self._telemetry.registry.gauge("train/grad_norm").set(
                self._last_grad_norm)
        self._count_skipped(finite)
        self._optimizer_steps += 1
        self._grad_accum_counter = 0
        self._reset_tracking_window()
        self._observe_health([self._step_rows()])
        self._after_optimizer_steps()

    def _count_skipped(self, finite: Optional[torch.Tensor]) -> None:
        """``skipped_optimizer_steps += 1 - finite`` on the device (fp16)."""
        if finite is not None:
            self._skipped_steps += 1.0 - finite.float()

    @_health_guarded
    @_timed("train_step")
    def train_step(self, model_args: Any, loss_args: Any = (),
                   model_kwargs: Optional[dict] = None):
        """``model -> loss -> backward -> step`` in one call:
        ``loss(model(*model_args, **model_kwargs), *loss_args)``. Returns
        the losses divided by ``grad_accum``, like :meth:`loss`."""
        if not self.training:
            raise RuntimeError("Stoke -- train_step() called in eval mode")
        if not isinstance(model_args, tuple):
            model_args = (model_args,)
        if not isinstance(loss_args, tuple):
            loss_args = (loss_args,)
        view, (margs, mkwargs, largs) = self._place_call(
            model_args, model_kwargs or {}, loss_args)
        mkwargs = {**self._train_kwargs, **mkwargs}
        do_apply = self._grad_accum_counter + 1 >= self._status_obj.grad_accum
        t0 = self._device_clock_start(
            do_apply and self._telemetry_will_record())
        with using_seq_shard(view):
            report, finite = self._engine.fused(margs, mkwargs, largs,
                                                do_apply=do_apply)
        self._device_clock_stop(t0)
        self._pending = None
        self._backward_steps += 1
        self._update_loss_tracking(report)
        if do_apply:
            self._count_skipped(finite)
            self._optimizer_steps += 1
            self._grad_accum_counter = 0
            self._reset_tracking_window()
            self._observe_health([self._step_rows()])
            self._after_optimizer_steps()
        else:
            self._grad_accum_counter += 1
        return report

    def _window_args(self, name: str, model_args, loss_args) -> tuple:
        """``name``'s checks that it runs in train mode at an accumulation
        boundary; returns ``(model_args, loss_args)`` as tuples."""
        if not self.training:
            raise RuntimeError(f"Stoke -- {name}() called in eval mode")
        if self._grad_accum_counter != 0:
            raise RuntimeError(
                f"Stoke -- {name}() must start at an accumulation "
                f"boundary (counter={self._grad_accum_counter}); finish the "
                "window with backward()/step() or reset() first"
            )
        return (model_args if isinstance(model_args, tuple) else (model_args,),
                loss_args if isinstance(loss_args, tuple) else (loss_args,))

    def _run_window(self, view: Optional[SeqShard], margs: tuple,
                    mkwargs: dict, loss_args: tuple):
        """One window of inputs already on the device and stacked to
        ``[grad_accum, ...]``, under the sequence view ``view``: the
        engine's window, then the counters, the loss tracking (once, with
        the window-mean micro loss) and the skipped count. Returns the
        stacked reports; the window's sentinel row is the engine's
        ``sentinel_row``."""
        with using_seq_shard(view):
            reports, finite = self._engine.window(margs, mkwargs, loss_args)
        self._pending = None
        self._backward_steps += self._status_obj.grad_accum
        self._update_loss_tracking(tree_map(lambda r: r.mean(0), reports))
        self._count_skipped(finite)
        self._optimizer_steps += 1
        self._reset_tracking_window()
        return reports

    @_health_guarded
    @_timed("train_step_window")
    def train_step_window(self, model_args: Any, loss_args: Any = (),
                          model_kwargs: Optional[dict] = None):
        """A whole accumulation window (``grad_accum`` micro-batches and
        the apply) in one call; on the card one replay of a CUDA graph
        (``StepEngine.window``).

        Args are stacked micro-batches: each tensor leaf has shape
        ``[grad_accum, micro_batch, ...]``. Must be called at a window
        boundary (``grad_accum_counter == 0``). Returns the per-micro loss
        reports stacked on axis 0, on the device."""
        model_args, loss_args = self._window_args(
            "train_step_window", model_args, loss_args)
        k = self._status_obj.grad_accum
        for leaf in tree_leaves((model_args, loss_args, model_kwargs or {})):
            if hasattr(leaf, "shape") and (not leaf.shape
                                           or leaf.shape[0] != k):
                raise ValueError(
                    f"Stoke -- train_step_window() expects leaves stacked to "
                    f"[grad_accum={k}, ...]; got shape "
                    f"{tuple(getattr(leaf, 'shape', ()))}"
                )
        view, (margs, mkwargs, largs) = self._place_call(
            model_args, model_kwargs or {}, loss_args, stacked=True)
        reports = self._run_window(view, margs,
                                   {**self._train_kwargs, **mkwargs}, largs)
        self._observe_health([self._step_rows()])
        self._after_optimizer_steps()
        return reports

    @_health_guarded
    @_timed("train_steps")
    def train_steps(self, model_args: Any, loss_args: Any = (),
                    model_kwargs: Optional[dict] = None,
                    segment_size: Optional[int] = None):
        """n complete optimizer steps: n windows of ``grad_accum``
        micro-batches, each a replay of the window's CUDA graph on the
        card.

        Args are stacked micro-batches: each tensor leaf has shape
        ``[total_micro, micro_batch, ...]`` with ``total_micro`` a multiple
        of ``grad_accum``; ``n = total_micro // grad_accum`` optimizer steps
        run. Must be called at a window boundary. The segment goes to the
        device once; each window's slice then reaches the graph's inputs by
        one device-to-device copy. ``segment_size=c`` moves it in chunks of
        c optimizer steps instead (the same numbers and loss tracking);
        without it a guard raises when the stacked inputs obviously exceed
        the device's free memory. The loss EMA advances once per optimizer
        step with that step's window-mean loss, as ``n`` calls of
        :meth:`train_step_window`. Returns the reports stacked to
        ``[n, grad_accum, ...]``, on the device."""
        model_args, loss_args = self._window_args("train_steps", model_args,
                                                  loss_args)
        k = self._status_obj.grad_accum
        n = None
        seg_bytes = 0
        for leaf in tree_leaves((model_args, loss_args, model_kwargs or {})):
            if hasattr(leaf, "shape") and leaf.shape:
                if leaf.shape[0] % k:
                    raise ValueError(
                        f"Stoke -- train_steps() leaves must stack "
                        f"[total_micro, micro_batch, ...] with total_micro a "
                        f"multiple of grad_accum={k}; got "
                        f"{tuple(leaf.shape)}"
                    )
                if n is None:
                    n = leaf.shape[0] // k
                elif leaf.shape[0] // k != n:
                    raise ValueError(
                        "Stoke -- train_steps() leaves disagree on the "
                        "number of stacked micro-batches"
                    )
                # inputs already on the device count in its bytes in use
                if getattr(leaf, "device", None) != self._device:
                    seg_bytes += getattr(leaf, "nbytes", 0)
        if not n:
            raise ValueError(
                "Stoke -- train_steps() found no stacked array leaves"
            )
        if segment_size is not None and segment_size < 1:
            raise ValueError(
                f"Stoke -- segment_size must be >= 1, got {segment_size}"
            )
        if segment_size is not None and segment_size < n:
            chunks = []
            for c0 in range(0, n, segment_size):
                sl = slice(c0 * k, min(c0 + segment_size, n) * k)
                chunks.append(self.train_steps(
                    _leading(model_args, sl), _leading(loss_args, sl),
                    None if model_kwargs is None
                    else _leading(model_kwargs, sl)))
            return tree_map(lambda *r: torch.cat(r), *chunks)
        _check_segment_memory(seg_bytes, _device_memory_stats(self._device))
        if self._health is not None:
            # the call legitimately covers n optimizer steps: re-arm the
            # watchdog with the segment's deadline (n x timeout)
            self._health.arm_watchdog(steps=n)
        view, (margs, mkwargs, loss_args) = self._place_call(
            model_args, model_kwargs or {}, loss_args, stacked=True)
        mkwargs = {**self._train_kwargs, **mkwargs}
        reports: List[Any] = []
        rows: List[Optional[torch.Tensor]] = []
        for i in range(n):
            sl = slice(i * k, (i + 1) * k)
            reports.append(self._run_window(
                view, _leading(margs, sl), _leading(mkwargs, sl),
                _leading(loss_args, sl)))
            rows.append(self._step_rows())
        # the segment's rows read back once; a save boundary crossed
        # inside the segment is saved at its end
        self._observe_health(rows, window=n)
        self._after_optimizer_steps(window=n)
        return tree_map(lambda *r: torch.stack(r), *reports)

    def reset(self) -> None:
        """Drop the accumulated gradients and zero the accumulation
        counter without stepping (the JAX facade's ``reset``)."""
        self._engine.optimizer.zero_grad(set_to_none=True)
        if self._ladder is not None:
            self._ladder.drop_grads()
        self._grad_accum_counter = 0
        self._pending = None
        self._reset_tracking_window()

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #

    def _param_names(self) -> Dict[torch.Tensor, str]:
        """Each optimizer parameter's name in the module, a sharded leaf's
        slice by its leaf's (raises for a parameter the module does not
        hold)."""
        names = {p: n for n, p in self._module.named_parameters()}
        if self._ladder is not None:
            for p, o in zip(self._ladder.params, self._ladder.opt_params):
                names[o] = names[p]
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p not in names:
                    raise ValueError(
                        "Stoke -- the optimizer holds a parameter the "
                        "model does not; a checkpoint keys optimizer "
                        "state by the model's parameter names"
                    )
        return names

    def _opt_checkpoint(self, names: Dict[torch.Tensor, str]):
        """``(arrays, values, groups)``: every tensor of the optimizer's
        state keyed ``"{parameter name}/{state key}"``, its other state
        values keyed alike, and its param groups with the parameters by
        name (all of ``optimizer.state_dict()``)."""
        arrays, values = {}, {}
        for p, state in self.optimizer.state.items():
            for key, v in state.items():
                (arrays if torch.is_tensor(v) else values)[
                    f"{names[p]}/{key}"] = v
        groups = [{**{k: (v.detach().cpu().clone() if torch.is_tensor(v)
                          else copy.deepcopy(v))
                      for k, v in g.items() if k != "params"},
                   "params": [names[p] for p in g["params"]]}
                  for g in self.optimizer.param_groups]
        return arrays, values, groups

    def save(self, path: str, name: str = "stoke",
             extras: Optional[Dict[str, Any]] = None) -> str:
        """Write a checkpoint under ``path`` (the tag directory
        ``stoke-{name}-backward-step-{n}``) as ``CheckpointConfig``
        says (``async_save``: written on a background thread; see
        :meth:`wait_for_checkpoint`). It holds the module's state dict,
        the optimizer's state, the scaler state, the counters, the status
        dict, ``extras``, the dropout generator's state and, mid-window,
        the accumulated gradients. Returns the tag directory."""
        return self._save_with_config(
            path, name, self._status_obj.checkpoint_config, extras)

    def _accumulated_grads(self) -> Dict[str, torch.Tensor]:
        """The accumulated gradient of each parameter by name, a sharded
        accumulator's slice in its place (the whole leaf at world 1)."""
        names = {p: n for n, p in self._module.named_parameters()}
        out = {names[p]: p.grad for p in self._engine.params
               if p.grad is not None}
        if self._ladder is not None:
            for i, p in enumerate(self._ladder.params):
                acc = self._ladder.accumulator(i)
                if acc is not None:
                    out[names[p]] = acc
        return out

    @_timed("save")
    def _save_with_config(self, path: str, name: str,
                          config: CheckpointConfig,
                          extras: Optional[Dict[str, Any]]) -> str:
        with self._whole_params(), self._engine.resident_state():
            tag_dir = self._save_whole(path, name, config, extras)
        mon = self._resilience
        if mon is not None and mon.chaos.active:
            # corrupt_save needs the payload on disk; the injector is a
            # test harness, so draining an async save here is acceptable
            if config.async_save and mon.chaos.spec.corrupt_save is not None:
                io_ops.wait_for_saves()
            mon.chaos.note_saved(tag_dir)
        return tag_dir

    def _save_whole(self, path: str, name: str, config: CheckpointConfig,
                    extras: Optional[Dict[str, Any]]) -> str:
        names = self._param_names()
        arrays, values, groups = self._opt_checkpoint(names)
        grad_buf = None
        if self._grad_accum_counter > 0:
            grad_buf = self._accumulated_grads()
        state = {
            "variables": self._module.state_dict(),
            "opt_state": arrays,
            "scaler_state": dict(self._engine.scaler),
            "grad_buf": grad_buf,
        }
        port_state = {
            "param_groups": groups, "opt_values": values,
            "generator": self._generator.get_state().numpy(),
            "generator_device": self._device.type,
        }
        sharded = config.format is CheckpointFormat.sharded
        if self._tp is not None and self._tp.cuts:
            # the sharded format writes the model split's slices as they
            # are (their accumulated gradients whole, with the ranks' own)
            state = self._whole_state(state, grads_only=sharded)
        rank_state = layout = None
        if self._ladder is not None:
            state, rank_state, layout = self._split_by_rank(state, sharded)
            if self.world_size > 1:
                # each rank draws its dropout masks from its own generator
                port_state["generators"] = [
                    g.cpu().numpy() for g in gather_by_rank(
                        self._generator.get_state().to(self._device),
                        self._group)]
        mon = self._resilience
        with_manifest = mon is not None and mon.cfg.manifest
        with trace_span("stoke/io", track="io"):
            return io_ops.save_checkpoint(
                path=path, name=name, state=state,
                counters={
                    "backward_step": self._backward_steps,
                    "grad_accum_step": self._grad_accum_counter,
                    "optimizer_step": self._optimizer_steps,
                },
                status=self._status_obj.to_dict(),
                extras=extras, config=config,
                backward_step=self._backward_steps,
                port_state=port_state, rank_state=rank_state,
                layout=layout, group=self._group,
                manifest=with_manifest,
                topology=(self.topology_descriptor() if with_manifest
                          else None),
                chaos=(mon.chaos if mon is not None and mon.chaos.active
                       else None),
                # a save counts as the last durable one only once it landed
                on_durable=functools.partial(self._note_durable_save,
                                             self._optimizer_steps),
                staging_pool=self._staging_pool,
            )

    def _whole_state(self, state: Dict[str, Any],
                     grads_only: bool = False) -> Dict[str, Any]:
        """``state`` with every slice of the model split gathered over its
        own group into its whole tensor (parameters, their optimizer
        state, accumulated gradients; only the gradients with
        ``grads_only``): the arrays a run without the split saves. Every
        rank runs the same gathers in the same order."""
        tp = self._tp
        out = dict(state)
        if not grads_only:
            out["variables"] = {n: tp.gather(n, t)
                                for n, t in state["variables"].items()}
            out["opt_state"] = {k: tp.gather(k.rpartition("/")[0], v)
                                for k, v in state["opt_state"].items()}
        if state["grad_buf"] is not None:
            out["grad_buf"] = {n: tp.gather(n, g)
                               for n, g in state["grad_buf"].items()}
        return out

    def _leaf_index(self) -> Dict[str, int]:
        """The ladder's index of each trainable parameter, by name."""
        names = {p: n for n, p in self._module.named_parameters()}
        return {names[p]: i for i, p in enumerate(self._ladder.params)}

    def _mesh_rank(self, coords: Dict[str, int]) -> int:
        """The world rank at the mesh coordinates ``coords`` (by axis
        name; 0 on every axis they leave out)."""
        mesh = self._mesh
        return int(mesh.mesh[tuple(coords.get(a, 0)
                                   for a in mesh.mesh_dim_names)])

    def _cut_ranks(self, axes: tuple) -> List[int]:
        """The world ranks that hold a cut's slices over ``axes`` (the
        flattened coordinate, the first axis major), at 0 on every other
        axis."""
        mesh = self._mesh
        sizes = [mesh.mesh.shape[mesh.mesh_dim_names.index(a)] for a in axes]
        out = []
        for x in range(math.prod(sizes)):
            coords = {}
            for a, n in zip(reversed(axes), reversed(sizes)):
                x, coords[a] = divmod(x, n)
            out.append(self._mesh_rank(coords))
        return out

    def _split_by_rank(self, state: Dict[str, Any], sharded: bool):
        """Across the ladder's ranks: ``(the writer's arrays, this rank's
        slices, the layout for meta.json)`` of one save. The
        consolidated format gathers every slice (the optimizer state of
        the sharded leaves, the sharded accumulators) whole to every rank
        and writes the ranks' own accumulated gradients both as their
        mean (``grad_buf``) and one by one (``grad_local``); the sharded
        format leaves each rank its slices (and, under fsdp, its slices of
        the parameters), described in the layout. Every rank runs the
        same collectives in the same order, on this thread.

        Under a mesh of several axes the layout names the mesh, and a
        slice is written once: a leaf's data slice ``d`` by the rank at
        data coordinate ``d`` and 0 on every other axis (the others of
        data row ``d`` hold it alike), a model split's slice of a
        parameter and its optimizer state by the rank at its coordinates
        on the axes that cut it and 0 on every other axis, with the cut
        (each level's axes, view, dim and, under a stage axis, stride)
        beside the data level."""
        ladder, world = self._ladder, self._ladder.world
        index = self._leaf_index()
        freed = {i for b in ladder.buckets if b.frees for i in b.index}
        cuts = self._tp.cuts if sharded and self._tp is not None else {}
        mesh = self._mesh
        data_axis = self._status_obj.dp_config.axis_name
        several = mesh is not None and mesh.ndim > 1
        mine_at = ({a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
                   if several else {})

        def writes(axes) -> bool:
            # this rank is at 0 on every axis but ``axes``
            return all(c == 0 for a, c in mine_at.items() if a not in axes)

        out = {k: {} for k in ("variables", "opt_state", "scaler_state",
                               "grad_buf", "grad_local")}
        mine = {k: {} for k in ("variables", "opt_state", "grad_buf")}
        leaves = {k: {} for k in mine}
        local: List[str] = []
        out["scaler_state"] = state["scaler_state"]

        def keep_slice(key, label, t, full_shape, dim):
            leaves[key][label] = {
                "dim": dim, "shape": list(full_shape),
                "extents": ladder.slice_extents(full_shape[dim]),
                "ranks": [[self._mesh_rank({data_axis: d})]
                          for d in range(world)]}
            if writes((data_axis,)):
                mine[key][label] = t

        def keep_cut(key, label, t, cut):
            leaves[key][label] = {
                "dim": None, "shape": list(cut.full),
                "cut": io_ops.cut_layout(cut),
                "ranks": [self._cut_ranks(cut.group_axes)]}
            if writes(cut.group_axes):
                mine[key][label] = t

        def cut_of(name, t):
            cut = cuts.get(name)
            return cut if cut is not None and (
                tuple(t.shape) == cut.local) else None

        for n, t in state["variables"].items():
            i = index.get(n)
            if cut_of(n, t) is not None:
                keep_cut("variables", n, t, cuts[n])
            elif sharded and world > 1 and i in freed:
                d = ladder.sliced_dim(i)
                part = t.unflatten(d, (world, -1)).movedim(d, 0)[ladder.rank]
                keep_slice("variables", n, part, t.shape, d)
            else:
                out["variables"][n] = t
        for label, v in state["opt_state"].items():
            pname = label.rpartition("/")[0]
            i = index[pname]
            d = ladder.sliced_dim(i)
            full = ladder.params[i].shape
            if v.dim() and cut_of(pname, v) is not None:
                keep_cut("opt_state", label, v, cuts[pname])
            elif d is None or world == 1 or v.dim() == 0:
                out["opt_state"][label] = v
            elif sharded:
                keep_slice("opt_state", label, v, full, d)
            else:
                out["opt_state"][label] = ladder.gather_slice(v, d)
        for n, g in (state["grad_buf"] or {}).items():
            i = index[n]
            d = ladder.accumulator_dim(i)
            if self.world_size == 1:
                out["grad_buf"][n] = g
            elif d is not None:
                if sharded:
                    keep_slice("grad_buf", n, g, ladder.params[i].shape, d)
                else:
                    out["grad_buf"][n] = ladder.gather_slice(g, d)
            elif sharded:
                mine["grad_buf"][n] = g
                local.append(n)
            else:
                mean = g.clone()
                dist.all_reduce(mean, op=dist.ReduceOp.AVG,
                                group=self._group)
                out["grad_buf"][n] = mean
                for r, part in enumerate(gather_by_rank(g, self._group)):
                    out["grad_local"][f"{n}@{r}"] = part
        if state["grad_buf"] is None:
            out["grad_buf"] = None
        if not out["grad_local"]:
            del out["grad_local"]
        if not sharded:
            return out, None, None
        layout = {"leaves": {k: v for k, v in leaves.items() if v},
                  "grad_local": local}
        if several:
            layout["mesh"] = {"axes": list(mesh.mesh_dim_names),
                              "shape": list(mesh.mesh.shape)}
        return out, {k: v for k, v in mine.items() if v}, layout

    def _opt_spec(self, params: Dict[str, torch.Tensor],
                  held: Dict[str, torch.Tensor]):
        """``spec(name)`` of the optimizer's arrays, whole: None for a
        parameter the optimizer does not hold or a state key its live state
        lacks; the live state tensor's where there is one (the whole
        leaf's shape for a state the optimizer keeps of a slice); for an
        optimizer that has not stepped yet, a scalar fp32 ``step`` or a
        tensor shaped like its parameter."""
        def spec(key: str) -> io_ops.Spec:
            pname, _, skey = key.rpartition("/")
            p, o = params.get(pname), held.get(pname)
            if p is None or o is None:
                return None
            state = self.optimizer.state.get(o, {})
            if state and skey not in state:
                return None
            live = state.get(skey)
            # a split parameter's state is saved whole
            whole = (p.shape if self._tp is None
                     else self._tp.full_shape(pname, p.shape))
            if torch.is_tensor(live):
                shape = (whole if live.dim() and live.shape == o.shape
                         else live.shape)
                return tuple(shape), io_ops.numpy_dtype(live.dtype)
            if skey == "step":
                return (), np.dtype(np.float32)
            return tuple(whole), io_ops.spec_of(p)[1]
        return spec

    def _my_part(self, a: np.ndarray, dim: Optional[int]) -> np.ndarray:
        """This rank's slice of a whole leaf's array along ``dim`` (the
        ladder's rank-major split), or the array itself."""
        ladder = self._ladder
        if dim is None or ladder is None or ladder.world == 1:
            return a
        return np.ascontiguousarray(
            np.split(a, ladder.world, axis=dim)[ladder.rank])

    @_timed("load")
    def load(self, path: str, tag: Optional[str] = None,
             name: str = "stoke") -> Dict[str, Any]:
        """Restore a checkpoint: the newest tag of ``name`` under ``path``,
        or ``tag``. Every array is checked by name, shape and dtype
        against the live state first (``ValueError`` naming the first that
        differs), then copied into the live tensors (so a window captured
        as a CUDA graph replays from the loaded state), and the counters
        are restored. A tag saved mid-window restores the accumulated
        gradients and the window's counter; one without them restarts the
        window from zero. Across processes every rank reads the tag (of
        either format, saved at any world size) and takes its slices; a
        rank resumes its own accumulated gradients and dropout generator
        when the tag was saved at this world size, else the global
        batch's mean gradients. Returns the tag's extras."""
        with self._whole_params(), self._engine.resident_state():
            extras = self._load_whole(path, tag, name)
            if self._ladder is not None:
                self._ladder.load_from_params()
        return extras

    def _load_whole(self, path: str, tag: Optional[str],
                    name: str) -> Dict[str, Any]:
        sd = self._module.state_dict()
        params = dict(self._module.named_parameters())
        held = {n: o for o, n in self._param_names().items()}
        scaler = self._engine.scaler
        ladder = self._ladder
        index = self._leaf_index() if ladder is not None else {}

        tp = self._tp

        def like(tensors):
            if tp is None:
                return lambda n: (io_ops.spec_of(tensors[n])
                                  if n in tensors else None)
            # a split model's arrays are saved whole
            return lambda n: ((tp.full_shape(n, tensors[n].shape),
                               io_ops.numpy_dtype(tensors[n].dtype))
                              if n in tensors else None)

        with trace_span("stoke/io", track="io"):
            payload = io_ops.load_checkpoint(
                path, tag,
                {"variables": (like(sd), sd.keys()),
                 "opt_state": (self._opt_spec(params, held), ()),
                 "scaler_state": (like(scaler), scaler.keys()),
                 "grad_buf": (like(params), ())},
                name=name if tag is None else None)
        port = payload["port"]
        self._check_param_groups(port.get("param_groups"))
        opt = {}
        cut = tp.take if tp is not None else (lambda n, a: a)
        for key, a in payload["opt_state"].items():
            pname = key.rpartition("/")[0]
            sliced = (ladder.sliced_dim(index[pname])
                      if pname in index and a.ndim else None)
            opt[key] = self._my_part(cut(pname, a), sliced)
        with torch.no_grad():
            for n, a in payload["variables"].items():
                sd[n].copy_(io_ops.from_numpy(cut(n, a), sd[n].dtype))
            for n, a in payload["scaler_state"].items():
                scaler[n].copy_(io_ops.from_numpy(a, scaler[n].dtype))
            self._restore_optimizer(opt, port, held)
            grads = payload["grad_buf"]
            own = (payload["grad_local"]
                   if payload["world"] == self.world_size else None) or {}
            if ladder is not None:
                ladder.drop_grads()
            for n, p in params.items():
                if grads is None or n not in grads:
                    p.grad = None
                    continue
                i = index.get(n)
                dim = ladder.accumulator_dim(i) if i is not None else None
                if dim is not None:
                    ladder.accumulator(i).copy_(io_ops.from_numpy(
                        self._my_part(grads[n], dim), p.dtype))
                    p.grad = None
                    continue
                a = own[n][self.rank] if n in own else grads[n]
                g = io_ops.from_numpy(cut(n, a), p.dtype).to(p.device)
                if p.grad is not None and p.grad.shape == p.shape:
                    p.grad.copy_(g)
                else:
                    p.grad = g
        if port.get("generator_device") == self._device.type:
            gens = port.get("generators")
            if (gens is not None and len(gens) == self.world_size
                    and payload["world"] == self.world_size):
                self._generator.set_state(
                    torch.from_numpy(gens[self.rank]))
            elif self.world_size == 1:
                self._generator.set_state(torch.from_numpy(port["generator"]))
        counters = payload["counters"]
        self._backward_steps = counters["backward_step"]
        self._optimizer_steps = counters["optimizer_step"]
        self._grad_accum_counter = (counters["grad_accum_step"]
                                    if grads is not None else 0)
        self._pending = None
        return payload.get("extras") or {}

    def _check_param_groups(self, saved: Optional[List[dict]]) -> None:
        """Raise ``ValueError`` when the tag's param groups are not the
        live optimizer's: another count, other parameters, or other
        hyperparameter keys (another optimizer class)."""
        if saved is None:
            return
        names = self._param_names()
        live = self.optimizer.param_groups
        if len(saved) != len(live):
            raise ValueError(
                f"Stoke -- checkpoint opt_state has {len(saved)} param "
                f"groups; the optimizer has {len(live)}")
        for i, (a, b) in enumerate(zip(saved, live)):
            if a["params"] != [names[p] for p in b["params"]]:
                raise ValueError(
                    f"Stoke -- checkpoint opt_state param group {i} holds "
                    f"other parameters than the optimizer's")
            keys = set(a) ^ set(b)
            if keys:
                raise ValueError(
                    f"Stoke -- checkpoint opt_state param group {i} differs "
                    f"from the optimizer's in {sorted(keys)[0]!r} (written "
                    f"by another optimizer?)")

    def _restore_optimizer(self, arrays: Dict[str, np.ndarray],
                           port: Dict[str, Any],
                           params: Dict[str, torch.Tensor]) -> None:
        """The optimizer's state and param groups from a checkpoint: into
        the live state tensors by ``copy_`` where they exist with the same
        shape and dtype; state the live optimizer lacks is created (on the
        parameter's device; a ``step`` count stays on the CPU unless the
        group is capturable or fused, as ``torch.optim`` keeps it) and the
        captured windows, which hold the old tensors' addresses, are
        dropped."""
        opt = self.optimizer
        owner = {p: g for g in opt.param_groups for p in g["params"]}
        wanted: Dict[torch.Tensor, Dict[str, Any]] = {p: {} for p in owner}
        for key, a in arrays.items():
            pname, _, skey = key.rpartition("/")
            wanted[params[pname]][skey] = a
        for key, v in port.get("opt_values", {}).items():
            pname, _, skey = key.rpartition("/")
            if pname in params:
                wanted[params[pname]][skey] = v
        rebound = False
        for p, want in wanted.items():
            live = opt.state[p] if p in opt.state else {}
            for skey in [k for k in live if k not in want]:
                del live[skey]
                rebound = True
            for skey, v in want.items():
                if not isinstance(v, np.ndarray):
                    live[skey] = v
                    continue
                cur = live.get(skey)
                dtype = (p.dtype if (v.shape, v.dtype) == io_ops.spec_of(p)
                         else torch.from_numpy(np.empty(0, v.dtype)).dtype)
                if torch.is_tensor(cur) and io_ops.spec_of(cur) == (
                        v.shape, v.dtype):
                    cur.copy_(io_ops.from_numpy(v, cur.dtype))
                    continue
                group = owner[p]
                on_cpu = skey == "step" and not (group.get("capturable")
                                                 or group.get("fused"))
                live[skey] = io_ops.from_numpy(v, dtype).to(
                    "cpu" if on_cpu else p.device, copy=True)
                rebound = True
            if live:
                opt.state[p] = live
            elif p in opt.state:
                del opt.state[p]
        for group, saved in zip(opt.param_groups,
                                port.get("param_groups", ())):
            for k, v in saved.items():
                if k == "params" or k in _DEVICE_FLAGS:
                    continue
                cur = group.get(k)
                if torch.is_tensor(cur) and torch.is_tensor(v):
                    cur.copy_(v)
                else:
                    group[k] = v
        if rebound:
            self._engine.drop_windows()

    def wait_for_checkpoint(self) -> None:
        """Block until the async saves in flight have finished; raise if
        one failed (its partial tag is removed)."""
        io_ops.wait_for_saves()

    def maybe_resume(self, path: Optional[str] = None) -> bool:
        """Load the newest tag of ``CheckpointConfig.auto_name`` under
        ``path`` (default ``CheckpointConfig.auto_path``) if there is one.
        Returns whether one was loaded; with the periodic auto-save this
        makes a training loop restart-safe."""
        cfg = self._status_obj.checkpoint_config
        target = path or cfg.auto_path
        if not target:
            return False
        try:
            self.load(target, name=cfg.auto_name)
            return True
        except FileNotFoundError:
            return False

    def _note_durable_save(self, step: int) -> None:
        """One save's write landed (possibly on its writer thread): the
        lost-goodput estimate prices the steps beyond it."""
        self._last_save_step = max(self._last_save_step, int(step))

    # ------------------------------------------------------------------ #
    # resilience: preemption, emergency saves, verified resume
    # ------------------------------------------------------------------ #

    @property
    def resilience(self) -> Optional[ResilienceMonitor]:
        """The run's resilience monitor (None without a
        ``ResilienceConfig``): the preemption flag, the fault injector and
        the ``resilience/*`` counters."""
        return self._resilience

    @property
    def resilience_summary(self) -> Optional[Dict[str, Any]]:
        """Restarts, preemptions, emergency saves, quarantined tags and
        the resumed and lost steps; None without a ``ResilienceConfig``."""
        if self._resilience is None:
            return None
        return self._resilience.summary()

    @property
    def restart_attempt(self) -> int:
        """The supervisor's attempt this process is
        (``STOKE_RESTART_ATTEMPT``; 0 on a first run or without a
        ``ResilienceConfig``)."""
        return 0 if self._resilience is None else self._resilience.restarts

    def _comm_layout(self) -> Optional[Dict[str, Any]]:
        """The gradient transport's residual layout (None without one)."""
        order = self._engine.comm_order
        if order is None:
            return None
        return self._engine.transport.layout_descriptor(
            order.sizes())

    def topology_descriptor(self) -> Dict[str, Any]:
        """This run's topology and sharding descriptor (the JAX facade's
        keys): mesh, process and device counts, the tier, the resolved
        ``shard_updates``, the parameters' count and elements, and the
        transport's residual layout. Every manifest this facade writes
        carries it; :meth:`resume` compares a checkpoint's against it.
        A model split's leaves count whole, as the JAX tree's do."""
        st = self._status_obj
        names = {p: n for n, p in self._module.named_parameters()}
        full = (self._tp.full_shape if self._tp is not None
                else (lambda n, shape: shape))
        sizes = [math.prod(full(names[p], p.shape))
                 for p in self._engine.params]
        dp = self._group is not None
        return {
            "version": 1,
            "process_count": int(self.n_processes),
            "device_count": int(self.world_size),
            "mesh_axes": list(st.mesh_config.axes) if dp else None,
            # the config's axes (the port's mesh may hold a data axis of
            # 1 in front of them), as the JAX facade counts them
            "mesh_shape": ([self._mesh.shape[self._mesh.mesh_dim_names.index(
                a)] for a in st.mesh_config.axes] if dp else None),
            "tier": st.sharding_tier.value,
            "shard_updates": bool(
                comm_shard_updates(st.comm_config, st.sharding_tier)),
            "axis_name": st.mesh_config.axes[0] if dp else None,
            "param_leaves": len(sizes),
            "param_elems": int(sum(sizes)),
            "comm": self._comm_layout(),
        }

    def _descriptor_incompatible(
            self, saved: Optional[Dict[str, Any]]) -> Optional[str]:
        """Why a saved descriptor cannot serve this run (None: it can; a
        topology difference is what elastic resume remaps). Another
        parameter tree cannot: the reason names the remedy."""
        if not saved:
            return None
        cur = self.topology_descriptor()
        for key in ("param_elems", "param_leaves"):
            if key in saved and saved[key] != cur[key]:
                return (
                    f"incompatible checkpoint: saved {key}={saved[key]} "
                    f"vs current {key}={cur[key]} — the checkpoint was "
                    f"written by a different MODEL; resume with the "
                    f"saving architecture, or point resume() at this "
                    f"run's own checkpoint root"
                )
        return None

    @staticmethod
    def _topology_changed(saved: Optional[Dict[str, Any]],
                          cur: Dict[str, Any]) -> bool:
        """Whether the run changed shape between save and resume (what
        ``resilience/elastic_resumes`` counts)."""
        if not saved:
            return False
        return any(saved.get(k) != cur.get(k)
                   for k in ("mesh_shape", "process_count", "device_count",
                             "tier", "shard_updates"))

    def resume(self, path: Optional[str] = None, name: str = "stoke") -> bool:
        """Restore the newest VALID checkpoint and the step counters.

        Candidates: the resilience emergency root first, then ``path`` (or
        ``CheckpointConfig.auto_path``), ordered by backward step across
        them. Each is verified against its ``manifest.json`` and its
        topology descriptor; a corrupt, partial or incompatible one is
        quarantined (renamed under ``<root>/quarantine/``, never deleted)
        with the reason and remedy, and the next newest is tried. An
        emergency tag also restores the state its extras carry (the
        generator, the loss EMA, the skipped steps, the error-feedback
        residual, remapped when the layout changed), so the resumed
        trajectory is the uninterrupted one bit for bit. Across processes
        rank 0 verifies and quarantines and broadcasts its (root, step)
        pick. Returns False when there is no valid tag (start fresh).
        Without a ``ResilienceConfig``: no quarantine."""
        mon = self._resilience
        ckpt_cfg = self._status_obj.checkpoint_config
        roots = []
        if mon is not None:
            roots.append((mon.cfg.save_path, mon.cfg.save_name))
        if path:
            roots.append((path, name))
        elif ckpt_cfg.auto_path:
            roots.append((ckpt_cfg.auto_path, ckpt_cfg.auto_name))
        if not roots:
            return False
        # the newest step recorded anywhere, before any quarantine: the
        # lost-steps accounting charges the gap to the restored tag
        newest_step = max((c["step"] for root, nm in roots
                           for c in list_checkpoints(root, nm)),
                          default=None)
        verify = mon.cfg.verify_on_resume if mon is not None else True
        quarantine = mon.cfg.quarantine if mon is not None else False
        manifests: Dict[str, Any] = {}

        def validate(tag_dir):
            manifest = read_manifest(tag_dir)
            manifests[tag_dir] = manifest
            reason = self._descriptor_incompatible(
                (manifest or {}).get("topology"))
            return (False, reason) if reason is not None else (True, "ok")

        def on_quarantine(tag_dir, dest, reason):
            self.warn(f"quarantined corrupt checkpoint {tag_dir} -> "
                      f"{dest or '<rename failed>'} ({reason})")
            if mon is not None:
                mon.note_quarantined(tag_dir, dest, reason)

        def pick():
            return find_latest_valid_checkpoint(
                roots, verify=verify, quarantine=quarantine,
                on_quarantine=on_quarantine, validate_fn=validate)

        if self.world_size > 1:
            # one validator, one choice: ranks loading different tags
            # would diverge
            choice = torch.tensor([-1, -1], dtype=torch.int64)
            if self.is_rank_0:
                cand = pick()
                if cand is not None:
                    choice = torch.tensor([next(
                        i for i, (r, n) in enumerate(roots)
                        if r == cand["root"] and n == cand["name"]),
                        cand["step"]], dtype=torch.int64)
            choice = choice.to(self._device)
            dist.broadcast(choice, 0, group=self._group)
            idx, step = (int(v) for v in choice.cpu())
            cand = None
            if idx >= 0:
                root, nm = roots[idx]
                tag = io_ops.checkpoint_tag(nm, step)
                cand = {"root": root, "tag": tag, "name": nm, "step": step,
                        "tag_dir": os.path.join(root, tag)}
        else:
            cand = pick()
        if cand is None:
            return False
        manifest = manifests.get(cand["tag_dir"])
        if manifest is None:
            manifest = read_manifest(cand["tag_dir"])
        saved_topo = (manifest or {}).get("topology")
        extras = self.load(cand["root"], tag=cand["tag"])
        rs = extras.get("resilience") if isinstance(extras, dict) else None
        if rs:
            self._restore_resume_state(rs)
        if mon is not None:
            lost = None
            if newest_step is not None:
                lost = max(0, newest_step - cand["step"]) // max(
                    self._status_obj.grad_accum, 1)
            mon.note_resumed(self._optimizer_steps, lost_steps=lost)
            cur_topo = self.topology_descriptor()
            if self._topology_changed(saved_topo, cur_topo):
                mon.note_elastic_resume(saved_topo, cur_topo)
                self.info(
                    f"elastic resume: checkpoint saved on mesh "
                    f"{(saved_topo or {}).get('mesh_shape')} (tier "
                    f"{(saved_topo or {}).get('tier')}), resumed onto "
                    f"{cur_topo.get('mesh_shape')} (tier "
                    f"{cur_topo.get('tier')})")
        self.info(f"resumed from {cand['tag_dir']} at optimizer step "
                  f"{self._optimizer_steps}")
        return True

    def _resilience_boundary(self, window: int = 1) -> None:
        """After ``window`` optimizer steps: drive the fault injector and,
        when a preemption notice arrived (on any rank: the flag is
        all-reduced), run the drain, save and exit here, with the steps
        complete."""
        mon = self._resilience
        if mon is None:
            return
        now = time.perf_counter()
        if self._last_boundary_t is not None and window > 0:
            per_step = (now - self._last_boundary_t) / window
            self._step_wall_ema = (
                per_step if self._step_wall_ema is None
                else 0.7 * self._step_wall_ema + 0.3 * per_step)
        self._last_boundary_t = now
        mon.chaos.on_step(self._optimizer_steps, window)
        preempt = mon.preempt_requested
        if self.world_size > 1:
            # a notice reaches one host: every rank drains at the same step
            flag = torch.tensor([1 if preempt else 0], dtype=torch.int32,
                                device=self._device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
            peer = bool(int(flag.cpu()[0]))
            if peer and not preempt:
                mon.request_preemption("peer-preemption")
            preempt = peer
        if preempt:
            self._handle_preemption()

    def _handle_preemption(self) -> None:
        mon = self._resilience
        mon.note_preemption_honored()
        step = self._optimizer_steps
        self.warn(
            f"preemption notice ({mon.preempt_signal}) honored at "
            f"optimizer step {step}: draining async saves, writing the "
            f"emergency checkpoint")
        tag_dir = None
        try:
            tag_dir = self._emergency_save()
            mon.note_emergency_saved(tag_dir)
        except Exception as e:
            # the supervisor still restarts from the last periodic tag
            self.warn(f"emergency checkpoint failed: {e!r}")
        if self._health is not None:
            try:
                self._health.dump("preemption", extra={
                    "step": step,
                    "signal": mon.preempt_signal,
                    "emergency_tag": tag_dir,
                    "step_ema_s": self._step_wall_ema,
                    "lost_steps_estimate": (
                        0 if tag_dir is not None
                        else max(0, step - self._last_save_step)),
                })
            except Exception:
                pass
        if mon.cfg.exit_on_preempt:
            try:
                self.close_telemetry()
            except Exception:
                pass
        mon.exit_or_raise(step, tag_dir)

    def _emergency_save(self) -> str:
        """A synchronous checkpoint under the resilience root, after the
        async saves drained (the staged snapshots first) and the card's
        queued work finished, with the emergency keep window; its extras
        carry :meth:`_resume_state`."""
        mon = self._resilience
        try:
            self.wait_for_checkpoint()
        except RuntimeError as e:
            self.warn(f"async checkpoint drain reported failures: {e}")
        self.block_until_ready()
        cfg = dataclasses.replace(self._status_obj.checkpoint_config,
                                  async_save=False,
                                  max_to_keep=mon.cfg.max_to_keep)
        return self._save_with_config(
            mon.cfg.save_path, mon.cfg.save_name, cfg,
            {"resilience": self._resume_state()})

    def _resume_state(self) -> Dict[str, Any]:
        """The training state outside the checkpoint payload, on the host:
        the counters, the generator, the loss EMA, the skipped steps and
        the transport's state (key and whole residual buckets) with its
        layout."""
        mon = self._resilience
        state: Dict[str, Any] = {
            "optimizer_step": self._optimizer_steps,
            "backward_step": self._backward_steps,
            "preempt_signal": mon.preempt_signal if mon is not None else None,
            "restart_attempt": mon.restarts if mon is not None else 0,
            "rng": {"device": self._device.type, "world": self.world_size,
                    "state": self._generator.get_state().numpy()},
            "ema_loss": (None if self._rolling_mean_loss is None
                         else float(self._rolling_mean_loss)),
            "ema_initialized": self._rolling_mean_loss is not None,
            "skipped_steps": float(self._skipped_steps),
        }
        comm = self._engine.comm_state
        if comm:
            host: Dict[str, Any] = {"rng": comm["rng"].cpu().numpy()}
            if "residual" in comm:
                whole = []
                for r in comm["residual"]:
                    if self._engine.transport.layout_kind == "sharded" and (
                            self._ladder is not None):
                        r = torch.cat(gather_by_rank(r, self._ladder.group))
                    whole.append(r.cpu().numpy())
                host["residual"] = whole
            state["comm_state"] = host
            state["comm_layout"] = self._comm_layout()
        return state

    def _restore_resume_state(self, rs: Dict[str, Any]) -> None:
        try:
            rng = rs.get("rng")
            if (isinstance(rng, dict) and rng.get("device") == self._device.type
                    and rng.get("world") == self.world_size == 1):
                self._generator.set_state(torch.from_numpy(rng["state"]))
            if rs.get("ema_loss") is not None:
                self._rolling_mean_loss = torch.tensor(
                    rs["ema_loss"], dtype=torch.float32, device=self._device)
            if rs.get("skipped_steps") is not None:
                self._skipped_steps.fill_(float(rs["skipped_steps"]))
            host = rs.get("comm_state")
            comm = self._engine.comm_state
            if host and comm:
                comm["rng"].copy_(torch.from_numpy(
                    np.asarray(host["rng"])).to(comm["rng"].device))
                if "residual" in host and "residual" in comm:
                    self._restore_residual(host["residual"],
                                           rs.get("comm_layout"))
        except Exception as e:
            # an extras blob of another model or transport degrades to a
            # plain resume of the payload and the counters
            self.warn(f"could not restore emergency resume extras: {e!r}")

    def _restore_residual(self, saved: List[np.ndarray],
                          saved_desc: Optional[Dict[str, Any]]) -> None:
        """The saved residual (whole padded buckets) into the live one,
        remapped when the saved layout differs (world, buckets, kind);
        this rank takes its slice under the sharded transport."""
        cur_desc = self._comm_layout()
        if saved_desc and cur_desc and (
                saved_desc["kind"] != cur_desc["kind"]
                or saved_desc["buckets"] != cur_desc["buckets"]
                or saved_desc["world"] != cur_desc["world"]):
            saved = remap_residual(saved, saved_desc, cur_desc)
        live = self._engine.comm_state["residual"]
        sharded = self._engine.transport.layout_kind == "sharded"
        with torch.no_grad():
            for dst, whole in zip(live, saved):
                src = torch.from_numpy(np.asarray(whole, np.float32))
                if sharded and self._engine.transport.world > 1:
                    # the data coordinate's part, alike across a second axis
                    n, r = dst.numel(), self._engine.transport.rank
                    src = src[r * n:(r + 1) * n]
                dst.copy_(src.to(dst.device))

    @staticmethod
    def _crossed_boundary(steps: int, every: int, window: int) -> bool:
        """Whether a multiple of ``every`` lies in ``(steps - window,
        steps]``: a path that advanced the step count by ``window``
        crossed a boundary."""
        return steps > 0 and steps // every > (steps - window) // every

    def _after_optimizer_steps(self, window: int = 1) -> None:
        """What follows ``window`` optimizer steps, as in the JAX facade:
        the TensorBoard metrics, the telemetry step event, then the
        periodic auto-save, each when the steps crossed its cadence, and
        last the resilience boundary (the fault injector, a preemption's
        emergency save)."""
        self._maybe_log_metrics(window)
        self._maybe_emit_telemetry(window)
        self._maybe_auto_save(window)
        self._resilience_boundary(window)

    # ------------------------------------------------------------------ #
    # telemetry step records and the health monitor
    # ------------------------------------------------------------------ #

    def _telemetry_will_record(self, window: int = 1) -> bool:
        """True when the optimizer step(s) about to complete cross the
        telemetry logging cadence (decides whether to pay for the optional
        samples: the grad norm, the device-time bracket)."""
        t = self._telemetry
        return t.enabled and self._crossed_boundary(
            self._optimizer_steps + window, t.config.log_every_n_steps,
            window)

    def _device_clock_start(self, will_record: bool) -> Optional[float]:
        """Start of a device-time sample of the step about to run (at the
        logging cadence, with ``sample_device_time``): the queued work
        drained first so the bracket holds this step alone; None when no
        sample is taken."""
        if not (will_record and self._telemetry.will_sample_device()):
            return None
        self.block_until_ready()
        return time.perf_counter()

    def _device_clock_stop(self, t0: Optional[float]) -> None:
        if t0 is not None:
            self.block_until_ready()
            self._telemetry.observe_device_step(time.perf_counter() - t0)

    def _health_loss_input(self) -> Optional[torch.Tensor]:
        """The 4-call apply's sentinel loss: the last undivided micro loss
        (0 before any), None without sentinels."""
        if not self._engine.sentinels:
            return None
        if self._last_step_loss is not None:
            return self._last_step_loss
        return torch.zeros((), dtype=torch.float32, device=self._device)

    def _step_rows(self) -> tuple:
        """The last step's (sentinel row, numerics matrix) on the
        device."""
        return self._engine.sentinel_row, self._engine.numerics_row

    def _observe_numerics(self, rows: List[Optional[torch.Tensor]],
                          window: int = 1) -> None:
        """Feed the just-completed steps' group matrices (computed in
        their own applies) to the numerics monitor in one read, before the
        health observation whose ``numerics_provenance`` detector drains
        what they show."""
        m = self._numerics
        if m is None or not rows or rows[0] is None:
            return
        m.observe_window(self._optimizer_steps - window + 1,
                         torch.stack(rows).float().cpu().numpy())

    def _observe_health(self, rows: List[tuple], window: int = 1) -> None:
        """Feed the just-completed ``window`` optimizer steps to the
        numerics monitor and then the health monitor: ``rows`` are each
        step's (sentinel row, numerics matrix), read back in one transfer
        each (they were computed in the steps' own applies), the detectors
        run step by step, and the last row kept for the step event. A
        ``halt`` detector raises :class:`HealthHaltError` from here, at
        the facade boundary."""
        self._observe_numerics([r[1] for r in rows], window)
        h = self._health
        if h is None:
            return
        rows = [r[0] for r in rows]
        arr = None
        if rows and rows[0] is not None:
            arr = torch.stack(rows).float().cpu().numpy()
            self._last_sentinels = arr[-1]
            t = self._telemetry
            if t.enabled and t.config.grad_norm:
                # the in-step grad norm replaces the extra reduction
                gn = float(arr[-1][SENTINEL_INDEX["grad_norm"]])
                self._last_grad_norm = gn
                t.registry.gauge("train/grad_norm").set(gn)
        first = self._optimizer_steps - window + 1
        for i in range(window):
            h.observe(first + i, arr[i] if arr is not None else None)

    def _maybe_emit_telemetry(self, window: int = 1) -> None:
        """One structured step event at the telemetry cadence (JSONL /
        Prometheus / TensorBoard); the device values (EMA loss, loss
        scale) are read on the host only here."""
        if self._tracer is not None:
            # tag later spans with the last completed optimizer step (the
            # anchor the cross-rank trace merge aligns on)
            self._tracer.set_step(self._optimizer_steps)
        t = self._telemetry
        if not t.enabled or self._optimizer_steps == 0:
            return
        if self._attribution is not None:
            # closes an auto-capture once it covered its steps
            self._attribution.on_step(self._optimizer_steps)
        # one optimizer step consumes one (global) effective batch
        t.add_samples((self._status_obj.effective_batch_size or 0) * window)
        comm = self.comm_bytes
        if comm is not None:
            t.registry.counter("comm/grad_bytes_prequant_total").inc(
                comm["prequant"] * window)
            t.registry.counter("comm/grad_bytes_onwire_total").inc(
                comm["onwire"] * window)
            if "param_gather" in comm:
                t.registry.counter("comm/param_gather_bytes_total").inc(
                    comm["param_gather"] * window)
        if not self._crossed_boundary(
                self._optimizer_steps, t.config.log_every_n_steps, window):
            return
        self._sample_wire_error()
        scaled = self._precision.scaled
        sent = (unpack_sentinels(self._last_sentinels)
                if self._last_sentinels is not None else {})
        record = t.record_step(
            self._optimizer_steps,
            window_steps=window,
            ema_loss=self.ema_loss,
            step_loss=self.step_loss,
            grad_norm=self._last_grad_norm,
            loss_scale=self.loss_scale if scaled else None,
            skipped_steps=self.skipped_optimizer_steps if scaled else 0.0,
            comm_residual_norm=self._comm_residual_norm(),
            param_norm=sent.get("param_norm"),
            update_ratio=sent.get("update_ratio"),
            nonfinite_leaves=sent.get("nonfinite_leaves"),
            health_anomalies=(float(self._health.anomaly_count)
                              if self._health is not None else None),
        )
        if record is not None and self._health is not None:
            # the flight recorder's ring replays the step events
            self._health.recorder.record_event(record)
        self._last_grad_norm = None

    def _comm_residual_norm(self) -> Optional[float]:
        """The error-feedback residual's norm (one reduction and a read, at
        the logging cadence only), None without error feedback; this
        rank's slice under the sharded transport."""
        residual = self._engine.comm_state.get("residual")
        if not residual:
            return None
        with torch.no_grad():
            norm = float(torch.stack(
                [torch.linalg.vector_norm(r) for r in residual]).norm())
        self._telemetry.registry.gauge("comm/residual_norm").set(norm)
        return norm

    def close_telemetry(self) -> None:
        """Flush and close the telemetry sinks, export the trace (with
        ``TraceConfig.export_on_close``), close the health monitor (its
        watchdog thread and signal handlers) and free the staged saves'
        pinned buffers; idempotent. The ops plane unbinds first, and a
        straggler streak that completed on the last fleet window is drained
        into the health monitor."""
        if (self._health is not None and self._fleet is not None
                and self._fleet._pending_straggler is not None):
            # no later step observation would drain it; a halt from a
            # registry-driven detector must not raise out of shutdown
            try:
                self._health.observe(self._optimizer_steps, None)
            except HealthHaltError:
                pass
        if self._opsplane is not None:
            # unbind first: a scraper must not read closing subsystems
            self._opsplane.close()
        self._staging_pool.close()
        if self._tracer is not None:
            # stop receiving other runs' spans, then export the final ring
            unregister_recorder(self._tracer)
            tcfg = self._status_obj.trace_config
            if tcfg is not None and tcfg.export_on_close:
                try:
                    self._tracer.export()
                except OSError as e:
                    self.warn(f"trace export failed: {e}")
        self._telemetry.close()
        if self._resilience is not None:
            # resilience installed its handlers after the recorder, so it
            # uninstalls them first (its saved previous SIGTERM handler is
            # the recorder's)
            self._resilience.close()
        if self._health is not None:
            self._health.close()

    def _maybe_auto_save(self, window: int = 1) -> None:
        """Save under ``CheckpointConfig.auto_path`` when the last
        ``window`` optimizer steps crossed a multiple of
        ``save_every_n_steps``."""
        cfg = self._status_obj.checkpoint_config
        if (cfg.save_every_n_steps and cfg.auto_path
                and self._crossed_boundary(self._optimizer_steps,
                                           cfg.save_every_n_steps, window)):
            self.save(cfg.auto_path, name=cfg.auto_name)

    # ------------------------------------------------------------------ #
    # TensorBoard metrics (TensorboardConfig)
    # ------------------------------------------------------------------ #

    @property
    def _tb_writer(self) -> Optional[TBEventWriter]:
        """The event writer of ``TensorboardConfig`` on rank 0, made at
        first use under ``output_path/job_name``; None otherwise."""
        cfg = self._status_obj.tensorboard_config
        if cfg is None or not self.is_rank_0:
            return None
        if self._tb_writer_obj is None:
            self._tb_writer_obj = TBEventWriter(
                os.path.join(cfg.output_path, cfg.job_name))
        return self._tb_writer_obj

    def log_scalar(self, tag: str, value, step: Optional[int] = None) -> None:
        """Write a user scalar to TensorBoard now (with a
        ``TensorboardConfig``, on rank 0), at ``step`` or the optimizer
        step count, and into the telemetry gauge ``user/<tag>``; a tensor
        is read on the host."""
        value = float(value)
        self._telemetry.log_scalar(tag, value)
        w = self._tb_writer
        if w is not None:
            w.add_scalar(tag, value,
                         step if step is not None else self._optimizer_steps)

    def _maybe_log_metrics(self, window: int = 1) -> None:
        """The loss metrics of ``stoke_tpu/facade.py:1320-1346`` when the
        last ``window`` optimizer steps crossed a multiple of
        ``log_every_n_steps``: the loss EMA and micro loss, under fp16
        the loss scale(s) and skipped steps, and the backward count. Only
        here are the device values read on the host."""
        cfg = self._status_obj.tensorboard_config
        if (cfg is None or self._optimizer_steps == 0
                or not self._crossed_boundary(
                    self._optimizer_steps, cfg.log_every_n_steps, window)):
            return
        w = self._tb_writer
        if w is None:
            return
        step = self._optimizer_steps
        w.add_scalar("loss/ema", self.ema_loss, step)
        if self._last_step_loss is not None:
            w.add_scalar("loss/micro", self.step_loss, step)
        if self._precision.scaled:
            ls = self.loss_scale
            if isinstance(ls, list):  # per-loss scalers: one curve each
                for i, v in enumerate(ls):
                    w.add_scalar(f"scaler/loss_scale_{i}", v, step)
            else:
                w.add_scalar("scaler/loss_scale", ls, step)
            w.add_scalar("scaler/skipped_steps",
                         self.skipped_optimizer_steps, step)
        w.add_scalar("counters/backward_steps", self._backward_steps, step)
        w.flush()

    # ------------------------------------------------------------------ #
    # serving and the step's cost
    # ------------------------------------------------------------------ #

    def serve(self, **overrides):
        """A :class:`~stoke_tpu_torch.serving.ServingEngine` over this
        run's GPT and its current weights, on this run's device.

        Needs a ``ServeConfig`` in ``Stoke(configs=[...])`` (else
        ``StokeValidationError``) and a
        :class:`~stoke_tpu_torch.models.gpt.GPT` model (else
        ``TypeError``). ``overrides`` replace ``ServeConfig`` fields for
        this engine only and are checked by the same serve rules. The
        engine serves a copy of the model and its weights: training on
        does not change an engine already built (build another to serve
        newer weights). Across processes every rank builds the engine
        over the whole weights (under fsdp gathered for the copy, so every
        rank must call it)."""
        from stoke_tpu_torch.models.gpt import GPT
        from stoke_tpu_torch.serving.engine import ServingEngine

        scfg = self._status_obj.serve_config
        if scfg is None:
            raise StokeValidationError(
                "Stoke.serve() requires a ServeConfig — add one to "
                "Stoke(configs=[ServeConfig(...)]) (the serving stack is "
                "opt-in; docs/serving.md)"
            )
        if overrides:
            scfg = dataclasses.replace(scfg, **overrides)
            # cross-config rules (cost_cards needs an AttributionConfig)
            # see the run's companions
            companions = [c for c in (self._status_obj.attribution_config,
                                      self._status_obj.telemetry_config)
                          if c is not None]
            StokeStatus(batch_size_per_device=self.batch_size,
                        device=self._status_obj.device,
                        configs=[scfg] + companions)
        if not isinstance(self._module, GPT):
            raise TypeError(
                f"Stoke.serve() serves GPT models (the paged-KV decode "
                f"forward lives in models/gpt.py); this facade wraps "
                f"{type(self._module).__name__}"
            )
        # the copy shares the Stoke's dropout generator (eval mode draws
        # nothing from it) and nothing else
        shared = {id(m.generator): m.generator
                  for m in self._module.modules()
                  if isinstance(m, Dropout) and m.generator is not None}
        with self._whole_params():
            model = (copy.deepcopy(self._module, memo=shared)
                     if self._tp is None
                     else self._tp.whole_copy(self._module, memo=shared))
        engine = ServingEngine(
            model, model.state_dict(), scfg, device=self._device,
            # the run's peaks, which the serve roofline divides by
            attribution=(self._status_obj.attribution_config
                         if scfg.cost_cards else None),
            # the engine's own ledger (its weights and KV pool)
            memory=self._status_obj.memory_config)
        if self._opsplane is not None:
            # /requests and the /statusz serving block follow the newest
            # engine this facade built
            self._opsplane.attach_engine(engine)
        if self._numerics is not None and engine.quant_errors_by_group:
            # the int8 weights' error by group joins this run's numerics
            self._numerics.set_quant_errors(engine.quant_errors_by_group)
        return engine

    def estimate_step_flops(self, model_args: Any,
                            loss_args: Any = ()) -> float:
        """FLOPs of one training step on these inputs, by
        ``torch.utils.flop_counter.FlopCounterMode``: the products and
        convolutions of the forward and the backward (the optimizer's
        elementwise update has no FLOP formula there), with the flash
        kernels counted by their formula whether the kernels or their
        plain versions run. The run's state is as it was afterwards: the
        gradients, buffers, scaler state and dropout generator are put
        back, and no counter moves. Across ranks every rank must call it
        (the loss and BatchNorm still reduce over the ranks), and the
        gradients are not reduced."""
        from torch.utils.flop_counter import FlopCounterMode

        if not isinstance(model_args, tuple):
            model_args = (model_args,)
        if not isinstance(loss_args, tuple):
            loss_args = (loss_args,)
        view, (margs, largs) = self._place_call(model_args, loss_args)
        params = self._engine.params
        grads = [p.grad for p in params]
        buffers = {n: b.clone() for n, b in self._module.named_buffers()}
        scaler = {k: v.clone() for k, v in self._engine.scaler.items()}
        rng = self._generator.get_state()
        training = self.training
        self._module.train()
        try:
            for p in params:
                p.grad = None
            self._engine.sync = False
            with FlopCounterMode(display=False) as counter, \
                    using_seq_shard(view):
                self._engine.accum(margs, dict(self._train_kwargs), largs)
        finally:
            self._engine.sync = True
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.grad = g
                for n, b in self._module.named_buffers():
                    b.copy_(buffers[n])
                for k, v in scaler.items():
                    self._engine.scaler[k].copy_(v)
            self._generator.set_state(rng)
            self._module.train(training)
        return float(counter.get_total_flops())

    def estimate_step_cost(self, model_args: Any, loss_args: Any = ()):
        """The :class:`~stoke_tpu_torch.telemetry.attribution.CostCard` of
        one fused optimizer step at these inputs (forward, backward and
        the apply): FLOPs, bytes accessed and, with an
        ``AttributionConfig``'s peaks, the roofline-optimal time, counted
        by the funnel of the live cards
        (:func:`~stoke_tpu_torch.telemetry.attribution.counting`). The
        step runs on the device and everything it changed is put back: the
        parameters, gradients, buffers, optimizer state (what its first
        step would create is dropped again), scaler, transport state and
        dropout generator; no counter moves. Across ranks every rank must
        call it. Under ``OffloadDiskConfig`` the spill of the state is
        file IO a step repeats, so the estimate is refused there."""
        from stoke_tpu_torch.telemetry.attribution import CostCard, counting

        eng = self._engine
        if eng.disk_store is not None:
            raise ValueError(
                "Stoke -- estimate_step_cost runs a step and puts the "
                "state back; the disk tier (OffloadDiskConfig) would spill "
                "the stepped state to its files first. Estimate in a run "
                "without it")
        if not isinstance(model_args, tuple):
            model_args = (model_args,)
        if not isinstance(loss_args, tuple):
            loss_args = (loss_args,)
        view, (margs, largs) = self._place_call(model_args, loss_args)
        params = eng.params
        grads = [p.grad for p in params]
        buffers = {n: b.clone() for n, b in self._module.named_buffers()}
        scaler = {k: v.clone() for k, v in eng.scaler.items()}
        comm = {k: ([t.clone() for t in v] if isinstance(v, list)
                    else v.clone()) for k, v in eng.comm_state.items()}
        stateful = set(eng.optimizer.state)
        kept = {k: t.clone() for k, t in eng._guarded().items()}
        hosted = ([t.clone() for t in eng.host_state.host_tensors]
                  if eng.host_state is not None else [])
        rng = self._generator.get_state()
        training = self.training
        self._module.train()
        try:
            for p in params:
                p.grad = None
            eng.sync = True
            with counting() as cost, using_seq_shard(view):
                eng.accum(margs, dict(self._train_kwargs), largs)
                eng._apply()
        finally:
            with torch.no_grad():
                for p in [p for p in eng.optimizer.state
                          if p not in stateful]:
                    del eng.optimizer.state[p]
                live = eng._guarded()
                for k, t in kept.items():
                    if k in live:
                        live[k].copy_(t)
                if eng.host_state is not None:
                    for dst, src in zip(eng.host_state.host_tensors, hosted):
                        dst.copy_(src)
                for p, g in zip(params, grads):
                    p.grad = g
                for n, b in self._module.named_buffers():
                    b.copy_(buffers[n])
                for k, v in scaler.items():
                    eng.scaler[k].copy_(v)
                for k, v in comm.items():
                    if isinstance(v, list):
                        for dst, src in zip(eng.comm_state[k], v):
                            dst.copy_(src)
                    else:
                        eng.comm_state[k].copy_(v)
            self._generator.set_state(rng)
            self._module.train(training)
        acfg = self._status_obj.attribution_config
        return CostCard.from_cost(
            cost.as_dict(), "fused", 1,
            peak_tflops=acfg.peak_tflops if acfg is not None else 0.0,
            peak_hbm_gbps=acfg.peak_hbm_gbps if acfg is not None else 0.0)

    # ------------------------------------------------------------------ #
    # the observatories (numerics, memory, attribution)
    # ------------------------------------------------------------------ #

    def _sample_wire_error(self) -> None:
        """The error-feedback residual's norm by group, at the logging
        cadence (one small read); a failure is warned once and the signal
        left out."""
        m = self._numerics
        eng = self._engine
        if (m is None or not m.cfg.wire_error or eng.transport is None
                or not eng.comm_state.get("residual")):
            return
        try:
            from stoke_tpu_torch.telemetry.numerics import (
                wire_residual_group_norms,
            )

            m.observe_wire(wire_residual_group_norms(
                eng.transport, eng.comm_state, m.groups,
                eng.comm_order.sizes()))
        except Exception as e:
            if not self._wire_error_warned:
                self._wire_error_warned = True
                self.warn(f"per-layer wire-error attribution unavailable "
                          f"({type(e).__name__}: {e}); numerics wire_err "
                          f"will be absent this run")

    @property
    def numerics(self):
        """The run's numerics monitor (None without a ``NumericsConfig``)."""
        return self._numerics

    def numerics_summary(self) -> Optional[Dict[str, Any]]:
        """Groups ranked by gradient noise, quantization error and wire
        error, the latest per-group statistics and every provenance event;
        None without a ``NumericsConfig``."""
        if self._numerics is None:
            return None
        return self._numerics.summary()

    @property
    def memory(self):
        """The run's memory observatory (None without a ``MemoryConfig``)."""
        return self._memory_obs

    @property
    def memory_summary(self) -> Optional[Dict[str, Any]]:
        """The device-memory ledger: components ranked by bytes (summing
        to the resident total), the program cards, the pre-flight verdicts
        and the allocator's unattributed bytes; None without a
        ``MemoryConfig``."""
        if self._memory_obs is None:
            return None
        return self._memory_obs.summary()

    @property
    def attribution(self):
        """The run's attribution monitor (None without an
        ``AttributionConfig``): cost cards, MFU gauges, goodput, captures."""
        return self._attribution

    @property
    def fleet(self):
        """The run's fleet monitor (None without a ``FleetConfig``): the
        per-process signal matrix, skew aggregates, straggler streaks."""
        return self._fleet

    @property
    def fleet_summary(self) -> Optional[Dict[str, Any]]:
        """End-of-run fleet accounting: exchange windows, the latest
        per-process matrix, aggregates and straggler verdict, the
        straggler counts. None without a ``FleetConfig``."""
        return self._telemetry.fleet_summary()

    @property
    def opsplane(self):
        """The run's live ops plane (None without an ``OpsPlaneConfig``):
        the bound HTTP observatory serving /metrics, /healthz, /statusz,
        /requests, /trace and /profile for this rank."""
        return self._opsplane

    @property
    def goodput(self) -> Optional[Dict[str, Any]]:
        """The run's goodput accounting (None without an
        ``AttributionConfig``)."""
        return self._telemetry.goodput_summary()

    @property
    def compile_cache(self):
        """The run's persistent compile cache (None without a
        ``CompileConfig``): the kernel libraries' hit and miss counts,
        reclaimed build seconds (``.stats()``), and the cache directory."""
        return self._compile_cache

    def audit(
        self,
        serve=None,
        *,
        replicated_bytes_threshold: Optional[int] = None,
        churn_threshold: Optional[int] = None,
        cost_manifest: Optional[dict] = None,
        cost_tolerance: Optional[float] = None,
        mem_manifest: Optional[dict] = None,
        mem_tolerance: Optional[float] = None,
    ):
        """Static program audit of this live build: walk what the first
        run of every program the engine has run recorded (and, with
        ``serve=engine``, a serving engine's) and check the program
        invariants (:mod:`stoke_tpu_torch.analysis.program`): the declared
        in-place state, hidden host round-trips, recompile hazards, whole
        parameters on a model or expert group, collectives against the
        gradient exchange's accounting, and with a manifest the serve
        programs' cost drift.

        A walk over recorded facts: NO dispatch and no kernel launch
        (``dispatch_count`` and ``ops.LAUNCHES`` are equal before and
        after). Returns an :class:`~stoke_tpu_torch.analysis.program.
        AuditReport`; ticks ``analysis/programs_audited_total`` and
        ``analysis/audit_findings_total`` and warns on findings on rank 0.
        Run the step APIs you care about first: the audit covers what the
        engine ran."""
        from stoke_tpu_torch.analysis.program import audit_program_specs

        specs = self._engine.audit_specs()
        if serve is not None:
            specs += serve.audit_specs()
        kwargs = {}
        if replicated_bytes_threshold is not None:
            kwargs["replicated_bytes_threshold"] = replicated_bytes_threshold
        if churn_threshold is not None:
            kwargs["churn_threshold"] = churn_threshold
        if cost_manifest is not None:
            kwargs["cost_manifest"] = cost_manifest
        if cost_tolerance is not None:
            kwargs["cost_tolerance"] = cost_tolerance
        if mem_manifest is not None:
            kwargs["mem_manifest"] = mem_manifest
        if mem_tolerance is not None:
            kwargs["mem_tolerance"] = mem_tolerance
        transport = self._engine.transport
        report = audit_program_specs(
            specs,
            transport_active=bool(transport is not None
                                  and transport.active),
            comm_bytes=self.comm_bytes,
            shape_sig_counts=self._engine.shape_sig_counts(),
            **kwargs,
        )
        if self._engine._audit_truncated:
            report.notes.append(
                f"program inventory truncated at the engine's "
                f"{self._engine._MAX_AUDIT_SPECS}-spec audit cap — "
                f"programs first run after the cap were NOT audited")
        reg = self._telemetry.registry
        reg.counter("analysis/programs_audited_total",
                    help="programs checked by Stoke.audit()").inc(
                        len(report.programs))
        reg.counter("analysis/audit_findings_total",
                    help="program-audit findings").inc(len(report.findings))
        if report.findings and self.is_rank_0:
            import warnings

            warnings.warn(
                "Stoke -- program audit found "
                f"{len(report.findings)} issue(s):\n" + report.format())
        return report
    # ------------------------------------------------------------------ #
    # loss tracking (device tensors; read on the host only when asked)
    # ------------------------------------------------------------------ #

    def _update_loss_tracking(self, report) -> None:
        # losses arrive divided by grad_accum; track the undivided micro loss
        micro = sum(l.detach().float() for l in tree_leaves(report))
        micro = micro * self._status_obj.grad_accum
        self._last_step_loss = micro
        self._agg_loss = micro if self._agg_loss is None else self._agg_loss + micro
        self._agg_count += 1
        w = self._ema_weight
        self._rolling_mean_loss = (
            micro if self._rolling_mean_loss is None
            else (1.0 - w) * self._rolling_mean_loss + w * micro
        )

    def _reset_tracking_window(self) -> None:
        self._agg_loss = None
        self._agg_count = 0

    @property
    def ema_loss(self) -> float:
        """EMA of the undivided micro losses (the first loss seeds it)."""
        if self._rolling_mean_loss is None:
            return 0.0
        return float(self._rolling_mean_loss)

    @property
    def step_loss(self) -> Optional[float]:
        if self._last_step_loss is None:
            return None
        return float(self._last_step_loss)

    @property
    def mean_accumulated_loss(self) -> Optional[float]:
        if self._agg_count == 0:
            return None
        return float(self._agg_loss) / self._agg_count

    def reset_ema(self) -> None:
        """Restart the loss EMA (the next loss seeds it)."""
        self._rolling_mean_loss = None

    def reset_tracking(self) -> None:
        """Clear the loss tracking and the step counters; the partial
        gradient window goes with them."""
        self.reset_ema()
        self.reset()
        self._last_step_loss = None
        self._optimizer_steps = 0
        self._backward_steps = 0

    def detach_and_sync_loss(self, loss: Any,
                             user_reduction: str = "mean") -> float:
        """The host float of a loss (a tensor, or a tuple, list or dict of
        them: their sum). A loss from :meth:`loss` is already the global
        batch's. With ``DataParallelConfig(loss_reduction=LossReduction
        .sum)`` and a mean-reduced loss function (``user_reduction=
        "mean"``) the value is ``world_size`` times it, the sum of the
        ranks' means (the JAX facade's rule); a sum-reduced loss is already
        a global sum."""
        if user_reduction not in ("mean", "sum"):
            raise ValueError(
                f"user_reduction must be 'mean' or 'sum', got "
                f"{user_reduction!r}"
            )
        val = float(sum(torch.as_tensor(l).detach().float()
                        for l in tree_leaves(loss)))
        st = self._status_obj
        if (st.is_distributed
                and st.dp_config.loss_reduction is LossReduction.sum
                and user_reduction == "mean"):
            val *= self.world_size
        return val

    def print_ema_loss(self, prepend_msg: str = "EMA Loss") -> None:
        self.print_on_devices(f"{prepend_msg}: {self.ema_loss:.6f}")

    def print_mean_accumulated_synced_loss(
            self, prepend_msg: str = "Mean accumulated loss") -> None:
        v = self.mean_accumulated_loss
        self.print_on_devices(f"{prepend_msg}: {v:.6f}" if v is not None
                              else f"{prepend_msg}: n/a")

    def print_synced_loss(self, loss: Any, prepend_msg: str = "Step loss",
                          scale_by_accum: bool = True) -> None:
        """Print a loss from :meth:`loss`, times ``grad_accum`` (the
        undivided micro loss) unless ``scale_by_accum=False``."""
        v = self.detach_and_sync_loss(loss)
        if scale_by_accum:
            v *= self._status_obj.grad_accum
        self.print_on_devices(f"{prepend_msg}: {v:.6f}")

    # ------------------------------------------------------------------ #
    # ranks and printing (one device a process)
    # ------------------------------------------------------------------ #

    @property
    def rank(self) -> int:
        """This process's rank in the run's group (0 on one device)."""
        return 0 if self._group is None else dist.get_rank(self._group)

    @property
    def is_rank_0(self) -> bool:
        return self.rank == 0

    @property
    def world_size(self) -> int:
        return self._status_obj.world_size or 1

    @property
    def n_processes(self) -> int:
        """Processes in the run: one a device, so the world size."""
        return self.world_size

    def print_on_devices(self, msg: str, rank: Optional[int] = 0) -> None:
        """Print on process ``rank``, or on every process with None."""
        if rank is None or self.rank == rank:
            unrolled_print(f"(rank {self.rank}) {msg}")

    def info(self, msg: str) -> None:
        if self.is_rank_0:
            unrolled_print(f"INFO: {msg}")

    def warn(self, msg: str) -> None:
        if self.is_rank_0:
            unrolled_print(f"WARN: {msg}")

    def barrier(self) -> None:
        """Wait for every process of the run (nothing to wait for on one
        device). The wait lands in ``sync/barrier_wait_s`` of every live
        telemetry registry."""
        if self._group is not None:
            with timed_sync("barrier"):
                dist.barrier(group=self._group)

    def block_until_ready(self) -> None:
        """Wait for the card's queued work (nothing to wait for on the
        CPU)."""
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    # ------------------------------------------------------------------ #
    # profiling and observability
    # ------------------------------------------------------------------ #

    def _clock(self, phase: str):
        """Accumulating host timer of the wall-clock breakdown
        (``facade/<phase>_s``), with a ``stoke/<phase>`` span; a null
        context unless ``ProfilerConfig(wall_clock_breakdown=True)``, a
        ``TelemetryConfig`` or a ``TraceConfig`` is on."""
        if not self._wall_clock_enabled:
            return contextlib.nullcontext()
        return self._telemetry.phase(phase)

    @property
    def telemetry(self) -> Telemetry:
        """The run's telemetry pipeline (registry always live; sinks and
        collectors attach with a ``TelemetryConfig``)."""
        return self._telemetry

    @property
    def wall_clock_breakdown(self) -> Dict[str, float]:
        """Cumulative host seconds per facade phase (with
        ``ProfilerConfig(wall_clock_breakdown=True)``, a
        ``TelemetryConfig`` or a ``TraceConfig``). Host time only: the
        card runs asynchronously; :meth:`profile_trace` gives device
        timelines."""
        return self._telemetry.wall_clock_breakdown()

    def print_wall_clock_breakdown(self) -> None:
        breakdown = self.wall_clock_breakdown
        total = sum(breakdown.values()) or 1.0
        for phase, secs in sorted(breakdown.items(), key=lambda kv: -kv[1]):
            self.print_on_devices(
                f"wall_clock {phase}: {secs:.3f}s "
                f"({100 * secs / total:.1f}%)")

    def profile_trace(self, name: str = "stoke"):
        """Context manager capturing a ``torch.profiler`` trace of the
        block (host ops and, on the card, CUDA kernels) into
        ``ProfilerConfig.trace_dir`` as ``<name>.rank<N>.pt.trace.json``
        (Chrome / Perfetto trace JSON); yields the profiler. A null context
        without a ``trace_dir``.

        Usage:
            with stoke.profile_trace():
                for batch in loader: ...
        """
        cfg = self._status_obj.profiler_config
        if cfg.trace_dir is None:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def _trace():
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self._device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                yield prof
            os.makedirs(cfg.trace_dir, exist_ok=True)
            path = os.path.join(cfg.trace_dir,
                                f"{name}.rank{self.rank}.pt.trace.json")
            prof.export_chrome_trace(path)
            self.info(f"profiler trace written to {path}")

        return _trace()

    @property
    def health(self) -> Optional[HealthMonitor]:
        """The run's health monitor (None without a ``HealthConfig``)."""
        return self._health

    @property
    def tracer(self) -> Optional[TraceRecorder]:
        """The run's trace recorder (None without a ``TraceConfig``): the
        bounded span ring, the Perfetto exporter and the summary."""
        return self._tracer

    @property
    def trace_summary(self) -> Optional[Dict[str, Any]]:
        """Self-time summary of the trace ring (per-span-name counts, total
        and self seconds, the ranked ``critical_path``); None without a
        ``TraceConfig``. A nonzero ``trace/dropped_total`` means the ring
        evicted spans: the summary describes the recent tail."""
        if self._tracer is None:
            return None
        return self._tracer.summary()

    def export_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the span ring as Chrome/Perfetto trace-event JSON
        (``trace.rank<N>.json`` under ``TraceConfig.output_dir`` unless
        ``path``); returns the path, or None without a ``TraceConfig``.
        ``scripts/merge_rank_traces.py`` merges the ranks' files."""
        if self._tracer is None:
            return None
        return self._tracer.export(path)

    @property
    def dispatch_count(self) -> int:
        """The step engine's device-issuing calls: one for each eager
        micro-step of the four calls (``backward``), each apply
        (``step``), each fused ``train_step``, and each window (eager or a
        CUDA-graph replay; ``train_steps(n)`` makes n). The health
        sentinels add none."""
        return self._engine.dispatch_count

    def print_status(self) -> None:
        """Print the run's status, one line a flag or config."""
        if self.is_rank_0:
            unrolled_print(repr(self._status_obj).splitlines())

    def num_model_parameters(
            self, normalize: Optional[ParamNormalize] = None) -> float:
        """The model's parameter count (parameters, not buffers: a
        BatchNorm's running statistics do not count), divided by
        ``normalize``'s value when given."""
        if self._tp is None:
            n = tree_count_params(list(self._module.parameters()))
        else:
            n = sum(math.prod(self._tp.full_shape(name, p.shape))
                    for name, p in self._module.named_parameters())
        return n / normalize.value if normalize is not None else n

    def print_num_model_parameters(
            self, normalize: Optional[ParamNormalize] = None) -> None:
        n = self.num_model_parameters(normalize)
        suffix = f" ({normalize.name})" if normalize else ""
        self.print_on_devices(f"Model parameters: {n}{suffix}")

    def dump_model_parameter_info(self) -> None:
        """Print each parameter's name, shape and dtype."""
        for name, p in self._module.named_parameters():
            shape = (tuple(p.shape) if self._tp is None
                     else self._tp.full_shape(name, p.shape))
            self.print_on_devices(
                f"param {name}: shape={shape} dtype={p.dtype}")

    # ------------------------------------------------------------------ #
    # data
    # ------------------------------------------------------------------ #

    def DataLoader(self, dataset, **kwargs) -> StokeDataLoader:
        """A :class:`~stoke_tpu_torch.data.StokeDataLoader` of
        ``batch_size_per_device`` rows on this run's device; ``sampler=``
        (e.g. a :class:`~stoke_tpu_torch.data.BucketedDistributedSampler`)
        orders it. A run of several processes needs a sampler, each
        process loading its own slice (the JAX facade's rule). With
        ``FleetConfig(rebalance=True)`` across processes the loader reads
        by the shares of an :class:`~stoke_tpu_torch.data.InputRebalancer`
        that the fleet monitor shifts (the JAX facade's hand-over; a run of
        one process has nothing to rebalance). On a mesh of several axes
        the rows go by the data coordinate (:meth:`_data_sampler`), and a
        rebalancer's hosts are the data rows, as a JAX host owns whole
        data-axis shards: its shares are the rows', and the read payloads
        are exchanged over this process's data sub-group, so every process
        of a row reads the same share and yields the same rows."""
        multi = (dist.is_available() and dist.is_initialized()
                 and dist.get_world_size() > 1)
        if multi and kwargs.get("sampler") is None:
            raise ValueError(
                "Stoke -- multi-process runs require a distributed sampler "
                "(see BucketedDistributedSampler / DistributedSampler) — "
                "reference stoke.py:822-826"
            )
        if (self._data_group is not None
                and kwargs.get("sampler") is not None):
            kwargs["sampler"] = self._data_sampler(dataset, kwargs["sampler"])
        fcfg = self._status_obj.fleet_config
        hosts, host, group = self.n_processes, self.rank, None
        if self._fleet is not None:
            group = self._fleet.row_group
            if self._data_group is not None:
                hosts = dist.get_world_size(self._data_group)
                host = dist.get_rank(self._data_group)
        if ("rebalancer" not in kwargs and fcfg is not None
                and fcfg.rebalance and self._fleet is not None
                and hosts > 1):
            from stoke_tpu_torch.data import InputRebalancer, gloo_allgather

            rb = InputRebalancer(
                n_hosts=hosts, rank=host, batch_size=self.batch_size,
                max_frac=fcfg.rebalance_max_frac,
                # applied past every process's prefetch lookahead
                apply_slack=int(kwargs.get("prefetch", 2)) + 2)
            self._fleet.attach_rebalancer(rb)
            kwargs["rebalancer"] = rb
            kwargs.setdefault("rebalance_allgather", gloo_allgather(group))
        return StokeDataLoader(
            dataset, batch_size=self.batch_size, device=self._device,
            telemetry=self._telemetry if self._telemetry.enabled else None,
            **kwargs)

    def _data_sampler(self, dataset, sampler):
        """On a mesh of several axes (model, expert, stage or seq beside
        the data axis), the rows go by the data coordinate (a model group
        and a data row's sequence shards read the same rows): a
        ``BucketedDistributedSampler`` built with the world's defaults is
        built again over the data sub-group; one over other replicas is
        refused."""
        from stoke_tpu_torch.data import BucketedDistributedSampler

        group = self._data_group
        want = (dist.get_world_size(group), dist.get_rank(group))
        got = (getattr(sampler, "num_replicas", None),
               getattr(sampler, "rank", None))
        if got == want:
            return sampler
        if (isinstance(sampler, BucketedDistributedSampler)
                and got == (self.world_size, self.rank)):
            return BucketedDistributedSampler(
                dataset, sampler.buckets, sampler.batch_size,
                sampler.sorted_idx, sampler.allow_bucket_overlap,
                num_replicas=want[0], rank=want[1], shuffle=sampler.shuffle,
                seed=sampler.seed, drop_last=sampler.drop_last,
                info_rank=-1)
        raise ValueError(
            f"Stoke -- on a mesh of several axes the rows are "
            f"sharded over the data axis: build the sampler with "
            f"num_replicas={want[0]}, rank={want[1]} (got {got})")

    # ------------------------------------------------------------------ #
    # counters, flags and access
    # ------------------------------------------------------------------ #

    @property
    def status(self) -> StokeStatus:
        return self._status_obj

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def model_access(self) -> nn.Module:
        return self._module

    @property
    def loss_access(self) -> Callable:
        return self._engine.loss_fn

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self._engine.optimizer

    @property
    def batch_size(self) -> int:
        return self._status_obj.batch_size

    @property
    def effective_batch_size(self) -> int:
        return self._status_obj.effective_batch_size

    @property
    def grad_accum_steps(self) -> int:
        return self._status_obj.grad_accum

    @property
    def grad_accum(self) -> int:
        return self._status_obj.grad_accum

    @property
    def grad_clip(self):
        return self._status_obj.grad_clip

    @property
    def grad_accum_counter(self) -> int:
        return self._grad_accum_counter

    @property
    def optimizer_steps(self) -> int:
        return self._optimizer_steps

    @property
    def backward_steps(self) -> int:
        return self._backward_steps

    @property
    def skipped_optimizer_steps(self) -> float:
        """fp16 steps skipped because their gradients were not finite."""
        return float(self._skipped_steps)

    @property
    def scaler(self) -> dict:
        """The loss scaler's device state (``scale``, ``growth_count`` and,
        with per-loss scalers, ``finite``), built for every precision as
        the JAX facade builds it; only fp16 reads or updates it."""
        return self._engine.scaler

    @property
    def loss_scale(self):
        """The current dynamic loss scale: a float, or a list of one scale
        a loss with per-loss scalers. Without fp16 the scale never moves
        from ``PrecisionConfig.init_scale``, as in the JAX package."""
        s = self._engine.scaler["scale"]
        return [float(v) for v in s] if s.ndim else float(s)

    @property
    def comm_bytes(self) -> Optional[Dict[str, int]]:
        """Analytic per-device bytes on the wire of one optimizer step's
        gradient exchange (None without a ``CommConfig``): ``prequant``
        what the schedule moves in fp32, ``onwire`` what the wire dtype
        moves, and under the sharded transport ``param_gather``, the
        updated parameters' all-gather (0 under fsdp). The JAX formula:
        the port's extra int8 all-gather of the sharded schedule and its
        fp32 all-reduce of the gradients before the wire are not in it."""
        engine = self._engine
        if engine.transport is None or engine.comm_order is None:
            return None
        return engine.transport.bytes_per_step(
            engine.comm_order.sizes())

    @property
    def is_distributed(self) -> bool:
        return self._status_obj.is_distributed

    @property
    def is_scaled_precision(self) -> bool:
        return self._status_obj.is_scaled_precision

    @property
    def precision(self) -> PrecisionOptions:
        return self._status_obj.precision

    @property
    def is_fp16(self) -> bool:
        return self._status_obj.precision is PrecisionOptions.fp16

    @property
    def is_bf16(self) -> bool:
        return self._status_obj.precision is PrecisionOptions.bf16

    @property
    def precision_config(self) -> PrecisionConfig:
        return self._status_obj.precision_config

    @property
    def checkpoint_config(self) -> CheckpointConfig:
        return self._status_obj.checkpoint_config

    @property
    def dp_config(self):
        return self._status_obj.dp_config

    @property
    def mesh_config(self):
        return self._status_obj.mesh_config

    @property
    def oss_config(self):
        return self._status_obj.oss_config

    @property
    def sddp_config(self):
        return self._status_obj.sddp_config

    @property
    def fsdp_config(self):
        return self._status_obj.fsdp_config

    @property
    def profiler_config(self):
        return self._status_obj.profiler_config

    @property
    def mesh(self):
        """The run's ``DeviceMesh``: the data axis, or the data and sequence
        axes (None on one device without ``distributed``)."""
        return self._mesh

    @property
    def seq_shard(self) -> Optional[SeqShard]:
        """This process's view of the sequence on a mesh with a ``seq``
        axis (:class:`~stoke_tpu_torch.ops.attention.SeqShard`): its shard
        under ``shard_seq_dim``, else the global view (``whole``); None
        without a seq axis."""
        return self._seq_shard

    @property
    def sharding_rules(self):
        """The tier's :class:`~stoke_tpu_torch.parallel.sharding
        .ShardingRules` over the run's data axis; ``overrides`` holds the
        compiled partition rules."""
        return self._rules

    @property
    def tensor_parallel(self) -> Optional[TensorParallel]:
        """The model's Megatron or expert split
        (:class:`~stoke_tpu_torch.parallel.tensor.TensorParallel`), or
        None without partition rules."""
        return self._tp

    @property
    def aux_losses(self) -> Optional[Dict[str, Any]]:
        """The last forward's auxiliary losses (each MoE FFN's
        load-balancing term, fp32 scalars on the device, 0 before its
        first forward), nested by the JAX package's path as its ``"losses"``
        collection (``{"layer_1": {"moe": {"aux_loss": ...}}}``); None for
        a model without any. They join the objective weighted by
        ``aux_loss_weight``, not ``loss()``'s report, and no checkpoint
        holds them."""
        out: Dict[str, Any] = {}
        for name, m in self._module.named_modules():
            if not isinstance(m, MoEFFN):
                continue
            node = out
            for key in re.sub(r"(^|\.)layers\.(\d+)", r"\1layer_\2",
                              name).split("."):
                if key:
                    node = node.setdefault(key, {})
            node["aux_loss"] = (
                m.aux_loss.detach() if m.aux_loss is not None
                else torch.zeros((), dtype=torch.float32,
                                 device=self._device))
        return out or None

    @property
    def sharded(self) -> bool:
        """Gradient sharding on (the reference's ``sharded``: sddp)."""
        return self._status_obj.sddp

    @property
    def fully_sharded(self) -> bool:
        """Parameter sharding on (the reference's ``fully_sharded``:
        fsdp)."""
        return self._status_obj.fsdp

    @property
    def tpu(self) -> bool:
        """Always False: the port runs on a CUDA card or the CPU."""
        return False

    @property
    def oss(self) -> bool:
        return self._status_obj.oss

    @property
    def sddp(self) -> bool:
        return self._status_obj.sddp

    @property
    def fsdp(self) -> bool:
        return self._status_obj.fsdp
