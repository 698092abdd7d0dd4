"""The step engine of the port on one device: precision policy, the
dynamic loss scaler, gradient clipping, optimizer construction, the
accumulate / apply steps and the whole accumulation window.

Counterpart of ``stoke_tpu/engine.py``: ``PrecisionPolicy`` (``:233-266``),
``init_scaler_state`` and ``_scaler_update`` (``:269-305``),
``clip_gradients`` (``:312-341``), ``build_optimizer`` (``:349-372``), the
train forward (``:699-707``), the accumulate core for one loss,
``loss_weights`` or per-loss scalers (``:951-1117``), the window core
(``window_step``, ``:1143-1273``, which ``multi_step`` repeats) and the
apply core (``:1434-1531``, with the gradient transport of a
``CommConfig``, the health sentinels and the numerics matrix), the
rematerialized forward of an ``ActivationCheckpointingConfig``
(``:693-697``, :mod:`stoke_tpu_torch.remat`), with the JAX engine's
``dispatch_count`` and its ``stoke/accum``, ``stoke/dispatch`` and
``stoke/step`` spans.

Model-internal auxiliary losses (an MoE block's load-balancing term,
:mod:`stoke_tpu_torch.models.moe`) join the objective as
``aux_loss_weight * sum(aux)`` on every step path, folded into the first
loss (``stoke_tpu/engine.py:1028-1040``); the reported losses stay
unweighted. Under a Megatron or expert split (``tp``, a
:class:`~stoke_tpu_torch.parallel.tensor.TensorParallel`) the norms of the
clip, the sentinels and the numerics are the global parameters': a split
leaf's squares (or largest magnitude) taken over its own group (the axes
that cut it: an expert leaf is whole over the model axis, so its squares
are not summed there), a whole leaf once, and a non-finite flag ANDed
over every group. A gathered placement's slices are all-gathered before
each forward (:meth:`StepEngine._cast_forward`).

The JAX engine traces forward and grad into one program; here autograd
records the eager forward, ``backward`` runs into the parameters' fp32
``.grad`` (the accumulation buffer), and ``apply`` unscales, checks,
clips, steps the ``torch.optim`` optimizer and zeroes the buffer.

Under bf16 and fp16 the whole model runs in the 16-bit type, as the JAX
policy casts the params and floating inputs: ``torch.func.functional_call``
swaps in casts of the fp32 master parameters (buffers, such as BatchNorm's
running statistics, keep their dtype and are updated in place), so every
op (LayerNorm and the tied head included) computes in that type and the
gradients flow back
through the casts into fp32 ``.grad`` on the masters. The tied embedding is
cast once and used twice, and its two gradients sum into one. The output is
cast to fp32. ``torch.autocast`` would compute a different function: it
keeps LayerNorm and softmax in fp32.

fp16 adds the JAX package's dynamic loss scaler, a device-resident state
(``init_scaler_state``) updated by its rule (``scaler_update``), not
``torch.amp.GradScaler``, which has no ``min_scale`` floor and counts
growth differently. A step whose gradients are not finite is skipped with
no host sync: every parameter and optimizer state tensor is put back by
``torch.where`` on the device (see :meth:`StepEngine.apply`).

A window (:meth:`StepEngine.window`, k micro-steps then one apply) runs
eagerly on the CPU. On the card, its first call for a signature runs one
window eagerly and captures the next into a CUDA graph; later windows of
that signature copy their micro-batches into the graph's static inputs
and replay it (:class:`CapturedWindow`).

With ``sentinels=True`` (a ``HealthConfig``) the apply also computes the
sentinel row of :mod:`stoke_tpu_torch.telemetry.health` on the device:
the grad norm, non-finite flags and first bad leaf of the unscaled,
post-transport gradients before the clip (whose per-leaf norms the clip
then reuses, so the parameters are bit for bit those of a run without
sentinels), the updated parameters' norm and the update's, from a copy of
the parameters taken before the step (under fp16, the skip's copy). In a
window it is one of the graph's outputs, so a replay yields its row
too. ``dispatch_count`` counts the engine's device-issuing calls: one a
4-call ``backward`` or ``apply``, a ``fused`` step or a ``window``
(eager or replayed); a fault injector (:attr:`StepEngine.chaos`, a
``ResilienceConfig`` with a chaos plan) sees each dispatch first. With
``numerics`` (a ``NumericsConfig``) the apply also packs the per-group
statistics of :mod:`stoke_tpu_torch.telemetry.numerics`
(:attr:`StepEngine.numerics_row`) from the sentinels' taps and the same
copy of the parameters; a window returns its matrix too.

The attribution's cost cards and the memory observatory watch the
dispatches (:attr:`StepEngine.cost_cards`, :attr:`StepEngine.memory`):
the first run of each (program, input signature) is counted and
measured (``accum``: the 4-call forward, loss and backward; ``apply``,
``fused``, ``fused_nb`` and ``window``: a window's eager first run, never
its capture), every later one booked. That first run is also recorded as
the program (the JAX engine's ``_aot_call`` / ``_note_audit``): what its
ops wrote, copied, synced and communicated
(:class:`~stoke_tpu_torch.analysis.program.TraceRecorder`'s facts) and the
state it declares updated in place (:attr:`DECLARED_STATE`, the
counterpart of the JAX programs' ``donate_argnums``) become one
:class:`~stoke_tpu_torch.analysis.program.ProgramSpec` for the auditor
(:meth:`StepEngine.audit_specs`, at most ``_MAX_AUDIT_SPECS``).

Offload (the JAX engine's ``:553-650``): with :attr:`StepEngine.host_state`
(``OffloadOptimizerConfig``) the optimizer state shaped like its
parameters lives in pinned host memory between steps and the update
streams it through the card in leaf groups
(:class:`~stoke_tpu_torch.offload.HostOptimizerState`), inside a captured
window too; with :attr:`StepEngine.disk_store` (``OffloadDiskConfig``) it
is spilled to memory-mapped files after every update and its device
memory freed, and loaded back before the next, which is file IO: such a
window runs its steps eagerly on the card, never captured.
"""

from __future__ import annotations

import contextlib
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch
from torch import nn
from torch.func import functional_call
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from stoke_tpu_torch.configs import (
    ClipGradConfig,
    ClipGradNormConfig,
    PrecisionConfig,
    PrecisionOptions,
)
from stoke_tpu_torch import remat
from stoke_tpu_torch.analysis.program import (
    ProgramSpec,
    StateEntry,
    TraceRecorder,
    program_signature,
)
from stoke_tpu_torch.ops import chunked_ce
from stoke_tpu_torch.ops.flash_attention import LAUNCHES
from stoke_tpu_torch.telemetry import collectors
from stoke_tpu_torch.telemetry.health import (
    jax_leaf_order,
    leaf_norms,
    nonfinite_flags,
    pack_sentinels,
)
from stoke_tpu_torch.telemetry.attribution import counting, signature
from stoke_tpu_torch.telemetry.tracing import trace_span


def _grad_or_zeros(p: torch.Tensor) -> torch.Tensor:
    """``p.grad``, set to zeros first when the parameter has none."""
    if p.grad is None:
        p.grad = torch.zeros_like(p)
    return p.grad


def _cast_floating(tree, dtype: Optional[torch.dtype]):
    """Cast every floating tensor leaf of ``tree`` to ``dtype`` (None: no
    cast); integer and bool leaves stay."""
    if dtype is None:
        return tree
    return tree_map(
        lambda x: x.to(dtype)
        if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
        tree,
    )


class PrecisionPolicy(NamedTuple):
    """fp32 master params, the compute dtype the model runs in (None: no
    cast), the dtype its outputs are cast to, and whether the dynamic loss
    scaler is on (fp16 only)."""

    param_dtype: torch.dtype
    compute_dtype: Optional[torch.dtype]
    output_dtype: Optional[torch.dtype]
    scaled: bool = False

    @staticmethod
    def make(option: PrecisionOptions, cfg: PrecisionConfig) -> "PrecisionPolicy":
        param = getattr(torch, cfg.param_dtype)
        if option is PrecisionOptions.full:
            return PrecisionPolicy(param, None, None)
        if option is PrecisionOptions.bf16:
            return PrecisionPolicy(param, torch.bfloat16,
                                   getattr(torch, cfg.output_dtype))
        if option is PrecisionOptions.fp16:
            return PrecisionPolicy(param, torch.float16,
                                   getattr(torch, cfg.output_dtype), True)
        raise ValueError(f"no precision policy for {option}")

    def cast_compute(self, tree):
        return _cast_floating(tree, self.compute_dtype)

    def cast_output(self, tree):
        return _cast_floating(tree, self.output_dtype)


def init_scaler_state(cfg: PrecisionConfig,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """The dynamic loss scaler's state on ``device``: ``scale`` (float32)
    and ``growth_count`` (int32), scalars; with ``num_losses > 1`` each a
    ``[num_losses]`` vector, plus the per-loss ``finite`` flags (bool) that
    each loss's backward ANDs into and the apply resets (the JAX package's
    ``init_scaler_state``)."""
    if cfg.num_losses > 1:
        n = cfg.num_losses
        return {
            "scale": torch.full((n,), cfg.init_scale, dtype=torch.float32,
                                device=device),
            "growth_count": torch.zeros(n, dtype=torch.int32, device=device),
            "finite": torch.ones(n, dtype=torch.bool, device=device),
        }
    return {
        "scale": torch.tensor(cfg.init_scale, dtype=torch.float32,
                              device=device),
        "growth_count": torch.zeros((), dtype=torch.int32, device=device),
    }


def scaler_update(state: Dict[str, torch.Tensor], finite: torch.Tensor,
                  cfg: PrecisionConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's ``_scaler_update``, elementwise: after
    ``growth_interval`` finite steps in a row the scale grows by
    ``growth_factor`` and the count restarts; a step that is not finite
    backs the scale off by ``backoff_factor``, floored at ``min_scale``,
    and restarts the count. Returns the new ``scale`` and
    ``growth_count``."""
    scale, count = state["scale"], state["growth_count"]
    grew = count + 1 >= cfg.growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grew, scale * cfg.growth_factor, scale),
        (scale * cfg.backoff_factor).clamp_min(cfg.min_scale),
    )
    new_count = torch.where(finite & ~grew, count + 1,
                            torch.zeros_like(count))
    return {"scale": new_scale, "growth_count": new_count}


def unscale_and_check(grads: Sequence[torch.Tensor],
                      inv_scale: torch.Tensor) -> torch.Tensor:
    """Multiply ``grads`` in place by ``inv_scale`` (a float32 scalar on
    their device) and return whether every element was finite, as a bool
    scalar on the device, with no host sync (one multi-tensor pass per
    dtype: ``torch._amp_foreach_non_finite_check_and_unscale_``)."""
    found = torch.zeros((), dtype=torch.float32, device=inv_scale.device)
    for dtype in {g.dtype for g in grads}:
        torch._amp_foreach_non_finite_check_and_unscale_(
            [g for g in grads if g.dtype == dtype], found, inv_scale)
    return found == 0


def _norm(grads: Sequence[torch.Tensor], p: float,
          device: Optional[torch.device] = None,
          leaf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``p``-norm over all of ``grads`` in fp32 (0 on ``device`` for
    none), from each tensor's norm (``leaf``, when already taken)."""
    if not grads:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.linalg.vector_norm(
        leaf_norms(grads, p) if leaf is None else leaf, p)


@torch.no_grad()
def clip_gradients(grads: Sequence[torch.Tensor], grad_clip,
                   sharded: Sequence[torch.Tensor] = (),
                   ladder=None,
                   leaf: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   whole: Optional[Callable] = None
                   ) -> Optional[torch.Tensor]:
    """Clip ``grads`` and ``sharded`` in place, on the accumulated,
    unscaled gradients. Returns the global norm of ``ClipGradNormConfig``
    (None otherwise); ``leaf`` are the 2-norms of each tensor of ``grads``
    and of ``sharded`` when the caller took them already (the health
    sentinels), used for a 2-norm clip.

    ``ClipGradConfig``: clamp each element to ``[-v, v]``.
    ``ClipGradNormConfig``: the global ``norm_type``-norm over all
    gradients in fp32 (``inf``: the largest magnitude), then every
    gradient times ``min(1, max_norm / (norm + 1e-6))``, computed on the
    device with no host sync. Across the ranks of ``ladder``, ``grads``
    are the replicated leaves' (the same on every rank, counted once) and
    ``sharded`` each rank's slices, whose powers (or maxima) are summed
    (or maxed) over the ranks. Without slices (plain dp) the norm is
    local: every rank holds the same reduced gradients. ``whole(norms,
    p)`` (a model split's) turns the ``p``-norms of ``grads`` into the
    whole leaves' where the caller did not take them already."""
    everything = list(grads) + list(sharded)
    if grad_clip is None or not everything:
        return None
    if isinstance(grad_clip, ClipGradConfig):
        v = grad_clip.clip_value
        for g in everything:
            g.clamp_(-v, v)
        return None
    if isinstance(grad_clip, ClipGradNormConfig):
        p = grad_clip.norm_type
        if leaf is None or p != 2:
            leaf = (None, None)
        rep_leaf = leaf[0]
        if rep_leaf is None and grads and whole is not None:
            rep_leaf = whole(leaf_norms(grads, p), p)
        # the ladder's layout is the same on every rank, so all skip the
        # reduction together
        if ladder is None or not ladder.buckets:
            both = (rep_leaf if rep_leaf is None or leaf[1] is None
                    else torch.cat([rep_leaf, leaf[1]]))
            norm = _norm(everything, p, leaf=both)
        else:
            dev = everything[0].device
            rep = _norm(grads, p, dev, rep_leaf)
            part = _norm(sharded, p, dev, leaf[1])
            if p == float("inf"):
                norm = torch.maximum(rep, ladder.reduce_(part, "max"))
            else:
                norm = (rep ** p + ladder.reduce_(part ** p)) ** (1.0 / p)
        factor = torch.clamp(grad_clip.max_norm / (norm + 1e-6), max=1.0)
        for g in everything:
            g.mul_(factor.to(g.dtype))
        return norm
    raise TypeError(f"unknown grad_clip {type(grad_clip)}")


def build_optimizer(optimizer: Any, params) -> torch.optim.Optimizer:
    """Instantiate the optimizer over ``params``: a ``StokeOptimizer``
    (``{"optimizer": ctor, "optimizer_kwargs": {...}}``) or a callable
    that takes the parameters."""
    if isinstance(optimizer, dict) and "optimizer" in optimizer:
        built = optimizer["optimizer"](
            params, **optimizer.get("optimizer_kwargs", {}))
    elif callable(optimizer):
        built = optimizer(params)
    else:
        built = None
    if not isinstance(built, torch.optim.Optimizer):
        raise TypeError(
            "Stoke -- optimizer must be a StokeOptimizer "
            "{'optimizer': ctor, 'optimizer_kwargs': {...}} or a callable "
            "taking the parameters, and build a torch.optim.Optimizer; got "
            f"{type(built if built is not None else optimizer).__name__}"
        )
    return built


def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Keep the optimizer's step counts on the device: ``capturable=True``
    on every param group that has the flag (Adam, AdamW and the other
    ``torch.optim`` classes that count steps). Their step then runs inside
    a CUDA graph, and a skipped fp16 step can be put back with no host
    sync. The update is the same function; only where the step count and
    bias corrections are computed moves (to fp32 on the device)."""
    for group in optimizer.param_groups:
        if "capturable" in group:
            group["capturable"] = True


class _GradProbe:
    """The gradient part of a step's sentinel row, taken before the clip:
    the 2-norm and the non-finite flag of each tensor of ``grads`` (the
    leaves stepped whole, engine indices ``grad_idx``) and of ``sharded``
    (this rank's slices, engine indices ``shard_idx``); with ``numerics``
    also each tensor's largest magnitude, count of finite elements and
    element count."""

    def __init__(self, grads: Sequence[torch.Tensor],
                 sharded: Sequence[torch.Tensor], grad_idx: List[int],
                 shard_idx: List[int], device: torch.device,
                 flags: bool = True, numerics: bool = False):
        empty = torch.zeros(0, dtype=torch.float32, device=device)
        self.grad_idx, self.shard_idx = grad_idx, shard_idx
        self.rep_norms = leaf_norms(grads) if grads else empty
        self.part_norms = leaf_norms(sharded) if sharded else empty
        self.rep_flags = nonfinite_flags(grads) if grads and flags else empty
        self.part_flags = (nonfinite_flags(sharded) if sharded and flags
                           else empty)
        if numerics:
            self.rep_absmax, self.rep_finite = _absmax_and_finite(grads,
                                                                  empty)
            self.part_absmax, self.part_finite = _absmax_and_finite(
                sharded, empty)
            self.rep_numel = [max(g.numel(), 1) for g in grads]
            self.part_numel = [max(g.numel(), 1) for g in sharded]


def _absmax_and_finite(tensors: Sequence[torch.Tensor],
                       empty: torch.Tensor):
    """Each tensor's largest magnitude (one multi-tensor pass; inf or NaN
    where it holds one, as ``jnp.max(jnp.abs(g))``) and its count of
    finite elements (two kernels a tensor), as fp32 vectors."""
    if not tensors:
        return empty, empty
    tensors = [t if t.numel() else t.new_zeros(1) for t in tensors]
    finite = torch.stack([torch.isfinite(t).sum() for t in tensors])
    return leaf_norms(tensors, float("inf")), finite.float()


class _Recording:
    """One program's first run of a signature being recorded: the
    recorder, and the declared state with how to read each entry back (a
    4-call micro-step records in three segments: forward, loss and
    backward)."""

    def __init__(self, program: str, memo, inputs):
        self.program = program
        self.memo = memo
        self.recorder = TraceRecorder(program)
        self.abstract, self.weak = program_signature(inputs)
        self.state: List[tuple] = []


def _storage_ref(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef

    return StorageWeakRef(t.untyped_storage())


class CapturedWindow(NamedTuple):
    """A window captured as a CUDA graph: the graph, its static inputs (the
    flattened inputs' leaves), its outputs (stacked reports, the finite
    flag and the sentinel row, in the graph's memory), the kernel launches
    that one replay
    makes (counted by the wrappers during capture, which launches nothing)
    and the learning rates baked into it."""

    graph: Any
    inputs: List[Any]
    outputs: Tuple[Any, Optional[torch.Tensor], Optional[torch.Tensor]]
    launches: Dict[str, int]
    lrs: Tuple[Any, ...]


class StepEngine:
    """The accumulate and apply steps over one module, and the window.

    Args:
        module: the model, on its device, parameters in ``param_dtype``.
        loss_fn: ``loss_fn(output, *loss_args)`` -> a scalar, or a tuple,
            list or dict of scalars (several losses).
        optimizer: the built ``torch.optim`` optimizer over the module's
            parameters. On a CUDA device it is made capturable
            (:func:`make_capturable`).
        precision: the :class:`PrecisionPolicy`.
        grad_accum: micro-batches per optimizer step.
        grad_clip: ``ClipGradConfig``, ``ClipGradNormConfig`` or None.
        loss_weights: None, or weights shaped like the loss result; the
            objective is then ``sum(w_i * loss_i)`` while the reported
            losses stay unweighted.
        precision_config: the loss scaler's settings (fp16); None is
            ``PrecisionConfig()``.
        generator: the ``torch.Generator`` the model's dropout draws from;
            a captured window registers it, so every replay draws fresh
            masks.
        ladder: the data-parallel tier's collectives
            (:class:`~stoke_tpu_torch.parallel.ladder.Ladder`), or None on
            one device. The optimizer then holds ``ladder.opt_params``.
        transport: the gradient transport of a ``CommConfig``
            (:mod:`stoke_tpu_torch.parallel.collectives`), or None. When
            active it rewrites the reduced gradients at every apply, in
            the JAX leaf order and layout, before the clip; its state (the
            key and the error-feedback residual, ``comm_state``) lives on
            the device and is updated in place, so a captured window
            carries it from replay to replay.
        sentinels: compute the health sentinel row at every apply
            (``HealthConfig(sentinels=True)``); after each step call it is
            :attr:`sentinel_row`, a ``[N_SENTINELS]`` fp32 tensor on the
            device.
        remat: an ``ActivationCheckpointingConfig``: the training forward
            recomputed in backward under its policy.
        numerics: compute the numerics' group statistics at every apply
            (``NumericsConfig(grad_stats=True)``), :attr:`numerics_row`.
        aux_loss_weight: the weight of the model's auxiliary losses in
            the objective (0: left out).
        tp: the model's Megatron or expert split
            (:class:`~stoke_tpu_torch.parallel.tensor.TensorParallel`), or
            None.
    """

    def __init__(self, module: nn.Module, loss_fn: Callable,
                 optimizer: torch.optim.Optimizer, precision: PrecisionPolicy,
                 grad_accum: int = 1, grad_clip=None, loss_weights=None,
                 precision_config: Optional[PrecisionConfig] = None,
                 generator: Optional[torch.Generator] = None,
                 ladder=None, transport=None, sentinels: bool = False,
                 remat=None, numerics: bool = False,
                 aux_loss_weight: float = 0.0, tp=None):
        from stoke_tpu_torch.models.moe import MoEFFN

        self.module = module
        self.aux_loss_weight = float(aux_loss_weight)
        #: the MoE FFNs whose ``aux_loss`` joins the objective
        self.aux_modules = [m for m in module.modules()
                            if isinstance(m, MoEFFN)]
        #: the ``ActivationCheckpointingConfig`` (None: no recompute)
        self.remat = remat
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.precision = precision
        self.grad_accum = grad_accum
        self.grad_clip = grad_clip
        self.loss_weights = loss_weights
        self.precision_config = precision_config or PrecisionConfig()
        self.generator = generator
        self.ladder = ladder
        #: whether a backward reduces its gradients over the ranks
        self.sync = True
        self.params: List[torch.Tensor] = [
            p for p in module.parameters() if p.requires_grad
        ]
        self.device = (self.params[0].device if self.params
                       else torch.device("cpu"))
        self.tp = tp
        #: the positions in ``params`` of the leaves the split cut, to
        #: the axes of the group their slices lie over
        self._cut: Dict[int, tuple] = {}
        if tp is not None:
            names = {id(p): n for n, p in module.named_parameters()}
            self._cut = {i: tp.cuts[names[id(self.params[i])]].group_axes
                         for i in tp.sliced_indices(module, self.params)}
        self.per_loss = (precision.scaled
                         and self.precision_config.num_losses > 1)
        # built for every precision, as the JAX facade builds it; only
        # fp16 (``precision.scaled``) reads or updates it
        self.scaler = init_scaler_state(self.precision_config, self.device)
        self._snapshot: Dict[Any, torch.Tensor] = {}
        self._windows: Dict[Any, CapturedWindow] = {}
        # every window signature captured so far (a recapture is a
        # recompile of the telemetry)
        self._captured: set = set()
        self.transport = transport
        self.comm_order = None
        self.comm_state: Dict[str, Any] = {}
        if transport is not None and transport.cfg is not None:
            from stoke_tpu_torch.parallel.collectives import JaxLeafOrder

            self.comm_order = JaxLeafOrder(module, self.params,
                                           tp if tp is not None and tp.cuts
                                           else None)
            self.comm_state = transport.init_state(
                self.comm_order.sizes(), self.device)
        if self.device.type == "cuda":
            make_capturable(optimizer)
        self.sentinels = bool(sentinels)
        #: the last step's sentinel row (None without sentinels)
        self.sentinel_row: Optional[torch.Tensor] = None
        #: the per-group statistics of a ``NumericsConfig``
        #: (:mod:`~stoke_tpu_torch.telemetry.numerics`): the groups, and the
        #: last step's ``[n_groups, N_NUMERICS_STATS]`` fp32 matrix
        self.numerics = bool(numerics)
        self.groups = None
        self.numerics_row: Optional[torch.Tensor] = None
        self._index_cache: Dict[tuple, torch.Tensor] = {}
        if self.numerics:
            from stoke_tpu_torch.telemetry.numerics import module_groups

            self.groups = module_groups(module, self.params)
            member = [0] * len(self.params)
            for g, group in enumerate(self.groups):
                for i in group.param_indices:
                    member[i] = g
            # made once here: a host-to-device copy inside a captured
            # window would break the capture
            self._group_of = torch.tensor(member, dtype=torch.long,
                                          device=self.device)
        #: the last probed pre-clip grad norm (``apply(probe_grad_norm=
        #: True)``), a device scalar
        self.grad_norm: Optional[torch.Tensor] = None
        self._jax_order = (jax_leaf_order(module, self.params)
                           if self.sentinels else None)
        #: whether a step keeps a copy of the parameters from before it
        #: (the sentinels' and the numerics' update norms share it)
        self._keeps_old = self.sentinels or self.numerics
        #: device-issuing calls (the JAX engine's counter)
        self.dispatch_count = 0
        #: the run's ``CompileTracker`` (the facade assigns it), told of
        #: windows captured again
        self.compile_tracker = None
        #: the fault injector whose ``on_dispatch`` runs before every
        #: dispatch (the facade assigns it when a chaos plan is armed)
        self.chaos = None
        #: the optimizer state's pinned host tier (``HostOptimizerState``)
        #: or disk tier (``DiskOptimizerStore``); the facade assigns them
        self.host_state = None
        self.disk_store = None
        self._disk_keys: List[Tuple[torch.Tensor, str]] = []
        #: the attribution's cost cards (``CostCardCache``) and the memory
        #: observatory (``MemoryObservatory``); the facade assigns them
        self.cost_cards = None
        self.memory = None
        # the 4-call path's micro-step: its forward's signature and, on the
        # signature's first run, the cost its forward counted and its
        # recording
        self._accum_sig = None
        self._accum_cost = None
        self._accum_rec: Optional[_Recording] = None
        # the program specs of first runs (the auditor's), and the
        # signatures each program has run (its churn ledger)
        self._audit_specs: List[ProgramSpec] = []
        self._audit_seen: set = set()
        self._audit_truncated = False
        self._spec_of: Dict[Any, ProgramSpec] = {}
        self._program_sigs: Dict[str, set] = {}
        self._window_captures = 0
        self._recording = False

    #: the state each program declares updated in place, stated once
    #: (the JAX programs' ``donate_argnums``: ``accum`` donates nothing,
    #: ``fused_nb`` the gradient buffer, the apply family the variables,
    #: the gradient buffer, the optimizer state and the scaler). Only what
    #: exists before the run is declared: a first step's optimizer state
    #: and gradients are made by it
    DECLARED_STATE: Dict[str, Tuple[str, ...]] = {
        "accum": (),
        "fused_nb": ("grad",),
        "apply": ("param", "grad", "opt", "scaler"),
        "fused": ("param", "grad", "opt", "scaler"),
        "window": ("param", "grad", "opt", "scaler"),
    }
    #: bound on recorded specs (one a program signature; a shape-churning
    #: run stops recording, never errors)
    _MAX_AUDIT_SPECS = 64
    #: bound on the signatures remembered a program
    _MAX_SIGS = 1024

    @contextlib.contextmanager
    def _observed(self, program: str, sig, steps: int, inputs=()):
        """One dispatch of ``program`` at ``sig`` (of ``inputs``) inside
        the block: the cost card counted on its first run and accounted on
        every run (``cost_cards``), its memory measured on its first run
        (``memory``), and its first run recorded (:meth:`_start_recording`)
        innermost, so no count's own ops are in the recording."""
        self._accum_rec = None
        with contextlib.ExitStack() as stack:
            if self.memory is not None:
                stack.enter_context(self.memory.measure(program, sig))
            if self.cost_cards is not None:
                stack.enter_context(self.cost_cards.dispatch(
                    (program, sig), program, steps))
            rec = self._start_recording(program, sig, inputs)
            if rec is None:
                yield
                return
            self._recording = True
            try:
                with rec.recorder:
                    yield
            finally:
                self._recording = False
            self._finish_recording(rec)

    def _start_recording(self, program: str, sig, inputs
                         ) -> Optional[_Recording]:
        """A recording of ``program``'s first run at ``sig``, under the
        spec cap (None otherwise, and on every later run); the declared
        state is named first."""
        seen = self._program_sigs.setdefault(program, set())
        if len(seen) < self._MAX_SIGS:
            seen.add(sig)
        memo = (program, sig)
        if memo in self._audit_seen:
            return None
        if len(self._audit_specs) >= self._MAX_AUDIT_SPECS:
            self._audit_truncated = True
            return None
        self._audit_seen.add(memo)
        rec = _Recording(program, memo, inputs)
        names = {id(p): n for n, p in self.module.named_parameters()}
        for kind in self.DECLARED_STATE.get(program, ()):
            for name, t, read in self._state_of(kind, names):
                rec.recorder.declare(name, t)
                cut = bool(kind == "param" and self.tp is not None
                           and name[len("param:"):] in self.tp.cuts)
                rec.state.append((StateEntry(
                    name, t.numel() * t.element_size(), cut),
                    _storage_ref(t), read))
        return rec

    def _state_of(self, kind: str, names: Dict[int, str]):
        """``(name, tensor, read back)`` of the live state of ``kind``."""
        if kind == "param":
            for n, p in self.module.named_parameters():
                if p.requires_grad:
                    yield f"param:{n}", p, (lambda p=p: p)
        elif kind == "grad":
            for n, p in self.module.named_parameters():
                if p.grad is not None:
                    yield f"grad:{n}", p.grad, (lambda p=p: p.grad)
        elif kind == "opt":
            for i, p in enumerate(self.opt_params):
                pname = names.get(id(p), f"#{i}")
                for k, v in self.optimizer.state.get(p, {}).items():
                    if torch.is_tensor(v):
                        yield (f"opt:{pname}/{k}", v,
                               lambda p=p, k=k: self.optimizer.state.get(
                                   p, {}).get(k))
        elif kind == "scaler" and self.precision.scaled:
            for k in ("scale", "growth_count"):
                yield f"scaler:{k}", self.scaler[k], (
                    lambda k=k: self.scaler[k])

    def _finish_recording(self, rec: _Recording) -> None:
        """The recorded first run as a spec (what each declared entry
        became)."""
        state = []
        for entry, ref, read in rec.state:
            after = read()
            if after is None:
                entry.after = "released"
            elif ref.expired() or _storage_ref(after).cdata != ref.cdata:
                entry.after = "replaced"
            state.append(entry)
        rec.state.clear()
        groups = {}
        if self.tp is not None:
            groups = {"/".join(map(str, axes)): int(g.size)
                      for axes, g in self.tp.groups.items()}
        exchange = (self.ladder is not None
                    or (self.transport is not None and self.transport.active)
                    or (self.tp is not None and bool(self.tp.cuts)))
        spec = ProgramSpec(
            program=rec.program, facts=rec.recorder.facts,
            abstract_args=rec.abstract, state=tuple(state),
            weak_leaves=rec.weak, source="engine", group_sizes=groups,
            exchange=exchange)
        self._audit_specs.append(spec)
        self._spec_of[rec.memo] = spec

    def _accum_segment(self):
        """The pending 4-call micro-step's recording around a step of it
        (its forward, loss or backward), outside any other recording."""
        if self._accum_rec is None or self._recording:
            return contextlib.nullcontext()
        return self._accum_rec.recorder

    def audit_specs(self) -> List[ProgramSpec]:
        """The recorded program specs (``Stoke.audit()`` is the
        consumer)."""
        return list(self._audit_specs)

    def shape_sig_counts(self) -> Dict[str, int]:
        """Distinct input signatures run a program (a window's: its
        captures when more) — the auditor's recompile-churn ledger."""
        out = {p: len(s) for p, s in self._program_sigs.items()}
        if self._window_captures:
            out["window"] = max(out.get("window", 0),
                                self._window_captures)
        return out

    def _dispatch(self, program: str) -> None:
        """Count one device-issuing call (after the fault injector's
        ``on_dispatch``, which may stall it)."""
        if self.chaos is not None:
            self.chaos.on_dispatch(program)
        self.dispatch_count += 1

    @property
    def opt_params(self) -> List[torch.Tensor]:
        """The tensors the optimizer steps: the parameters, or under a
        sharding tier each sharded leaf's slice in its place."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def forward(self, args: tuple, kwargs: dict):
        """The model's forward under the precision policy (JAX
        ``_run_forward_train``); autograd records it when grad is on.
        Under fsdp the parameters are gathered first, and freed after a
        forward that records no gradient. With cost cards, a forward that
        records a gradient starts the 4-call micro-step's card (the
        ``accum`` program: this forward and the next :meth:`backward`)."""
        if not torch.is_grad_enabled():
            return self._forward_gathered(args, kwargs)
        cards = self.cost_cards
        self._accum_sig = signature((args, kwargs))
        self._accum_cost = None
        self._accum_rec = self._start_recording("accum", self._accum_sig,
                                                (args, kwargs))
        with contextlib.ExitStack() as stack:
            if cards is not None and cards.needs_count(
                    ("accum", self._accum_sig), "accum"):
                self._accum_cost = stack.enter_context(counting())
            stack.enter_context(self._accum_segment())
            return self._forward_gathered(args, kwargs)

    def _forward_gathered(self, args: tuple, kwargs: dict):
        if self.ladder is None:
            return self._forward(args, kwargs)
        self.ladder.materialize()
        out = self._forward(args, kwargs)
        if not torch.is_grad_enabled():
            self.ladder.release()
        return out

    def _forward(self, args: tuple, kwargs: dict):
        """The forward under the precision policy; with an
        ``ActivationCheckpointingConfig`` recomputed in backward under its
        policy (the JAX ``_maybe_remat``), the 16-bit casts of the masters
        made again inside the recompute."""
        if self.remat is None:
            return self._cast_forward(args, kwargs)
        return remat.checkpoint(self._cast_forward, args, kwargs,
                                policy=self.remat.policy)

    def _cast_forward(self, args: tuple, kwargs: dict):
        dt = self.precision.compute_dtype
        gathered = self.tp is not None and self.tp.gathered
        if dt is None and not gathered:
            return self.module(*args, **kwargs)
        # parameters only: buffers (BatchNorm's running statistics) keep
        # their dtype and stay the module's own tensors, so their in-place
        # updates land, as the JAX package casts only ``params``
        swap = {n: t.to(dt) if dt is not None and t.is_floating_point()
                else t for n, t in self.module.named_parameters()}
        if gathered:
            # each gathered placement whole, from its (cast) slice
            swap.update(self.tp.run_params(swap))
        out = functional_call(self.module, swap,
                              self.precision.cast_compute(tuple(args)),
                              self.precision.cast_compute(dict(kwargs)))
        return self.precision.cast_output(out)

    def loss(self, *args, **kwargs):
        """``loss_fn(*args, **kwargs)``; under a 16-bit policy the chunked
        LM head multiplies in the compute dtype
        (:func:`stoke_tpu_torch.ops.chunked_ce.compute_dtype`)."""
        with chunked_ce.compute_dtype(self.precision.compute_dtype), \
                self._accum_segment():
            return self.loss_fn(*args, **kwargs)

    def objective(self, result) -> Tuple[torch.Tensor, Any]:
        """:meth:`_objective`, in the pending 4-call recording."""
        with self._accum_segment():
            return self._objective(result)

    def _objective(self, result) -> Tuple[torch.Tensor, Any]:
        """``(objective, report)`` of a training loss result.

        ``objective`` is the fp32 sum of the (weighted) losses divided by
        ``grad_accum``, the tensor to differentiate; with per-loss scalers
        the vector of the (weighted) losses divided by ``grad_accum``, one
        entry a scale. ``report`` has the loss result's structure, each
        loss detached and divided by ``grad_accum`` (the JAX facade's
        convention); across ranks each averaged over them, the global
        batch's loss."""
        inv = 1.0 / self.grad_accum
        leaves, spec = tree_flatten(result)
        if self.loss_weights is not None:
            weights, wspec = tree_flatten(self.loss_weights)
            if wspec != spec:
                raise ValueError(
                    "Stoke -- loss_weights structure must match the loss() "
                    "return structure"
                )
            comps = [float(w) * l.float().sum()
                     for w, l in zip(weights, leaves)]
        else:
            comps = [l.float().sum() for l in leaves]
        aux = self.aux_total()
        if self.aux_loss_weight and aux is not None:
            comps[0] = comps[0] + self.aux_loss_weight * aux
        for m in self.aux_modules:
            # the objective holds the graph now; a module attribute that
            # kept it past the backward would keep its gradient nodes,
            # whose stream a later captured window would not match
            if m.aux_loss is not None:
                m.aux_loss = m.aux_loss.detach()
        if self.per_loss:
            n = self.precision_config.num_losses
            if len(comps) != n:
                raise ValueError(
                    f"Stoke -- PrecisionConfig.num_losses={n} but loss() "
                    f"returned {len(comps)} loss leaves — per-loss scalers "
                    f"need one scale per loss"
                )
            objective = torch.stack(comps) * inv
        else:
            objective = sum(comps) * inv
        report = tree_unflatten([l.detach() * inv for l in leaves], spec)
        if self.ladder is not None:
            report = self.ladder.average(report)
        return objective, report

    def aux_total(self) -> Optional[torch.Tensor]:
        """The sum of the last forward's auxiliary losses (fp32), or None
        for a model without any."""
        terms = [m.aux_loss.float() for m in self.aux_modules
                 if m.aux_loss is not None]
        return sum(terms) if terms else None

    def _cut_positions(self, idx: Sequence[int]) -> List[tuple]:
        """The positions in ``idx`` of the leaves the split cut, by the
        axes of their group: ``[(axes, positions), ...]``."""
        by: Dict[tuple, List[int]] = {}
        for j, i in enumerate(idx):
            if i in self._cut:
                by.setdefault(self._cut[i], []).append(j)
        return list(by.items())

    def _whole_norms(self, norms: torch.Tensor, idx: Sequence[int],
                     p: float = 2.0) -> torch.Tensor:
        """``norms`` (the ``p``-norm of each of the leaves ``idx``, this
        rank's) with each leaf the split cut taken whole: its slices'
        ``p``-th powers summed (maxima maxed) over its own group. At a
        group of one the values do not move (``sqrt(x * x)`` is ``x`` in
        binary floating point)."""
        for axes, at in self._cut_positions(idx):
            pos = self._device_vector(at, torch.long)
            part = norms.index_select(0, pos)
            if p == float("inf"):
                part = self.tp.reduce_(part, "max", axes)
            elif p == 2:
                part = self.tp.reduce_(part * part, axes=axes).sqrt()
            else:
                part = self.tp.reduce_(part ** p, axes=axes) ** (1.0 / p)
            norms = norms.index_copy(0, pos, part)
        return norms

    def _whole_sums(self, values: torch.Tensor, idx: Sequence[int],
                    op: str = "sum") -> torch.Tensor:
        """``values`` (one a leaf of ``idx``) with each cut leaf's summed
        (or maxed) over its own group."""
        for axes, at in self._cut_positions(idx):
            pos = self._device_vector(at, torch.long)
            part = self.tp.reduce_(values.index_select(0, pos), op, axes)
            values = values.index_copy(0, pos, part)
        return values

    def backward(self, objective: torch.Tensor) -> None:
        """The 4-call path's micro-step (one dispatch, a ``stoke/accum``
        span): :meth:`_backward`."""
        self._dispatch("backward")
        rec = self._accum_rec
        with trace_span("stoke/accum", track="step"):
            if self.cost_cards is None:
                with self._accum_segment():
                    self._backward(objective)
            else:
                key = ("accum", self._accum_sig)
                cost, self._accum_cost = self._accum_cost, None
                with contextlib.ExitStack() as stack:
                    if cost is not None:
                        stack.enter_context(counting(cost))
                    stack.enter_context(self._accum_segment())
                    self._backward(objective)
                self.cost_cards.note_dispatch(key, "accum", cost, steps=0)
        self._accum_rec = None
        if rec is not None:
            self._finish_recording(rec)

    def _backward(self, objective: torch.Tensor) -> None:
        """Autograd of ``objective`` into the accumulated fp32 ``.grad``:
        times the loss scale under fp16; with per-loss scalers, one
        backward per loss seeded with its own scale, each checked for
        finiteness (ANDed into the scaler's ``finite`` flags) and unscaled
        into the buffer, which then holds unscaled gradients (the JAX
        accumulate core's per-loss branch). Across ranks the tier then
        reduces what it shards between micro-steps
        (:meth:`~stoke_tpu_torch.parallel.ladder.Ladder.after_backward`)."""
        if self.per_loss:
            self._backward_per_loss(objective)
        elif self.precision.scaled:
            (objective * self.scaler["scale"]).backward()
        else:
            objective.backward()
        if self.ladder is not None:
            self.ladder.after_backward(self.sync)

    def _backward_per_loss(self, objective: torch.Tensor) -> None:
        scales, flags = self.scaler["scale"], self.scaler["finite"]
        n = scales.shape[0]
        index = torch.arange(n, device=scales.device)
        for i in range(n):
            seed = torch.where(index == i, scales, 0.0)
            grads = torch.autograd.grad(objective, self.params, seed,
                                        retain_graph=i < n - 1,
                                        allow_unused=True)
            got = [(p, g) for p, g in zip(self.params, grads)
                   if g is not None]
            finite = unscale_and_check([g for _, g in got],
                                       torch.reciprocal(scales[i]))
            flags[i] = flags[i] & finite
            for p, g in got:
                if p.grad is None:
                    p.grad = g
                else:
                    p.grad.add_(g)

    def accum(self, args: tuple, kwargs: dict, loss_args: tuple = ()):
        """One micro-step: forward, loss, :meth:`backward` of
        ``objective / grad_accum`` into the accumulated fp32 ``.grad`` of
        the masters. Returns the report."""
        out = self._forward_gathered(args, kwargs)
        objective, report = self.objective(self.loss(out, *loss_args))
        self._backward(objective)
        return report

    def apply(self, loss: Optional[torch.Tensor] = None,
              probe_grad_norm: bool = False) -> Optional[torch.Tensor]:
        """The 4-call path's apply (one dispatch, a ``stoke/step`` span):
        :meth:`_apply`, its sentinel row kept as :attr:`sentinel_row` and
        its group statistics as :attr:`numerics_row` (``loss``: the
        boundary's undivided micro loss). With
        ``probe_grad_norm`` (and no sentinels) the pre-clip global grad
        norm is kept as :attr:`grad_norm`. Returns the finite flag."""
        self._dispatch("apply")
        with trace_span("stoke/step", track="step"), \
                self._observed("apply", (), 1):
            finite, self.sentinel_row, self.numerics_row = self._apply(
                loss, probe_grad_norm)
        return finite

    @torch.no_grad()
    def _apply(self, loss: Optional[torch.Tensor] = None,
               probe_grad_norm: bool = False
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                          Optional[torch.Tensor]]:
        """At the accumulation boundary, in the JAX apply core's order:
        under fp16 unscale and check the accumulated gradients (ANDed with
        the per-loss flags), then clip, step the optimizer (put back when
        not finite), zero the buffer, and update the scaler. Returns the
        finite flag (a bool scalar on the device), or None without fp16,
        the sentinel row (None without sentinels) and the numerics'
        group statistics (None without them).

        Across ranks the gradients are first reduced
        (:meth:`~stoke_tpu_torch.parallel.ladder.Ladder.reduce_for_apply`),
        the finite flags ANDed over the ranks (one rank's overflow skips
        the step everywhere), the clip norm taken over the global
        gradient, and after the step the tier's parameters gathered."""
        ladder = self.ladder
        transport = (self._transport_grads
                     if self.transport is not None and self.transport.active
                     else None)
        if ladder is None:
            if transport is not None:
                transport([_grad_or_zeros(p) for p in self.params])
            grad_idx = [i for i, p in enumerate(self.params)
                        if p.grad is not None]
            grads = [self.params[i].grad for i in grad_idx]
            sharded: List[torch.Tensor] = []
            shard_idx: List[int] = []
        else:
            grads, sharded = ladder.reduce_for_apply(transport)
            grad_idx = list(ladder.replicated)
            shard_idx = [i for b in ladder.buckets for i in b.index]
        finite = None
        if self.precision.scaled:
            scale = self.scaler["scale"]
            inv = (torch.ones((), dtype=torch.float32, device=scale.device)
                   if self.per_loss else torch.reciprocal(scale))
            finite = unscale_and_check(grads + sharded, inv)
            if self.per_loss:
                if ladder is not None:
                    self.scaler["finite"].copy_(
                        ladder.all_true(self.scaler["finite"]))
                if self._cut:
                    self.scaler["finite"].copy_(
                        self.tp.all_true(self.scaler["finite"]))
                finite = finite & self.scaler["finite"].all()
            if ladder is not None:
                finite = ladder.all_true(finite)
            if self._cut:
                finite = self.tp.all_true(finite)
        probe = None
        if self.sentinels or self.numerics or probe_grad_norm:
            probe = _GradProbe(grads, sharded, grad_idx, shard_idx,
                               self.device, flags=self.sentinels,
                               numerics=self.numerics)
            if self._cut:
                self._whole_probe(probe)
        clip_norm = clip_gradients(
            grads, self.grad_clip, sharded, ladder,
            None if probe is None else (probe.rep_norms, probe.part_norms),
            (lambda v, p: self._whole_norms(v, grad_idx, p))
            if self._cut else None)
        if self.disk_store is not None and self.disk_store.spilled:
            self._unspill()
        old = None
        if self.host_state is not None:
            old = self._host_step(finite)
        elif finite is None:
            if self._keeps_old:
                old = self._snap({(i, None): p for i, p in
                                  enumerate(self.opt_params)})
            self.optimizer.step()
        else:
            old = self._step_unless(finite)
        if self.disk_store is not None:
            self._spill()
        self.optimizer.zero_grad(set_to_none=True)
        if ladder is not None:
            ladder.after_step()
        row = groups = None
        if self._keeps_old:
            sq = self._step_squares(old)
            if self._cut:
                every = range(len(self.params))
                sq = (self._whole_sums(sq[0], every),
                      self._whole_sums(sq[1], every))
            if self.sentinels:
                row = self._sentinel_row(probe, clip_norm, sq, finite, loss)
            if self.numerics:
                groups = self._group_stats(probe, sq)
        if not self.sentinels and probe_grad_norm:
            self.grad_norm = self._probe_grad_norm(probe, clip_norm)
        if self.precision.scaled:
            flags = self.scaler["finite"] if self.per_loss else finite
            new = scaler_update(self.scaler, flags, self.precision_config)
            self.scaler["scale"].copy_(new["scale"])
            self.scaler["growth_count"].copy_(new["growth_count"])
            if self.per_loss:
                self.scaler["finite"].fill_(True)
        return finite, row, groups

    def _whole_probe(self, probe: "_GradProbe") -> None:
        """The probe of the leaves stepped whole over the data axis, the
        leaves the model split cut taken whole: their norms, flags and
        numerics summed (or maxed) over each leaf's own group."""
        idx = probe.grad_idx
        if not idx:
            return
        probe.rep_norms = self._whole_norms(probe.rep_norms, idx)
        if probe.rep_flags.numel():
            probe.rep_flags = (self._whole_sums(probe.rep_flags, idx)
                               > 0).float()
        if self.numerics:
            probe.rep_absmax = self._whole_sums(probe.rep_absmax, idx, "max")
            probe.rep_finite = self._whole_sums(probe.rep_finite, idx)
            parts = {i: self.tp.groups[a].size for i, a in self._cut.items()}
            probe.rep_numel = [n * parts.get(i, 1)
                               for i, n in zip(idx, probe.rep_numel)]

    def _step_squares(self, old: Dict[Any, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The squared 2-norm of each updated parameter (a slice under a
        sharding tier) and of its update (``old - new`` in place on the
        copy ``old`` taken before the step), this rank's, in the engine's
        order."""
        params = self.opt_params
        before = [old[(i, None)] for i in range(len(params))]
        torch._foreach_sub_(before, params)
        return leaf_norms(params) ** 2, leaf_norms(before) ** 2

    def _group_stats(self, probe: "_GradProbe",
                     sq: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """The numerics matrix ``[n_groups, N_NUMERICS_STATS]`` (the JAX
        ``compute_group_stats``): per group of the JAX tree the sum of the
        gradients' squares, their largest magnitude and count of
        non-finite elements (the unscaled, post-transport, pre-clip
        gradients of ``probe``), and the sums of squares of the updated
        parameters and of the update (``sq``). Across the ladder's ranks
        the sliced leaves' parts are summed (their largest magnitude
        maxed) over the ranks first."""
        n = len(self.params)
        zero = torch.zeros(n, dtype=torch.float32, device=self.device)
        g_sq, g_max, g_nf = zero.clone(), zero.clone(), zero.clone()
        for idx, sq_, mx, fin, numel in (
                (probe.grad_idx, probe.rep_norms ** 2, probe.rep_absmax,
                 probe.rep_finite, probe.rep_numel),
                (probe.shard_idx, probe.part_norms ** 2, probe.part_absmax,
                 probe.part_finite, probe.part_numel)):
            if idx:
                at = self._device_vector(idx, torch.long)
                g_sq.index_copy_(0, at, sq_)
                g_max.index_copy_(0, at, mx)
                g_nf.index_copy_(
                    0, at, self._device_vector(numel, torch.float32) - fin)
        p_sq, u_sq = sq
        cut = probe.shard_idx
        if self.ladder is not None and cut:
            at = self._device_vector(cut, torch.long)
            vec = torch.cat([g_sq[at], g_nf[at], p_sq[at], u_sq[at]])
            self.ladder.reduce_(vec)
            k = len(cut)
            g_sq[at], g_nf[at] = vec[:k], vec[k:2 * k]
            p_sq = p_sq.index_copy(0, at, vec[2 * k:3 * k])
            u_sq = u_sq.index_copy(0, at, vec[3 * k:])
            g_max[at] = self.ladder.reduce_(g_max[at], "max")
        G = len(self.groups)
        out = torch.zeros((G, 5), dtype=torch.float32, device=self.device)
        for j, v in ((0, g_sq), (2, g_nf), (3, p_sq), (4, u_sq)):
            out[:, j].index_add_(0, self._group_of, v)
        out[:, 1] = torch.zeros(G, dtype=torch.float32,
                                device=self.device).scatter_reduce(
            0, self._group_of, g_max, "amax")
        return out

    def _device_vector(self, values: List[int],
                       dtype: torch.dtype) -> torch.Tensor:
        """``values`` as a tensor on the device, made once per list (a
        host-to-device copy cannot run inside a captured window; the
        first apply runs eagerly)."""
        key = (tuple(values), dtype)
        t = self._index_cache.get(key)
        if t is None:
            t = self._index_cache[key] = torch.tensor(
                values, dtype=dtype, device=self.device)
        return t

    def _sentinel_row(self, probe: "_GradProbe",
                      clip_norm: Optional[torch.Tensor],
                      sq: Tuple[torch.Tensor, torch.Tensor],
                      finite: Optional[torch.Tensor],
                      loss: Optional[torch.Tensor]) -> torch.Tensor:
        """The sentinel row after the step: the gradient part of ``probe``
        (its grad norm the clip's 2-norm when the clip took one), the
        norms of the updated parameters and of the update (their squares
        ``sq``), the error-feedback residual's norm. Across the ladder's
        ranks each sliced leaf's squares and flags are summed over the
        ranks in one all-reduce, so the norms and flags are global."""
        n = len(self.opt_params)
        # per-leaf scalars, put together in Python (an index tensor made
        # on the host would be a host-to-device copy inside the graph)
        param_sq = list(sq[0].unbind(0))
        upd_sq = list(sq[1].unbind(0))
        residual = self.comm_state.get("residual")
        res_sq = None
        if residual:
            res_sq = (leaf_norms(residual) ** 2).sum().reshape(1)
        part_sq, part_flags = probe.part_norms ** 2, probe.part_flags
        if self.ladder is not None:
            # the sliced leaves' parts, summed over the ranks (a
            # residual of the sharded transport is a slice a rank too)
            cut = probe.shard_idx
            shard_res = (res_sq is not None
                         and self.transport.layout_kind == "sharded")
            parts = [part_sq, part_flags]
            if cut:
                parts += [torch.stack([param_sq[i] for i in cut]),
                          torch.stack([upd_sq[i] for i in cut])]
            if shard_res:
                parts.append(res_sq)
            vec = torch.cat(parts)
            if vec.numel():
                self.ladder.reduce_(vec)
            k = len(cut)
            part_sq, part_flags = vec[:k], (vec[k:2 * k] > 0).float()
            for j, i in enumerate(cut):
                param_sq[i] = vec[2 * k + j]
                upd_sq[i] = vec[3 * k + j]
            if shard_res:
                res_sq = vec[-1:]
        grad_norm = self._probe_grad_norm(probe, clip_norm, part_sq)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        flag = [zero] * n
        for i, f in zip(probe.grad_idx, probe.rep_flags.unbind(0)):
            flag[i] = f
        for i, f in zip(probe.shard_idx, part_flags.unbind(0)):
            flag[i] = f
        flags = torch.stack([flag[i] for i in self._jax_order])
        return pack_sentinels(
            loss, grad_norm, torch.stack(param_sq).sum().sqrt(),
            torch.stack(upd_sq).sum().sqrt(), flags, finite,
            None if res_sq is None else res_sq.sum().sqrt())

    def _probe_grad_norm(self, probe: "_GradProbe",
                         clip_norm: Optional[torch.Tensor],
                         part_sq: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """The global pre-clip 2-norm of the gradients: the clip's when it
        took a 2-norm, else from ``probe``'s leaf norms (``part_sq``: the
        slices' squares already summed over the ranks)."""
        if clip_norm is not None and self.grad_clip.norm_type == 2:
            return clip_norm.float()
        if part_sq is None:
            part_sq = probe.part_norms ** 2
            if self.ladder is not None and part_sq.numel():
                self.ladder.reduce_(part_sq)
        return (probe.rep_norms.pow(2).sum() + part_sq.sum()).sqrt()

    def _transport_grads(self, grads: List[torch.Tensor]) -> None:
        """The gradient transport over the whole reduced gradients
        ``grads`` (the engine's parameter order), in place: unscaled
        (a lossy transport is not legal under fp16), before the finite
        check and the clip, as the JAX apply core orders them."""
        order = self.comm_order
        out = self.transport.apply(order.to_jax(grads), self.comm_state)
        order.from_jax(out, grads)

    def _guarded(self) -> Dict[Any, torch.Tensor]:
        """Every tensor a step may change: the parameters and each tensor
        of the optimizer's state, by (parameter index, state key); under
        a sharding tier the slices the optimizer holds. The state the host
        tier keeps is its own to put back."""
        params = self.opt_params
        out = {(i, None): p for i, p in enumerate(params)}
        hosted = ({id(t) for t in self.host_state.host_tensors}
                  if self.host_state is not None else ())
        for i, p in enumerate(params):
            for key, v in self.optimizer.state.get(p, {}).items():
                if torch.is_tensor(v) and id(v) not in hosted:
                    out[(i, key)] = v
        return out

    def _host_step(self, finite: Optional[torch.Tensor]
                   ) -> Optional[Dict[Any, torch.Tensor]]:
        """The optimizer step through the host tier: the state streamed
        group by group (put back there where ``finite`` is false), the
        parameters and the device scalars (step counts) put back here.
        Returns the copies taken before the step (the sentinels'), or
        None."""
        old = None
        if finite is not None:
            old = self._snap(self._guarded())
        elif self._keeps_old:
            old = self._snap({(i, None): p for i, p in
                              enumerate(self.opt_params)})
        self.host_state.step(finite)
        if self.host_state.reallocated:
            # its buffers' addresses are in the captured windows
            self.host_state.reallocated = False
            self.drop_windows()
        if finite is not None:
            for key, t in self._guarded().items():
                prev = old.get(key)
                if prev is None:
                    prev = torch.zeros((), dtype=t.dtype, device=t.device)
                torch.where(finite, t, prev, out=t)
        return old

    def _spill(self) -> None:
        """The disk tier: write the optimizer state shaped like its
        parameters to the store and free its memory (the parameters
        protected)."""
        keys, tensors = [], []
        for p in self.opt_params:
            for key, v in self.optimizer.state.get(p, {}).items():
                if torch.is_tensor(v) and v.dim() and v.shape == p.shape:
                    keys.append((p, key))
                    tensors.append(v)
        self._disk_keys = keys
        self.disk_store.store(tensors, protect=self.opt_params)

    def _unspill(self) -> None:
        """The disk tier: the spilled state back into the optimizer."""
        for (p, key), t in zip(self._disk_keys, self.disk_store.load()):
            self.optimizer.state[p][key] = t

    @contextlib.contextmanager
    def resident_state(self):
        """The optimizer state readable (and writable) by the host inside
        the block: the host tier's copies of the last update waited for,
        the disk tier's spill loaded back, and spilled again after."""
        if self.host_state is not None and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        spilled = self.disk_store is not None and self.disk_store.spilled
        if spilled:
            self._unspill()
        try:
            yield
        finally:
            if spilled:
                self._spill()

    @torch.no_grad()
    def _snap(self, live: Dict[Any, torch.Tensor]) -> Dict[Any, torch.Tensor]:
        """Copies of ``live`` into buffers kept from step to step (outside
        autograd: a copy of a parameter recorded by autograd would keep
        the parameter's gradient node alive on this stream)."""
        for key, t in live.items():
            b = self._snapshot.get(key)
            if (b is None or b.shape != t.shape or b.dtype != t.dtype
                    or b.device != t.device):
                self._snapshot[key] = torch.empty_like(t)
        bufs = [self._snapshot[key] for key in live]
        torch._foreach_copy_(bufs, list(live.values()))
        return dict(zip(live, bufs))

    def _step_unless(self, finite: torch.Tensor) -> Dict[Any, torch.Tensor]:
        """``optimizer.step()``, then every parameter and optimizer state
        tensor, step counts included, put back where ``finite`` is false:
        ``torch.where`` over the new value and a copy taken before the
        step, so a skipped step leaves them bit for bit as they were,
        decided on the device with no host sync (and so inside a CUDA
        graph). This works for any ``torch.optim`` optimizer; the
        ``found_inf`` argument of the fused Adam family would skip in the
        kernel but exists only there. State the step creates (the first
        step's) is zeroed instead, as optax initialises it. Returns the
        copies taken before the step, by (parameter index, state key)."""
        old = self._snap(self._guarded())
        self.optimizer.step()
        for key, t in self._guarded().items():
            keep = finite if finite.device == t.device else finite.to(t.device)
            prev = old.get(key)
            if prev is None:
                prev = torch.zeros((), dtype=t.dtype, device=t.device)
            torch.where(keep, t, prev, out=t)
        return old

    def fused(self, args: tuple, kwargs: dict, loss_args: tuple = (),
              do_apply: bool = True):
        """:meth:`accum`, then :meth:`_apply` when ``do_apply`` (one
        dispatch, a ``stoke/dispatch`` span; the row of an apply is
        :attr:`sentinel_row`). Returns ``(report, finite)``; ``finite`` is
        None without an apply or without fp16."""
        self._dispatch("fused")
        program = "fused" if do_apply else "fused_nb"
        inputs = (args, kwargs, loss_args)
        sig = signature(inputs)
        with trace_span("stoke/dispatch", track="step"), \
                self._observed(program, sig, int(do_apply), inputs):
            report = self.accum(args, kwargs, loss_args)
            finite = None
            if do_apply:
                finite, self.sentinel_row, self.numerics_row = self._apply(
                    self._report_loss(report) if self.sentinels else None)
        return report, finite

    def _report_loss(self, report) -> torch.Tensor:
        """The sentinel's boundary loss (the JAX ``_report_loss``): the sum
        over the loss leaves of each leaf's mean (over a stacked micro
        axis), times ``grad_accum``: undivided micro-loss units."""
        return sum(l.float().mean() for l in tree_leaves(report)) * float(
            self.grad_accum)

    # ------------------------------------------------------------------ #
    # the accumulation window
    # ------------------------------------------------------------------ #

    def _window(self, margs: tuple, mkwargs: dict, loss_args: tuple):
        """``grad_accum`` micro-steps over the stacked inputs' leading
        axis, then :meth:`apply`: exactly what ``grad_accum`` calls of
        :meth:`fused` compute. Returns (reports stacked ``[k, ...]``,
        finite, the sentinel row or None)."""
        reports = []
        for i in range(self.grad_accum):
            def pick(tree, i=i):
                return tree_map(lambda t: t[i] if torch.is_tensor(t) else t,
                                tree)

            reports.append(self.accum(pick(margs), pick(mkwargs),
                                      pick(loss_args)))
        reports = tree_map(lambda *r: torch.stack(r), *reports)
        finite, row, groups = self._apply(
            self._report_loss(reports) if self.sentinels else None)
        return reports, finite, row, groups

    def window(self, margs: tuple, mkwargs: dict, loss_args: tuple):
        """One whole accumulation window over inputs stacked to
        ``[grad_accum, ...]`` (the JAX ``window_step``; one dispatch, a
        ``stoke/dispatch`` span). Returns (the reports stacked
        ``[grad_accum, ...]``, the finite flag or None); the sentinel row
        is :attr:`sentinel_row`, a tensor of its own on every call.

        On the CPU it runs eagerly. On the card, the first call for a
        signature (the stacked inputs' structure, shapes and dtypes, with
        ``grad_accum`` and the loss structure that follow from them) runs
        one window eagerly, which makes the optimizer's state and builds
        the kernels, then captures a window into a ``torch.cuda.CUDAGraph``
        with static input buffers. Every later call of that signature
        copies its inputs into those buffers (device to device when they
        are on the card) and replays the graph. The learning rates are
        baked into the graph as floats, as the JAX package's compiled
        window bakes its schedule: a window whose param groups' ``lr``
        changed captures anew. A capture that fails raises with its
        cause; nothing falls back to eager on the card. A capture counts
        as a compile of the telemetry, and one for a signature captured
        before (or after another signature) as a recompile."""
        self._dispatch("window")
        with trace_span("stoke/dispatch", track="step"):
            (reports, finite, self.sentinel_row,
             self.numerics_row) = self._run_window(margs, mkwargs, loss_args)
        return reports, finite

    def _run_window(self, margs: tuple, mkwargs: dict, loss_args: tuple):
        inputs = (tuple(margs), dict(mkwargs), tuple(loss_args))
        if self.device.type != "cuda" or self.disk_store is not None:
            # the disk tier's spill is file IO, which a graph cannot hold
            with self._observed("window", signature(inputs), 1, inputs):
                return self._window(*inputs)
        flat, spec = tree_flatten(inputs)
        key = (spec, tuple((tuple(t.shape), t.dtype, t.device)
                           if torch.is_tensor(t) else t for t in flat))
        lrs = tuple(None if torch.is_tensor(g["lr"]) else g["lr"]
                    for g in self.optimizer.param_groups)
        cap = self._windows.get(key)
        # a replay needs the signature only for its cost card
        sig = (signature(inputs) if cap is None or cap.lrs != lrs
               or self.cost_cards is not None else None)
        if cap is not None and cap.lrs != lrs:
            baked = self._spec_of.get(("window", sig))
            if baked is not None:
                # the floats baked into the graph changed: a recapture
                baked.weak_leaves += (
                    f"captured learning rates {cap.lrs} changed to {lrs}",)
            del self._windows[key]
            cap = None
        if cap is None:
            # the first window of a signature runs eagerly: the one its
            # cost card counts, its memory card measures and the auditor
            # records (never the capture)
            with self._observed("window", sig, 1, inputs):
                out = self._window(*inputs)
            if self.compile_tracker is not None and self._captured:
                self.compile_tracker.note_recompile()
            self._captured.add(key)
            self._window_captures += 1
            reserved = torch.cuda.memory_reserved(self.device)
            with collectors.compiling():
                self._windows[key] = self._capture(flat, spec, lrs)
            if self.memory is not None:
                self.memory.note_graph_pool(
                    "window",
                    torch.cuda.memory_reserved(self.device) - reserved)
            return out
        for dst, src in zip(cap.inputs, flat):
            if torch.is_tensor(dst):
                dst.copy_(src)
        if self.cost_cards is not None:
            self.cost_cards.note_dispatch(("window", sig), "window", None, 1)
        cap.graph.replay()
        for name, n in cap.launches.items():
            LAUNCHES[name] += n
        reports, *rest = cap.outputs
        return (tree_map(torch.clone, reports),
                *(None if t is None else t.clone() for t in rest))

    def drop_windows(self) -> None:
        """Forget every captured window: the next window of each signature
        captures anew (after the parameters' or the optimizer state's
        tensors were replaced, whose addresses a graph holds)."""
        self._windows.clear()

    def _capture(self, flat: list, spec, lrs) -> CapturedWindow:
        hosted = ({id(t) for t in self.host_state.host_tensors}
                  if self.host_state is not None else ())
        for p in self.opt_params:
            for key, v in self.optimizer.state.get(p, {}).items():
                if (torch.is_tensor(v) and v.device != self.device
                        and id(v) not in hosted):
                    raise RuntimeError(
                        f"Stoke -- the optimizer keeps its state {key!r} on "
                        f"{v.device}; a window on the card runs as a CUDA "
                        f"graph and needs all optimizer state on "
                        f"{self.device} (an optimizer with capturable=True)"
                    )
        if self.precision.scaled:
            # the skip's copies live outside the graph's memory pool
            self._snap(self._guarded())
        elif self._keeps_old:
            # so do the sentinels' copies of the parameters
            self._snap({(i, None): p for i, p in enumerate(self.opt_params)})
        static = [t.clone() if torch.is_tensor(t) else t for t in flat]
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = dict(LAUNCHES)
        try:
            with torch.cuda.graph(graph):
                outputs = self._window(*tree_unflatten(static, spec))
        except Exception as e:
            raise RuntimeError(
                f"Stoke -- capturing the accumulation window as a CUDA "
                f"graph failed: {e}"
            ) from e
        finally:
            launched = {n: LAUNCHES[n] - before[n] for n in LAUNCHES}
            LAUNCHES.update(before)
        return CapturedWindow(graph, static, outputs, launched, lrs)
