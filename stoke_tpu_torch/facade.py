"""The ``Stoke`` facade of the port, on one device.

Counterpart of ``stoke_tpu/facade.py``: the constructor (``:229-804``, the
parts the port takes), the four-call contract and ``train_step``
(``:973-1278``), ``train_step_window`` and ``train_steps``
(``:2446-2729``) with the segment memory guard (``:94-115``), ``reset``
(``:2731``), loss tracking (``:2743-2812``), ``DataLoader``
(``:3047-3101``) and the counters, flags and loss scale
(``:3440-3547``).

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

Left out, and refused with ``NotImplementedError`` naming their ROADMAP
item: ``distributed`` and the oss/sddp/fsdp tiers (by the status layer)
and ``save``/``load``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils._pytree import tree_leaves, tree_map

from stoke_tpu_torch.configs import (
    ClipGradConfig,
    ClipGradNormConfig,
    DeviceOptions,
    DistributedOptions,
    PrecisionConfig,
    PrecisionOptions,
)
from stoke_tpu_torch.data import StokeDataLoader, place
from stoke_tpu_torch.engine import PrecisionPolicy, StepEngine, build_optimizer
from stoke_tpu_torch.models.bert import Dropout
from stoke_tpu_torch.serving.engine import resolve_device
from stoke_tpu_torch.status import StokeStatus

_LATER_IO = "ROADMAP Queue 1 item 6 (checkpoint IO)"


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
        distributed / oss / sddp / fsdp: later slices.
        precision: None/"full", "bf16" (the whole model in bfloat16 over
            fp32 master parameters) or "fp16" (in float16, with the dynamic
            loss scaler of ``PrecisionConfig``).
        configs: ``PrecisionConfig`` (the other classes are later slices).
        model_train_kwargs / model_eval_kwargs: keyword arguments the
            forward gets in train / eval mode (only when given).
        loss_weights: weights shaped like the loss result; the objective
            is ``sum(w_i * loss_i)``, the reported losses stay unweighted.
        seed: seeds the ``torch.Generator`` that draws the model's
            dropout masks (each :class:`~stoke_tpu_torch.models.bert
            .Dropout` of the model uses it).
        ema_weight: weight of the newest micro loss in ``ema_loss``.
        verbose: kept for the JAX signature; the port prints nothing.
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
        seed: int = 0,
        ema_weight: float = 0.1,
        verbose: bool = True,
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
        st.set_post_init_values(world_size=1)
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
        self._generator.manual_seed(seed)
        for m in self._module.modules():
            if isinstance(m, Dropout):
                m.generator = self._generator
        self._train_kwargs = dict(model_train_kwargs or {})
        self._eval_kwargs = dict(model_eval_kwargs or {})
        self._engine = StepEngine(
            self._module, loss,
            build_optimizer(optimizer, self._module.parameters()),
            self._precision, grad_accum=st.grad_accum,
            grad_clip=st.grad_clip, loss_weights=loss_weights,
            precision_config=st.precision_config, generator=self._generator,
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
        self.train()

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

    def _place(self, tree):
        return place(tree, self._device)

    def model(self, *args, **kwargs):
        """The forward on ``args`` (placed on the device): under autograd
        in train mode, under ``torch.no_grad()`` in eval mode."""
        args, kwargs = self._place(args), self._place(kwargs)
        if self.training:
            return self._engine.forward(args, {**self._train_kwargs, **kwargs})
        with torch.no_grad():
            return self._engine.forward(args, {**self._eval_kwargs, **kwargs})

    def loss(self, *args, **kwargs):
        """``loss(*args, **kwargs)``; in train mode the losses are returned
        divided by ``grad_accum`` and the objective is kept for
        :meth:`backward` (when it has a gradient: a loss of a detached
        output gives ``backward()`` nothing to commit)."""
        args, kwargs = self._place(args), self._place(kwargs)
        result = self._engine.loss(*args, **kwargs)
        if not self.training:
            return result
        objective, report = self._engine.objective(result)
        self._pending = objective if objective.requires_grad else None
        self._update_loss_tracking(report)
        return report

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
        self._engine.backward(objective)
        self._grad_accum_counter += 1
        self._backward_steps += 1

    def step(self) -> None:
        """At the accumulation boundary: (under fp16, unscale and check)
        clip, optimizer step (skipped when not finite), zero the gradients
        (and update the loss scale); before it, nothing."""
        if self._grad_accum_counter < self._status_obj.grad_accum:
            return
        self._count_skipped(self._engine.apply())
        self._optimizer_steps += 1
        self._grad_accum_counter = 0
        self._reset_tracking_window()

    def _count_skipped(self, finite: Optional[torch.Tensor]) -> None:
        """``skipped_optimizer_steps += 1 - finite`` on the device (fp16)."""
        if finite is not None:
            self._skipped_steps += 1.0 - finite.float()

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
        margs = self._place(model_args)
        mkwargs = {**self._train_kwargs, **self._place(model_kwargs or {})}
        do_apply = self._grad_accum_counter + 1 >= self._status_obj.grad_accum
        report, finite = self._engine.fused(
            margs, mkwargs, self._place(loss_args), do_apply=do_apply)
        self._pending = None
        self._backward_steps += 1
        self._update_loss_tracking(report)
        if do_apply:
            self._count_skipped(finite)
            self._optimizer_steps += 1
            self._grad_accum_counter = 0
            self._reset_tracking_window()
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

    def _run_window(self, margs: tuple, mkwargs: dict, loss_args: tuple):
        """One window of inputs already on the device and stacked to
        ``[grad_accum, ...]``: the engine's window, then the counters, the
        loss tracking (once, with the window-mean micro loss) and the
        skipped count. Returns the stacked reports."""
        reports, finite = self._engine.window(margs, mkwargs, loss_args)
        self._pending = None
        self._backward_steps += self._status_obj.grad_accum
        self._update_loss_tracking(tree_map(lambda r: r.mean(0), reports))
        self._count_skipped(finite)
        self._optimizer_steps += 1
        self._reset_tracking_window()
        return reports

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
        return self._run_window(
            self._place(model_args),
            {**self._train_kwargs, **self._place(model_kwargs or {})},
            self._place(loss_args))

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
        margs, loss_args = self._place(model_args), self._place(loss_args)
        mkwargs = {**self._train_kwargs, **self._place(model_kwargs or {})}
        reports: List[Any] = []
        for i in range(n):
            sl = slice(i * k, (i + 1) * k)
            reports.append(self._run_window(
                _leading(margs, sl), _leading(mkwargs, sl),
                _leading(loss_args, sl)))
        return tree_map(lambda *r: torch.stack(r), *reports)

    def reset(self) -> None:
        """Drop the accumulated gradients and zero the accumulation
        counter without stepping (the JAX facade's ``reset``)."""
        self._engine.optimizer.zero_grad(set_to_none=True)
        self._grad_accum_counter = 0
        self._pending = None
        self._reset_tracking_window()

    def save(self, *args, **kwargs):
        raise NotImplementedError(f"Stoke.save is not ported yet: {_LATER_IO}")

    def load(self, *args, **kwargs):
        raise NotImplementedError(f"Stoke.load is not ported yet: {_LATER_IO}")

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

    # ------------------------------------------------------------------ #
    # data
    # ------------------------------------------------------------------ #

    def DataLoader(self, dataset, **kwargs) -> StokeDataLoader:
        """A :class:`~stoke_tpu_torch.data.StokeDataLoader` of
        ``batch_size_per_device`` rows on this run's device."""
        return StokeDataLoader(dataset, batch_size=self.batch_size,
                               device=self._device, **kwargs)

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
    def oss(self) -> bool:
        return self._status_obj.oss

    @property
    def sddp(self) -> bool:
        return self._status_obj.sddp

    @property
    def fsdp(self) -> bool:
        return self._status_obj.fsdp
