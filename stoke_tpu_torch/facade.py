"""The ``Stoke`` facade of the port, on one device.

Counterpart of ``stoke_tpu/facade.py``: the constructor (``:229-804``, the
parts this slice takes), the four-call contract and ``train_step``
(``:973-1278``), loss tracking (``:2743-2812``), ``DataLoader``
(``:3047-3101``) and the counters and flags (``:3463-3547``).

The JAX facade defers the forward (``model()`` returns a
``DeferredOutput``; forward, loss and grad run fused in ``loss()``)
because JAX must trace them together. The port does what PyTorch does:

- ``model()`` runs the forward eagerly under autograd and returns it;
- ``loss()`` returns the losses divided by ``grad_accum``;
- ``backward()`` runs autograd into the accumulated fp32 gradients;
- ``step()`` applies at the accumulation boundary, and before it does
  nothing.

``train_step(model_args, loss_args)`` computes the same as the four calls.
In eval mode ``model()`` runs under ``torch.no_grad()``; train and eval
are the module's mode bit.

Left out of this slice, and refused with ``NotImplementedError`` naming
their ROADMAP item: fp16, ``distributed`` and the oss/sddp/fsdp tiers
(by the status layer), ``save``/``load``, and
``train_step_window``/``train_steps``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils._pytree import tree_leaves

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
_LATER_WINDOW = "ROADMAP Queue 1 item 2c (train_step_window / train_steps)"


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
        precision: None/"full" or "bf16" (the whole model in bfloat16 over
            fp32 master parameters); "fp16" is a later slice.
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
        )

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
        result = self._engine.loss_fn(*args, **kwargs)
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
        objective.backward()
        self._grad_accum_counter += 1
        self._backward_steps += 1

    def step(self) -> None:
        """At the accumulation boundary: clip, optimizer step, zero the
        gradients; before it, nothing."""
        if self._grad_accum_counter < self._status_obj.grad_accum:
            return
        self._engine.apply()
        self._optimizer_steps += 1
        self._grad_accum_counter = 0
        self._reset_tracking_window()

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
        report = self._engine.fused(margs, mkwargs, self._place(loss_args),
                                    do_apply=do_apply)
        self._pending = None
        self._backward_steps += 1
        self._update_loss_tracking(report)
        if do_apply:
            self._optimizer_steps += 1
            self._grad_accum_counter = 0
            self._reset_tracking_window()
        else:
            self._grad_accum_counter += 1
        return report

    def train_step_window(self, *args, **kwargs):
        raise NotImplementedError(
            f"Stoke.train_step_window is not ported yet: {_LATER_WINDOW}")

    def train_steps(self, *args, **kwargs):
        raise NotImplementedError(
            f"Stoke.train_steps is not ported yet: {_LATER_WINDOW}")

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
