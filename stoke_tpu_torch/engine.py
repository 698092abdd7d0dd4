"""The step engine of the port on one device: precision policy, gradient
clipping, optimizer construction, and the accumulate / apply steps.

Counterpart of ``stoke_tpu/engine.py``: ``PrecisionPolicy`` (``:233-266``),
``clip_gradients`` (``:312-341``), ``build_optimizer`` (``:349-372``), the
train forward (``:699-707``), the accumulate core for one loss or
``loss_weights`` (``:951-1117``) and the apply core (``:1434-1531``,
without transports, sentinels or numerics).

The JAX engine traces forward and grad into one program; here autograd
records the eager forward, ``backward`` runs into the parameters' fp32
``.grad`` (the accumulation buffer), and ``apply`` clips, steps the
``torch.optim`` optimizer and zeroes the buffer.

Under bf16 the whole model runs in bfloat16, as the JAX policy casts the
params and floating inputs: ``torch.func.functional_call`` swaps in
bfloat16 casts of the fp32 master parameters, so every op (LayerNorm and
the tied head included) computes in bfloat16 and the gradients flow back
through the casts into fp32 ``.grad`` on the masters. The tied embedding is
cast once and used twice, and its two gradients sum into one. The output is
cast to fp32. ``torch.autocast`` would compute a different function: it
keeps LayerNorm and softmax in fp32.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from stoke_tpu_torch.configs import (
    ClipGradConfig,
    ClipGradNormConfig,
    PrecisionConfig,
    PrecisionOptions,
)


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
    cast), and the dtype its outputs are cast to."""

    param_dtype: torch.dtype
    compute_dtype: Optional[torch.dtype]
    output_dtype: Optional[torch.dtype]

    @staticmethod
    def make(option: PrecisionOptions, cfg: PrecisionConfig) -> "PrecisionPolicy":
        param = getattr(torch, cfg.param_dtype)
        if option is PrecisionOptions.full:
            return PrecisionPolicy(param, None, None)
        if option is PrecisionOptions.bf16:
            return PrecisionPolicy(param, torch.bfloat16,
                                   getattr(torch, cfg.output_dtype))
        raise ValueError(f"no precision policy for {option}")

    def cast_compute(self, tree):
        return _cast_floating(tree, self.compute_dtype)

    def cast_output(self, tree):
        return _cast_floating(tree, self.output_dtype)


@torch.no_grad()
def clip_gradients(grads: Sequence[torch.Tensor], grad_clip) -> None:
    """Clip ``grads`` in place, on the accumulated, unscaled gradients.

    ``ClipGradConfig``: clamp each element to ``[-v, v]``.
    ``ClipGradNormConfig``: the global ``norm_type``-norm over all
    gradients in fp32 (``inf``: the largest magnitude), then every
    gradient times ``min(1, max_norm / (norm + 1e-6))``, computed on the
    device with no host sync."""
    if grad_clip is None or not grads:
        return
    if isinstance(grad_clip, ClipGradConfig):
        v = grad_clip.clip_value
        for g in grads:
            g.clamp_(-v, v)
        return
    if isinstance(grad_clip, ClipGradNormConfig):
        p = grad_clip.norm_type
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float(), p) for g in grads]), p)
        factor = torch.clamp(grad_clip.max_norm / (norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(factor.to(g.dtype))
        return
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


class StepEngine:
    """The accumulate and apply steps over one module.

    Args:
        module: the model, on its device, parameters in ``param_dtype``.
        loss_fn: ``loss_fn(output, *loss_args)`` -> a scalar, or a tuple,
            list or dict of scalars (several losses).
        optimizer: the built ``torch.optim`` optimizer over the module's
            parameters.
        precision: the :class:`PrecisionPolicy`.
        grad_accum: micro-batches per optimizer step.
        grad_clip: ``ClipGradConfig``, ``ClipGradNormConfig`` or None.
        loss_weights: None, or weights shaped like the loss result; the
            objective is then ``sum(w_i * loss_i)`` while the reported
            losses stay unweighted.
    """

    def __init__(self, module: nn.Module, loss_fn: Callable,
                 optimizer: torch.optim.Optimizer, precision: PrecisionPolicy,
                 grad_accum: int = 1, grad_clip=None, loss_weights=None):
        self.module = module
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.precision = precision
        self.grad_accum = grad_accum
        self.grad_clip = grad_clip
        self.loss_weights = loss_weights
        self.params: List[torch.Tensor] = [
            p for p in module.parameters() if p.requires_grad
        ]

    def forward(self, args: tuple, kwargs: dict):
        """The model's forward under the precision policy (JAX
        ``_run_forward_train``); autograd records it when grad is on."""
        if self.precision.compute_dtype is None:
            return self.module(*args, **kwargs)
        dt = self.precision.compute_dtype
        cast = {n: t.to(dt) if t.is_floating_point() else t
                for n, t in (*self.module.named_parameters(),
                             *self.module.named_buffers())}
        out = functional_call(self.module, cast,
                              self.precision.cast_compute(tuple(args)),
                              self.precision.cast_compute(dict(kwargs)))
        return self.precision.cast_output(out)

    def objective(self, result) -> Tuple[torch.Tensor, Any]:
        """``(objective, report)`` of a training loss result.

        ``objective`` is the fp32 sum of the (weighted) losses divided by
        ``grad_accum``, the tensor to differentiate. ``report`` has the
        loss result's structure, each loss detached and divided by
        ``grad_accum`` (the JAX facade's convention)."""
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
        objective = sum(comps) * inv
        report = tree_unflatten([l.detach() * inv for l in leaves], spec)
        return objective, report

    def accum(self, args: tuple, kwargs: dict, loss_args: tuple = ()):
        """One micro-step: forward, loss, ``(objective / grad_accum)
        .backward()`` into the accumulated fp32 ``.grad`` of the masters.
        Returns the report."""
        out = self.forward(args, kwargs)
        objective, report = self.objective(self.loss_fn(out, *loss_args))
        objective.backward()
        return report

    def apply(self) -> None:
        """At the accumulation boundary: clip the accumulated gradients,
        step the optimizer, zero the buffer."""
        grads = [p.grad for p in self.params if p.grad is not None]
        clip_gradients(grads, self.grad_clip)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def fused(self, args: tuple, kwargs: dict, loss_args: tuple = (),
              do_apply: bool = True):
        """:meth:`accum`, then :meth:`apply` when ``do_apply``."""
        report = self.accum(args, kwargs, loss_args)
        if do_apply:
            self.apply()
        return report
