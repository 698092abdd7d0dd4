"""Rematerialization of the port: the training forward, or each
``TransformerBlock``, recomputed in backward instead of kept.

Counterpart of ``jax.checkpoint`` under the JAX engine's
``ActivationCheckpointingConfig`` (``stoke_tpu/engine.py:693-697``) and of
flax's ``nn.remat(TransformerBlock)`` in the models' ``remat=True``
(``stoke_tpu/models/bert.py:159-160``, ``vit.py:66-67``,
``gpt.py:162-165``). :func:`checkpoint` runs a function under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` with a saving
policy:

- ``nothing_saveable``: keep only the inputs, recompute everything;
- ``dots_saveable``: keep the outputs of ``aten.mm`` / ``addmm`` /
  ``bmm`` / ``baddbmm`` (``create_selective_checkpoint_contexts``);
- ``dots_with_no_batch_dims_saveable``: keep ``mm`` / ``addmm`` only. A
  ``Linear`` on ``[B, L, H]`` is one ``addmm`` over ``[B*L, H]`` (the JAX
  ``Dense``, a ``dot_general`` without batch dims); attention's einsums
  are ``bmm``s with batch dims;
- ``everything_saveable``: keep everything, which is no recompute: the
  function runs as it is.

The flash ``autograd.Function`` s are not dots (in the JAX package a
``pallas_call`` is not a ``dot_general`` either), so every policy but
``everything_saveable`` runs the forward kernel again in backward.

Dropout under recompute. The port's dropout draws its masks from the Stoke
generator, an explicit ``torch.Generator`` (``preserve_rng_state`` covers
only torch's default generators). Flax's remat replays the same keys, so
the JAX package's numbers do not move under remat; the port's must not
either. The forward of a checkpointed region keeps each mask it draws on a
tape (:func:`draw`); its recompute takes them back from the tape, in
order, and draws nothing. The generator then advances exactly as without
remat, eagerly and inside a CUDA-graph capture alike (a capture cannot
rewind a registered generator: ``set_state`` is refused there, and a
cloned state is not registered with the graph). A mask is one byte an
element, a small share of the block's activations. Nested regions (the
engine's checkpoint around blocks that checkpoint themselves) share
masks: an inner region recorded inside an outer recompute takes them from
the outer tape.

``prevent_cse`` has no meaning in eager PyTorch; it stays a parity field.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List

import torch
from torch.func import functional_call

from stoke_tpu_torch.configs import REMAT_POLICIES

#: the products each selective policy keeps
_DOTS = {
    "dots_saveable": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
}

_local = threading.local()


class _Tape:
    """The masks one checkpointed region drew, in order, and the recompute's
    read position."""

    __slots__ = ("masks", "cursor")

    def __init__(self):
        self.masks: List[torch.Tensor] = []
        self.cursor = 0


def _frames() -> list:
    frames = getattr(_local, "frames", None)
    if frames is None:
        frames = _local.frames = []
    return frames


@contextlib.contextmanager
def _frame(mode: str, tape: _Tape):
    if mode == "replay":
        tape.cursor = 0
    frames = _frames()
    frames.append((mode, tape))
    try:
        yield
    finally:
        frames.pop()


def draw(make: Callable[[], torch.Tensor]) -> torch.Tensor:
    """A random mask: ``make()`` outside any recompute, kept on the tape of
    every region recording it; inside a recompute, the next mask of the
    innermost replaying region's tape (``make`` is not called)."""
    source, recorders = None, []
    for mode, tape in reversed(_frames()):
        if mode == "replay":
            source = tape
            break
        recorders.append(tape)
    if source is None:
        mask = make()
    else:
        if source.cursor >= len(source.masks):
            raise RuntimeError(
                "remat: the recompute drew more random masks than its "
                "forward did (a region must draw the same masks in the "
                "same order)"
            )
        mask = source.masks[source.cursor]
        source.cursor += 1
    for tape in recorders:
        tape.masks.append(mask)
    return mask


def replaying() -> bool:
    """Whether this runs inside a recompute (its masks come from a
    tape): a forward's side outputs, such as an MoE block's auxiliary
    loss, keep the forward's values."""
    frames = _frames()
    return bool(frames) and frames[-1][0] == "replay"


def _policy_fn(keep):
    from torch.utils.checkpoint import CheckpointPolicy

    names = {getattr(torch.ops.aten, n).default for n in keep}

    def policy(ctx, op, *args, **kwargs):
        if op in names:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _contexts(policy: str):
    """``context_fn`` of ``torch.utils.checkpoint``: the mask tape's
    record / replay frames, with the selective policy's dispatch modes
    inside them."""
    tape = _Tape()
    selective = None
    if policy in _DOTS:
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        selective = create_selective_checkpoint_contexts(
            _policy_fn(_DOTS[policy]))

    @contextlib.contextmanager
    def both(mode: str, i: int):
        with _frame(mode, tape):
            if selective is None:
                yield
            else:
                with selective[i]:
                    yield

    return both("record", 0), both("replay", 1)


def check_policy(policy: str) -> None:
    if policy not in REMAT_POLICIES:
        raise ValueError(
            f"remat policy {policy!r}; valid: {list(REMAT_POLICIES)}")


def checkpoint(fn: Callable, *args, policy: str = "nothing_saveable"):
    """``fn(*args)``, its activations recomputed in backward under
    ``policy`` (see the module docstring). Without grad it simply runs."""
    check_policy(policy)
    if policy == "everything_saveable" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint as torch_checkpoint

    return torch_checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=lambda: _contexts(policy))


def checkpoint_module(module: torch.nn.Module, *args,
                      policy: str = "nothing_saveable"):
    """``module(*args)`` recomputed in backward, its parameters passed to
    the checkpoint as inputs: what the module holds at the call (the
    16-bit casts of the masters inside the engine's ``functional_call``)
    is what the recompute runs on, and the recompute's gradients reach
    them, and through the casts the fp32 masters."""
    named = list(module.named_parameters())
    names = [n for n, _ in named]
    tensors = [p for _, p in named]

    def body(*flat):
        n = len(names)
        return functional_call(module, dict(zip(names, flat[:n])),
                               flat[n:])

    return checkpoint(body, *tensors, *args, policy=policy)
