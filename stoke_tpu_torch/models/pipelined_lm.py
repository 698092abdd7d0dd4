"""A pipeline-parallel causal LM of the port, trained through ``Stoke``.

Counterpart of ``stoke_tpu/models/pipelined_lm.py``: token and position
embeddings (``embed.tok``, ``embed.pos``), the transformer blocks split
into V·S pipeline stages of ``layers_per_stage`` post-LN blocks each, and
the untied head ``head`` (``[hidden, vocab]``, no bias); no final
LayerNorm, as the JAX model has none (``:145-157``). A stage is the JAX
``_StageBlock`` (``:38-55``): the blocks of :mod:`.bert` with dense
attention under the additive causal bias ``where(tril, 0, -1e9)`` cast to
the activations' dtype, without dropout.

Parameter layout: the stage blocks' tensors are stacked on a leading
``[V·S]`` dim (``stages.block_<i>.<...>``, the JAX ``stages/block_<i>/...``
leaves), and ``stages`` is the template a stage applies by
``torch.func.functional_call`` on one slice. So a converter, a
consolidated tag, the optimizer state and the partition rule of
:func:`pipeline_parallel_rules` each see one tensor a JAX leaf.

Under a ``("data", "stage")`` mesh (or a ``("stage",)`` one) with
:func:`pipeline_parallel_rules`, ``Stoke`` cuts each stacked tensor to
this rank's ``stages[d::S]`` and gives the model its stage ``group``
(:func:`~stoke_tpu_torch.parallel.tensor.shard_module`); the forward then
runs :func:`~stoke_tpu_torch.parallel.pipeline.local_pipeline` over the
group. Every rank of a stage group takes the same rows. Where S divides
M, rank ``d`` applies the head to its emitted rows and the logits are
gathered over the group (:func:`~stoke_tpu_torch.parallel.tensor
.gather_from_group`), the head's gradient summed over it
(``copy_to_group``); otherwise every rank applies the head to all rows.
Either way every rank returns the whole batch's logits, and the embedding
and the head end each backward with the same gradient on every rank.
Without a group the stack runs as one stage of all its slices in turn.

Beside a model axis (``("data", "stage", "model")``) a rule that also
places a stacked leaf on ``model`` (or ``expert``) cuts it in a second
level inside the stage cut; the step engine gathers that level over its
group before each forward (the JAX pipeline's ``shard_map`` names only
the stage axis in its ``in_specs``, ``stoke_tpu/parallel/pipeline.py:
213-241``, so GSPMD all-gathers the other axes at the boundary), and the
stage applications run on the stage slices whole.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from stoke_tpu_torch.models.bert import (
    BERT_SIZES,
    BertSize,
    TransformerBlock,
    dense_attention,
)
from stoke_tpu_torch.parallel.pipeline import local_pipeline
from stoke_tpu_torch.parallel.tensor import (
    ModelGroup,
    copy_to_group,
    gather_from_group,
)


def pipeline_parallel_rules(stage_axis: str = "stage") -> Tuple:
    """The partition rule placing the stage-stacked parameters on the
    stage axis (for ``PartitionRulesConfig``): every leaf under
    ``stages/`` gets its leading dim on the axis, the rest replicated."""
    return ((r"^stages/", (stage_axis, "...")),)


class _StageBlock(nn.Module):
    """One pipeline stage: ``layers_per_stage`` causal transformer blocks
    (``block_<i>``), without dropout."""

    def __init__(self, size: BertSize, layers_per_stage: int, device=None):
        super().__init__()
        self.layers_per_stage = layers_per_stage
        for i in range(layers_per_stage):
            self.add_module(f"block_{i}", TransformerBlock(
                size.hidden, size.heads, size.ff, 0.0, dense_attention,
                device=device))

    def forward(self, x, bias):
        for i in range(self.layers_per_stage):
            x = getattr(self, f"block_{i}")(x, bias)
        return x


class _Embed(nn.Module):
    """The JAX ``embed`` tree: ``tok`` ``[vocab, hidden]`` and ``pos``
    ``[max_len, hidden]``."""

    def __init__(self, vocab_size: int, max_len: int, hidden: int,
                 device=None):
        super().__init__()
        self.tok = nn.Parameter(torch.empty(vocab_size, hidden,
                                            device=device))
        self.pos = nn.Parameter(torch.empty(max_len, hidden, device=device))


class PipelinedLM(nn.Module):
    """Decoder-only LM with pipeline-parallel blocks.

    Args:
        vocab_size / size_name / max_len: as the JAX package's.
        num_microbatches: M, the microbatches a batch splits into (the
            batch must divide).
        layers_per_stage: blocks a stage (default ``max(1, layers //
            (V·S))``, the JAX default).
        stage_axis: the mesh axis the stages go on.
        rounds: V, stages a process holds (the circular schedule).
        remat: recompute each tick's stage application in backward.
        stages: S, the stage axis's size (the JAX package reads it from
            its mesh); the stack holds V·S stages.
        device: where the parameters are created (and seeded with 0 by
            :meth:`init_weights`).
    """

    def __init__(self, vocab_size: int = 50257, size_name: str = "tiny",
                 max_len: int = 256, num_microbatches: int = 2,
                 layers_per_stage: Optional[int] = None,
                 stage_axis: str = "stage", rounds: int = 1,
                 remat: bool = False, stages: int = 1, device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.size = BERT_SIZES[size_name]
        self.max_len = max_len
        self.num_microbatches = num_microbatches
        self.stage_axis = stage_axis
        self.rounds = int(rounds)
        self.remat = bool(remat)
        self.num_stages = int(stages) * self.rounds
        if layers_per_stage is None:
            layers_per_stage = max(1, self.size.num_layers // self.num_stages)
        self.layers_per_stage = layers_per_stage
        H = self.size.hidden
        self.embed = _Embed(vocab_size, max_len, H, device=device)
        self.stages = _StageBlock(self.size, layers_per_stage, device=device)
        self._stage_names = [n for n, _ in self.stages.named_parameters()]
        for name in self._stage_names:
            owner, _, attr = name.rpartition(".")
            mod = self.stages.get_submodule(owner)
            shape = getattr(mod, attr).shape
            setattr(mod, attr, nn.Parameter(torch.empty(
                (self.num_stages, *shape), device=device)))
        self.head = nn.Parameter(torch.empty(H, vocab_size, device=device))
        #: the stage group of a pipeline cut (None: the whole stack here)
        self.group: Optional[ModelGroup] = None
        self.init_weights(0)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Seeded init: the embeddings and the head from N(0, 0.02²), as
        the JAX ``init``; each stage's weight matrices from N(0, 1/fan_in),
        biases 0, LayerNorm scale 1 and shift 0 (flax's scales), drawn by
        a generator on the parameters' device."""
        gen = torch.Generator(device=self.head.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if not name.startswith("stages."):
                p.normal_(0.0, 0.02, generator=gen)
            elif ".ln_" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=gen)

    def sync_widths(self) -> None:
        """Nothing to sync: the forward reads the stage count from the
        stack it holds (after a cut, or made whole again)."""

    def _stage_params(self) -> dict:
        """The stacked tensors by their name in ``stages`` (under the
        engine's ``functional_call``, its casts)."""
        return {n: functools.reduce(getattr, n.split("."), self.stages)
                for n in self._stage_names}

    def forward(self, input_ids):
        """``input_ids [B, L]`` -> logits ``[B, L, vocab]``."""
        B, L = input_ids.shape
        M = self.num_microbatches
        if B % M != 0:
            raise ValueError(
                f"PipelinedLM: batch {B} not divisible by "
                f"num_microbatches={M}")
        if L > self.max_len:
            raise ValueError(
                f"PipelinedLM: sequence length {L} exceeds "
                f"max_len={self.max_len}")
        h = F.embedding(input_ids, self.embed.tok) + self.embed.pos[:L][None]
        causal = torch.tril(torch.ones(L, L, dtype=torch.bool,
                                       device=h.device))
        # built in fp32 and cast, as the JAX stage builds it
        bias = torch.where(causal, 0.0, -1e9)[None, None].to(h.dtype)
        stacked = self._stage_params()
        g = self.group if self.group is not None and self.group.size > 1 \
            else None
        run = local_pipeline(
            lambda p, x: functional_call(self.stages, p, (x, bias)), g,
            rounds=next(iter(stacked.values())).shape[0], remat=self.remat)
        h = run(stacked, h.reshape(M, B // M, L, -1))
        rows = g is not None and M % g.size == 0
        head = copy_to_group(self.head, g) if rows else self.head
        logits = h.reshape(-1, L, h.shape[-1]) @ head
        return gather_from_group(logits, g) if rows else logits
