"""Mixture-of-Experts FFN of the port, and expert parallelism.

Counterpart of ``stoke_tpu/models/moe.py``: :class:`MoEFFN` (switch
routing, top-1 or top-2, a capacity per expert, the load-balancing
auxiliary loss), :class:`MoETransformerBlock` and
:func:`moe_expert_parallel_rules`, with the JAX package's names, defaults
and messages:

- routing within groups of S = L tokens (one example a group); capacity
  ``C = max(1, int(ceil(k * S / E) * capacity_factor))`` (``:76``);
- the router's fp32 softmax, top-k, gates renormalised over the k choices
  when k > 1 (``:86-91``);
- ``aux = E * sum_e f_e * P_e``: ``f_e`` the share of tokens whose first
  choice is e, ``P_e`` the mean router probability (``:93-106``);
- choice-major priority: every first choice claims its expert's queue
  before any second choice (``:108-117``); a choice past the capacity is
  dropped (its gate 0);
- experts ``gelu(x @ w_in[e]) @ w_out[e]``, the gelu the tanh
  approximation (flax ``nn.gelu``).

The JAX package dispatches and combines with one-hot einsums over
``[G, S, E, C]``; the port gathers instead, which gives the same numbers:
each kept (token, choice) has one slot ``(e, g, position)`` of the
``[E, G, C]`` expert inputs, empty slots read a zero row, and the output
of a token is the gate-weighted sum of its slots' outputs. Both gathers
are ``index_select``, whose backward adds each row once into its source
(a token's row takes at most k, in either order the same sum); indexing
by a tensor would back-propagate through a sorting kernel that
serialises the many empty or dropped slots sharing one pad row. Every
shape is static and nothing syncs with the host, so the forward runs
inside a captured CUDA graph.

The auxiliary loss is transient: the forward keeps it as the plain
attribute ``aux_loss`` (never a buffer, so it is in no ``state_dict`` and
no checkpoint); :class:`~stoke_tpu_torch.Stoke` adds
``aux_loss_weight * sum(aux)`` to the objective (the JAX engine's
``"losses"`` collection). Under a data axis of more than one the two
``[E]`` vectors are averaged over the data group (``data_group``) before
their product, as the JAX package's are means over the global batch; the
``P_e`` average passes its gradient unchanged, so the ladder's average of
the gradients is the global one. Router noise (``router_noise`` > 0, in
training) draws from ``generator``, which ``Stoke`` sets to its own; a
rematerialized block's recompute takes the forward's noise back
(:func:`stoke_tpu_torch.remat.draw`).

Expert parallelism: under :func:`moe_expert_parallel_rules` on a
``("data", "expert")`` mesh,
:func:`~stoke_tpu_torch.parallel.tensor.apply_partition_rules` leaves each
rank ``E / X`` experts (``group``); every rank routes all of its rows
(the router is replicated), computes its experts' slots (from a branch of
the input through :func:`~stoke_tpu_torch.parallel.tensor.copy_to_group`,
which sums the experts' parts of its gradient over the group) and
gathers every rank's outputs (:func:`~stoke_tpu_torch.parallel.tensor
.gather_from_group`), so that it combines over all E experts and the
router's gradient is the same on every rank.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stoke_tpu_torch import remat as _remat
from stoke_tpu_torch.models.bert import (
    Dropout,
    MultiHeadAttention,
    dense_attention,
)
from stoke_tpu_torch.parallel.tensor import (
    copy_to_group,
    gather_from_group,
    mean_over_group,
)


class MoEFFN(nn.Module):
    """Switch-routed expert FFN (a drop-in for a dense FFN) on ``[G, S,
    H]``.

    Args:
        hidden / ff / num_experts / capacity_factor / router_noise /
            top_k: as the JAX package's ``MoEFFN``.
        device: where the parameters are created.

    Parameters: ``router`` (a ``Linear`` without bias, the flax
    ``router/kernel`` transposed), ``w_in`` ``[E, hidden, ff]`` and
    ``w_out`` ``[E, ff, hidden]`` in the JAX layout."""

    def __init__(self, hidden: int, ff: int, num_experts: int = 8,
                 capacity_factor: float = 1.25, router_noise: float = 0.0,
                 top_k: int = 1, device=None):
        super().__init__()
        self.hidden, self.ff = hidden, ff
        self.num_experts = num_experts
        self.capacity_factor = float(capacity_factor)
        self.router_noise = float(router_noise)
        self.top_k = top_k
        self.router = nn.Linear(hidden, num_experts, bias=False,
                                device=device)
        self.w_in = nn.Parameter(torch.empty(num_experts, hidden, ff,
                                             device=device))
        self.w_out = nn.Parameter(torch.empty(num_experts, ff, hidden,
                                              device=device))
        with torch.no_grad():
            self.w_in.normal_(0.0, (num_experts * hidden) ** -0.5)
            self.w_out.normal_(0.0, (num_experts * ff) ** -0.5)
        #: the router noise's generator (None: torch's default)
        self.generator = None
        #: the last forward's load-balancing loss (transient)
        self.aux_loss: Optional[torch.Tensor] = None
        #: the data group the two aux vectors are averaged over (None:
        #: this process's rows are the batch)
        self.data_group = None
        #: the expert group of expert parallelism (None: every expert)
        self.group = None
        self.local_experts = num_experts

    def sync_widths(self) -> None:
        """This rank's expert count, from the parameters."""
        self.local_experts = self.w_in.shape[0]

    def capacity(self, S: int) -> int:
        """Slots per expert and group for groups of ``S`` tokens."""
        k, E = self.top_k, self.num_experts
        return max(1, int(math.ceil(k * S / E) * self.capacity_factor))

    def route(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(slot, gates)`` of each (token, choice), ``[G, S, k]``: the
        flat index of its slot in the ``[E, G, C]`` expert inputs (``E * G
        * C`` for a dropped choice) and its gate (0 for a dropped choice),
        in fp32. Sets :attr:`aux_loss`."""
        G, S, _ = x.shape
        E, k = self.num_experts, self.top_k
        if not 1 <= k <= E:
            raise ValueError(f"MoEFFN: top_k must be in [1, {E}], got {k}")
        C = self.capacity(S)
        logits = self.router(x)
        if self.router_noise > 0.0 and self.training:
            noise = _remat.draw(lambda: torch.randn(
                logits.shape, device=logits.device, dtype=logits.dtype,
                generator=self.generator))
            logits = logits + self.router_noise * noise
        probs = torch.softmax(logits.float(), dim=-1)
        top_p, top_i = torch.topk(probs, k, dim=-1)
        gates = (top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
                 if k > 1 else top_p)
        f_e = F.one_hot(top_i[..., 0], E).float().mean((0, 1))
        p_e = probs.mean((0, 1))
        if self.data_group is not None:
            f_e = mean_over_group(f_e, self.data_group)
            p_e = mean_over_group(p_e, self.data_group)
        aux = float(E) * (f_e * p_e).sum()
        if not _remat.replaying():
            # the recompute of a rematerialized block (which must save
            # what its forward saved) keeps the forward's value
            self.aux_loss = aux
        # queue positions, choice-major: all first choices, then seconds
        assign = F.one_hot(top_i, E).float()                 # [G, S, k, E]
        prio = assign.transpose(1, 2).reshape(G, k * S, E)
        position = (torch.cumsum(prio, dim=1) - 1.0) * prio
        pos = position.sum(-1).reshape(G, k, S).transpose(1, 2)  # [G, S, k]
        keep = pos < C
        group = torch.arange(G, device=x.device).view(G, 1, 1)
        slot = (top_i * G + group) * C + pos.long()
        slot = torch.where(keep, slot, torch.full_like(slot, E * G * C))
        return slot, gates * keep

    def dispatch(self, x, slot) -> torch.Tensor:
        """The experts' inputs ``[E, G, C, H]``: each slot the row of the
        token that holds it, an empty slot zeros."""
        G, S, H = x.shape
        E, C = self.num_experts, self.capacity(S)
        token = torch.arange(G * S, device=x.device).view(G, S, 1)
        fill = torch.full((E * G * C + 1,), G * S, dtype=torch.long,
                          device=x.device)
        fill.scatter_(0, slot.reshape(-1),
                      token.expand_as(slot).reshape(-1))
        rows = torch.cat([x.reshape(G * S, H), x.new_zeros(1, H)])
        return rows.index_select(0, fill[:E * G * C]).view(E, G, C, H)

    def experts(self, expert_in) -> torch.Tensor:
        """``gelu(x @ w_in[e]) @ w_out[e]`` of each slot of this rank's
        experts: ``[E_local, G, C, H]`` in and out."""
        El, G, C, H = expert_in.shape
        h = torch.bmm(expert_in.reshape(El, G * C, H), self.w_in)
        h = F.gelu(h, approximate="tanh")
        return torch.bmm(h, self.w_out).view(El, G, C, H)

    @staticmethod
    def combine(expert_out, slot, gates) -> torch.Tensor:
        """Each token's gate-weighted sum of its slots' outputs (all E
        experts' ``[E, G, C, H]``): ``[G, S, H]``."""
        H = expert_out.shape[-1]
        rows = torch.cat([expert_out.reshape(-1, H),
                          expert_out.new_zeros(1, H)])
        picked = rows.index_select(0, slot.reshape(-1)).view(
            *slot.shape, H)                                   # [G, S, k, H]
        return (gates.to(picked.dtype).unsqueeze(-1) * picked).sum(2)

    def forward(self, x):
        slot, gates = self.route(x)
        if self.group is None:
            return self.combine(self.experts(self.dispatch(x, slot)), slot,
                                gates)
        # the experts' branch of x, whose gradient (this rank's experts'
        # part) is summed over the group; the router's branch is whole
        lo = self.group.rank * self.local_experts
        mine = self.dispatch(copy_to_group(x, self.group), slot)[
            lo:lo + self.local_experts]
        out = gather_from_group(self.experts(mine), self.group)
        return self.combine(out, slot, gates)


def moe_expert_parallel_rules(expert_axis: str = "expert") -> Tuple:
    """Partition rules sharding the stacked expert weights over the mesh
    ``expert_axis`` (for ``PartitionRulesConfig``; the JAX package's); the
    router stays replicated."""
    return (
        (r"w_in$", (expert_axis, None, None)),
        (r"w_out$", (expert_axis, None, None)),
    )


class MoETransformerBlock(nn.Module):
    """Post-LN transformer block whose FFN is a switch MoE (``moe``),
    attention as :class:`~stoke_tpu_torch.models.bert.TransformerBlock`'s;
    the JAX ``MoETransformerBlock``."""

    def __init__(self, hidden: int, heads: int, ff: int,
                 num_experts: int = 8, dropout_rate: float = 0.1,
                 capacity_factor: float = 1.25,
                 attention_fn: Optional[Callable] = None,
                 router_noise: float = 0.0, top_k: int = 1, device=None):
        super().__init__()
        self.attention = MultiHeadAttention(
            hidden, heads, dropout_rate, attention_fn or dense_attention,
            device=device)
        self.drop_attn = Dropout(dropout_rate)
        self.ln_attn = nn.LayerNorm(hidden, eps=1e-12, device=device)
        self.moe = MoEFFN(hidden, ff, num_experts, capacity_factor,
                          router_noise, top_k, device=device)
        self.drop_ff = Dropout(dropout_rate)
        self.ln_ff = nn.LayerNorm(hidden, eps=1e-12, device=device)

    def forward(self, x, bias, attention_fn: Optional[Callable] = None):
        y = self.drop_attn(self.attention(x, bias, attention_fn))
        x = self.ln_attn(x + y)
        return self.ln_ff(x + self.drop_ff(self.moe(x)))
