"""Sampling beyond greedy: temperature / top-k / top-p with per-request
seeded key streams.

Counterpart of ``stoke_tpu/serving/sampling.py``. The JAX sampler's
randomness is a fixed function of the key data, so this module ports that
function and gives the JAX engine's draws bit for bit:

- **Threefry-2x32** and the partitionable ``split`` and ``random_bits``
  of :mod:`stoke_tpu_torch.utils.prng` (host numpy ``uint32`` key data, or
  int64 tensors on the device), re-exported here;
- ``gumbel`` through ``uniform(minval=finfo(float32).tiny, maxval=1)``:
  the top 23 bits become a float in [1, 2), minus 1, then
  ``-log(-log(u))``.

Per-request knobs travel as ``[B]`` tensors (temperature 0 = the exact
raw argmax, top-k 0 = off, top-p 1.0 = off), and each request's key
advances one split per emitted token, so a request's draws depend only on
its own seed and token index, never on who else rode the batch. Splits
touch a few words per slot, so the engine runs them on the host (a chain
of S splits on the device would be S x 170 tiny kernel launches); the
Gumbel noise, ``[..., V]`` words per draw, is drawn on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# the threefry primitives live in utils/prng.py, shared with the gradient
# transports; the sampler's names stay importable from here
from stoke_tpu_torch.utils.prng import (  # noqa: F401
    initial_key_data,
    key_data_to_device,
    random_bits,
    split_chain,
    split_key_data,
    threefry2x32,
)

_NEG_INF = -1e30
#: float32 ``finfo.tiny``: ``gumbel``'s uniform lower bound
_TINY = float(np.finfo(np.float32).tiny)

#: wire encoding of "knob disabled" in the per-slot tensors
TOP_K_OFF = 0
TOP_P_OFF = 1.0


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (validated at ``submit()``).

    Attributes:
        temperature: softmax temperature; ``0.0`` is exact greedy (the raw
            argmax, not a limit).
        top_k: keep the k highest logits before drawing (``None`` = off).
        top_p: nucleus sampling, the smallest prefix of the sorted
            distribution whose mass reaches ``top_p`` (``None`` = off; the
            most probable token is always kept).
        seed: seed of this request's key stream (``None``: the scheduler
            uses ``ServeConfig.sampling_seed`` + the request id).
    """

    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: Optional[int] = None

    @property
    def is_greedy(self) -> bool:
        """True when the draw is the raw argmax (temperature 0)."""
        return self.temperature == 0.0

    def as_arrays(self) -> Tuple[float, int, float]:
        """The ``(temperature, top_k, top_p)`` wire triple (disabled knobs
        as ``TOP_K_OFF`` / ``TOP_P_OFF``)."""
        return (
            float(self.temperature),
            TOP_K_OFF if self.top_k is None else int(self.top_k),
            TOP_P_OFF if self.top_p is None else float(self.top_p),
        )


def validate_sampling_params(p: SamplingParams) -> None:
    """Reject impossible knobs at submit time, not mid-decode."""
    if p.temperature < 0.0:
        raise ValueError(
            f"SamplingParams.temperature must be >= 0, got {p.temperature}"
        )
    if p.top_k is not None and p.top_k < 1:
        raise ValueError(
            f"SamplingParams.top_k must be >= 1 when set, got {p.top_k}"
        )
    if p.top_p is not None and not (0.0 < p.top_p <= 1.0):
        raise ValueError(
            f"SamplingParams.top_p must be in (0, 1] when set, got {p.top_p}"
        )


# --------------------------------------------------------------------------- #
# gumbel noise over the shared threefry primitives (utils/prng.py)
# --------------------------------------------------------------------------- #


def gumbel(key_data, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` (the "low" mode) for every
    key of ``key_data [..., 2]``: ``[..., n]`` float32."""
    float_bits = (random_bits(key_data, n) >> 9) | 0x3F800000
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(floats * (1.0 - _TINY) + _TINY, _TINY)
    return -torch.log(-torch.log(u))


# --------------------------------------------------------------------------- #
# the draws
# --------------------------------------------------------------------------- #


def sample_tokens(logits, keys, temperature, top_k, top_p):
    """Temperature / top-k / top-p sampling, batched over any leading
    shape.

    Args:
        logits: ``[..., V]`` pre-sampling logits.
        keys: ``[..., 2]`` sub key data (one fresh split per draw, see
            :func:`split_key_data`).
        temperature: ``[...]`` float; 0 selects the exact raw argmax.
        top_k: ``[...]`` int; ``TOP_K_OFF`` (0) disables.
        top_p: ``[...]`` float; ``TOP_P_OFF`` (1.0) disables.

    Returns ``[...]`` int64 token ids. Top-k and top-p sort the scaled
    logits once and threshold by logit: the nucleus boundary maps back
    through the sorted logit, so the comparison is exact (a
    probability-space comparison against a separately summed softmax can
    drop the boundary token on rounding)."""
    logits = logits.float()
    V = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    temperature = temperature.float()
    t = torch.clamp_min(temperature, 1e-6)[..., None]
    scaled = logits / t
    k_eff = torch.where(top_k > 0, torch.clamp(top_k, 1, V),
                        torch.full_like(top_k, V)).long()[..., None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, k_eff - 1)
    masked = torch.where(scaled >= kth, scaled,
                         torch.full_like(scaled, _NEG_INF))
    rank = torch.arange(V, device=logits.device)
    pdesc = torch.softmax(
        torch.where(rank < k_eff, desc, torch.full_like(desc, _NEG_INF)),
        dim=-1,
    )
    csum = torch.cumsum(pdesc, dim=-1)
    p_lim = torch.clamp(top_p.float(), 0.0, 1.0)[..., None]
    keep_n = torch.clamp_min(((csum - pdesc) < p_lim).sum(-1, keepdim=True),
                             1)
    thr = torch.gather(desc, -1, keep_n - 1)
    final = torch.where(masked >= thr, masked,
                        torch.full_like(masked, _NEG_INF))
    g = gumbel(keys, V)
    sampled = torch.where(final > _NEG_INF * 0.5, final + g,
                          torch.full_like(final, _NEG_INF)).argmax(dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


def draw_targets(logits, subs, temperature, top_k, top_p):
    """The S draws of a verify step from their sub keys, as one batched
    pass over ``[S, B, V]``: ``logits [B, S, V]``, ``subs [S, B, 2]``
    (device), knobs ``[B]`` shared by a request's S draws. Returns
    ``[B, S]`` int64 tokens."""
    S = logits.shape[1]
    knobs = [t[None].expand(S, *t.shape) for t in (temperature, top_k, top_p)]
    return sample_tokens(logits.transpose(0, 1), subs, *knobs).transpose(0, 1)


def speculative_sample_tokens(logits, key_data, temperature, top_k, top_p):
    """The S sequential target draws of a verify dispatch.

    Position s draws with the sub key of the (s+1)-th split of the slot's
    key stream, the key the plain decode loop would use for that token.
    The S splits run in order (:func:`split_chain`); the S draws then run
    as one batched pass (:func:`draw_targets`).

    Args:
        logits: ``[B, S, V]`` verify logits (position s predicts the token
            after query s).
        key_data: ``[B, 2]`` per-slot key state before the draws: an int64
            tensor, or host uint32 data (then the splits run on the host
            and the sub keys are copied to the logits' device).
        temperature / top_k / top_p: ``[B]`` knobs, shared by the S draws
            of a request.

    Returns ``(targets [B, S] int64, key_stack [S, B, 2])``:
    ``key_stack[i]`` is the key state after ``i + 1`` splits, in
    ``key_data``'s type."""
    key_stack, subs = split_chain(key_data, logits.shape[1])
    if isinstance(subs, np.ndarray):
        subs = key_data_to_device(subs, logits.device)
    return draw_targets(logits, subs, temperature, top_k, top_p), key_stack


def accept_drafts(drafts, draft_lens, targets):
    """Leading-exact-match acceptance: draft ``drafts[b, i]`` is accepted
    iff it equals ``targets[b, i]``, ``i < draft_lens[b]`` and every
    earlier draft was accepted.

    Args:
        drafts: ``[B, K]`` proposed tokens (anything past ``draft_lens``).
        draft_lens: ``[B]`` valid drafts per slot.
        targets: ``[B, S]`` with S >= K+1, the true sequential draws.

    Returns ``n_emit [B]`` int64 in ``1..K+1``: the accepted run plus the
    correction (or bonus) token ``targets[b, n_emit - 1]``."""
    K = drafts.shape[1]
    i = torch.arange(K, device=drafts.device)
    ok = (drafts.long() == targets[:, :K].long()) & (
        i[None, :] < draft_lens.long()[:, None]
    )
    return torch.cumprod(ok.long(), dim=-1).sum(-1) + 1


def select_key_data(key_stack, n_emit):
    """The key state after ``n_emit[b]`` splits of each slot: ``key_stack
    [S, B, 2]`` indexed at ``n_emit - 1``, ``[B, 2]`` (host arrays or
    device tensors, both arguments alike)."""
    B = key_stack.shape[1]
    if isinstance(key_stack, np.ndarray):
        return key_stack[np.asarray(n_emit, np.int64) - 1, np.arange(B)]
    return key_stack[n_emit.long() - 1,
                     torch.arange(B, device=key_stack.device)]
