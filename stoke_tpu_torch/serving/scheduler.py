"""Continuous-batching scheduler: mid-flight admission into fixed slots.

Counterpart of ``stoke_tpu/serving/scheduler.py:46-534``, greedy path:
requests admit the moment a slot and their worst-case KV-block budget are
free, finished requests evict at once and their blocks refill the pool.
All host-side bookkeeping; the device never sees the queue.

Slot invariants the decode step relies on:

- every slot always has a block-table row (inactive rows are all
  ``SCRATCH_BLOCK``) and a token/position/context entry, so decode runs
  the full ``max_seqs`` batch every step;
- a live slot's blocks are disjoint from every other slot's, so in-batch
  page writes never collide;
- admission reserves ``ceil((prompt_len + max_new_tokens) / block_size)``
  blocks up front, so a decode step can never fail on an empty pool.

Prompts are zero-padded to a multiple of ``pad_multiple`` with numpy,
which gives what the JAX package's ``NativeBatcher.gather_pad`` gives for
one prompt; the native batcher is ported with ``data.py``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from stoke_tpu_torch.serving.kv_cache import SCRATCH_BLOCK, BlockAllocator


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs. This slice serves greedy decoding only
    (temperature 0: the argmax of the logits); sampling is a later slice."""

    temperature: float = 0.0

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


@dataclass
class Request:
    """One inference request and its lifecycle timestamps.

    ``tokens`` accumulates the generated ids (the first comes from
    prefill: its wall time is the TTFT); ``first_token_ts - arrival_ts``
    and the per-token deltas after it feed the TTFT/TPOT histograms."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    params: SamplingParams = field(default_factory=SamplingParams)
    arrival_ts: float = field(default_factory=time.perf_counter)
    first_token_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    tokens: List[int] = field(default_factory=list)

    @property
    def finished(self) -> bool:
        return self.finish_ts is not None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.arrival_ts

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token over the decode tokens (the prefill
        token is the TTFT's)."""
        if self.finish_ts is None or len(self.tokens) < 2:
            return None
        return (self.finish_ts - self.first_token_ts) / (len(self.tokens) - 1)


@dataclass
class _Slot:
    request: Optional[Request] = None
    blocks: List[int] = field(default_factory=list)
    context_len: int = 0       # cached tokens (prompt + committed decode)
    next_token: int = 0        # token the next decode step feeds


def pad_prompt(prompt: np.ndarray, pad_multiple: int) -> np.ndarray:
    """``[1, P]`` int32, the prompt zero-padded to a multiple of
    ``pad_multiple``."""
    P = -(-prompt.size // pad_multiple) * pad_multiple
    out = np.zeros((1, P), np.int32)
    out[0, : prompt.size] = prompt
    return out


class Scheduler:
    """Continuous-batching request scheduler over a block allocator."""

    def __init__(
        self,
        max_seqs: int,
        allocator: BlockAllocator,
        max_blocks_per_seq: int,
        *,
        max_seq_len: int,
        default_max_new_tokens: int,
        eos_id: Optional[int] = None,
        pad_multiple: int = 64,
    ):
        self.max_seqs = int(max_seqs)
        self.allocator = allocator
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.max_seq_len = int(max_seq_len)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.eos_id = eos_id
        self.pad_multiple = int(pad_multiple)
        self.queue: Deque[Request] = deque()
        self.slots: List[_Slot] = [_Slot() for _ in range(max_seqs)]
        self.block_tables = np.full(
            (max_seqs, max_blocks_per_seq), SCRATCH_BLOCK, np.int32
        )
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0

    # ----------------------------- intake ------------------------------ #

    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None,
               params: Optional[SamplingParams] = None) -> int:
        """Enqueue one request; returns its id. A request whose worst case
        cannot fit ``max_seq_len`` is rejected here, not mid-decode."""
        prompt = np.ascontiguousarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        cap = (
            self.default_max_new_tokens
            if max_new_tokens is None
            else int(max_new_tokens)
        )
        if cap < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {cap}")
        if prompt.size + cap > self.max_seq_len:
            raise ValueError(
                f"request needs {prompt.size} prompt + {cap} output tokens "
                f"> max_seq_len={self.max_seq_len}"
            )
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(
            Request(
                rid=rid,
                prompt=prompt,
                max_new_tokens=cap,
                eos_id=self.eos_id if eos_id is None else eos_id,
                params=params if params is not None else SamplingParams(),
            )
        )
        return rid

    # ---------------------------- admission ---------------------------- #

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s.request is not None)

    @property
    def queued(self) -> int:
        return len(self.queue)

    @property
    def has_work(self) -> bool:
        return self.active > 0 or self.queued > 0

    @property
    def batch_fill(self) -> float:
        return self.active / max(self.max_seqs, 1)

    def admit(self) -> List[Tuple[int, Request, np.ndarray, int]]:
        """Admit queued requests (FIFO) while a slot and their block budget
        are free. Returns ``[(slot, request, padded_prompt [1, P],
        prompt_len), ...]`` for the engine to prefill."""
        admitted = []
        for i, slot in enumerate(self.slots):
            if not self.queue:
                break
            if slot.request is not None:
                continue
            req = self.queue[0]
            need = self.allocator.blocks_for(
                req.prompt.size + req.max_new_tokens
            )
            blocks = self.allocator.alloc(need)
            if blocks is None:
                # head-of-line blocking by design: admitting a smaller
                # later request over the head would starve long prompts
                break
            self.queue.popleft()
            slot.request = req
            slot.blocks = blocks
            slot.context_len = int(req.prompt.size)
            self.block_tables[i, :] = SCRATCH_BLOCK
            self.block_tables[i, : len(blocks)] = blocks
            admitted.append(
                (i, req, pad_prompt(req.prompt, self.pad_multiple),
                 int(req.prompt.size))
            )
        return admitted

    # --------------------------- decode state -------------------------- #

    def decode_batch(self):
        """Fixed-shape decode inputs: ``(tokens [B], positions [B],
        block_tables [B, MB], context_lens [B])``. Inactive slots feed
        token 0 at position 0 with context 1 against an all-scratch
        table."""
        B = self.max_seqs
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        context = np.ones(B, np.int32)  # inactive: attend self-only
        for i, s in enumerate(self.slots):
            if s.request is None:
                continue
            tokens[i] = s.next_token
            positions[i] = s.context_len
            context[i] = s.context_len + 1
        return tokens, positions, self.block_tables.copy(), context

    # --------------------------- commit/evict --------------------------- #

    def note_prefill_token(self, slot: int, token: int, now: float) -> None:
        """Record the prefill-produced first token (the TTFT point) and arm
        the slot for decode (or finish at once at cap 1 or eos)."""
        s = self.slots[slot]
        req = s.request
        req.first_token_ts = now
        req.tokens.append(int(token))
        s.next_token = int(token)
        if self._done(req):
            self._finish(slot, now)

    def commit_decode(self, next_tokens: np.ndarray, now: float) -> int:
        """Fold one decode step's outputs into the slots; evict finished
        requests (blocks freed back to the pool). Returns the number of
        live tokens committed (inactive-slot outputs are discarded)."""
        live = 0
        for i, s in enumerate(self.slots):
            if s.request is None:
                continue
            tok = int(next_tokens[i])
            s.context_len += 1  # the token just fed is now cached
            s.request.tokens.append(tok)
            s.next_token = tok
            live += 1
            if self._done(s.request):
                self._finish(i, now)
        return live

    def _done(self, req: Request) -> bool:
        if len(req.tokens) >= req.max_new_tokens:
            return True
        return req.eos_id is not None and req.tokens[-1] == req.eos_id

    def _finish(self, slot: int, now: float) -> None:
        s = self.slots[slot]
        s.request.finish_ts = now
        self.finished[s.request.rid] = s.request
        self.allocator.free(s.blocks)
        self.slots[slot] = _Slot()
        self.block_tables[slot, :] = SCRATCH_BLOCK
