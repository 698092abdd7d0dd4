"""Continuous-batching scheduler: mid-flight admission into fixed slots.

Counterpart of ``stoke_tpu/serving/scheduler.py:46-534``: requests admit
the moment a slot and their worst-case KV-block budget are free, finished
requests evict at once and their blocks refill the pool. All host-side
bookkeeping; the device never sees the queue. Beside greedy decode it
feeds chunked prefill (one chunk, or every prefilling slot's chunk packed
into one batch), speculative verify batches with the prompt-lookup
drafter's proposals, and the per-slot sampling knobs.

Slot invariants the decode step relies on:

- every slot always has a block-table row (inactive rows are all
  ``SCRATCH_BLOCK``) and a token/position/context entry, so decode runs
  the full ``max_seqs`` batch every step;
- a live slot's blocks are disjoint from every other slot's, so in-batch
  page writes never collide;
- admission reserves ``ceil((prompt_len + max_new_tokens) / block_size)``
  blocks up front, so a decode step can never fail on an empty pool;
- a slot still chunk-prefilling occupies capacity but rides every decode
  and verify batch like an inactive slot (all-scratch table), so no
  decode write can clobber its half-written prompt.

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
from stoke_tpu_torch.serving.sampling import SamplingParams
from stoke_tpu_torch.serving.speculative import propose_draft


@dataclass
class Request:
    """One inference request and its lifecycle timestamps.

    ``tokens`` accumulates the generated ids (the first comes from
    prefill: its wall time is the TTFT); ``first_token_ts - arrival_ts``
    and the per-token deltas after it feed the TTFT/TPOT histograms.
    ``params`` and ``seed`` are the resolved sampling knobs and key-stream
    seed."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    params: SamplingParams = field(default_factory=SamplingParams)
    seed: int = 0
    arrival_ts: float = field(default_factory=time.perf_counter)
    admit_ts: Optional[float] = None
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
    # chunked prefill: prompt tokens already written to the cache; None
    # once prefill is complete (the slot decodes)
    prefill_pos: Optional[int] = None


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
        prefill_chunk_tokens: Optional[int] = None,
        sampling_seed_base: int = 0,
    ):
        self.max_seqs = int(max_seqs)
        self.allocator = allocator
        self.max_blocks_per_seq = int(max_blocks_per_seq)
        self.max_seq_len = int(max_seq_len)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.eos_id = eos_id
        self.pad_multiple = int(pad_multiple)
        self.prefill_chunk_tokens = (
            None if prefill_chunk_tokens is None else int(prefill_chunk_tokens)
        )
        self.sampling_seed_base = int(sampling_seed_base)
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
        cannot fit ``max_seq_len`` is rejected here, not mid-decode. The
        key-stream seed is resolved beside the id: an explicit
        ``params.seed`` wins, else ``sampling_seed_base + rid``."""
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
        params = params if params is not None else SamplingParams()
        seed = (
            params.seed
            if params.seed is not None
            else self.sampling_seed_base + rid
        )
        self.queue.append(
            Request(
                rid=rid,
                prompt=prompt,
                max_new_tokens=cap,
                eos_id=self.eos_id if eos_id is None else eos_id,
                params=params,
                seed=int(seed),
            )
        )
        return rid

    # ---------------------------- admission ---------------------------- #

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s.request is not None)

    @property
    def decoding(self) -> int:
        """Slots with a fully prefilled request: the live decode batch."""
        return sum(
            1
            for s in self.slots
            if s.request is not None and s.prefill_pos is None
        )

    @property
    def has_prefilling(self) -> bool:
        return any(s.prefill_pos is not None for s in self.slots)

    @property
    def queued(self) -> int:
        return len(self.queue)

    @property
    def has_work(self) -> bool:
        return self.active > 0 or self.queued > 0

    @property
    def batch_fill(self) -> float:
        return self.active / max(self.max_seqs, 1)

    def admit(self) -> List[Tuple[int, Request, Optional[np.ndarray], int]]:
        """Admit queued requests (FIFO) while a slot and their block budget
        are free. Returns ``[(slot, request, padded_prompt [1, P],
        prompt_len), ...]`` for the engine to prefill. With
        ``prefill_chunk_tokens`` set, a longer prompt is admitted in the
        prefilling state instead (``padded_prompt`` None): the engine
        pulls its chunks over later iterations."""
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
            req.admit_ts = time.perf_counter()
            slot.request = req
            slot.blocks = blocks
            slot.context_len = int(req.prompt.size)
            self.block_tables[i, :] = SCRATCH_BLOCK
            self.block_tables[i, : len(blocks)] = blocks
            chunk = self.prefill_chunk_tokens
            if chunk is not None and req.prompt.size > chunk:
                slot.prefill_pos = 0
                admitted.append((i, req, None, int(req.prompt.size)))
                continue
            admitted.append(
                (i, req, pad_prompt(req.prompt, self.pad_multiple),
                 int(req.prompt.size))
            )
        return admitted

    # ------------------------- chunked prefill -------------------------- #

    def _chunk_rows(self, s: _Slot) -> Tuple[np.ndarray, np.ndarray, bool,
                                             int]:
        """The next chunk of prefilling slot ``s``: ``(tokens [C],
        positions [C], is_final, logit_idx)``. Tokens are zero-padded to
        the chunk length; positions are the global prompt positions,
        padding rows clamped to ``max_seq_len - 1`` (their writes go to
        scratch, their outputs are discarded); ``logit_idx`` is the
        in-chunk row of the last prompt token (meaningful when final)."""
        C = self.prefill_chunk_tokens
        req = s.request
        plen = int(req.prompt.size)
        start = s.prefill_pos
        toks = np.zeros(C, np.int32)
        n = min(C, plen - start)
        toks[:n] = req.prompt[start : start + n]
        positions = np.minimum(
            start + np.arange(C, dtype=np.int32), self.max_seq_len - 1
        )
        is_final = start + C >= plen
        logit_idx = plen - 1 - start if is_final else 0
        return toks, positions, is_final, logit_idx

    def next_chunk(self):
        """The next prompt chunk to prefill, or None. One chunk per engine
        iteration bounds each iteration's prefill work; the oldest-admitted
        prefilling request goes first. Returns ``(slot, request, tokens
        [C], positions [C], is_final, logit_idx)``."""
        prefilling = [
            (s.request.admit_ts, i, s)
            for i, s in enumerate(self.slots)
            if s.prefill_pos is not None
        ]
        if not prefilling:
            return None
        _, i, s = min(prefilling)
        return (i, s.request, *self._chunk_rows(s))

    def note_chunk(self, slot: int) -> None:
        """One chunk dispatched for ``slot``: advance its prefill cursor;
        the final chunk completes prefill."""
        s = self.slots[slot]
        s.prefill_pos += self.prefill_chunk_tokens
        if s.prefill_pos >= s.request.prompt.size:
            s.prefill_pos = None

    def next_chunks(self):
        """Every prefilling slot's next chunk packed into one ``[B, C]``
        batch (the verify batch's shape: per-row positions, idle and
        decoding rows on all-scratch tables with zero length, outputs
        discarded). Returns None when nothing is prefilling, else
        ``(tokens [B, C], positions [B, C], tables [B, MB], lengths [B],
        logit_idx [B], rows)``, ``rows`` the ``(slot, request, is_final)``
        of the serviced slots."""
        C = self.prefill_chunk_tokens
        B = self.max_seqs
        if not self.has_prefilling:
            return None
        tokens = np.zeros((B, C), np.int32)
        positions = np.tile(np.arange(C, dtype=np.int32), (B, 1))
        lengths = np.zeros(B, np.int32)
        logit_idx = np.zeros(B, np.int32)
        tables = self.block_tables.copy()
        rows = []
        for i, s in enumerate(self.slots):
            if s.prefill_pos is None:
                tables[i, :] = SCRATCH_BLOCK
                continue
            tokens[i], positions[i], is_final, logit_idx[i] = (
                self._chunk_rows(s)
            )
            lengths[i] = s.request.prompt.size
            rows.append((i, s.request, is_final))
        return tokens, positions, tables, lengths, logit_idx, rows

    # ------------------------ speculative decode ------------------------ #

    def verify_batch(self, k: int, *, ngram_max: int, ngram_min: int):
        """Fixed-shape speculative verify inputs: each decoding slot's
        pending token plus up to ``k`` drafts of the prompt-lookup drafter,
        as S = k+1 query rows.

        Drafts are cut to ``remaining - 1`` (the cap minus the pending
        token), so a fully accepted dispatch never overshoots the token
        budget or the admission-reserved blocks. Idle and prefilling rows
        ride along with zero write budget on all-scratch tables.

        Returns ``(tokens [B, S], positions [B, S], tables [B, MB],
        lengths [B], draft_lens [B])``: ``lengths`` is the write budget
        (context + draft + 1), ``draft_lens`` the valid drafts per slot."""
        B = self.max_seqs
        S = k + 1
        tokens = np.zeros((B, S), np.int32)
        positions = np.tile(np.arange(S, dtype=np.int32), (B, 1))
        lengths = np.zeros(B, np.int32)
        draft_lens = np.zeros(B, np.int32)
        tables = self.block_tables.copy()
        for i, s in enumerate(self.slots):
            if s.request is None:
                continue
            if s.prefill_pos is not None:
                tables[i, :] = SCRATCH_BLOCK
                continue
            req = s.request
            remaining = req.max_new_tokens - len(req.tokens)
            budget = max(0, min(k, remaining - 1))
            draft = propose_draft(
                np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)]),
                budget,
                ngram_max=ngram_max,
                ngram_min=ngram_min,
            )[:budget]
            tokens[i, 0] = s.next_token
            tokens[i, 1 : 1 + len(draft)] = draft
            positions[i, :] = np.minimum(
                s.context_len + np.arange(S, dtype=np.int32),
                self.max_seq_len - 1,
            )
            lengths[i] = s.context_len + len(draft) + 1
            draft_lens[i] = len(draft)
        return tokens, positions, tables, lengths, draft_lens

    def commit_verify(self, targets: np.ndarray, n_emit: np.ndarray,
                      now: float) -> Tuple[np.ndarray, int]:
        """Fold one verify dispatch into the slots: each live slot emits
        its first ``n_emit[i]`` targets (the accepted run plus the
        correction or bonus draw), stopping early at eos or the cap.
        Returns ``(committed [B], accepted)``: tokens committed per slot
        and the draft tokens that became output (``committed - 1`` per
        live slot)."""
        committed = np.zeros(self.max_seqs, np.int32)
        accepted = 0
        for i, s in enumerate(self.slots):
            if s.request is None or s.prefill_pos is not None:
                continue
            req = s.request
            for j in range(int(n_emit[i])):
                tok = int(targets[i, j])
                s.context_len += 1  # query row j's K/V is now cached
                req.tokens.append(tok)
                s.next_token = tok
                committed[i] += 1
                if self._done(req):
                    self._finish(i, now)
                    break
            accepted += max(int(committed[i]) - 1, 0)
        return committed, accepted

    # --------------------------- decode state -------------------------- #

    def decode_batch(self):
        """Fixed-shape decode inputs: ``(tokens [B], positions [B],
        block_tables [B, MB], context_lens [B])``. Inactive slots feed
        token 0 at position 0 with context 1 against an all-scratch
        table; slots still prefilling get the same treatment (their table
        swapped for scratch), so the step's write cannot reach their
        half-written prompt."""
        B = self.max_seqs
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        context = np.ones(B, np.int32)  # inactive: attend self-only
        tables = self.block_tables.copy()
        for i, s in enumerate(self.slots):
            if s.request is None:
                continue
            if s.prefill_pos is not None:
                tables[i, :] = SCRATCH_BLOCK
                continue
            tokens[i] = s.next_token
            positions[i] = s.context_len
            context[i] = s.context_len + 1
        return tokens, positions, tables, context

    def sampling_batch(self):
        """Per-slot sampling knobs aligned with :meth:`decode_batch`:
        ``(temperature [B] f32, top_k [B] i32, top_p [B] f32)``, idle and
        prefilling slots greedy-encoded."""
        B = self.max_seqs
        temps = np.zeros(B, np.float32)
        ks = np.zeros(B, np.int32)
        ps = np.ones(B, np.float32)
        for i, s in enumerate(self.slots):
            if s.request is None or s.prefill_pos is not None:
                continue
            temps[i], ks[i], ps[i] = s.request.params.as_arrays()
        return temps, ks, ps

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
            if s.request is None or s.prefill_pos is not None:
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
