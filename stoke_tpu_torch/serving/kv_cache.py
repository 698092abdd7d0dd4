"""Paged KV cache: block pool, block allocator and the attention hook.

Counterpart of ``stoke_tpu/serving/kv_cache.py``:

- :class:`BlockAllocator`: host-side free list over the pool. Block 0 is
  reserved as scratch: inactive decode slots and prompt padding write
  their discarded K/V there, so every decode step runs the full slot batch
  with no active-mask branching.
- :class:`PagedKVCache`: the K and V page planes, ``[n_layers, n_blocks,
  block_size, heads, head_dim]``, zeroed on the engine's device.
- :class:`PagedAttentionHook`: the bridge into ``models/gpt.py``. In
  prefill mode a layer's attention writes the prompt's K/V into the
  slot's blocks and runs causal attention over the (padded) prompt (dense
  or the flash kernel); in decode mode it writes the fresh token's K/V and
  attends over the slot's cached blocks (the plain gather or the
  paged-decode kernel). Chunk mode (chunked prefill) and verify mode
  (speculative verify) write a multi-token query's K/V at global
  positions and attend the cache under the positional predicate; verify
  mode also snapshots what each write clobbers, so :meth:`rollback` can
  restore rejected draft positions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from stoke_tpu_torch.models.bert import dense_attention
from stoke_tpu_torch.ops.flash_attention import (
    flash_attention,
    paged_decode_attention,
    paged_decode_attention_pallas,
    paged_prefill_chunk_attention,
    paged_verify_attention,
    paged_verify_attention_pallas,
)

def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "stoke_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


#: block id every unused block-table entry (and every inactive slot) points
#: at: allocated to no request, read by nothing meaningful
SCRATCH_BLOCK = 0


class BlockAllocator:
    """Host-side free list over the KV block pool (block 0 reserved).

    The scheduler allocates a request's whole worst-case budget (prompt +
    token cap) at admission, so a decode step can never fail on an empty
    pool; freed blocks return to the tail and are reused."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"BlockAllocator needs >= 2 blocks (one is the reserved "
                f"scratch block {SCRATCH_BLOCK}), got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(1, num_blocks))

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache entries."""
        return -(-max(int(n_tokens), 1) // self.block_size)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks currently owned by requests (scratch excluded)."""
        return (self.num_blocks - 1) - len(self._free)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (pool minus the scratch block)."""
        return self.num_blocks - 1

    @property
    def occupancy(self) -> float:
        """Fraction of the allocatable pool currently owned."""
        return self.used_blocks / max(self.capacity, 1)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` blocks, or None (allocator unchanged) when the pool
        cannot supply them."""
        if n > len(self._free):
            return None
        taken, self._free = self._free[:n], self._free[n:]
        return taken

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if b == SCRATCH_BLOCK:
                raise ValueError("cannot free the reserved scratch block")
            if b in self._free:
                raise ValueError(f"double free of KV block {b}")
            self._free.append(int(b))


class PagedKVCache:
    """The device-side block pool: K and V page planes for every layer.

    Layer outermost, so one layer's plane is a contiguous view the decode
    and verify kernels read directly. ``device=None`` places the pool on
    the card (and raises when there is none); ``"cpu"`` on the CPU."""

    def __init__(self, n_layers: int, num_blocks: int, block_size: int,
                 heads: int, head_dim: int, dtype=torch.float32,
                 device=None):
        device = resolve_device(device)
        self.n_layers = int(n_layers)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.dtype = dtype
        shape = (n_layers, num_blocks, block_size, heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=device)

    @property
    def nbytes(self) -> int:
        """Device bytes of the pool (both planes)."""
        return (self.k_pages.numel() + self.v_pages.numel()) * (
            self.k_pages.element_size()
        )


def _flatten_heads(t):
    """[B, H, L, D] attention layout -> [B*L, H, D] page-write layout."""
    B, H, L, D = t.shape
    return t.transpose(1, 2).reshape(B * L, H, D)


class PagedAttentionHook:
    """Per-call cache bridge for ``GPT(..., kv_cache=hook)``.

    Args:
        k_pages / v_pages: ``[n_layers, NB, BS, H, D]`` pool planes,
            updated in place.
        block_tables: ``[B, MAX_BLOCKS] int32`` per-slot block ids.
        positions: ``[B, L]`` token positions written this call (prefill:
            ``arange`` rows; decode: each slot's current position, L == 1;
            chunk and verify: the queries' global positions).
        mode: ``"prefill"``, ``"chunk"`` (chunked prefill), ``"decode"``
            or ``"verify"`` (speculative verify).
        lengths: ``[B] int32``; prefill and chunk: true prompt lengths
            (padding positions write to scratch and are masked); decode:
            context lengths including the fresh token; verify: context +
            draft length + 1, the write budget (query rows past it write
            to scratch).
        attention_impl: prefill attention, ``"dense"`` or ``"flash"``.
        decode_impl: decode and verify attention, ``"reference"`` (the
            plain :func:`paged_decode_attention` /
            :func:`paged_verify_attention`) or ``"pallas"`` (the kernels'
            wrappers).
    """

    def __init__(self, k_pages, v_pages, block_tables, positions, *,
                 mode: str, lengths, attention_impl: str = "dense",
                 decode_impl: str = "reference"):
        if mode not in ("prefill", "chunk", "decode", "verify"):
            raise ValueError(f"unknown PagedAttentionHook mode {mode!r}")
        if attention_impl not in ("dense", "flash"):
            raise ValueError(
                f"unknown attention_impl {attention_impl!r}; valid: "
                f"['dense', 'flash']"
            )
        if decode_impl not in ("reference", "pallas"):
            raise ValueError(
                f"unknown PagedAttentionHook decode_impl {decode_impl!r}; "
                f"valid: ['reference', 'pallas']"
            )
        self.k_pages = k_pages
        self.v_pages = v_pages
        self.block_tables = block_tables
        self.positions = positions
        self.mode = mode
        self.lengths = lengths
        self.attention_impl = attention_impl
        self.decode_impl = decode_impl
        self.block_size = int(k_pages.shape[2])
        # verify mode: per layer, (blocks, offs, old_k, old_v) gathered
        # before the write, for rollback()
        self._saved: List[tuple] = []

    def _write_layer(self, layer: int, k, v) -> None:
        """Scatter this call's fresh K/V into layer ``layer``'s planes.

        Valid tokens land at ``(block_table[b, pos // BS], pos % BS)``;
        prompt padding, chunk rows past the prompt and verify rows past
        the write budget land in the scratch block (inactive slots are
        steered there by their all-scratch tables). Distinct live slots
        own distinct blocks, so writes of live tokens never collide.

        The planes are updated in place with ``index_put_``: this is the
        port's counterpart of the JAX engine donating the page buffers to
        its compiled programs (``stoke_tpu/serving/engine.py:361``), so
        the pool is never copied. In verify mode the rows a write clobbers
        are first gathered into a copy, since the write overwrites them in
        place."""
        B, L = self.positions.shape
        dev = self.positions.device
        pos = self.positions.reshape(-1).long()  # [B*L]
        slot = torch.arange(B, device=dev).repeat_interleave(L)
        if self.mode == "decode":
            valid = torch.ones_like(pos, dtype=torch.bool)
        else:
            valid = (self.positions < self.lengths[:, None]).reshape(-1)
        # clamp the table column so padding positions past the allocated
        # window index legally, then steer invalid writes to scratch
        col = torch.clamp(pos // self.block_size,
                          max=self.block_tables.shape[1] - 1)
        blocks = self.block_tables[slot, col].long()
        blocks = torch.where(valid, blocks, torch.full_like(blocks,
                                                            SCRATCH_BLOCK))
        offs = pos % self.block_size
        if self.mode == "verify":
            self._saved.append((blocks, offs,
                                self.k_pages[layer][blocks, offs],
                                self.v_pages[layer][blocks, offs]))
        self.k_pages[layer].index_put_(
            (blocks, offs), _flatten_heads(k).to(self.k_pages.dtype)
        )
        self.v_pages[layer].index_put_(
            (blocks, offs), _flatten_heads(v).to(self.v_pages.dtype)
        )

    def rollback(self, n_keep) -> None:
        """Restore every verify write past the accepted window.

        Called after the whole forward, once acceptance is known: query
        row ``i`` of slot ``b`` keeps its written K/V iff ``i <
        n_keep[b]``; every other row's destination gets back the snapshot
        :meth:`_write_layer` took. Kept rows' restores are steered to the
        scratch block, so the scatter has a fixed shape and rejected
        drafts never dirty the pool across dispatches.

        Args:
            n_keep: ``[B]`` accepted-row counts (the sampler's ``n_emit``).
        """
        if self.mode != "verify":
            raise ValueError(
                f"rollback() is a verify-mode operation; hook mode is "
                f"{self.mode!r}"
            )
        B, L = self.positions.shape
        dev = self.positions.device
        within = torch.arange(L, device=dev).repeat(B)
        slot = torch.arange(B, device=dev).repeat_interleave(L)
        keep = within < n_keep.long()[slot]
        for layer, (blocks, offs, old_k, old_v) in enumerate(self._saved):
            blocks_r = torch.where(keep, torch.full_like(blocks,
                                                         SCRATCH_BLOCK),
                                   blocks)
            self.k_pages[layer].index_put_((blocks_r, offs), old_k)
            self.v_pages[layer].index_put_((blocks_r, offs), old_v)

    def layer_attention(self, layer: int):
        """The attention function (``bert.py`` signature) of layer
        ``layer``: every write happens before the attention that reads
        it. The block hands ``q`` over contiguous (``bert.py`` makes the
        head split contiguous), as the kernels take it."""

        def attention_fn(q, k, v, bias):
            self._write_layer(layer, k, v)
            pages = (q, self.k_pages[layer], self.v_pages[layer],
                     self.block_tables)
            pallas = self.decode_impl == "pallas"
            if self.mode == "decode":
                decode = (paged_decode_attention_pallas if pallas
                          else paged_decode_attention)
                return decode(*pages, self.lengths)
            if self.mode == "verify":
                verify = (paged_verify_attention_pallas if pallas
                          else paged_verify_attention)
                return verify(*pages, self.positions)
            if self.mode == "chunk":
                # earlier chunks' prefix and the intra-chunk causal mask
                # fall out of one positional predicate
                return paged_prefill_chunk_attention(*pages, self.positions)
            # prefill: causal attention over the padded prompt, with the
            # padding keys masked
            L = q.shape[2]
            key_valid = (
                torch.arange(L, device=q.device)[None, :]
                < self.lengths[:, None]
            )  # [B, L]
            if self.attention_impl == "flash":
                return flash_attention(
                    q, k, v, key_valid.to(torch.int32), causal=True
                )
            causal = torch.tril(
                torch.ones(L, L, dtype=torch.bool, device=q.device)
            )
            allow = causal[None, None] & key_valid[:, None, None, :]
            pbias = torch.zeros(allow.shape, dtype=q.dtype, device=q.device)
            return dense_attention(q, k, v, pbias.masked_fill_(~allow, -1e9))

        return attention_fn
