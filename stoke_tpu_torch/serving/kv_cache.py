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
  paged-decode kernel). The chunk and verify modes of the JAX hook belong
  to later slices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from stoke_tpu_torch.models.bert import dense_attention
from stoke_tpu_torch.ops.flash_attention import (
    flash_attention,
    paged_decode_attention,
    paged_decode_attention_pallas,
)

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
    kernel reads directly."""

    def __init__(self, n_layers: int, num_blocks: int, block_size: int,
                 heads: int, head_dim: int, dtype=torch.float32,
                 device="cpu"):
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
            ``arange`` rows; decode: each slot's current position, L == 1).
        mode: ``"prefill"`` or ``"decode"``.
        lengths: ``[B] int32``; prefill: true prompt lengths (padding
            positions write to scratch and are masked); decode: context
            lengths including the fresh token.
        attention_impl: prefill attention, ``"dense"`` or ``"flash"``.
        decode_impl: decode attention, ``"reference"``
            (:func:`paged_decode_attention`) or ``"pallas"``
            (:func:`paged_decode_attention_pallas`, the kernel).
    """

    def __init__(self, k_pages, v_pages, block_tables, positions, *,
                 mode: str, lengths, attention_impl: str = "dense",
                 decode_impl: str = "reference"):
        if mode in ("chunk", "verify"):
            raise NotImplementedError(
                f"PagedAttentionHook mode {mode!r} is not ported yet "
                f"(ROADMAP Queue 1 item 3: chunked prefill, speculative verify)"
            )
        if mode not in ("prefill", "decode"):
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

    def _write_layer(self, layer: int, k, v) -> None:
        """Scatter this call's fresh K/V into layer ``layer``'s planes.

        Valid tokens land at ``(block_table[b, pos // BS], pos % BS)``;
        prompt padding lands in the scratch block (inactive decode slots
        are steered there by their all-scratch tables). Distinct live
        slots own distinct blocks, so writes of live tokens never collide.

        The planes are updated in place with ``index_put_``: this is the
        port's counterpart of the JAX engine donating the page buffers to
        its compiled programs (``stoke_tpu/serving/engine.py:361``), so
        the pool is never copied."""
        B, L = self.positions.shape
        dev = self.positions.device
        pos = self.positions.reshape(-1).long()  # [B*L]
        slot = torch.arange(B, device=dev).repeat_interleave(L)
        if self.mode == "prefill":
            valid = (self.positions < self.lengths[:, None]).reshape(-1)
        else:
            valid = torch.ones_like(pos, dtype=torch.bool)
        # clamp the table column so padding positions past the allocated
        # window index legally, then steer invalid writes to scratch
        col = torch.clamp(pos // self.block_size,
                          max=self.block_tables.shape[1] - 1)
        blocks = self.block_tables[slot, col].long()
        blocks = torch.where(valid, blocks, torch.full_like(blocks,
                                                            SCRATCH_BLOCK))
        offs = pos % self.block_size
        self.k_pages[layer].index_put_(
            (blocks, offs), _flatten_heads(k).to(self.k_pages.dtype)
        )
        self.v_pages[layer].index_put_(
            (blocks, offs), _flatten_heads(v).to(self.v_pages.dtype)
        )

    def layer_attention(self, layer: int):
        """The attention function (``bert.py`` signature) of layer
        ``layer``: every write happens before the attention that reads
        it."""

        def attention_fn(q, k, v, bias):
            self._write_layer(layer, k, v)
            if self.mode == "decode":
                decode = (paged_decode_attention_pallas
                          if self.decode_impl == "pallas"
                          else paged_decode_attention)
                return decode(q, self.k_pages[layer], self.v_pages[layer],
                              self.block_tables, self.lengths)
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
