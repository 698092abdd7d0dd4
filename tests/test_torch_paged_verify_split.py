"""The verify kernels' split context walk holds against the JAX kernel.

``csrc/paged_verify.cu`` splits each (slot, head)'s walk over its cached
positions into chunks of 64: a block scores its chunk for every query row
and keeps, per row, the chunk's max m, sum l and unnormalised P V; a merge
kernel then combines a slot's chunks by their log-sum-exp, giving weight 0
to a chunk that holds none of a row's visible positions (l == 0), and a
slot whose walk fits in one chunk is normalised in place. This file
emulates that schedule on the CPU in fp32 and holds it against
``paged_verify_attention_pallas`` of the JAX package (Pallas in interpret
mode) on the same numpy inputs, shaped like ``chip_smoke.verify_inputs``
with 2 heads: the fp32 pool at the fp32 tolerance of
``tests/test_torch_speculative.py`` (atol 1e-5), the bf16 pool at
``FWD_ATOL_BF16``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoke_tpu.ops.flash_attention import (
    paged_verify_attention_pallas as jax_verify_kernel,
)
from stoke_tpu_torch.ops import FWD_ATOL_BF16, NEG_INF, paged_verify_attention

pytestmark = pytest.mark.torch_port

CHUNK = 64  # cache positions of a block (kChunk)
B, H, D, BS, MB = 8, 2, 64, 16, 32
NB = B * MB + 1
# slot 0 idle; 17 ends mid-page; 60 leaves rows 0-3 (positions 60-63) out
# of chunk 1, which only row 4 (position 64) reaches; 123 ends on a page
# and a chunk edge (last position 127); 509 has its padding rows clamped
CTX = [0, 17, 60, 123, 250, 333, 480, 509]
ATOL = {"float32": 1e-5, "bfloat16": FWD_ATOL_BF16}


def _inputs(S, seed):
    """``chip_smoke.verify_inputs`` at 2 heads, from numpy: slot 0 on an
    all-scratch table at positions 0..S-1, the others at their context
    and after, clamped to MB * BS - 1; unused table entries on scratch
    block 0."""
    rng = np.random.default_rng(seed)
    positions = np.array(
        [[s if b == 0 else min(c + s, MB * BS - 1) for s in range(S)]
         for b, c in enumerate(CTX)], np.int32)
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    tables = np.zeros((B, MB), np.int32)
    for b in range(1, B):
        n = -(-(int(positions[b].max()) + 1) // BS)
        tables[b, :n] = perm[b * MB: b * MB + n]
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    return q, k, v, tables, positions


def chunk_partials(q, k_pages, v_pages, tables, positions, b):
    """Slot ``b``'s chunks as the chunk kernel computes them: per chunk of
    CHUNK positions up to the slot's last visible one, the rows' max m,
    sum l (``[H, S, 1]``) and unnormalised P V (``[H, S, D]``), fp32."""
    n_tok = min(int(positions[b].max()) + 1, tables.shape[1] * BS)
    pos = torch.arange(n_tok)
    blk = tables[b, pos // BS].long().clamp(0, k_pages.shape[0] - 1)
    keys = k_pages[blk, pos % BS].float()  # [n_tok, H, D]
    vals = v_pages[blk, pos % BS].float()
    qs = q[b].float() * q.shape[-1] ** -0.5
    parts = []
    for c0 in range(0, n_tok, CHUNK):
        w = slice(c0, min(c0 + CHUNK, n_tok))
        s = torch.einsum("hsd,whd->hsw", qs, keys[w])
        visible = pos[w][None, :] <= positions[b].long()[:, None]
        s = torch.where(visible[None], s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("hsw,whd->hsd", p, vals[w])))
    return parts


def merge(parts):
    """The merge kernel: the log-sum-exp combination of a slot's chunks,
    chunk c weighing exp(m_c - M) / sum_c' exp(m_c' - M) l_c' for a row
    (M the largest m of the chunks with l > 0), a chunk with l == 0 for a
    row weighing nothing for it; one chunk is normalised as it is."""
    if len(parts) == 1:
        _, l, acc = parts[0]
        return acc / torch.where(l > 0, l, 1.0)
    big = torch.stack([torch.where(l > 0, m, NEG_INF)
                       for m, l, _ in parts]).amax(0)
    wts = [torch.where(l > 0, torch.exp(m - big), 0.0) for m, l, _ in parts]
    total = sum(l * wt for (_, l, _), wt in zip(parts, wts))
    total = torch.where(total > 0, total, 1.0)
    return sum(acc * (wt / total) for (_, _, acc), wt in zip(parts, wts))


def split_verify(q, k_pages, v_pages, tables, positions):
    return torch.stack([
        merge(chunk_partials(q, k_pages, v_pages, tables, positions, b))
        for b in range(q.shape[0])]).to(q.dtype)


def _both(S, pool_dtype, q_dtype="float32", seed=0):
    q, k, v, tables, positions = _inputs(S, seed)
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    tk, tv = (torch.from_numpy(a).to(getattr(torch, pool_dtype))
              for a in (k, v))
    ours = split_verify(tq, tk, tv, torch.from_numpy(tables),
                        torch.from_numpy(positions))
    jdt = getattr(jnp, pool_dtype)
    theirs = jax_verify_kernel(
        jnp.asarray(q).astype(getattr(jnp, q_dtype)),
        jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt),
        jnp.asarray(tables), jnp.asarray(positions), interpret=True)
    return ours, np.asarray(theirs.astype(jnp.float32)), (tq, tk, tv,
                                                          tables, positions)


@pytest.mark.parametrize("S", [5, 16])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_split_walk_matches_jax_kernel(S, pool_dtype):
    ours, theirs, _ = _both(S, pool_dtype, seed=S)
    assert ours.shape == (B, H, S, D) and torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL[pool_dtype])


def test_split_walk_bf16_queries_over_bf16_pool():
    """bf16 in, bf16 out, as the kernel's bf16 instantiation."""
    ours, theirs, _ = _both(5, "bfloat16", q_dtype="bfloat16", seed=7)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), theirs,
                               atol=FWD_ATOL_BF16)


def test_split_walk_matches_the_plain_version():
    ours, _, (tq, tk, tv, tables, positions) = _both(5, "float32", seed=3)
    plain = paged_verify_attention(tq, tk, tv, torch.from_numpy(tables),
                                   torch.from_numpy(positions))
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), atol=1e-5)


def test_chunk_past_a_rows_last_position_weighs_nothing():
    """Slot 2 (context 60) walks two chunks; chunk 1 holds position 64,
    visible to row 4 only: rows 0-3 get l == 0 there (m at the sentinel),
    and the merge gives them their chunk-0 result (to the rounding of a
    multiply by 1 / l against a division by l)."""
    q, k, v, tables, positions = (torch.from_numpy(a)
                                  for a in _inputs(5, seed=11))
    parts = chunk_partials(q, k, v, tables, positions, 2)
    assert len(parts) == 2
    m1, l1, acc1 = parts[1]
    assert (l1[:, :4] == 0).all() and (m1[:, :4] == NEG_INF).all()
    assert (acc1[:, :4] == 0).all() and (l1[:, 4] > 0).all()
    merged = merge(parts)
    assert torch.isfinite(merged).all()
    alone = merge(parts[:1])
    np.testing.assert_allclose(merged[:, :4].numpy(), alone[:, :4].numpy(),
                               rtol=1e-6, atol=0)


def test_walk_stops_at_the_last_visible_position():
    """The grid's chunks past a slot's last visible position exit at
    once: 1 chunk for the idle slot and for context 17, 2 for context 123
    (positions up to 127, a chunk edge), 8 for the clamped slot."""
    q, k, v, tables, positions = (torch.from_numpy(a)
                                  for a in _inputs(5, seed=12))
    counts = [len(chunk_partials(q, k, v, tables, positions, b))
              for b in range(B)]
    assert counts == [1, 1, 2, 2, 4, 6, 8, 8]
    # the idle slot's rows attend scratch block 0 from position 0 on
    out = split_verify(q, k, v, tables, positions)
    np.testing.assert_allclose(out[0, :, 0].numpy(), v[0, 0].numpy(),
                               atol=1e-6)
