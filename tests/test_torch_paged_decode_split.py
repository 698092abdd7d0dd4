"""The decode kernels' split context walk holds against the JAX kernel.

``csrc/paged_decode.cu`` splits each (slot, head)'s walk over its cached
positions into chunks of 64: a block scores its chunk for the slot's one
query and keeps the chunk's max m, sum l and unnormalised P V; a merge
kernel then combines a slot's chunks by their log-sum-exp, and a slot
whose walk fits in one chunk is normalised in place. A slot at context 0
walks nothing and gets exactly 0. This file emulates that schedule on the
CPU in fp32 and holds it against ``paged_decode_attention_pallas`` of the
JAX package (Pallas in interpret mode) on the same numpy inputs, shaped
like ``chip_smoke.decode_inputs`` with 2 heads: the fp32 pool at the fp32
tolerance of ``tests/test_torch_paged_decode.py`` (atol 1e-5), the bf16
pool at ``FWD_ATOL_BF16``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoke_tpu.ops.flash_attention import (
    paged_decode_attention_pallas as jax_decode_kernel,
)
from stoke_tpu_torch.ops import FWD_ATOL_BF16, NEG_INF, paged_decode_attention

pytestmark = pytest.mark.torch_port

CHUNK = 64  # cache positions of a block (kChunk)
B, H, D, BS, MB = 8, 2, 64, 16, 32
NB = B * MB + 1
# slot 0 inactive (context 1 on an all-scratch table); 17 ends mid-page;
# 64 is one whole chunk and 65 one position more; 128 ends on a chunk
# edge; 512 is the table's last position; 600 is past it (clamped to 512)
CTX = [1, 17, 64, 65, 128, 250, 512, 600]
ATOL = {"float32": 1e-5, "bfloat16": FWD_ATOL_BF16}


def _inputs(seed, ctx=CTX):
    """``chip_smoke.decode_inputs`` at 2 heads, from numpy: slot 0 on an
    all-scratch table, the others on blocks of a permutation up to their
    (clamped) context; unused table entries on scratch block 0."""
    rng = np.random.default_rng(seed)
    lens = np.array(ctx, np.int32)
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    tables = np.zeros((B, MB), np.int32)
    for b in range(1, B):
        n = -(-min(int(lens[b]), MB * BS) // BS)
        tables[b, :n] = perm[b * MB: b * MB + n]
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    k = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    return q, k, v, tables, lens


def chunk_partials(q, k_pages, v_pages, tables, lens, b, chunks=None):
    """Slot ``b``'s chunks as the chunk kernel computes them: per chunk of
    CHUNK positions below ctx = clamp(lens[b], 0, MB * BS), the max m and
    sum l (``[H, 1]``) and unnormalised P V (``[H, D]``), fp32. ``chunks``
    (default: those the kernel walks) may name chunks past ctx, which the
    kernel's blocks skip."""
    ctx = min(max(int(lens[b]), 0), tables.shape[1] * BS)
    if chunks is None:
        chunks = range(-(-ctx // CHUNK))
    qs = q[b, :, 0].float() * q.shape[-1] ** -0.5  # [H, D]
    parts = []
    for c in chunks:
        pos = torch.arange(c * CHUNK, (c + 1) * CHUNK)
        blk = tables[b, (pos // BS).clamp(max=tables.shape[1] - 1)].long()
        blk = blk.clamp(0, k_pages.shape[0] - 1)
        keys = k_pages[blk, pos % BS].float()  # [CHUNK, H, D]
        vals = v_pages[blk, pos % BS].float()
        s = torch.einsum("hd,whd->hw", qs, keys)
        s = torch.where(pos[None, :] < ctx, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("hw,whd->hd", p, vals)))
    return parts


def merge(parts):
    """The merge kernel: the log-sum-exp combination of a slot's chunks,
    chunk c weighing exp(m_c - M) / sum_c' exp(m_c' - M) l_c' (M the
    largest m of the chunks with l > 0), a chunk with l == 0 weighing
    nothing; one chunk is normalised as it is, none gives 0."""
    if not parts:
        return torch.zeros(H, D)
    if len(parts) == 1:
        _, l, acc = parts[0]
        return acc / l
    big = torch.stack([torch.where(l > 0, m, NEG_INF)
                       for m, l, _ in parts]).amax(0)
    wts = [torch.where(l > 0, torch.exp(m - big), 0.0) for m, l, _ in parts]
    total = sum(l * wt for (_, l, _), wt in zip(parts, wts))
    total = torch.where(total > 0, total, 1.0)
    return sum(acc * (wt / total) for (_, _, acc), wt in zip(parts, wts))


def split_decode(q, k_pages, v_pages, tables, lens):
    return torch.stack([
        merge(chunk_partials(q, k_pages, v_pages, tables, lens, b))
        for b in range(q.shape[0])])[:, :, None].to(q.dtype)


def _ours(pool_dtype, q_dtype="float32", seed=0, ctx=CTX):
    """The emulated split walk on ``_inputs(seed, ctx)``, and the inputs
    as tensors (tables and lengths as numpy)."""
    q, k, v, tables, lens = _inputs(seed, ctx)
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    tk, tv = (torch.from_numpy(a).to(getattr(torch, pool_dtype))
              for a in (k, v))
    ours = split_decode(tq, tk, tv, torch.from_numpy(tables),
                        torch.from_numpy(lens))
    return ours, (tq, tk, tv, tables, lens)


def _both(pool_dtype, q_dtype="float32", seed=0, ctx=CTX):
    """``_ours``, with the JAX kernel's output on the same inputs."""
    ours, inputs = _ours(pool_dtype, q_dtype, seed, ctx)
    q, k, v, tables, lens = _inputs(seed, ctx)
    jdt = getattr(jnp, pool_dtype)
    theirs = jax_decode_kernel(
        jnp.asarray(q).astype(getattr(jnp, q_dtype)),
        jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True)
    return ours, np.asarray(theirs.astype(jnp.float32)), inputs


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_split_walk_matches_jax_kernel(pool_dtype):
    ours, theirs, _ = _both(pool_dtype, seed=1)
    assert ours.shape == (B, H, 1, D) and torch.isfinite(ours).all()
    np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL[pool_dtype])


def test_split_walk_bf16_queries_over_bf16_pool():
    """bf16 in, bf16 out, as the kernel's bf16 instantiation."""
    ours, theirs, _ = _both("bfloat16", q_dtype="bfloat16", seed=7)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), theirs,
                               atol=FWD_ATOL_BF16)


def test_split_walk_matches_the_plain_version():
    ours, (tq, tk, tv, tables, lens) = _ours("float32", seed=3)
    plain = paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                   torch.from_numpy(lens))
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), atol=1e-5)


def test_context_zero_gives_exactly_zero():
    """A slot at context 0 walks no chunk and gets exactly 0, as the JAX
    kernel gives it (its ``safe_l``). The JAX package's jnp reference, and
    the port's plain version with it, give that slot the mean of V over its
    table instead (a softmax over all-masked scores), so the kernel is held
    to the JAX kernel here; the other slots agree with both."""
    ctx = [0] + CTX[1:]
    ours, theirs, (tq, tk, tv, tables, lens) = _both("float32", seed=5,
                                                     ctx=ctx)
    assert (ours[0] == 0).all() and (theirs[0] == 0).all()
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-5)
    plain = paged_decode_attention(tq, tk, tv, torch.from_numpy(tables),
                                   torch.from_numpy(lens))
    assert plain[0].abs().max() > 0.1
    np.testing.assert_allclose(ours[1:].numpy(), plain[1:].numpy(),
                               atol=1e-5)


def test_chunk_past_the_context_adds_nothing():
    """Slot 3 (context 65) walks chunks 0 and 1; the grid's chunks 2-7 lie
    past its context, so their blocks exit at once. Computed all the same,
    such a chunk has every score masked: l == 0, P V == 0, and the merge
    gives it weight 0, so the result is the walked chunks' own."""
    q, k, v, tables, lens = (torch.from_numpy(a) for a in _inputs(seed=11))
    walked = chunk_partials(q, k, v, tables, lens, 3)
    assert len(walked) == 2
    past = chunk_partials(q, k, v, tables, lens, 3, chunks=range(2, 8))
    for m, l, acc in past:
        assert (l == 0).all() and (m == NEG_INF).all() and (acc == 0).all()
    np.testing.assert_array_equal(merge(walked + past).numpy(),
                                  merge(walked).numpy())


def test_walk_stops_at_the_context():
    """The chunks a slot walks: 1 for contexts 1, 17 and 64, 2 for 65 and
    for 128 (a chunk edge), 4 for 250, 8 for the table's last position and
    for the clamped slot; the inactive slot attends scratch block 0's
    position 0 alone."""
    q, k, v, tables, lens = (torch.from_numpy(a) for a in _inputs(seed=12))
    counts = [len(chunk_partials(q, k, v, tables, lens, b))
              for b in range(B)]
    assert counts == [1, 1, 1, 2, 2, 4, 8, 8]
    out = split_decode(q, k, v, tables, lens)
    np.testing.assert_allclose(out[0, :, 0].numpy(), v[0, 0].numpy(),
                               atol=1e-6)
