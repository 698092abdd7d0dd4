"""Port parity: paged decode attention against the JAX kernel.

The port's ``paged_decode_attention_pallas`` on CPU tensors (so its plain
version runs) against the JAX package's ``paged_decode_attention_pallas``
(the Pallas kernel in interpret mode) and ``paged_decode_attention``, on
the same numpy inputs: mixed context lengths including an inactive slot
(context 1 on an all-scratch table), unused table entries on scratch
block 0, pools in fp32 (atol 1e-5) and bf16 (atol 2e-2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stoke_tpu.ops.flash_attention import (
    paged_decode_attention as jax_decode_ref,
    paged_decode_attention_pallas as jax_decode_kernel,
)
from stoke_tpu_torch.ops import (
    paged_decode_attention,
    paged_decode_attention_pallas,
)

pytestmark = pytest.mark.torch_port

B, H, D, BS, MB = 4, 2, 16, 8, 4
NB = B * MB + 1
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ctx = np.array([1, 5, 17, 32], np.int32)  # slot 0 inactive
    tables = np.zeros((B, MB), np.int32)
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    for b in range(1, B):
        n = -(-int(ctx[b]) // BS)
        tables[b, :n] = perm[b * MB : b * MB + n]
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    k = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    return q, k, v, tables, ctx


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_jax_kernel_and_reference(pool_dtype):
    q, k, v, tables, ctx = _inputs()
    tdt = getattr(torch, pool_dtype)
    jdt = getattr(jnp, pool_dtype)
    out = paged_decode_attention_pallas(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(tables),
        torch.from_numpy(ctx),
    )
    assert out.shape == (B, H, 1, D) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    jargs = (jnp.asarray(q), jnp.asarray(k).astype(jdt),
             jnp.asarray(v).astype(jdt), jnp.asarray(tables),
             jnp.asarray(ctx))
    kern = np.asarray(jax_decode_kernel(*jargs))
    ref = np.asarray(jax_decode_ref(*jargs))
    np.testing.assert_allclose(out.numpy(), kern, atol=ATOL[pool_dtype])
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL[pool_dtype])


def test_paged_decode_inactive_slot_attends_scratch_position_0():
    q, k, v, tables, ctx = _inputs(seed=1)
    out = paged_decode_attention_pallas(*map(torch.from_numpy,
                                             (q, k, v, tables, ctx)))
    # context 1 on an all-scratch table: softmax over one key, so the
    # output is block 0's first value row
    np.testing.assert_allclose(out[0, :, 0].numpy(), v[0, 0], atol=1e-6)


def test_paged_decode_wrapper_on_cpu_is_the_plain_version():
    args = tuple(map(torch.from_numpy, _inputs(seed=2)))
    assert torch.equal(paged_decode_attention_pallas(*args),
                       paged_decode_attention(*args))


@pytest.mark.parametrize(
    "bad",
    [
        dict(q=(B, H, 2, D)),                 # multi-token query
        dict(k=(NB, BS, H + 1, D)),           # heads mismatch
        dict(tables=(B + 1, MB)),             # table rows != B
        dict(ctx=(B + 1,)),                   # lens rows != B
    ],
)
def test_paged_decode_rejects_bad_shapes(bad):
    shapes = dict(q=(B, H, 1, D), k=(NB, BS, H, D), tables=(B, MB), ctx=(B,))
    shapes.update(bad)
    q = torch.zeros(shapes["q"])
    k = torch.zeros(shapes["k"])
    tables = torch.zeros(shapes["tables"], dtype=torch.int32)
    ctx = torch.ones(shapes["ctx"], dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_decode_attention_pallas(q, k, k.clone(), tables, ctx)
