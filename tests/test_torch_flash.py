"""Port parity: the flash forward's plain version against the JAX kernel.

The same numpy inputs go through ``stoke_tpu_torch.ops.flash_attention``
(CPU tensors, so its plain PyTorch version runs) and through the JAX
package's ``flash_attention`` (the Pallas kernel in interpret mode off the
TPU) and ``dense_reference``. fp32 throughout, atol 1e-5: the two sum in
different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stoke_tpu.ops.flash_attention import dense_reference as jax_dense
from stoke_tpu.ops.flash_attention import flash_attention as jax_flash
from stoke_tpu_torch.ops import (
    NEG_INF,
    dense_reference,
    flash_attention,
    flash_attention_plain,
)

pytestmark = pytest.mark.torch_port

ATOL = 1e-5
B, H, D = 2, 2, 16


def _inputs(L, masked, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, L, D)).astype(np.float32)
               for _ in range(3))
    mask = None
    if masked:
        mask = np.ones((B, L), np.int32)
        mask[0, L - 7:] = 0  # prompt padding
        mask[0, 0] = 0       # under causal, query row 0 sees no key
        mask[1, :] = 0       # every row of batch 1 fully masked
    return q, k, v, mask


def _fully_masked(L, mask, causal):
    """[B, L] rows with no key to attend."""
    allow = np.ones((L, L), bool)
    if causal:
        allow = np.tril(allow)
    allow = np.broadcast_to(allow, (B, L, L))
    if mask is not None:
        allow = allow & (mask[:, None, :] > 0)
    return ~allow.any(-1)


@pytest.mark.parametrize("L", [64, 128])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_kernel(L, masked, causal):
    q, k, v, mask = _inputs(L, masked)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_attention(*t, tm, causal=causal, return_lse=True)
    j = [jnp.asarray(a) for a in (q, k, v)]
    jm = None if mask is None else jnp.asarray(mask)
    j_out, j_lse = jax_flash(*j, jm, causal=causal, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=ATOL)

    dead = _fully_masked(L, mask, causal)  # [B, L]
    assert dead.any() == masked
    dead_bhl = np.broadcast_to(dead[:, None, :], (B, H, L))
    assert (lse.numpy()[dead_bhl] == NEG_INF).all()
    assert (out.numpy()[dead_bhl] == 0).all()
    # rows with a key to attend equal the dense reference, both packages'
    live = ~dead_bhl
    ref = np.asarray(jax_dense(*j, jm, causal=causal))
    np.testing.assert_allclose(out.numpy()[live], ref[live], atol=ATOL)
    np.testing.assert_allclose(
        dense_reference(*t, tm, causal=causal).numpy()[live], ref[live],
        atol=ATOL,
    )


def test_flash_wrapper_on_cpu_is_the_plain_version():
    q, k, v, mask = _inputs(64, True, seed=1)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = flash_attention(*t, torch.from_numpy(mask), causal=True,
                               return_lse=True)
    ref_out, ref_lse = flash_attention_plain(*t, torch.from_numpy(mask), True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert flash_attention(*t).dtype == torch.float32


def test_flash_output_in_input_dtype_bf16():
    q, k, v, mask = _inputs(64, True, seed=2)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out = flash_attention(*t, torch.from_numpy(mask), causal=True)
    assert out.dtype == torch.bfloat16
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    j_out = jax_flash(*j, jnp.asarray(mask), causal=True)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(j_out.astype(jnp.float32)),
        atol=2e-2,
    )


@pytest.mark.parametrize(
    "shapes",
    [((1, 2, 8, 4), (1, 2, 8, 4), (1, 2, 9, 4), None),
     ((1, 2, 8, 4),) * 3 + ((1, 9),),
     ((2, 8, 4),) * 3 + (None,)],
)
def test_flash_rejects_bad_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes[:3])
    mask = None if shapes[3] is None else torch.ones(shapes[3], dtype=torch.int32)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, mask)


def test_flash_rejects_unsupported_device():
    q = torch.zeros(1, 1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
