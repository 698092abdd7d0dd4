"""Port parity: the flash backward's plain version against the JAX kernels.

The same numpy q/k/v/mask/dO go through ``stoke_tpu_torch.ops
.flash_attention`` under autograd (CPU tensors, so its plain backward
``flash_attention_bwd_plain`` runs) and through ``jax.grad`` of the JAX
package's ``flash_attention`` (its ``_dq_kernel`` and ``_dkv_kernel`` in
Pallas interpret mode off the TPU). fp32 at rtol 1e-4 and atol 1e-5, as
``tests/test_attention.py`` holds the JAX kernels: the two sum in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoke_tpu.ops.flash_attention import BWD_RTOL_BF16 as JAX_BWD_RTOL_BF16
from stoke_tpu.ops.flash_attention import flash_attention as jax_flash
from stoke_tpu.ops.flash_attention import make_flash_attention as jax_make
from stoke_tpu_torch.ops import (
    BWD_RTOL_BF16,
    LAUNCHES,
    flash_attention,
    flash_attention_bwd_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
    make_flash_attention,
)

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 1e-4, 1e-5
B, H, L, D = 2, 2, 64, 64


def _inputs(masked, seed=0, L=L):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, H, L, D)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.normal(size=(B, H, L)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, L), np.int32)
        mask[0, L - 7:] = 0  # padding keys
        mask[0, 0] = 0       # under causal, query row 0 sees no key
        mask[1, :] = 0       # every row of batch 1 fully masked
    return q, k, v, do, dlse, mask


def _port_grads(q, k, v, do, dlse, mask, causal, return_lse, dtype=None):
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    x = [a.to(dtype) for a in t] if dtype is not None else t
    tm = None if mask is None else torch.from_numpy(mask)
    res = flash_attention(*x, tm, causal=causal, return_lse=return_lse)
    if return_lse:
        out, lse = res
        obj = (out.float() * torch.from_numpy(do)).sum() + (
            lse * torch.from_numpy(dlse)).sum()
    else:
        obj = (res.float() * torch.from_numpy(do)).sum()
    obj.backward()
    return [a.grad.numpy() for a in t]


def _jax_grads(q, k, v, do, dlse, mask, causal, return_lse, dtype=None):
    jm = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        if dtype is not None:
            q, k, v = (a.astype(dtype) for a in (q, k, v))
        if return_lse:
            out, lse = jax_flash(q, k, v, jm, causal=causal, return_lse=True)
            return (jnp.sum(out.astype(jnp.float32) * do)
                    + jnp.sum(lse * dlse))
        out = jax_flash(q, k, v, jm, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * do)

    grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_matches_jax_kernels(causal, masked):
    q, k, v, do, dlse, mask = _inputs(masked)
    ours = _port_grads(q, k, v, do, dlse, mask, causal, return_lse=False)
    theirs = _jax_grads(q, k, v, do, dlse, mask, causal, return_lse=False)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    if masked:
        # fully masked query rows (all of batch 1; row 0 under causal)
        # get exactly zero dQ, and batch 1 sends nothing to dK or dV
        assert (ours[0][1] == 0).all() and (ours[1][1] == 0).all()
        assert (ours[2][1] == 0).all()
        if causal:
            assert (ours[0][0, :, 0] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_with_lse_gradient_matches_jax(causal):
    """return_lse=True: the LSE rows carry a gradient (delta - dlse)."""
    q, k, v, do, dlse, mask = _inputs(True, seed=1)
    ours = _port_grads(q, k, v, do, dlse, mask, causal, return_lse=True)
    theirs = _jax_grads(q, k, v, do, dlse, mask, causal, return_lse=True)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # the LSE cotangent moves the result: it is not the dO-only gradient
    plain = _port_grads(q, k, v, do, dlse, mask, causal, return_lse=False)
    assert np.abs(ours[0] - plain[0]).max() > 1e-3


def test_flash_bwd_bf16_matches_jax_kernels():
    """bf16 q/k/v: gradients within BWD_RTOL_BF16 of the largest gradient
    element (the JAX package's numerics contract)."""
    assert BWD_RTOL_BF16 == JAX_BWD_RTOL_BF16
    q, k, v, do, dlse, mask = _inputs(True, seed=2)
    ours = _port_grads(q, k, v, do, dlse, mask, True, False, torch.bfloat16)
    theirs = _jax_grads(q, k, v, do, dlse, mask, True, False, jnp.bfloat16)
    for a, b in zip(ours, theirs):
        assert np.abs(a - b).max() <= BWD_RTOL_BF16 * np.abs(b).max()


@pytest.mark.parametrize("return_lse", [False, True])
def test_flash_bwd_plain_gradcheck_float64(return_lse):
    """The plain backward is the gradient of the plain forward: gradcheck
    in float64 at L=16, causal, with a masked key and a fully masked row."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1, 16, 4, dtype=torch.float64, generator=gen,
                           requires_grad=True) for _ in range(3))
    mask = torch.ones(1, 16, dtype=torch.int32)
    mask[0, 0] = 0
    mask[0, 9] = 0
    fn = lambda a, b, c: flash_attention(a, b, c, mask, causal=True,
                                         return_lse=return_lse)
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_flash_bwd_on_cpu_is_the_plain_version():
    """Autograd on CPU tensors runs flash_attention_bwd_plain, and launches
    no kernel. dO arrives strided (as through the heads' transpose)."""
    q, k, v, do, dlse, mask = _inputs(True, seed=3)
    before = dict(LAUNCHES)
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tm = torch.from_numpy(mask)
    out, lse = flash_attention(*t, tm, causal=True, return_lse=True)
    g = torch.from_numpy(do).transpose(1, 2).contiguous().transpose(1, 2)
    assert not g.is_contiguous()
    out.backward(g)
    ref = flash_attention_bwd_plain(*t, tm, out.detach(), lse.detach(), g,
                                    None, True)
    for a, b in zip(t, ref):
        assert torch.equal(a.grad, b)
    assert dict(LAUNCHES) == before


def test_make_flash_attention_matches_jax():
    """The bias -> key-mask rule (bias[:, 0, 0, :] > -1e8) and causal
    masking of make_flash_attention, forward and gradients, against the JAX
    package's attention_fn on the same [B, 1, 1, L] padding bias."""
    q, k, v, do, _, mask = _inputs(True, seed=4)
    bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    t = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = make_flash_attention(causal=True)(*t, torch.from_numpy(bias))
    (out * torch.from_numpy(do)).sum().backward()
    fn = jax_make(causal=True)

    def f(q, k, v):
        return jnp.sum(fn(q, k, v, jnp.asarray(bias)) * do)

    j = [jnp.asarray(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(fn(*j, jnp.asarray(bias))),
        rtol=RTOL, atol=ATOL)
    for a, b in zip(t, jax.grad(f, argnums=(0, 1, 2))(*j)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)


def test_make_flash_attention_refuses_prob_dropout():
    x = torch.zeros(1, 1, 8, 64)
    with pytest.raises(NotImplementedError, match="dropout"):
        make_flash_attention(causal=True)(x, x, x, None, dropout=lambda p: p)


@pytest.mark.parametrize("wrapper", [flash_bwd_dq, flash_bwd_dkv])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """The kernels' wrappers launch on CUDA tensors or raise; they never
    fall back to the plain version."""
    x = torch.zeros(1, 1, 8, 64)
    stats = torch.zeros(1, 1, 8)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(x, x, x, None, x, stats, stats, True)
    assert dict(LAUNCHES) == before
