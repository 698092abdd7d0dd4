"""The bf16 and fp16 tolerances admit the tensor-core kernels' rounding.

The bf16 flash forward, dQ and dK/dV kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``) feed their second products from registers as bf16:
the forward rounds P before ``P V``, the dQ kernel dS before ``dS K``, the
dK/dV kernel P^T before ``P^T dO`` and dS^T before ``dS^T Q``. The JAX
kernels multiply fp32 P and dS. This file emulates that rounding on the CPU, beside the plain versions
(the forward tile by tile, as the kernel walks 128-key tiles with an online
softmax), and holds the emulation against the JAX package's
``flash_attention`` and its ``jax.grad`` (Pallas in interpret mode off the
TPU) on the same numpy inputs, at the port's bf16 contract, unchanged:
``FWD_ATOL_BF16`` absolute on O and LSE, ``BWD_RTOL_BF16`` of the largest
gradient element. Fully masked rows must stay exactly zero. The dQ and
dK/dV rounding is also held against the plain version row by row
(``bwd_row_err`` at ``BWD_ROW_RTOL_BF16``), the bound that catches a kernel
the contract's tolerance would pass.

The fp16 instantiations round the same operands to fp16. Their forward is
held to ``FWD_ATOL_FP16``, their backward to the same row bound against
the JAX kernels' fp16 gradients, at dO x 2^16 (the loss scale fp16 starts
at) and at the dO of the GPT-base fp16 step, whose |dS| (~2e-4) lies in
fp16's subnormal range: there the kernels' power-of-two scaling of dS
before the rounding (``ds_bound``) is what keeps the rows within the
bound, and rounding without it does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoke_tpu.ops.flash_attention import flash_attention as jax_flash
from stoke_tpu_torch.ops import (
    BWD_ROW_RTOL_BF16,
    BWD_RTOL_BF16,
    FWD_ATOL_BF16,
    FWD_ATOL_FP16,
    NEG_INF,
    bwd_row_err,
    ds_bound,
    ds_scale,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

pytestmark = pytest.mark.torch_port

B, H, D = 2, 2, 64
BLOCK_N = 128  # keys per tile of the bf16 forward kernel at D=64


def _inputs(L, masked, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(B, H, L, D)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((B, L), np.int32)
        mask[0, L - 7:] = 0  # padding keys
        mask[0, 0] = 0       # under causal, query row 0 sees no key
        mask[1, :] = 0       # every row of batch 1 fully masked
    return q, k, v, do, mask


def _scores(q, k, mask, causal):
    """fp32 ``q k^T / sqrt(D)`` from bf16 inputs, NEG_INF where forbidden."""
    L = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / D**0.5
    allow = torch.ones(L, L, dtype=torch.bool)
    if causal:
        allow = torch.tril(allow)
    allow = allow[None, None]
    if mask is not None:
        allow = allow & (mask[:, None, None, :] > 0)
    return torch.where(allow, s, torch.full_like(s, NEG_INF))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _fp16(x):
    return x.to(torch.float16).float()


def tc_forward(q, k, v, mask, causal, dtype=torch.bfloat16):
    """The 16-bit forward kernel's arithmetic: an fp32 online softmax over
    tiles of BLOCK_N keys, P rounded to ``dtype`` before ``P V``, l summed
    from the fp32 P. Returns (O in ``dtype``, LSE in fp32)."""
    rnd = _fp16 if dtype == torch.float16 else _bf16
    s = _scores(q, k, mask, causal)
    L = q.shape[2]
    acc = torch.zeros(B, H, L, D)
    m = torch.full((B, H, L), NEG_INF)
    l = torch.zeros(B, H, L)
    for k0 in range(0, L, BLOCK_N):
        st = s[..., k0:k0 + BLOCK_N]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(st > 0.5 * NEG_INF, torch.exp(st - m_new[..., None]),
                        torch.zeros_like(st))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", rnd(p), v[..., k0:k0 + BLOCK_N, :].float())
        m = m_new
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    out = acc / safe_l[..., None]
    lse = torch.where(l > 0, m + torch.log(safe_l), torch.full_like(l, NEG_INF))
    return out.to(dtype), lse


def tc_backward(q, k, v, mask, out, lse, do, causal, dtype=torch.bfloat16,
                scaled=True):
    """The 16-bit backward's arithmetic as the tensor-core kernels compute
    it: dS rounded to ``dtype`` for ``dS K``, P^T and dS^T for ``P^T dO``
    and ``dS^T Q``; in fp16 dS is first multiplied by the power of two of
    ``ds_bound`` (unless ``scaled`` is False) and dQ, dK divided by it.
    Returns (dq, dk, dv) in fp32, each rounded to ``dtype``."""
    rnd = _fp16 if dtype == torch.float16 else _bf16
    scale = 1.0 / D**0.5
    s = _scores(q, k, mask, causal)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    delta = (do.float() * out.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    c = (ds_scale(float(ds_bound(do, v, delta)))
         if dtype == torch.float16 and scaled else 1.0)
    dq = scale / c * torch.einsum("bhqk,bhkd->bhqd", rnd(ds * c), k.float())
    dk = scale / c * torch.einsum("bhqk,bhqd->bhkd", rnd(ds * c), q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", rnd(p), do.float())
    return [rnd(g) for g in (dq, dk, dv)]


def _torch_bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _jax_forward(q, k, v, mask, causal, dtype=jnp.bfloat16):
    j = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    jm = None if mask is None else jnp.asarray(mask)
    out, lse = jax_flash(*j, jm, causal=causal, return_lse=True)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _jax_grads(q, k, v, do, mask, causal, dtype=jnp.bfloat16):
    jm = None if mask is None else jnp.asarray(mask)
    g_out = jnp.asarray(do).astype(dtype).astype(jnp.float32)

    def f(q, k, v):
        q, k, v = (a.astype(dtype) for a in (q, k, v))
        out = jax_flash(q, k, v, jm, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * g_out)

    grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in grads]


def _dead_rows(L, mask, causal):
    """[B, L] query rows with no key to attend."""
    allow = np.ones((L, L), bool)
    if causal:
        allow = np.tril(allow)
    allow = np.broadcast_to(allow, (B, L, L))
    if mask is not None:
        allow = allow & (mask[:, None, :] > 0)
    return ~allow.any(-1)


@pytest.mark.parametrize("L", [64, 300])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_tc_forward_rounding_within_fwd_atol(L, masked, causal):
    q, k, v, _, mask = _inputs(L, masked, seed=L + 2 * masked + causal)
    tq, tk, tv = _torch_bf16(q, k, v)
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = tc_forward(tq, tk, tv, tm, causal)
    j_out, j_lse = _jax_forward(q, k, v, mask, causal)
    assert np.abs(out.float().numpy() - j_out).max() <= FWD_ATOL_BF16
    assert np.abs(lse.numpy() - j_lse).max() <= FWD_ATOL_BF16

    # the rounding is real: P in bf16 moves O off the plain version's
    plain_out, _ = flash_attention_plain(tq, tk, tv, tm, causal)
    assert not torch.equal(out, plain_out)

    dead = np.broadcast_to(_dead_rows(L, mask, causal)[:, None], (B, H, L))
    assert dead.any() == masked
    assert (out.float().numpy()[dead] == 0).all()
    assert (lse.numpy()[dead] == NEG_INF).all()


@pytest.mark.parametrize("L", [64, 300])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_tc_backward_rounding_within_bwd_rtol(L, masked, causal):
    q, k, v, do, mask = _inputs(L, masked, seed=10 + L + 2 * masked + causal)
    tq, tk, tv, tdo = _torch_bf16(q, k, v, do)
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = tc_forward(tq, tk, tv, tm, causal)
    ours = tc_backward(tq, tk, tv, tm, out, lse, tdo, causal)
    theirs = _jax_grads(q, k, v, do, mask, causal)
    for a, b in zip(ours, theirs):
        assert np.abs(a.numpy() - b).max() <= BWD_RTOL_BF16 * np.abs(b).max()

    dq, dk, dv = (g.numpy() for g in ours)
    dead = np.broadcast_to(_dead_rows(L, mask, causal)[:, None], (B, H, L))
    assert (dq[dead] == 0).all()
    if masked:
        # batch 1 attends nothing and its keys are all masked; batch 0's
        # padding keys get no gradient
        assert (dk[1] == 0).all() and (dv[1] == 0).all()
        assert (dk[0, :, L - 7:] == 0).all() and (dv[0, :, L - 7:] == 0).all()


@pytest.mark.parametrize("L", [64, 300])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_tc_dkv_rounding_within_row_rtol(L, masked, causal):
    """The bf16 rounding of P^T and dS^T keeps every key row of dK and dV
    within BWD_ROW_RTOL_BF16 of the plain version's; a dK/dV that drops
    the second half of the keys does not pass."""
    q, k, v, do, mask = _inputs(L, masked, seed=20 + L + 2 * masked + causal)
    tq, tk, tv, tdo = _torch_bf16(q, k, v, do)
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_attention_plain(tq, tk, tv, tm, causal)
    _, dk, dv = tc_backward(tq, tk, tv, tm, out, lse, tdo, causal)
    _, rdk, rdv = flash_attention_bwd_plain(tq, tk, tv, tm, out, lse, tdo,
                                            None, causal)
    for ours, plain in ((dk, rdk), (dv, rdv)):
        assert bwd_row_err(ours, plain) <= BWD_ROW_RTOL_BF16
        halved = ours.clone()
        halved[..., L // 2:, :] = 0
        assert bwd_row_err(halved, plain) > BWD_ROW_RTOL_BF16


@pytest.mark.parametrize("L", [64, 300])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_tc_dq_rounding_within_row_rtol(L, masked, causal):
    """The bf16 rounding of dS keeps every query row of dQ within
    BWD_ROW_RTOL_BF16 of the plain version's, the rows whose exact
    gradient is ~0 included (the first causal row; row 1 where key 0 is
    masked), and fully masked rows exactly zero; a dQ that drops the
    second half of the queries does not pass, nor does a noise-sized
    row in a head whose plain rows are all zero."""
    q, k, v, do, mask = _inputs(L, masked, seed=30 + L + 2 * masked + causal)
    tq, tk, tv, tdo = _torch_bf16(q, k, v, do)
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_attention_plain(tq, tk, tv, tm, causal)
    dq, _, _ = tc_backward(tq, tk, tv, tm, out, lse, tdo, causal)
    rdq, _, _ = flash_attention_bwd_plain(tq, tk, tv, tm, out, lse, tdo, None,
                                          causal)
    assert bwd_row_err(dq, rdq) <= BWD_ROW_RTOL_BF16
    dead = torch.from_numpy(_dead_rows(L, mask, causal))[:, None]
    assert (dq[dead.expand(B, H, L)] == 0).all()
    halved = dq.clone()
    halved[..., L // 2:, :] = 0
    assert bwd_row_err(halved, rdq) > BWD_ROW_RTOL_BF16
    if masked:
        # batch 1's plain rows are all zero: any nonzero row fails
        noisy = dq.clone()
        noisy[1, 0, L - 1, 0] = 1e-8
        assert bwd_row_err(noisy, rdq) == float("inf")


#: dO magnitudes of the fp16 cases: dO x 2^16 as chip_smoke.py's scaled
#: case (N(0, 2^-10) times the starting loss scale), and one that puts the
#: largest |dS| near the GPT-base fp16 step's ~2e-4 (PERF.md), most of dS
#: in fp16's subnormal range
FP16_DO = {"scaled": 2.0**-10 * 2.0**16, "step": 2.0**-14}


def _torch_fp16(*arrays):
    return [torch.from_numpy(a).to(torch.float16) for a in arrays]


@pytest.mark.parametrize("L", [64, 300])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_fp16_forward_rounding_within_fwd_atol(L, masked, causal):
    """P rounded to fp16 keeps O and the LSE within FWD_ATOL_FP16 of the
    JAX kernel's fp16 forward; fully masked rows stay exactly zero."""
    q, k, v, _, mask = _inputs(L, masked, seed=40 + L + 2 * masked + causal)
    tq, tk, tv = _torch_fp16(q, k, v)
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = tc_forward(tq, tk, tv, tm, causal, torch.float16)
    j_out, j_lse = _jax_forward(q, k, v, mask, causal, jnp.float16)
    assert out.dtype == torch.float16
    assert np.abs(out.float().numpy() - j_out).max() <= FWD_ATOL_FP16
    assert np.abs(lse.numpy() - j_lse).max() <= FWD_ATOL_FP16
    dead = np.broadcast_to(_dead_rows(L, mask, causal)[:, None], (B, H, L))
    assert (out.float().numpy()[dead] == 0).all()


@pytest.mark.parametrize("L", [64, 300])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("magnitude", sorted(FP16_DO))
def test_fp16_backward_rounding_within_row_rtol(L, masked, magnitude):
    """dS rounded to fp16 after its power-of-two scaling, as the kernels
    compute it, keeps every row of dQ, dK and dV within BWD_ROW_RTOL_BF16
    of the JAX kernel's gradients (fp32 dS, fp16 outputs), finite at dO x
    2^16. At the training step's magnitude, over the 300-key rows, the
    same rounding without the scaling breaks the row bound. (Much further
    down, the fp16 outputs themselves turn subnormal, in the JAX kernel as
    in these, and no row bound holds.)"""
    q, k, v, do, mask = _inputs(L, masked, seed=50 + L + 2 * masked)
    do = do * FP16_DO[magnitude]
    tq, tk, tv, tdo = _torch_fp16(q, k, v, do)
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = tc_forward(tq, tk, tv, tm, True, torch.float16)
    ours = tc_backward(tq, tk, tv, tm, out, lse, tdo, True, torch.float16)
    theirs = [torch.from_numpy(np.array(g)) for g in
              _jax_grads(q, k, v, do, mask, True, jnp.float16)]
    for a, b in zip(ours, theirs):
        assert torch.isfinite(a).all()
        assert bwd_row_err(a, b) <= BWD_ROW_RTOL_BF16
    dead = torch.from_numpy(_dead_rows(L, mask, True))[:, None]
    assert (ours[0][dead.expand(B, H, L)] == 0).all()
    if magnitude == "step" and L == 300:
        plain = tc_backward(tq, tk, tv, tm, out, lse, tdo, True,
                            torch.float16, scaled=False)
        assert max(bwd_row_err(a, b) for a, b in
                   zip(plain[:2], theirs[:2])) > BWD_ROW_RTOL_BF16
