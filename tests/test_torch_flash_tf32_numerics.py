"""The fp32 contract admits the 3xTF32 split of the fp32 flash kernels.

The fp32 forward, dQ and dK/dV kernels (``csrc/flash_fwd.cu``,
``flash_fwd_tf32x3_kernel``; ``csrc/flash_bwd.cu``,
``flash_bwd_dq_tf32x3_kernel`` and ``flash_bwd_dkv_tf32x3_kernel``) compute
every product on the tensor cores from TF32 operands: each fp32 operand x
is split into ``big = tf32(x)`` and ``small = tf32(x - big)``, and a product
is ``a_small b_big + a_big b_small + a_big b_big`` summed in fp32. This
file emulates that on the CPU (TF32 rounding on the int32 bits, to nearest
with ties away from zero, as ``cvt.rna.tf32.f32`` rounds), through the
kernels' products tile by tile (32-row tiles), and holds dQ, dK and
dV against ``jax.grad`` of the JAX package's ``flash_attention`` (Pallas in
interpret mode off the TPU) on the same numpy inputs, at the tolerance the
fp32 plain version is held to in ``tests/test_torch_flash_bwd.py`` (rtol
1e-4, atol 1e-5), unchanged. The forward is emulated the same way, q tile
by q tile and k tile by k tile (its online softmax in log2 units, P split
like any other operand, each tile's P V in a fresh sum), and O and LSE are
held against the JAX package's forward at the tolerance
``tests/test_torch_flash.py`` holds the plain version to (atol 1e-5). One
TF32 rounding per operand (1xTF32) does not pass either, which is why the
kernels split. Fully masked rows stay exactly zero (and LSE -1e30).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoke_tpu.ops.flash_attention import flash_attention as jax_flash
from stoke_tpu_torch.ops import NEG_INF, flash_attention_plain

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its small tensors gain nothing
    from more, and beside the suite's other workers each spare thread
    spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-4, 1e-5
FWD_ATOL = 1e-5  # tests/test_torch_flash.py's tolerance for the forward
B, H, D = 2, 2, 64
# q rows a step of the dK/dV kernel, k rows of the dQ kernel's and the
# forward kernel's streamed tiles
TILE = 32
FWD_Q_TILE = 64  # q rows of a forward CTA
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


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


def tf32(x):
    """fp32 rounded to TF32 (10 mantissa bits): to nearest on the
    magnitude's bits, ties away from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """``a @ b`` (batched) as the kernels compute it: 3xTF32."""
    a_big, b_big = tf32(a), tf32(b)
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm1(a, b):
    """``a @ b`` with each operand rounded to TF32 once."""
    return tf32(a) @ tf32(b)


def _allowed(L, mask, causal):
    allow = torch.ones(L, L, dtype=torch.bool)
    if causal:
        allow = torch.tril(allow)
    allow = allow[None, None]
    if mask is not None:
        allow = allow & (mask[:, None, None, :] > 0)
    return allow.expand(B, H, L, L)


def tf32x_backward(q, k, v, mask, out, lse, do, causal, mm=mm3):
    """dQ, dK and dV through the fp32 kernels' products, each tile's sum
    added to the running fp32 sum. dK/dV: per tile of TILE query rows,
    S^T = K Q^T and dP^T = V dO^T, P^T and dS^T, dV += P^T dO and dK +=
    dS^T Q. dQ: per tile of TILE keys, S = Q K^T and dP = dO V^T, dS, dQ +=
    dS K."""
    L = q.shape[2]
    scale = 1.0 / D**0.5
    allow = _allowed(L, mask, causal)
    delta = (do * out).sum(-1)
    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)
    for t0 in range(0, L, TILE):
        t = slice(t0, t0 + TILE)
        # dK/dV over the q tile t
        st = mm(k, q[:, :, t].transpose(-1, -2))
        ok = allow[:, :, t].transpose(-1, -2)
        pt = torch.where(ok, torch.exp(st * scale - lse[:, :, None, t]), 0.0)
        dpt = mm(v, do[:, :, t].transpose(-1, -2))
        dst = pt * (dpt - delta[:, :, None, t])
        dv += mm(pt, do[:, :, t])
        dk += mm(dst, q[:, :, t])
        # dQ over the k tile t
        s = mm(q, k[:, :, t].transpose(-1, -2))
        p = torch.where(allow[..., t], torch.exp(s * scale - lse[..., None]),
                        0.0)
        dp = mm(do, v[:, :, t].transpose(-1, -2))
        dq += mm(p * (dp - delta[..., None]), k[:, :, t])
    return dq * scale, dk * scale, dv


def _jax_grads(q, k, v, do, mask, causal):
    jm = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jnp.sum(jax_flash(q, k, v, jm, causal=causal) * do)

    grads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in grads]


def _ours(q, k, v, do, mask, causal, mm):
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = flash_attention_plain(tq, tk, tv, tm, causal)
    return [g.numpy() for g in tf32x_backward(tq, tk, tv, tm, out, lse, tdo,
                                              causal, mm)]


@pytest.mark.parametrize("L", [64, 300])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_backward_within_fp32_tolerance(L, masked, causal):
    q, k, v, do, mask = _inputs(L, masked, seed=40 + L + 2 * masked + causal)
    ours = _ours(q, k, v, do, mask, causal, mm3)
    theirs = _jax_grads(q, k, v, do, mask, causal)
    for name, a, b in zip(("dq", "dk", "dv"), ours, theirs):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)

    dq, dk, dv = ours
    allow = _allowed(L, None if mask is None else torch.from_numpy(mask),
                     causal).numpy()
    dead = ~allow.any(-1)  # [B, H, L] query rows with no key
    assert dead.any() == masked
    assert (dq[dead] == 0).all()
    if masked:
        # batch 1's keys are all masked, batch 0's last 7 are padding
        assert (dk[1] == 0).all() and (dv[1] == 0).all()
        assert (dk[0, :, L - 7:] == 0).all() and (dv[0, :, L - 7:] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_tf32x1_backward_fails_fp32_tolerance(causal):
    """Each operand rounded to TF32 once moves dQ, dK and dV by ~1e-3:
    outside the fp32 tolerance the 3xTF32 split keeps."""
    q, k, v, do, mask = _inputs(64, False, seed=60 + causal)
    ours = _ours(q, k, v, do, mask, causal, mm1)
    theirs = _jax_grads(q, k, v, do, mask, causal)
    for a, b in zip(ours, theirs):
        assert not np.allclose(a, b, rtol=RTOL, atol=ATOL)
        assert np.abs(a - b).max() > 10 * ATOL


# --------------------------------------------------------------------------- #
# the forward
# --------------------------------------------------------------------------- #


def tf32x_forward(q, k, v, mask, causal, mm=mm3):
    """O and LSE through the fp32 forward kernel's arithmetic: per q tile
    of FWD_Q_TILE rows, the k tiles of TILE keys (under causal, up to the
    last one that touches the tile's diagonal), S = Q K^T, the online
    softmax in log2 units with p = 0 at the sentinel, and each tile's P V
    summed fresh and added to the rescaled O."""
    q_tile = FWD_Q_TILE
    L = q.shape[2]
    scale_log2 = LOG2E / D**0.5
    allow = _allowed(L, mask, causal)
    out, lse = torch.zeros_like(q), torch.empty(B, H, L)
    for q0 in range(0, L, q_tile):
        qs = slice(q0, q0 + q_tile)
        rows = q[:, :, qs]
        m = torch.full((*rows.shape[:3], 1), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(rows)
        for k0 in range(0, min(L, q0 + q_tile) if causal else L, TILE):
            ks = slice(k0, k0 + TILE)
            s = mm(rows, k[:, :, ks].transpose(-1, -2))
            s = torch.where(allow[:, :, qs, ks], s * scale_log2, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.where(s > 0.5 * NEG_INF, torch.exp2(s - m_new), 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + mm(p, v[:, :, ks])
            m = m_new
        out[:, :, qs] = acc / torch.where(l > 0, l, 1.0)
        lse[:, :, qs] = torch.where(l > 0, m * LN2 + torch.log(l),
                                    NEG_INF)[..., 0]
    return out, lse


def _fwd_case(L, masked, causal, mm, seed):
    q, k, v, _, mask = _inputs(L, masked, seed)
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = tf32x_forward(*(torch.from_numpy(a) for a in (q, k, v)), tm,
                             causal, mm)
    j_out, j_lse = jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                             None if mask is None else jnp.asarray(mask),
                             causal=causal, return_lse=True)
    return out.numpy(), lse.numpy(), np.asarray(j_out), np.asarray(j_lse), tm


@pytest.mark.parametrize("L", [64, 130, 300])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_tf32x3_forward_within_fp32_tolerance(L, masked, causal):
    """L=130 and 300 end mid-tile, L=130 two keys into a third q tile."""
    out, lse, j_out, j_lse, tm = _fwd_case(
        L, masked, causal, mm3, seed=70 + L + 2 * masked + causal)
    np.testing.assert_allclose(out, j_out, atol=FWD_ATOL)
    np.testing.assert_allclose(lse, j_lse, atol=FWD_ATOL)

    dead = ~_allowed(L, tm, causal).numpy().any(-1)  # [B, H, L]
    assert dead.any() == masked
    assert (out[dead] == 0).all() and (lse[dead] == NEG_INF).all()
    assert np.isfinite(out).all()


@pytest.mark.parametrize("causal", [False, True])
def test_tf32x1_forward_fails_fp32_tolerance(causal):
    """Each operand rounded to TF32 once moves O by ~1e-3: outside the
    fp32 tolerance the 3xTF32 split keeps."""
    out, _, j_out, _, _ = _fwd_case(64, False, causal, mm1, seed=90 + causal)
    assert not np.allclose(out, j_out, atol=FWD_ATOL)
    assert np.abs(out - j_out).max() > 10 * FWD_ATOL
