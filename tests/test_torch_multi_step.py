"""Port parity: ``train_step_window`` and ``train_steps``.

``tests/test_multi_step.py`` is the spec: n windows of ``grad_accum``
micro-batches compute what the same micro-batches through ``train_step``
compute (parameters rtol 1e-4, atol 1e-6, the JAX test's), the loss EMA
advances once a window with its mean as ``train_step_window``'s does (rtol
1e-5), the reports stack to ``[n, grad_accum]``, ``segment_size`` chunks
give the single call's numbers, and the refusals and the memory guard
carry the JAX package's messages. On the CPU each window runs eagerly
(the CUDA graph is the card's; ``chip_smoke.py`` holds it to the eager
step). One trajectory holds the port's ``train_steps`` against the JAX
package's on GPT-tiny from the same weights, at ``test_torch_train.py``'s
AdamW tolerances: losses rtol 1e-3; parameters within 2e-5 wherever the
gradient stayed >= 1e-5 at every step, within 2 lr a step elsewhere.
"""

import jax
import numpy as np
import optax
import pytest
import torch

import stoke_tpu
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.gpt import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.ops import make_flash_attention as jax_make_flash
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.facade import _check_segment_memory, _device_memory_stats
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.ops import make_flash_attention

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


VOCAB, L, BATCH = 257, 32, 4
ADAM_LR, ADAM_PARAM_ATOL, ADAM_SMALL_GRAD = 1e-2, 2e-5, 1e-5


def _corpus(n):
    return np.random.default_rng(0).integers(0, VOCAB, size=(n, L)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_init():
    model = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                   dropout_rate=0.0, attention_fn=jax_make_flash(causal=True),
                   attention_is_causal=True)
    variables = init_module(model, jax.random.PRNGKey(0), _corpus(2),
                            train=False)
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _make(jax_init, grad_accum=1, **kw):
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                dropout_rate=0.0,
                attention_fn=make_flash_attention(causal=True),
                attention_is_causal=True)
    return port.Stoke(
        model, port.StokeOptimizer(torch.optim.AdamW, lr=ADAM_LR,
                                   weight_decay=1e-4),
        causal_lm_loss, gpt_state_dict_from_jax(jax_init[1]["params"]),
        batch_size_per_device=BATCH, grad_accum=grad_accum, device="cpu",
        grad_clip=port.ClipGradNormConfig(max_norm=0.5), **kw)


def _stack(n_micro):
    return _corpus(n_micro * BATCH).reshape(n_micro, BATCH, L)


def _params(s):
    return {n: p.detach().clone() for n, p in
            s.model_access.named_parameters()}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_matches_eager(jax_init, grad_accum):
    n_steps = 3
    total = n_steps * grad_accum
    xs = _stack(total)
    a = _make(jax_init, grad_accum)
    for i in range(total):
        a.train_step(xs[i], xs[i])
    b = _make(jax_init, grad_accum)
    reports = b.train_steps(xs, xs)
    assert b.optimizer_steps == a.optimizer_steps == n_steps
    assert b.backward_steps == a.backward_steps == total
    assert tuple(reports.shape) == (n_steps, grad_accum)
    pa, pb = _params(a), _params(b)
    for name in pa:
        torch.testing.assert_close(pb[name], pa[name], rtol=1e-4, atol=1e-6)
    # the EMA advances once a window with its mean: as train_step_window
    c = _make(jax_init, grad_accum)
    for i in range(n_steps):
        window = xs[i * grad_accum:(i + 1) * grad_accum]
        c.train_step_window(window, window)
    assert b.ema_loss == pytest.approx(c.ema_loss, rel=1e-5)
    assert b.step_loss == pytest.approx(c.step_loss, rel=1e-5)


def test_train_step_window_matches_four_call(jax_init):
    k = 3
    xs = _stack(k)
    s1 = _make(jax_init, k)
    losses = []
    for x in xs:
        loss = s1.loss(s1.model(x), x)
        s1.backward(loss)
        s1.step()
        losses.append(float(loss))
    s2 = _make(jax_init, k)
    reports = s2.train_step_window(xs, xs)
    assert tuple(reports.shape) == (k,)
    np.testing.assert_allclose(reports.numpy(), losses, rtol=1e-5)
    assert (s2.optimizer_steps, s2.backward_steps,
            s2.grad_accum_counter) == (1, k, 0)
    pa, pb = _params(s1), _params(s2)
    for name in pa:
        torch.testing.assert_close(pb[name], pa[name], rtol=1e-6, atol=1e-7)


def test_train_steps_rejects_bad_stacks(jax_init):
    s = _make(jax_init, 2)
    xs = _stack(3)  # 3 % 2 != 0
    with pytest.raises(ValueError, match="multiple of grad_accum"):
        s.train_steps(xs, xs)
    with pytest.raises(ValueError, match="disagree"):
        s.train_steps(_stack(4), _stack(2))
    with pytest.raises(ValueError, match="segment_size"):
        s.train_steps(_stack(4), _stack(4), segment_size=0)
    with pytest.raises(ValueError, match=r"\[grad_accum=2"):
        s.train_step_window(_stack(3), _stack(3))
    assert s.optimizer_steps == 0


def test_window_entry_points_refuse_mid_window_and_eval(jax_init):
    s = _make(jax_init, 2)
    x = _stack(1)[0]
    s.train_step(x, x)  # half a window
    xs = np.stack([x, x])
    for call in (s.train_steps, s.train_step_window):
        with pytest.raises(RuntimeError, match="boundary"):
            call(xs, xs)
    s.reset()
    assert s.grad_accum_counter == 0
    assert all(p.grad is None for p in s.model_access.parameters())
    s.train_steps(xs, xs)
    assert s.optimizer_steps == 1
    s.eval()
    with pytest.raises(RuntimeError, match="eval mode"):
        s.train_steps(xs, xs)


def test_train_steps_chunked_matches_full(jax_init):
    grad_accum, n_steps = 2, 4
    xs = _stack(n_steps * grad_accum)
    a = _make(jax_init, grad_accum)
    ra = a.train_steps(xs, xs)
    b = _make(jax_init, grad_accum)
    rb = b.train_steps(xs, xs, segment_size=3)  # chunks of 3 and 1 steps
    assert b.optimizer_steps == a.optimizer_steps == n_steps
    assert b.backward_steps == a.backward_steps == n_steps * grad_accum
    assert ra.shape == rb.shape == (n_steps, grad_accum)
    torch.testing.assert_close(rb, ra, rtol=1e-5, atol=1e-7)
    pa, pb = _params(a), _params(b)
    for name in pa:
        torch.testing.assert_close(pb[name], pa[name], rtol=1e-5, atol=1e-7)
    assert b.ema_loss == pytest.approx(a.ema_loss, rel=1e-5)
    c = _make(jax_init, grad_accum)
    c.train_steps(xs, xs, segment_size=99)  # >= n: one segment
    assert c.optimizer_steps == n_steps


def test_segment_memory_guard():
    """The guard raises when the stacked inputs alone exceed 90% of free
    device memory and stays quiet otherwise; the CPU has no stats."""
    assert _device_memory_stats(torch.device("cpu")) is None
    _check_segment_memory(10**12, None)
    _check_segment_memory(1_000,
                          {"bytes_limit": 1_000_000, "bytes_in_use": 100_000})
    with pytest.raises(ValueError, match="segment_size"):
        _check_segment_memory(
            950_000, {"bytes_limit": 1_000_000, "bytes_in_use": 500_000})


def test_train_steps_trajectory_matches_jax(jax_init):
    """``train_steps`` in both packages over the same 8 micro-batches at
    ``grad_accum=2`` (4 optimizer steps), AdamW with norm clipping. The
    port's per-step gradients come from its eager loop, which computes the
    same as its ``train_steps`` on the CPU (asserted)."""
    grad_accum, n_steps = 2, 4
    xs = _stack(n_steps * grad_accum)
    model, variables = jax_init
    js = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.adamw,
            optimizer_kwargs=dict(learning_rate=ADAM_LR, b1=0.9, b2=0.999,
                                  eps=1e-8, weight_decay=1e-4)),
        jax_causal_lm_loss, jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=BATCH, grad_accum=grad_accum, device="cpu",
        grad_clip=stoke_tpu.ClipGradNormConfig(max_norm=0.5),
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)
    theirs = np.asarray(js.train_steps(xs, (xs,)))
    ref = gpt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         js.params))
    ps = _make(jax_init, grad_accum)
    ours = ps.train_steps(xs, xs)
    assert ours.shape == theirs.shape == (n_steps, grad_accum)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-3)

    eager = _make(jax_init, grad_accum)
    small = None
    for i in range(n_steps * grad_accum):
        loss = eager.loss(eager.model(xs[i]), xs[i])
        eager.backward(loss)
        if i % grad_accum == grad_accum - 1:
            below = {n: p.grad.abs() < ADAM_SMALL_GRAD
                     for n, p in eager.model_access.named_parameters()}
            small = below if small is None else {
                n: small[n] | below[n] for n in small}
        eager.step()
    params, eager_params = _params(ps), _params(eager)
    for name, p in params.items():
        assert torch.equal(p, eager_params[name]), name
        gap, few = (p - ref[name]).abs().numpy(), small[name].numpy()
        assert gap[~few].max(initial=0.0) <= ADAM_PARAM_ATOL, name
        assert gap[few].max(initial=0.0) <= 2 * ADAM_LR * n_steps, name
