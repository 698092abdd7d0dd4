"""Port parity: fp16 and its dynamic loss scaler.

``tests/test_per_loss_scaler.py`` and the fp16 cases of
``tests/test_facade.py`` and ``tests/test_engine.py`` are the spec. The
port's scaler (``stoke_tpu_torch.engine.init_scaler_state`` and
``scaler_update``) must give the JAX package's ``_scaler_update``
trajectory exactly, ``min_scale`` floor included; a step whose gradients
are not finite is skipped with every parameter and optimizer state tensor
bit for bit as it was, and the scale backs off; per-loss scalers isolate
an overflowing loss. Tolerances: the scaler exactly; the linear model's
per-loss against single-scaler parameters at fp16's epsilon (rtol 2e-3,
atol 2e-4, the JAX test's); fp16 GPT-tiny losses against the JAX package
at FP16_LOSS_RTOL (both run the whole model in float16 and round at other
places: the JAX package's Pallas kernels against the port's plain
versions, XLA's fusions against eager ops).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import stoke_tpu
from stoke_tpu.configs import PrecisionConfig as JaxPrecisionConfig
from stoke_tpu.engine import _scaler_update as jax_scaler_update
from stoke_tpu.engine import init_scaler_state as jax_init_scaler_state
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.gpt import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.ops import make_flash_attention as jax_make_flash
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.configs import PrecisionConfig, PrecisionOptions
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.engine import (
    PrecisionPolicy,
    init_scaler_state,
    scaler_update,
)
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.ops import make_flash_attention
from stoke_tpu_torch.status import StokeStatus, StokeValidationError

pytestmark = pytest.mark.torch_port

#: fp16 GPT-tiny losses, port against the JAX package, relative: the run
#: shows 1.5e-4 at most over its 4 steps; 5e-4 leaves a 3x margin
FP16_LOSS_RTOL = 5e-4

SCALER = dict(init_scale=16.0, growth_factor=2.0, backoff_factor=0.5,
              growth_interval=3, min_scale=1.0)


def _flags(n, seed, shape=()):
    return np.random.default_rng(seed).random((n, *shape)) < 0.6


def test_precision_policy_fp16_scaled():
    p = PrecisionPolicy.make(PrecisionOptions.fp16, PrecisionConfig())
    assert p.compute_dtype == torch.float16 and p.scaled
    assert p.param_dtype == torch.float32 and p.output_dtype == torch.float32
    assert not PrecisionPolicy.make(PrecisionOptions.bf16,
                                    PrecisionConfig()).scaled


@pytest.mark.parametrize("num_losses", [1, 3])
def test_scaler_trajectory_matches_jax_exactly(num_losses):
    """A seeded run of finite and overflowing steps: growth after
    ``growth_interval`` finite steps, back-off on overflow, the floor at
    ``min_scale`` reached; per-loss scalers each on their own flags."""
    shape = () if num_losses == 1 else (num_losses,)
    ours = init_scaler_state(PrecisionConfig(num_losses=num_losses,
                                             **SCALER), torch.device("cpu"))
    jcfg = JaxPrecisionConfig(num_losses=num_losses, **SCALER)
    theirs = jax_init_scaler_state(jcfg)
    floor_hits = 0
    for finite in _flags(60, seed=num_losses, shape=shape):
        ours = {**ours, **scaler_update(ours, torch.as_tensor(finite),
                                        PrecisionConfig(**SCALER))}
        theirs = {**theirs, **jax_scaler_update(theirs, jnp.asarray(finite),
                                                jcfg)}
        np.testing.assert_array_equal(ours["scale"].numpy(),
                                      np.asarray(theirs["scale"]))
        np.testing.assert_array_equal(ours["growth_count"].numpy(),
                                      np.asarray(theirs["growth_count"]))
        assert ours["scale"].dtype == torch.float32
        assert ours["growth_count"].dtype == torch.int32
        floor_hits += int((ours["scale"] == 1.0).sum())
    assert floor_hits  # the min_scale floor was reached


def test_num_losses_requires_fp16():
    with pytest.raises(StokeValidationError, match="num_losses"):
        StokeStatus(batch_size_per_device=8, precision="bf16",
                    configs=[PrecisionConfig(num_losses=2)])
    with pytest.raises(StokeValidationError, match="num_losses"):
        StokeStatus(batch_size_per_device=8, precision="fp16",
                    configs=[PrecisionConfig(num_losses=0)])
    st = StokeStatus(batch_size_per_device=8, precision="fp16",
                     configs=[PrecisionConfig(num_losses=2)])
    assert st.is_scaled_precision


# --------------------------------------------------------------------------- #
# the linear model of tests/test_per_loss_scaler.py, in both packages
# --------------------------------------------------------------------------- #


def _two_losses(out, y):
    return (((out - y) ** 2).mean(), 0.01 * (out ** 2).mean())


def _exploding_second(out, y):
    # loss 1's gradient ~1e35: inf once seeded with the scale
    return (((out - y) ** 2).mean(), 1e35 * (out * y).mean())


def _jax_two_losses(out, y):
    return (jnp.mean((out - y) ** 2), 0.01 * jnp.mean(out ** 2))


def _jax_exploding_second(out, y):
    return (jnp.mean((out - y) ** 2), jnp.float32(1e35) * jnp.mean(out * y))


def _linear_stoke(loss=_two_losses, num_losses=2, scaler_kwargs=None, **kw):
    model = nn.Linear(4, 2)
    nn.init.zeros_(model.weight)
    nn.init.zeros_(model.bias)
    kw.setdefault("precision", "fp16")
    return port.Stoke(
        model, port.StokeOptimizer(torch.optim.SGD, lr=0.2), loss,
        batch_size_per_device=8, device="cpu",
        configs=[PrecisionConfig(num_losses=num_losses,
                                 **(scaler_kwargs or {}))], **kw)


def _jax_linear_stoke(loss=_jax_two_losses, num_losses=2, scaler_kwargs=None,
                      **kw):
    kw.setdefault("precision", "fp16")
    return stoke_tpu.Stoke(
        model=lambda params, x: x @ params["w"] + params["b"],
        optimizer=stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd, optimizer_kwargs={"learning_rate": 0.2}),
        loss=loss,
        params={"w": jnp.zeros((4, 2), jnp.float32),
                "b": jnp.zeros((2,), jnp.float32)},
        batch_size_per_device=8, verbose=False,
        configs=[stoke_tpu.PrecisionConfig(num_losses=num_losses,
                                           **(scaler_kwargs or {}))], **kw)


def _batch(rng, n=8):
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return x, (x @ np.ones((4, 2), np.float32)).astype(np.float32)


def _four_call(s, x, y):
    s.backward(s.loss(s.model(x), y))
    s.step()


def test_scaler_state_is_a_vector_per_loss():
    s = _linear_stoke(num_losses=2)
    assert tuple(s.scaler["scale"].shape) == (2,)
    assert tuple(s.scaler["growth_count"].shape) == (2,)
    assert tuple(s.scaler["finite"].shape) == (2,)
    assert s.loss_scale == [2.0**16, 2.0**16]
    assert _linear_stoke(num_losses=1).loss_scale == 2.0**16


@pytest.mark.parametrize("num_losses", [1, 2])
@pytest.mark.parametrize("precision", ["full", "bf16", "fp16"])
def test_scaler_state_equals_the_jax_facades(precision, num_losses):
    """``Stoke.scaler`` for every precision: the JAX facade's keys, values
    and dtypes exactly (Queue 3 item 2). Per-loss scalers need fp16 in
    both packages."""
    kw = dict(precision=precision, num_losses=num_losses)
    if num_losses > 1 and precision != "fp16":
        with pytest.raises(StokeValidationError, match="num_losses"):
            _linear_stoke(**kw)
        with pytest.raises(stoke_tpu.StokeValidationError,
                           match="num_losses"):
            _jax_linear_stoke(**kw)
        return
    ours, theirs = _linear_stoke(**kw).scaler, _jax_linear_stoke(**kw).scaler
    assert sorted(ours) == sorted(theirs)
    for key, want in theirs.items():
        want = np.asarray(want)
        got = ours[key].cpu().numpy()
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want)


def test_bf16_step_neither_scales_nor_snapshots():
    """The bf16 step with the scaler built: the same losses and parameters
    as the forward, objective and SGD step written out (no loss scale in
    the backward), no snapshot for the fp16 skip, the scaler untouched."""
    rng = np.random.default_rng(3)
    batches = [_batch(rng) for _ in range(3)]
    s = _linear_stoke(loss=lambda out, y: ((out - y) ** 2).mean(),
                      num_losses=1, precision="bf16")
    model = nn.Linear(4, 2)
    nn.init.zeros_(model.weight)
    nn.init.zeros_(model.bias)
    opt = torch.optim.SGD(model.parameters(), lr=0.2)
    for x, y in batches:
        got = s.train_step(x, y)
        params = {n: p.to(torch.bfloat16)
                  for n, p in model.named_parameters()}
        out = torch.func.functional_call(
            model, params, (torch.from_numpy(x).to(torch.bfloat16),))
        want = ((out.float() - torch.from_numpy(y)) ** 2).mean()
        want.backward()
        opt.step()
        opt.zero_grad()
        assert torch.equal(got, want.detach())
    for a, b in zip(s.model_access.parameters(), model.parameters()):
        assert torch.equal(a, b)
    assert s._engine._snapshot == {}
    assert float(s.scaler["scale"]) == 2.0**16
    assert int(s.scaler["growth_count"]) == 0


@pytest.mark.parametrize("loop", ["four_call", "train_step"])
def test_overflow_skips_the_step_bit_for_bit(loop):
    """An overflowing loss skips the step: parameters and optimizer state
    unchanged, the scale halved, one skipped step, as in the JAX package
    (``test_fp16_overflow_skips_step``, ``test_train_step_fp16_skips_on
    _overflow``). One healthy step first, so that SGD has a momentum
    buffer to keep."""
    rng = np.random.default_rng(0)
    healthy, bad = _batch(rng), _batch(rng)
    boom = torch.ones(())

    def loss(out, y):
        return ((out - y) ** 2).mean() * boom

    model = nn.Linear(4, 2)
    s = port.Stoke(model, port.StokeOptimizer(torch.optim.SGD, lr=0.1,
                                              momentum=0.9),
                   loss, batch_size_per_device=8, device="cpu",
                   precision="fp16",
                   configs=[PrecisionConfig(init_scale=2.0**8)])
    run = (_four_call if loop == "four_call"
           else lambda s, x, y: s.train_step(x, y))
    run(s, *healthy)
    before = [p.detach().clone() for p in model.parameters()]
    state = [s.optimizer.state[p]["momentum_buffer"].clone()
             for p in model.parameters()]
    boom.fill_(1e30)
    run(s, *bad)
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    assert all(torch.equal(a, s.optimizer.state[p]["momentum_buffer"])
               for a, p in zip(state, model.parameters()))
    assert s.loss_scale == 2.0**7
    assert s.skipped_optimizer_steps == 1.0

    def jax_loss(out, y):
        return jnp.mean((out - y) ** 2) * 1e30

    js = _jax_linear_stoke(loss=jax_loss, num_losses=1,
                           scaler_kwargs={"init_scale": 2.0**8})
    (_four_call if loop == "four_call"
     else lambda s, x, y: s.train_step(x, y))(js, *bad)
    assert (js.loss_scale, js.skipped_optimizer_steps) == (2.0**7, 1.0)


def test_first_step_overflow_leaves_a_fresh_optimizer():
    """A first step that overflows leaves AdamW's state as it starts:
    step 0, zero moments (optax's initial state); the parameters
    untouched."""
    model = nn.Linear(4, 2)
    s = port.Stoke(model, port.StokeOptimizer(torch.optim.AdamW, lr=0.1),
                   lambda out, y: ((out - y) ** 2).mean() * 1e30,
                   batch_size_per_device=8, device="cpu", precision="fp16")
    before = [p.detach().clone() for p in model.parameters()]
    s.train_step(*_batch(np.random.default_rng(0)))
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    for p in model.parameters():
        assert all(float(v.abs().max()) == 0.0
                   for v in s.optimizer.state[p].values())
    assert s.skipped_optimizer_steps == 1.0


def test_per_loss_overflow_isolated_as_jax():
    """An overflow in loss 1 backs off only scale[1], skips the step and
    leaves the parameters at zero, in both packages."""
    kw = dict(scaler_kwargs={"init_scale": 2.0**8})
    s = _linear_stoke(loss=_exploding_second, **kw)
    js = _jax_linear_stoke(loss=_jax_exploding_second, **kw)
    x, y = _batch(np.random.default_rng(0))
    _four_call(s, x, y)
    _four_call(js, x, y)
    assert s.loss_scale == js.loss_scale == [2.0**8, 2.0**7]
    assert s.skipped_optimizer_steps == js.skipped_optimizer_steps == 1.0
    assert float(s.model_access.weight.detach().abs().max()) == 0.0
    assert bool(s.scaler["finite"].all())  # reset at the apply


def test_per_loss_matches_single_scaler_training():
    """With no overflow, per-loss scaling is the single-scaler objective
    (each loss's scale cancels); the warm-up back-off at 2^16 hits both
    modes alike."""
    rng = np.random.default_rng(0)
    s1, s2 = _linear_stoke(num_losses=1), _linear_stoke(num_losses=2)
    for _ in range(5):
        x, y = _batch(rng)
        for s in (s1, s2):
            _four_call(s, x, y)
    torch.testing.assert_close(s1.model_access.weight,
                               s2.model_access.weight, rtol=2e-3, atol=2e-4)
    assert s2.skipped_optimizer_steps == s1.skipped_optimizer_steps


def test_per_loss_trajectory_matches_jax():
    rng = np.random.default_rng(3)
    s, js = _linear_stoke(), _jax_linear_stoke()
    for _ in range(5):
        x, y = _batch(rng)
        _four_call(s, x, y)
        _four_call(js, x, y)
    assert s.loss_scale == js.loss_scale
    assert s.skipped_optimizer_steps == js.skipped_optimizer_steps
    np.testing.assert_allclose(s.model_access.weight.detach().numpy().T,
                               np.asarray(js.params["w"]), rtol=2e-3,
                               atol=2e-4)


def test_wrong_loss_count_raises():
    s = _linear_stoke(num_losses=3)
    x, y = _batch(np.random.default_rng(0))
    with pytest.raises(ValueError, match="num_losses"):
        s.loss(s.model(x), y)


def test_dropped_pending_loss_leaves_scaler_untouched():
    """Flags commit at backward(): an overflowing loss() that is never
    backpropagated skips nothing and backs off no scale."""
    s = _linear_stoke(loss=_exploding_second,
                      scaler_kwargs={"init_scale": 2.0**8})
    x, y = _batch(np.random.default_rng(0))
    s.loss(s.model(x), y)
    assert s.loss_scale == [2.0**8, 2.0**8]
    assert bool(s.scaler["finite"].all())
    assert s.backward_steps == 0


def test_per_loss_through_train_step_and_window():
    rng = np.random.default_rng(0)
    s = _linear_stoke()
    s.train_step(*_batch(rng))
    assert s.optimizer_steps == 1 and tuple(s.scaler["scale"].shape) == (2,)
    s4 = _linear_stoke(grad_accum=2)
    micro = [_batch(rng) for _ in range(2)]
    reports = s4.train_step_window(np.stack([m[0] for m in micro]),
                                   (np.stack([m[1] for m in micro]),))
    assert s4.optimizer_steps == 1 and s4.backward_steps == 2
    assert tuple(reports[0].shape) == (2,)
    four = _linear_stoke(grad_accum=2)
    for x, y in micro:
        _four_call(four, x, y)
    assert torch.equal(four.model_access.weight, s4.model_access.weight)
    assert four.loss_scale == s4.loss_scale


def test_fp16_training_converges():
    rng = np.random.default_rng(0)
    s = _linear_stoke(loss=lambda out, y: ((out - y) ** 2).mean(),
                      num_losses=1, scaler_kwargs={"init_scale": 2.0**8})
    for _ in range(60):
        _four_call(s, *_batch(rng))
    assert s.ema_loss < 0.05
    assert all(p.dtype == torch.float32 for p in s.model_access.parameters())


# --------------------------------------------------------------------------- #
# GPT-tiny in fp16 against the JAX package
# --------------------------------------------------------------------------- #

VOCAB, L, BATCH, STEPS = 257, 32, 4, 4


def _corpus():
    return np.random.default_rng(0).integers(0, VOCAB, size=(16, L)).astype(
        np.int32)


def test_fp16_gpt_tiny_trajectory_matches_jax():
    """GPT-tiny, fp16 over fp32 masters, flash attention (Pallas in
    interpret mode against the port's plain versions), AdamW, the same
    weights and batches: the losses agree within FP16_LOSS_RTOL and the
    scalers move alike."""
    model = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                   dropout_rate=0.0, attention_fn=jax_make_flash(causal=True),
                   attention_is_causal=True)
    variables = jax.tree_util.tree_map(np.asarray, init_module(
        model, jax.random.PRNGKey(0), _corpus()[:2], train=False))
    js = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.adamw,
            optimizer_kwargs=dict(learning_rate=1e-2, weight_decay=1e-4)),
        jax_causal_lm_loss, jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=BATCH, device="cpu", precision="fp16",
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)
    pm = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L, dropout_rate=0.0,
             attention_fn=make_flash_attention(causal=True),
             attention_is_causal=True)
    ps = port.Stoke(pm, port.StokeOptimizer(torch.optim.AdamW, lr=1e-2,
                                            weight_decay=1e-4),
                    causal_lm_loss,
                    gpt_state_dict_from_jax(variables["params"]),
                    batch_size_per_device=BATCH, device="cpu",
                    precision="fp16")
    batches = _corpus().reshape(STEPS, BATCH, L)
    ours = [float(ps.train_step(b, b)) for b in batches]
    theirs = [float(js.train_step(b, b)) for b in batches]
    np.testing.assert_allclose(ours, theirs, rtol=FP16_LOSS_RTOL)
    assert ps.loss_scale == js.loss_scale
    assert ps.skipped_optimizer_steps == js.skipped_optimizer_steps
