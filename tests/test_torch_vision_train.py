"""Port parity: training a small ResNet through the ``Stoke`` facade.

Both packages start from the JAX package's seeded init of a two-stage
ResNet (basic blocks, 4 filters, the CIFAR stem; the second stage's
stride-2 block has ``conv_proj`` / ``norm_proj``), carried over by
``stoke_tpu_torch.convert.cnn_state_dict_from_jax``, and train on the same
seeded 8x8 images with SGD (lr 0.05, momentum 0.9) and a softmax cross
entropy. The JAX facade carries BatchNorm's ``batch_stats`` from step to
step; the port updates the module's running statistics in place.

Tolerances (relative to the largest magnitude of each tensor; fp32 sums in
different orders):

- fp32: losses, parameters and statistics 1e-5; the port's own paths
  (four calls, ``train_step``, ``train_step_window``, ``train_steps``)
  agree with each other bit for bit;
- bf16 and fp16: statistics and losses within four units of the type's
  roundoff (bf16 2^-7, fp16 2^-10): the two frameworks round the 16-bit
  activations at other places (the convolutions' outputs), a 16-bit ulp
  here and there, and each statistic averages such values. The largest
  seen: bf16 statistics 2.5e-3, losses 1.8e-4; fp16 1.8e-5 and 9.4e-6.
  Without Queue 3 item 1's repair the port's statistics would not move
  at all.
"""

import jax
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import stoke_tpu
from stoke_tpu.models.resnet import BasicBlock as JaxBasicBlock
from stoke_tpu.models.resnet import ResNet as JaxResNet
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.convert import cnn_state_dict_from_jax
from stoke_tpu_torch.models.resnet import BasicBlock, ResNet

pytestmark = pytest.mark.torch_port

BATCH, SIDE, CLASSES = 8, 8, 10
LR, MOMENTUM = 0.05, 0.9
FP32_TOL = 1e-5
HALF_TOL = {"bf16": 2.0**-7, "fp16": 2.0**-10}
STATS = ("running_mean", "running_var")


def _jax_model():
    return JaxResNet(stage_sizes=(1, 1), block=JaxBasicBlock,
                     num_classes=CLASSES, num_filters=4, cifar_stem=True)


def _port_model():
    return ResNet(stage_sizes=(1, 1), block=BasicBlock, num_classes=CLASSES,
                  num_filters=4, cifar_stem=True)


@pytest.fixture(scope="module")
def variables():
    v = init_module(_jax_model(), jax.random.PRNGKey(0),
                    np.zeros((2, SIDE, SIDE, 3), np.float32), train=False)
    return jax.tree_util.tree_map(np.asarray, v)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, BATCH, SIDE, SIDE, 3)).astype(np.float32)
    ys = rng.integers(0, CLASSES, size=(n, BATCH)).astype(np.int32)
    return xs, ys


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _jax_ce(logits, y):
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


def _ce(logits, y):
    return F.cross_entropy(logits.float(), y.long())


def _run_jax(variables, n, grad_accum=1, precision=None):
    s = stoke_tpu.Stoke(
        _jax_model(), stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd,
            optimizer_kwargs=dict(learning_rate=LR, momentum=MOMENTUM)),
        _jax_ce, jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=BATCH, grad_accum=grad_accum, device="cpu",
        precision=precision, model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)
    xs, ys = _data(n)
    losses = [float(s.train_step(xs[i], (ys[i],))) for i in range(n)]
    return np.asarray(losses), cnn_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, s.variables))


def _port(variables, grad_accum=1, precision=None, loss=_ce):
    return port.Stoke(
        _port_model(), port.StokeOptimizer(torch.optim.SGD, lr=LR,
                                           momentum=MOMENTUM, dampening=0.0),
        loss, cnn_state_dict_from_jax(variables),
        batch_size_per_device=BATCH, grad_accum=grad_accum, device="cpu",
        precision=precision)


def _drive(s, n, loop):
    """``n`` micro-batches through one of the port's four entry paths;
    returns the per-micro losses as reported."""
    xs, ys = _data(n)
    x, y = _nchw(xs), torch.from_numpy(ys)
    if loop == "train_steps":
        return s.train_steps(x, y).reshape(-1).numpy()
    if loop == "window":
        k = s.grad_accum
        return np.concatenate([s.train_step_window(x[i:i + k], y[i:i + k])
                               .numpy() for i in range(0, n, k)])
    losses = []
    for i in range(n):
        if loop == "train_step":
            loss = s.train_step(x[i], y[i])
        else:
            loss = s.loss(s.model(x[i]), y[i])
            s.backward(loss)
            s.step()
        losses.append(float(loss))
    return np.asarray(losses)


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


def _state(s):
    return {k: v.detach().clone() for k, v in
            s.model_access.state_dict().items()}


def _assert_state_close(got, want, tol, keys=None):
    for k in keys or want:
        assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))


@pytest.fixture(scope="module")
def fp32_reference(variables):
    """JAX's losses and state after 3 fp32 steps."""
    return _run_jax(variables, 3)


@pytest.mark.parametrize("loop", ["train_step", "four_call"])
def test_fp32_training_matches_jax(variables, fp32_reference, loop):
    """3 steps: losses, every parameter and every running statistic."""
    want_losses, want = fp32_reference
    s = _port(variables)
    losses = _drive(s, 3, loop)
    np.testing.assert_allclose(losses, want_losses, rtol=FP32_TOL)
    _assert_state_close(_state(s), want, FP32_TOL)
    first = cnn_state_dict_from_jax(variables)
    assert all(not torch.equal(want[k], first[k])
               for k in want if k.endswith(STATS))


@pytest.fixture(scope="module")
def accum_reference(variables):
    """JAX at grad_accum=2 (3 optimizer steps), and the port's
    ``train_step`` on the same micro-batches."""
    jax_losses, jax_state = _run_jax(variables, 6, grad_accum=2)
    s = _port(variables, grad_accum=2)
    losses = _drive(s, 6, "train_step")
    return jax_losses, jax_state, losses, _state(s)


@pytest.mark.parametrize("loop", ["four_call", "window", "train_steps"])
def test_grad_accum_paths_match_train_step(variables, accum_reference, loop):
    """At grad_accum=2 the four calls, ``train_step_window`` and
    ``train_steps`` give ``train_step``'s losses, parameters and
    statistics bit for bit, and those match JAX's."""
    jax_losses, jax_state, ref_losses, ref_state = accum_reference
    s = _port(variables, grad_accum=2)
    losses = _drive(s, 6, loop)
    assert (s.optimizer_steps, s.backward_steps) == (3, 6)
    np.testing.assert_array_equal(losses, ref_losses)
    state = _state(s)
    for k in ref_state:
        assert torch.equal(state[k], ref_state[k]), k
    np.testing.assert_allclose(losses, jax_losses, rtol=FP32_TOL)
    _assert_state_close(state, jax_state, FP32_TOL)


@pytest.mark.parametrize("precision", ["bf16", "fp16"])
def test_16bit_batch_stats_move_and_match_jax(variables, precision):
    """The regression test of Queue 3 item 1: after 16-bit steps the
    running statistics moved, stayed fp32, and match JAX's
    ``batch_stats``."""
    want_losses, want = _run_jax(variables, 3, precision=precision)
    s = _port(variables, precision=precision)
    losses = _drive(s, 3, "train_step")
    np.testing.assert_allclose(losses, want_losses,
                               rtol=HALF_TOL[precision])
    state, first = _state(s), cnn_state_dict_from_jax(variables)
    stats = [k for k in state if k.endswith(STATS)]
    assert len(stats) == 2 * 6  # norm_init, 2 blocks x 2, norm_proj
    for k in stats:
        assert state[k].dtype == torch.float32
        assert not torch.equal(state[k], first[k]), k
    _assert_state_close(state, want, HALF_TOL[precision], stats)


@pytest.mark.parametrize("loop", ["train_step", "window"])
def test_fp16_inf_window_keeps_batch_stats(variables, loop):
    """A window whose loss is inf: parameters and SGD's momentum buffers
    stay bit for bit and the scale halves, while the forward's running
    statistics stay updated, as the JAX apply keeps ``batch_stats``: they
    equal those of the same window with a finite loss."""
    boom = {"a": torch.ones(()), "b": torch.ones(())}

    def scaled(name):
        return lambda logits, y: _ce(logits, y) * boom[name]

    a = _port(variables, precision="fp16", loss=scaled("a"))
    b = _port(variables, precision="fp16", loss=scaled("b"))
    _drive(a, 1, loop)
    _drive(b, 1, loop)
    params = {n: p.detach().clone()
              for n, p in a.model_access.named_parameters()}
    momenta = {n: a.optimizer.state[p]["momentum_buffer"].clone()
               for n, p in a.model_access.named_parameters()}
    stats = {k: v for k, v in _state(a).items() if k.endswith(STATS)}
    boom["a"].fill_(float("inf"))
    scale = a.loss_scale
    _drive(a, 1, loop)
    _drive(b, 1, loop)
    for n, p in a.model_access.named_parameters():
        assert torch.equal(p, params[n]), n
        assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                           momenta[n]), n
    assert a.loss_scale == scale / 2
    assert a.skipped_optimizer_steps == 1.0
    after_a, after_b = _state(a), _state(b)
    for k in stats:
        assert not torch.equal(after_a[k], stats[k]), k
        assert torch.equal(after_a[k], after_b[k]), k
