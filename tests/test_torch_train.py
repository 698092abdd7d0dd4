"""Port parity: training GPT-tiny through the ``Stoke`` facade.

Both packages start from the same weights (the JAX package's seeded init,
carried over by ``stoke_tpu_torch.convert.gpt_state_dict_from_jax``), run
flash attention (the JAX kernels in Pallas interpret mode, the port's
plain versions on the CPU), and read the same batches in the same order
(``stoke.DataLoader(ArrayDataset(corpus), shuffle=True, drop_last=True)``
in each). GPT-tiny, vocab 257, L=32, B=4, ``grad_accum=2``, 4 optimizer
steps. Tolerances, on the losses each step reports:

- SGD with momentum (optax ``sgd`` against ``torch.optim.SGD``, dampening
  0), fp32: losses rtol 1e-5, parameters atol 1e-5 (fp32 sums in
  different orders);
- AdamW with norm clipping, fp32: losses rtol 1e-3; the accumulated
  gradients of step 1 within 1e-5 of the largest element; parameters
  within atol 2e-5 wherever the gradient stayed >= 1e-5 (1000 x Adam's
  eps) at every step. Elsewhere Adam's ``m / (sqrt(v) + eps)`` turns the
  last bits of a gradient near eps into a step of up to ~lr, in either
  package: chiefly the attention key bias, whose exact gradient is 0
  (softmax ignores a shift shared by a query's scores);
- bf16: losses rtol 2e-2 (the two frameworks round bf16 at other places).

SGD runs both loops (the four calls and ``train_step``); AdamW and bf16
run the four calls, which the JAX package compiles into fewer programs.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

import stoke_tpu
from stoke_tpu.data import StokeDataLoader as JaxLoader
from stoke_tpu.engine import clip_gradients as jax_clip
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.gpt import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.ops import make_flash_attention as jax_make_flash
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.engine import clip_gradients
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


VOCAB, L, BATCH, ACCUM, MICRO = 257, 32, 4, 2, 8


def _corpus():
    return np.random.default_rng(0).integers(0, VOCAB, size=(64, L)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_init():
    model = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                   dropout_rate=0.0,
                   attention_fn=jax_make_flash(causal=True),
                   attention_is_causal=True)
    variables = init_module(model, jax.random.PRNGKey(0), _corpus()[:2],
                            train=False)
    return model, jax.tree_util.tree_map(np.asarray, variables)


OPTIMIZERS = {
    "sgd": (
        lambda: stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd,
            optimizer_kwargs=dict(learning_rate=0.1, momentum=0.9)),
        lambda: port.StokeOptimizer(torch.optim.SGD, lr=0.1, momentum=0.9,
                                    dampening=0.0),
    ),
    "adamw": (
        lambda: stoke_tpu.StokeOptimizer(
            optimizer=optax.adamw,
            optimizer_kwargs=dict(learning_rate=1e-2, b1=0.9, b2=0.999,
                                  eps=1e-8, weight_decay=1e-4)),
        lambda: port.StokeOptimizer(torch.optim.AdamW, lr=1e-2,
                                    betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=1e-4),
    ),
}


def _drive(s, loader, loop):
    losses = []
    for i, batch in enumerate(loader):
        if i == MICRO:
            break
        if loop == "train_step":
            loss = s.train_step(batch, batch)
        else:
            loss = s.loss(s.model(batch), batch)
            s.backward(loss)
            s.step()
        losses.append(float(loss))
    return np.asarray(losses)


def _run_jax(jax_init, opt, loop, precision=None, clip=None):
    model, variables = jax_init
    s = stoke_tpu.Stoke(
        model, OPTIMIZERS[opt][0](), jax_causal_lm_loss,
        jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=BATCH, grad_accum=ACCUM, device="cpu",
        precision=precision,
        grad_clip=None if clip is None else stoke_tpu.ClipGradNormConfig(
            max_norm=clip),
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False,
    )
    loader = s.DataLoader(stoke_tpu.ArrayDataset(_corpus()), shuffle=True,
                          drop_last=True)
    losses = _drive(s, loader, loop)
    assert s.optimizer_steps == MICRO // ACCUM
    return losses, gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, s.params))


def _run_port(jax_init, opt, loop, precision=None, clip=None):
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                dropout_rate=0.0,
                attention_fn=make_flash_attention(causal=True),
                attention_is_causal=True)
    s = port.Stoke(
        model, OPTIMIZERS[opt][1](), causal_lm_loss,
        gpt_state_dict_from_jax(jax_init[1]["params"]),
        batch_size_per_device=BATCH, grad_accum=ACCUM, device="cpu",
        precision=precision,
        grad_clip=None if clip is None else port.ClipGradNormConfig(
            max_norm=clip),
    )
    loader = s.DataLoader(port.ArrayDataset(_corpus()), shuffle=True,
                          drop_last=True)
    losses = _drive(s, loader, loop)
    assert (s.optimizer_steps, s.backward_steps) == (MICRO // ACCUM, MICRO)
    return losses, {k: v.detach() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("loop", ["four_call", "train_step"])
def test_sgd_trajectory_matches_jax(jax_init, loop):
    ref_losses, ref_params = _run_jax(jax_init, "sgd", loop)
    losses, params = _run_port(jax_init, "sgd", loop)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    for name, p in params.items():
        np.testing.assert_allclose(p.numpy(), ref_params[name].numpy(),
                                   atol=1e-5, err_msg=name)
    # the weights moved: the comparison is not of two untouched inits
    init = gpt_state_dict_from_jax(jax_init[1]["params"])
    assert not torch.allclose(params["tok_emb.weight"], init["tok_emb.weight"])


#: AdamW tolerances: gradients relative to the largest element; parameters
#: where |grad| >= ADAM_SMALL_GRAD at every step so far
ADAM_GRAD_RTOL = 1e-5
ADAM_PARAM_ATOL = 2e-5
ADAM_SMALL_GRAD = 1e-5
ADAM_LR = 1e-2


def _adamw_steps(s, loader, grads_of, params_of):
    """The four calls over MICRO micro-batches; per optimizer step, the
    accumulated gradients just before ``step()`` and the parameters after
    it. Returns (losses, [grads], [params])."""
    losses, grads, params = [], [], []
    for i, batch in enumerate(loader):
        if i == MICRO:
            break
        loss = s.loss(s.model(batch), batch)
        s.backward(loss)
        losses.append(float(loss))
        if (i + 1) % ACCUM == 0:
            grads.append(grads_of())
            s.step()
            params.append(params_of())
        else:
            s.step()
    return np.asarray(losses), grads, params


def test_adamw_clip_trajectory_matches_jax(jax_init):
    model, variables = jax_init
    js = stoke_tpu.Stoke(
        model, OPTIMIZERS["adamw"][0](), jax_causal_lm_loss,
        jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=BATCH, grad_accum=ACCUM, device="cpu",
        grad_clip=stoke_tpu.ClipGradNormConfig(max_norm=0.5),
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False,
    )

    def jax_tree(tree):
        return gpt_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, tree))

    ref = _adamw_steps(
        js, js.DataLoader(stoke_tpu.ArrayDataset(_corpus()), shuffle=True,
                          drop_last=True),
        lambda: jax_tree(js._grad_buf), lambda: jax_tree(js.params))
    pm = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
             dropout_rate=0.0, attention_fn=make_flash_attention(causal=True),
             attention_is_causal=True)
    ps = port.Stoke(
        pm, OPTIMIZERS["adamw"][1](), causal_lm_loss,
        gpt_state_dict_from_jax(variables["params"]),
        batch_size_per_device=BATCH, grad_accum=ACCUM, device="cpu",
        grad_clip=port.ClipGradNormConfig(max_norm=0.5),
    )
    ours = _adamw_steps(
        ps, ps.DataLoader(port.ArrayDataset(_corpus()), shuffle=True,
                          drop_last=True),
        lambda: {n: p.grad.detach().clone()
                 for n, p in pm.named_parameters()},
        lambda: {n: p.detach().clone() for n, p in pm.state_dict().items()})
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-3)
    # the gradients of step 1 agree to the last bits of the largest one
    g_ref, g_ours = ref[1][0], ours[1][0]
    g_max = max(float(g.abs().max()) for g in g_ref.values())
    for name, g in g_ours.items():
        np.testing.assert_allclose(g.numpy(), g_ref[name].numpy(),
                                   atol=ADAM_GRAD_RTOL * g_max, err_msg=name)
    # the key bias's exact gradient is 0: only rounding is left of it
    for name, g in g_ref.items():
        if name.endswith("qkv.bias"):
            assert float(g.reshape(3, -1)[1].abs().max()) < 1e-6 * g_max
    small = {n: g.abs() < ADAM_SMALL_GRAD for n, g in g_ref.items()}
    for step, (p_ours, p_ref) in enumerate(zip(ours[2], ref[2])):
        if step:
            small = {n: small[n] | (ref[1][step][n].abs() < ADAM_SMALL_GRAD)
                     for n in small}
        for name, p in p_ours.items():
            gap = (p - p_ref[name]).abs().numpy()
            assert gap[~small[name].numpy()].max(initial=0.0) <= \
                ADAM_PARAM_ATOL, (step, name)
            # near eps, each package moves by at most ~lr a step
            assert gap[small[name].numpy()].max(initial=0.0) <= \
                2 * ADAM_LR * (step + 1), (step, name)


def test_bf16_trajectory_matches_jax(jax_init):
    ref_losses, _ = _run_jax(jax_init, "adamw", "four_call",
                             precision="bf16")
    losses, _ = _run_port(jax_init, "adamw", "four_call", precision="bf16")
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-2)


def test_bf16_runs_the_whole_model_in_bf16_over_fp32_masters():
    """A cast of the whole model, not autocast: LayerNorm (here the final
    one) runs on bf16 inputs and bf16 weights, the output comes back as
    fp32, and the gradients land in fp32 on the fp32 masters."""
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                dropout_rate=0.0)
    model.init_weights(0)
    seen = {}
    model.ln_final.register_forward_hook(
        lambda m, args, out: seen.update(x=args[0].dtype, out=out.dtype))
    s = port.Stoke(model, port.StokeOptimizer(torch.optim.SGD, lr=0.1),
                   causal_lm_loss, batch_size_per_device=BATCH,
                   grad_accum=2, device="cpu", precision="bf16")
    batch = _corpus()[:BATCH]
    out = s.model(batch)
    assert out.dtype == torch.float32
    assert seen == {"x": torch.bfloat16, "out": torch.bfloat16}
    s.backward(s.loss(out, batch))
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_matches_jax_over_two_epochs(drop_last):
    data = np.arange(22 * 3, dtype=np.int32).reshape(22, 3)
    labels = np.arange(22, dtype=np.int64)
    kw = dict(batch_size=4, shuffle=True, drop_last=drop_last, seed=5)
    theirs = JaxLoader(stoke_tpu.ArrayDataset(data, labels), place=False,
                       **kw)
    ours = port.StokeDataLoader(port.ArrayDataset(data, labels),
                                device="cpu", **kw)
    assert len(ours) == len(theirs)
    for _ in range(2):
        got = [(x.numpy(), y.numpy()) for x, y in ours]
        want = list(theirs)
        assert len(got) == len(want) == len(theirs)
        for (x, y), (jx, jy) in zip(got, want):
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_gradients_matches_jax(norm_type):
    """min(1, max_norm / (norm + 1e-6)) over all gradients, fp32 norm."""
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    cfg = port.ClipGradNormConfig(max_norm=0.7, norm_type=norm_type)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    clip_gradients(ours, cfg)
    theirs = jax_clip(list(grads), stoke_tpu.ClipGradNormConfig(
        max_norm=0.7, norm_type=norm_type))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    value = [torch.from_numpy(g.copy()) for g in grads]
    clip_gradients(value, port.ClipGradConfig(clip_value=0.5))
    assert all(float(v.abs().max()) <= 0.5 for v in value)


def test_causal_lm_loss_matches_jax():
    """Shifted-target fp32 cross entropy: the mean, and with a padding
    mask the masked mean over max(sum(w), 1) (an all-zero mask gives 0)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 9, 17)).astype(np.float32)
    ids = rng.integers(0, 17, size=(3, 9)).astype(np.int32)
    mask = np.ones((3, 9), np.int32)
    mask[0, 5:] = 0
    mask[2] = 0
    for m in (None, mask, np.zeros_like(mask)):
        ours = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                              None if m is None else torch.from_numpy(m))
        theirs = jax_causal_lm_loss(logits, ids, m)
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6)


def test_loader_takes_any_dataset_through_torch():
    """A dataset that is not an ArrayDataset goes through
    torch.utils.data.DataLoader, and its batches are placed as tensors."""
    rows = [(np.full(3, i, np.float32), i) for i in range(10)]
    loader = port.StokeDataLoader(rows, batch_size=4, device="cpu")
    batches = list(loader)
    assert len(loader) == len(batches) == 3
    x, y = batches[0]
    assert x.shape == (4, 3) and y.tolist() == [0, 1, 2, 3]


def _dropout_losses(seed, rate, steps=3):
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                dropout_rate=rate)
    model.init_weights(0)
    s = port.Stoke(model, port.StokeOptimizer(torch.optim.SGD, lr=0.1),
                   causal_lm_loss, batch_size_per_device=BATCH, device="cpu",
                   seed=seed)
    batch = _corpus()[:BATCH]
    return [float(s.train_step(batch, batch)) for _ in range(steps)]


def test_dropout_is_seeded_by_stoke():
    """Masks come from the generator Stoke(seed=...) seeds: the same seed
    gives the same losses, another seed or rate 0 other ones."""
    a = _dropout_losses(seed=3, rate=0.1)
    assert a == _dropout_losses(seed=3, rate=0.1)
    assert a != _dropout_losses(seed=4, rate=0.1)
    assert a != _dropout_losses(seed=3, rate=0.0)


def _linear_stoke(**kw):
    torch.manual_seed(0)
    return port.Stoke(nn.Linear(4, 2),
                      port.StokeOptimizer(torch.optim.SGD, lr=0.2),
                      kw.pop("loss", lambda out, y: ((out - y) ** 2).mean()),
                      batch_size_per_device=8, device="cpu", **kw)


def test_grad_accum_equals_the_concatenated_batch():
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(8, 4)).astype(np.float32) for _ in range(4)]
    ys = [x @ np.ones((4, 2), np.float32) for x in xs]
    one = _linear_stoke()
    one.train_step(np.concatenate(xs), np.concatenate(ys))
    four = _linear_stoke(grad_accum=4)
    reports = [four.train_step(x, y) for x, y in zip(xs, ys)]
    assert four.optimizer_steps == 1
    torch.testing.assert_close(four.model_access.weight,
                               one.model_access.weight, rtol=1e-5, atol=1e-6)
    # reported losses are divided by grad_accum; ema_loss tracks them
    # undivided with weight 0.1, seeded by the first
    micro = [4 * float(r) for r in reports]
    ema = micro[0]
    for m in micro[1:]:
        ema = 0.9 * ema + 0.1 * m
    assert four.ema_loss == pytest.approx(ema, rel=1e-6)
    assert four.step_loss == pytest.approx(micro[-1], rel=1e-6)


def test_loss_weights_weight_the_objective_not_the_report():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 4)).astype(np.float32)
    y = x @ np.ones((4, 2), np.float32)

    def two(out, y):
        return {"a": ((out - y) ** 2).mean(), "b": out.abs().mean()}

    weighted = _linear_stoke(loss=two, loss_weights={"a": 1.0, "b": 0.5})
    report = weighted.train_step(x, y)
    hand = _linear_stoke(
        loss=lambda out, y: two(out, y)["a"] + 0.5 * two(out, y)["b"])
    hand.train_step(x, y)
    torch.testing.assert_close(weighted.model_access.weight,
                               hand.model_access.weight)
    with torch.no_grad():
        plain = two(_linear_stoke().model_access(torch.from_numpy(x)),
                    torch.from_numpy(y))
    assert float(report["b"]) == pytest.approx(float(plain["b"]), rel=1e-6)
