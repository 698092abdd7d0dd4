"""Port parity: rematerialization and GPT's untied head.

- ``ActivationCheckpointingConfig`` through both facades (the JAX spec
  ``test_facade.py::test_activation_checkpointing_matches``): the same
  linear model, SGD, three ``train_step``s, parameters within rtol 1e-6.
- ``remat=True`` on BERT-tiny against the JAX package's ``nn.remat``
  blocks (the spec ``test_models.py::test_bert_remat_matches``): the same
  converted weights, dropout 0, the training-mode logits within 1e-5 and
  the gradients of their sum of squares within 1e-5 of the largest
  element (fp32 summed in other orders).
- The port's remat against the port without it, **bit for bit**, at
  dropout 0.1 (the masks replayed from the forward's tape): every engine
  policy, per-block remat, both nested, bf16, ``train_step``,
  ``train_steps`` windows and the four calls at ``grad_accum=2``; with
  the flash launches of each (two blocks: the forward kernel twice a step
  under any recompute, three times nested, once under
  ``everything_saveable``; each backward kernel once).
- GPT-tiny with ``tie_embeddings=False`` against the JAX package's
  ``lm_head`` model through ``convert``: logits within 1e-4 (the GPT
  parity tolerance), one SGD step's loss within rtol 1e-5 and parameters
  within atol 1e-5, and greedy serving streams token for token.
"""

import sys

import numpy as np
import optax
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import stoke_tpu
from stoke_tpu.configs import ServeConfig as JaxServeConfig
from stoke_tpu.models.bert import BertForSequenceClassification as JaxBert
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.gpt import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.serving import ServingEngine as JaxServingEngine
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.configs import ServeConfig
from stoke_tpu_torch.convert import (
    bert_state_dict_from_jax,
    gpt_state_dict_from_jax,
)
from stoke_tpu_torch.models.bert import BertForSequenceClassification
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.ops import make_flash_attention
from stoke_tpu_torch.serving import ServingEngine
from stoke_tpu_torch.status import StokeStatus, StokeValidationError

pytestmark = pytest.mark.torch_port

FA = sys.modules["stoke_tpu_torch.ops.flash_attention"]
#: the wrappers' plain paths, counted by _run
_FWD, _BWD = FA._flash_forward_direct, FA._flash_backward_direct
VOCAB, L, B = 97, 32, 4
FACADE_RTOL = 1e-6   # the JAX spec's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its tiny models gain nothing
    from more, and beside the suite's other workers each spare thread
    spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
FP32_TOL = 1e-5
LOGITS_ATOL = 1e-4   # test_torch_gpt.py's


# --------------------------------------------------------------------------- #
# against the JAX package
# --------------------------------------------------------------------------- #


def test_activation_checkpointing_matches_jax_facade():
    rng = np.random.default_rng(0)
    batches = [(x, x @ np.ones((4, 2), np.float32)) for x in
               (rng.normal(size=(8, 4)).astype(np.float32)
                for _ in range(3))]
    js = stoke_tpu.Stoke(
        model=lambda p, x: x @ p["w"] + p["b"],
        optimizer=stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd, optimizer_kwargs={"learning_rate": 0.2}),
        loss=lambda o, y: jnp.mean((o - y) ** 2),
        params={"w": jnp.zeros((4, 2)), "b": jnp.zeros((2,))},
        batch_size_per_device=8, verbose=False,
        configs=[stoke_tpu.ActivationCheckpointingConfig(
            policy="nothing_saveable")])
    lin = nn.Linear(4, 2)
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    ps = port.Stoke(lin, port.StokeOptimizer(torch.optim.SGD, lr=0.2),
                    lambda o, y: ((o - y) ** 2).mean(),
                    batch_size_per_device=8, device="cpu", verbose=False,
                    configs=[port.ActivationCheckpointingConfig(
                        policy="nothing_saveable")])
    for x, y in batches:
        js.train_step(x, y)
        ps.train_step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(lin.weight.detach().numpy().T,
                               np.asarray(js.params["w"]), rtol=FACADE_RTOL)


def test_bert_remat_matches_jax():
    ids = np.random.default_rng(1).integers(1, 1000, (2, 16)).astype(
        np.int32)
    jmodel = JaxBert(vocab_size=1000, size_name="tiny", dropout_rate=0.0,
                     remat=True)
    v = init_module(jmodel, jax.random.PRNGKey(0), ids, train=False)

    def obj(params):
        out = jmodel.apply({"params": params}, ids, train=True)
        return jnp.sum(out ** 2), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(obj, has_aux=True))(
        v["params"])
    pmodel = BertForSequenceClassification(vocab_size=1000,
                                           size_name="tiny",
                                           dropout_rate=0.0, remat=True)
    pmodel.load_state_dict(bert_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, v["params"])))
    out = pmodel.train()(torch.from_numpy(ids).long())
    out.square().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=FP32_TOL, rtol=FP32_TOL)
    want = bert_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrad))
    grads = {n: p.grad for n, p in pmodel.named_parameters()}
    top = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(),
                                   atol=FP32_TOL * top, err_msg=n)


def test_policy_rule_keeps_the_jax_message():
    for st in (StokeStatus, stoke_tpu.status.StokeStatus):
        cfg = (port.ActivationCheckpointingConfig if st is StokeStatus
               else stoke_tpu.ActivationCheckpointingConfig)
        with pytest.raises(Exception, match="jax.checkpoint_policies") as e:
            st(batch_size_per_device=8, device="cpu",
               configs=[cfg(policy="offload_everything")])
        assert "StokeValidationError" in type(e.value).__name__
    s = StokeStatus(batch_size_per_device=8, device="cpu", configs=[
        port.ActivationCheckpointingConfig(policy="dots_saveable")])
    assert s.activation_checkpointing_config.policy == "dots_saveable"
    assert issubclass(StokeValidationError, ValueError)


# --------------------------------------------------------------------------- #
# the port's remat against the port without it, bit for bit
# --------------------------------------------------------------------------- #


def _gpt(remat=False, dropout=0.1):
    m = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
            dropout_rate=dropout,
            attention_fn=make_flash_attention(causal=True),
            attention_is_causal=True, remat=remat)
    for block in m.layers:
        block.attention.prob_dropout.rate = 0.0
    m.init_weights(0)
    return m


def _run(monkeypatch, remat=False, policy=None, precision=None, accum=1,
         four_call=False):
    launches = {"fwd": 0, "bwd": 0}

    def count_fwd(*a):
        launches["fwd"] += 1
        return _FWD(*a)

    def count_bwd(*a):
        launches["bwd"] += 1
        return _BWD(*a)

    monkeypatch.setattr(FA, "_flash_forward_direct", count_fwd)
    monkeypatch.setattr(FA, "_flash_backward_direct", count_bwd)
    m = _gpt(remat)
    s = port.Stoke(
        m, port.StokeOptimizer(torch.optim.AdamW, lr=3e-3), causal_lm_loss,
        batch_size_per_device=B, grad_accum=accum, device="cpu",
        precision=precision,
        grad_clip=port.ClipGradNormConfig(max_norm=1.0), verbose=False,
        configs=([port.ActivationCheckpointingConfig(policy=policy)]
                 if policy else None))
    g = torch.Generator().manual_seed(1)
    losses = []
    if four_call:
        for _ in range(2 * accum):
            x = torch.randint(0, VOCAB, (B, L), generator=g)
            loss = s.loss(s.model(x), x)
            s.backward(loss)
            s.step()
            losses.append(float(loss))
    else:
        for _ in range(2):
            x = torch.randint(0, VOCAB, (B, L), generator=g)
            losses.append(float(s.train_step(x, x)))
        xs = torch.randint(0, VOCAB, (2 * accum, B, L), generator=g)
        losses += s.train_steps(xs, xs).reshape(-1).tolist()
    return (losses, [p.detach().clone() for p in m.parameters()],
            launches, s.optimizer_steps)


#: (model remat, engine policy, forward launches a step for two blocks)
CASES = [
    (True, None, 4),
    (False, "nothing_saveable", 4),
    (False, "dots_saveable", 4),
    (False, "dots_with_no_batch_dims_saveable", 4),
    (False, "everything_saveable", 2),
    (True, "nothing_saveable", 6),
]


@pytest.fixture(scope="module")
def plain_runs():
    return {}


@pytest.mark.parametrize("case", CASES, ids=[
    f"block{int(r)}-{p}" for r, p, _ in CASES])
def test_remat_bit_for_bit_under_dropout(case, monkeypatch, plain_runs):
    remat, policy, fwd_per_step = case
    if "plain" not in plain_runs:
        plain_runs["plain"] = _run(monkeypatch)
    base = plain_runs["plain"]
    got = _run(monkeypatch, remat=remat, policy=policy)
    assert got[0] == base[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], base[1]))
    steps = got[3]
    assert steps == 4 and base[2] == {"fwd": 2 * steps, "bwd": 2 * steps}
    assert got[2] == {"fwd": fwd_per_step * steps, "bwd": 2 * steps}


@pytest.mark.parametrize("precision,four_call", [("bf16", False),
                                                 (None, True)])
def test_remat_bit_for_bit_bf16_and_four_calls(precision, four_call,
                                                monkeypatch):
    """bf16 through the engine's ``functional_call`` casts (the recompute
    casts the masters again) and the four calls at ``grad_accum=2`` (the
    masks of two micro-steps on two tapes), per block and nested."""
    accum = 2 if four_call else 1
    base = _run(monkeypatch, precision=precision, accum=accum,
                four_call=four_call)
    for remat, policy in ((True, None), (True, "dots_saveable")):
        got = _run(monkeypatch, remat=remat, policy=policy,
                   precision=precision, accum=accum, four_call=four_call)
        assert got[0] == base[0]
        assert all(torch.equal(a, b) for a, b in zip(got[1], base[1]))


def test_selective_policies_keep_their_products():
    """``nothing_saveable`` runs the ``Linear``'s product again in
    backward, the dots policies keep its output: a bias changed between
    the forward and the backward moves the first's gradient (to the new
    bias's, bit for bit) and not the others' (the old bias's)."""
    from stoke_tpu_torch import remat

    torch.manual_seed(0)
    lin = nn.Linear(8, 8)

    def fn(x):
        h = lin(x)
        return torch.bmm(h, h.transpose(1, 2)).sum()

    x = torch.randn(2, 4, 8, requires_grad=True)
    old = lin.bias.detach().clone()
    ref_old = torch.autograd.grad(fn(x), x)[0]
    with torch.no_grad():
        lin.bias.copy_(old + 1.0)
    ref_new = torch.autograd.grad(fn(x), x)[0]
    for policy, want in (("nothing_saveable", ref_new),
                         ("dots_with_no_batch_dims_saveable", ref_old),
                         ("dots_saveable", ref_old)):
        with torch.no_grad():
            lin.bias.copy_(old)
        y = remat.checkpoint(fn, x, policy=policy)
        with torch.no_grad():
            lin.bias.copy_(old + 1.0)
        assert torch.equal(torch.autograd.grad(y, x)[0], want), policy


# --------------------------------------------------------------------------- #
# GPT's untied head
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def untied():
    model = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=64,
                   dropout_rate=0.0, tie_embeddings=False)
    ids = np.random.default_rng(2).integers(0, VOCAB, (B, L)).astype(
        np.int32)
    v = init_module(model, jax.random.PRNGKey(0), ids[:1], train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    return model, params, ids


def _port_untied(params):
    m = GPT(vocab_size=VOCAB, size_name="tiny", max_len=64,
            dropout_rate=0.0, tie_embeddings=False)
    m.load_state_dict(gpt_state_dict_from_jax(params))
    return m


def test_untied_logits_and_step_match_jax(untied):
    model, params, ids = untied
    assert {"kernel", "bias"} == set(params["lm_head"])
    m = _port_untied(params)
    jlog = np.asarray(model.apply({"params": params}, ids, train=False))
    plog = m.eval()(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(plog, jlog, atol=LOGITS_ATOL)
    js = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd, optimizer_kwargs={"learning_rate": 0.1}),
        jax_causal_lm_loss, {"params": jax.tree_util.tree_map(
            np.array, params)},
        batch_size_per_device=B, device="cpu", verbose=False,
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False})
    jl = float(js.train_step(ids, ids))
    ps = port.Stoke(m, port.StokeOptimizer(torch.optim.SGD, lr=0.1),
                    causal_lm_loss, batch_size_per_device=B, device="cpu",
                    verbose=False)
    t = torch.from_numpy(ids)
    pl = float(ps.train_step(t, t))
    assert abs(pl - jl) <= FP32_TOL * abs(jl)
    want = gpt_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, js.params))
    got = m.state_dict()
    assert "lm_head.weight" in want and "lm_head.bias" in want
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), atol=FP32_TOL,
                                   err_msg=n)


def test_untied_serving_streams_match_jax(untied):
    model, params, _ = untied
    serve = dict(max_seqs=3, kv_block_size=8, max_seq_len=48,
                 max_new_tokens=5, prefill_pad_multiple=16)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, VOCAB, size=int(n)).astype(np.int32)
               for n in (4, 11, 19, 7)]
    jax_engine = JaxServingEngine(model, params, JaxServeConfig(**serve))
    want = jax_engine.generate(prompts)
    engine = ServingEngine(_port_untied(params), gpt_state_dict_from_jax(
        params), ServeConfig(**serve), device="cpu")
    assert engine.generate(prompts) == [list(s) for s in want]
