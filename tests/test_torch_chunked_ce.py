"""Port parity: the chunked LM-head cross entropy and ``GPT(chunked_head)``.

The same seeded hidden states, embedding, targets and masks go through the
JAX package's ``chunked_softmax_cross_entropy`` (a ``lax.scan`` of
rematerialised chunks) and the port's (a loop of checkpointed chunks), and
through a full-logits cross entropy. Tolerances:

- fp32 values and gradients (against ``jax.grad``): 1e-5 relative to the
  largest magnitude (fp32 sums in different orders);
- under ``chunked_ce.compute_dtype(torch.bfloat16)`` (what the step
  engine enters under a bf16 policy), on fp32 copies of bf16 values: the
  forward computes the fp32 product's products exactly, summed in another
  order: 1e-5; its backward rounds the logits' gradient to bf16 before
  its products, and their fp32 results to bf16, the operands' type:
  2^-7, two bf16 roundings (4.1e-3 seen);
- tiny GPT with the chunked head through both ``Stoke`` facades in fp32:
  losses 1e-5 relative, 3 steps.
"""

import jax
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import stoke_tpu
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.ops.chunked_ce import (
    chunked_causal_lm_loss as jax_chunked_causal_lm_loss,
)
from stoke_tpu.ops.chunked_ce import (
    chunked_softmax_cross_entropy as jax_chunked_ce,
)
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.models.gpt import GPT
from stoke_tpu_torch.ops import (
    chunked_causal_lm_loss,
    chunked_ce,
    chunked_softmax_cross_entropy,
)

pytestmark = pytest.mark.torch_port

B, L, H, V = 2, 10, 16, 37
FP32_TOL = 1e-5
BF16_GRAD_TOL = 2.0**-7


def _inputs(seed=0, masked=False):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(B, L, H)).astype(np.float32)
    emb = (rng.normal(size=(V, H)) / np.sqrt(H)).astype(np.float32)
    targets = rng.integers(0, V, size=(B, L)).astype(np.int32)
    mask = None
    if masked:
        mask = (rng.random((B, L)) < 0.7).astype(np.int32)
        mask[0, -3:] = 0
    return hidden, emb, targets, mask


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _port_value_and_grads(hidden, emb, targets, mask, chunk, **kw):
    h = torch.tensor(hidden, requires_grad=True)
    e = torch.tensor(emb, requires_grad=True)
    loss = chunked_softmax_cross_entropy(
        h, e, torch.from_numpy(targets), chunk=chunk,
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    loss.backward()
    return float(loss.detach()), h.grad.numpy(), e.grad.numpy()


@pytest.mark.parametrize("chunk", [4, 5, 10, 64])
@pytest.mark.parametrize("masked", [False, True])
def test_values_and_grads_match_jax(chunk, masked):
    """Chunks of 4 leave L=10 a padded tail; 64 is cut to L."""
    hidden, emb, targets, mask = _inputs(seed=chunk, masked=masked)
    fn = lambda h, e: jax_chunked_ce(h, e, targets, chunk=chunk, mask=mask)
    want, (gh, ge) = jax.value_and_grad(fn, argnums=(0, 1))(hidden, emb)
    got, ph, pe = _port_value_and_grads(hidden, emb, targets, mask, chunk)
    assert abs(got - float(want)) <= FP32_TOL * abs(float(want))
    assert _rel(ph, gh) <= FP32_TOL
    assert _rel(pe, ge) <= FP32_TOL


@pytest.mark.parametrize("masked", [False, True])
def test_matches_full_cross_entropy(masked):
    hidden, emb, targets, mask = _inputs(seed=1, masked=masked)
    logits = torch.from_numpy(hidden) @ torch.from_numpy(emb).T
    ce = F.cross_entropy(logits.reshape(-1, V),
                         torch.from_numpy(targets).long().reshape(-1),
                         reduction="none")
    w = torch.ones(B * L) if mask is None else torch.from_numpy(
        mask).float().reshape(-1)
    want = float((ce * w).sum() / w.sum())
    got, _, _ = _port_value_and_grads(hidden, emb, targets, mask, chunk=3)
    assert abs(got - want) <= FP32_TOL * abs(want)


def test_bf16_operands_compute_the_fp32_products():
    """fp32 copies of bf16 values: the bf16-operand product with an fp32
    result against the fp32 product."""
    hidden, emb, targets, mask = _inputs(seed=2, masked=True)
    hidden = torch.from_numpy(hidden).bfloat16().float().numpy()
    emb = torch.from_numpy(emb).bfloat16().float().numpy()
    want, wh, we = _port_value_and_grads(hidden, emb, targets, mask, 4)
    with chunked_ce.compute_dtype(torch.bfloat16):
        got, gh, ge = _port_value_and_grads(hidden, emb, targets, mask, 4)
    assert abs(got - want) <= FP32_TOL * abs(want)
    assert _rel(gh, wh) <= BF16_GRAD_TOL
    assert _rel(ge, we) <= BF16_GRAD_TOL


def test_chunked_causal_lm_loss_matches_jax():
    hidden, emb, ids, mask = _inputs(seed=3, masked=True)
    want = float(jax_chunked_causal_lm_loss((hidden, emb), ids, mask,
                                            chunk=4))
    got = float(chunked_causal_lm_loss(
        (torch.from_numpy(hidden), torch.from_numpy(emb)),
        torch.from_numpy(ids), torch.from_numpy(mask), chunk=4))
    assert abs(got - want) <= FP32_TOL * abs(want)


def test_untied_chunked_head_raises_the_jax_message():
    with pytest.raises(ValueError) as jax_err:
        init_module(JaxGPT(vocab_size=V, size_name="tiny", max_len=16,
                           tie_embeddings=False, chunked_head=True),
                    jax.random.PRNGKey(0), np.zeros((1, 8), np.int32),
                    train=False)
    with pytest.raises(ValueError) as port_err:
        GPT(vocab_size=V, size_name="tiny", max_len=16,
            tie_embeddings=False, chunked_head=True)
    assert str(port_err.value) == str(jax_err.value)


def test_untied_head_is_refused():
    """Refused until ROADMAP item 13 landed: ``tie_embeddings=False`` now
    builds flax's ``lm_head`` (a Dense with a bias) and the logits are its
    product, not the embedding's; only the chunked head stays refused
    (``test_untied_chunked_head_raises_the_jax_message``)."""
    m = GPT(vocab_size=V, size_name="tiny", max_len=16,
            tie_embeddings=False)
    m.init_weights(0)
    assert tuple(m.lm_head.weight.shape) == (V, m.tok_emb.weight.shape[1])
    ids = torch.randint(0, V, (2, 8))
    with torch.no_grad():
        m.lm_head.bias.fill_(0.5)
    final = []
    m.ln_final.register_forward_hook(lambda mod, i, o: final.append(o))
    logits = m.eval()(ids)
    want = final[0] @ m.lm_head.weight.T + m.lm_head.bias
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    assert not torch.allclose(logits, final[0] @ m.tok_emb.weight.T)


VOCAB, SEQ, BATCH = 257, 16, 4


@pytest.fixture(scope="module")
def gpt_params():
    model = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=SEQ,
                   dropout_rate=0.0, chunked_head=True)
    v = init_module(model, jax.random.PRNGKey(0),
                    np.zeros((1, SEQ), np.int32), train=False)
    return model, jax.tree_util.tree_map(np.asarray, v["params"])


def test_chunked_head_equals_full_head(gpt_params):
    """The pair's product is the full head's logits."""
    sd = gpt_state_dict_from_jax(gpt_params[1])
    chunked = GPT(vocab_size=VOCAB, size_name="tiny", max_len=SEQ,
                  dropout_rate=0.0, chunked_head=True)
    full = GPT(vocab_size=VOCAB, size_name="tiny", max_len=SEQ,
               dropout_rate=0.0)
    chunked.load_state_dict(sd)
    full.load_state_dict(sd)
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, VOCAB, (2, SEQ)))
    h, emb = chunked.eval()(ids)
    assert emb is chunked.tok_emb.weight
    torch.testing.assert_close(h @ emb.T, full.eval()(ids), rtol=0, atol=0)


def test_gpt_chunked_head_trains_as_jax(gpt_params):
    """Tiny GPT with the chunked head, 3 ``train_step``s of AdamW through
    both facades in fp32 from the same weights and batches."""
    model, params = gpt_params
    corpus = np.random.default_rng(5).integers(
        0, VOCAB, (3, BATCH, SEQ)).astype(np.int32)
    loss = lambda out, ids: jax_chunked_causal_lm_loss(out, ids, chunk=4)
    js = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.adamw,
            optimizer_kwargs=dict(learning_rate=1e-3, weight_decay=0.0)),
        loss, {"params": jax.tree_util.tree_map(np.array, params)},
        batch_size_per_device=BATCH, device="cpu",
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)
    want = [float(js.train_step(b, b)) for b in corpus]
    ported = GPT(vocab_size=VOCAB, size_name="tiny", max_len=SEQ,
                 dropout_rate=0.0, chunked_head=True)
    s = port.Stoke(
        ported, port.StokeOptimizer(torch.optim.AdamW, lr=1e-3,
                                    weight_decay=0.0),
        lambda out, ids: chunked_causal_lm_loss(out, ids, chunk=4),
        gpt_state_dict_from_jax(params), batch_size_per_device=BATCH,
        device="cpu")
    got = [float(s.train_step(torch.from_numpy(b), torch.from_numpy(b)))
           for b in corpus]
    np.testing.assert_allclose(got, want, rtol=FP32_TOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("path", ["train_step", "four_calls"])
@pytest.mark.parametrize("precision,dtype", [
    (None, None), ("bf16", torch.bfloat16), ("fp16", torch.float16)])
def test_stoke_policy_picks_the_head_product(gpt_params, monkeypatch,
                                             precision, dtype, path):
    """Under a 16-bit policy the step's chunked loss multiplies in the
    compute dtype with fp32 logits; in fp32 it runs the fp32 product. A
    loss outside the step multiplies as its inputs are."""
    seen = []
    apply = chunked_ce._Logits16.apply

    def spy(h, emb):
        seen.append((h.dtype, emb.dtype))
        return apply(h, emb)

    monkeypatch.setattr(chunked_ce._Logits16, "apply", spy)
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=SEQ,
                dropout_rate=0.0, chunked_head=True)
    s = port.Stoke(
        model, port.StokeOptimizer(torch.optim.SGD, lr=1e-2),
        lambda out, ids: chunked_causal_lm_loss(out, ids, chunk=8),
        gpt_state_dict_from_jax(gpt_params[1]),
        batch_size_per_device=BATCH, device="cpu", precision=precision)
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, VOCAB, (BATCH, SEQ)))
    if path == "train_step":
        loss = s.train_step(ids, ids)
    else:
        out = s.model(ids)
        assert out[0].dtype == out[1].dtype == torch.float32
        loss = s.loss(out, ids)
        s.backward(loss)
        s.step()
    assert np.isfinite(float(loss))
    # two chunks, each run forward and again by the checkpoint's backward
    assert seen == ([] if dtype is None else [(dtype, dtype)] * 4)
    chunked_causal_lm_loss((torch.zeros(1, 4, 128), torch.zeros(VOCAB, 128)),
                           torch.zeros(1, 4, dtype=torch.long))
    assert len(seen) == (0 if dtype is None else 4)
