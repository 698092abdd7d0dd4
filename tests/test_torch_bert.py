"""Port parity: BERT sequence classification.

BERT-tiny's variables come from ``jax.eval_shape`` of the JAX package's
init and a numpy seed (no init compile), are carried over by
``stoke_tpu_torch.convert.bert_state_dict_from_jax``, and the port's
``BertForSequenceClassification`` is held against the flax module's
``apply`` on the same numpy inputs. Tolerances, as ``max |port - jax|``
over ``max |jax|``:

- fp32 logits, 1e-5 (fp32 sums in different orders): dense attention with
  and without the padding mask, with token types, and flash attention (the
  port's plain version on the CPU against the JAX kernel in Pallas
  interpret mode);
- bf16 and fp16 logits (both models' weights cast): their error against
  the fp32 logits at most twice the JAX package's own (which is 7.7e-3
  and 1.5e-3 of the largest logit here);
- 3 fp32 optimizer steps of ``Stoke`` (AdamW, clip norm 1.0,
  ``grad_accum=2``) against the JAX facade on the same bucketed batches:
  losses within 1e-5 relative.

Progressive layer drop cannot match the JAX draws (threefry against
Philox), so it is held to its definition: off, the result is exact; on,
each layer's output is its block's output or its input, and keep
frequencies lie within a binomial bound of ``1 - frac (i+1)/N``.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import stoke_tpu
from stoke_tpu.data import BucketedDistributedSampler as JaxSampler
from stoke_tpu.data import RaggedSequenceDataset as JaxRagged
from stoke_tpu.models.bert import (
    BertForSequenceClassification as JaxBert,
)
from stoke_tpu.models.bert import dense_attention as jax_dense
from stoke_tpu.ops import make_flash_attention as jax_make_flash
import stoke_tpu_torch as port
from stoke_tpu_torch.convert import bert_state_dict_from_jax
from stoke_tpu_torch.data import (
    BucketedDistributedSampler,
    RaggedSequenceDataset,
)
from stoke_tpu_torch.models.bert import (
    BertEncoder,
    BertForSequenceClassification,
    BertTiny,
    BERT_SIZES,
)
from stoke_tpu_torch.ops import make_flash_attention
from stoke_tpu_torch.utils.yaml_config import stoke_from_config

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


VOCAB, MAX_LEN, CLASSES = 97, 64, 3
FP32_TOL = 1e-5
TRAIN_RTOL = 1e-5


def rel_err(port_out, ref) -> float:
    port_out = np.asarray(port_out.detach().float(), np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(port_out - ref).max() / np.abs(ref).max())


def jax_variables(model, *inputs, seed=0):
    """``model``'s params (shapes from ``jax.eval_shape`` of its init),
    kernels from N(0, 1/fan_in), embeddings from N(0, 1), LayerNorm scales
    from U(0.5, 1.5), biases and shifts from N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), *inputs, train=False))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        std = {"kernel": np.prod(leaf.shape[:-1]) ** -0.5,
               "embedding": 1.0}.get(name, 0.1)
        return rng.normal(0, std, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def inputs(seed=1, B=3, L=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, 20:] = 0
    mask[1, 5:] = 0
    types = (np.arange(L)[None] >= rng.integers(1, L, size=(B, 1))).astype(
        np.int32)
    return ids, mask, types


@pytest.fixture(scope="module")
def trees():
    """(params without seg_emb, params with seg_emb)."""
    ids, mask, types = inputs()
    model = JaxBert(vocab_size=VOCAB, num_classes=CLASSES, size_name="tiny",
                    max_len=MAX_LEN, dropout_rate=0.0)
    return (jax_variables(model, ids, mask),
            jax_variables(model, ids, mask, types, seed=1))


def port_bert(params, **kw):
    model = BertTiny(vocab_size=VOCAB, num_classes=CLASSES, max_len=MAX_LEN,
                     dropout_rate=0.0,
                     token_types="seg_emb" in params["encoder"], **kw)
    model.load_state_dict(bert_state_dict_from_jax(params))
    return model.eval()


@pytest.mark.parametrize("case", ["dense", "dense_masked", "token_types",
                                  "flash", "flash_masked"])
def test_fp32_logits_match_jax(trees, case):
    ids, mask, types = inputs()
    flash = case.startswith("flash")
    params = trees[1] if case == "token_types" else trees[0]
    args = [ids]
    if case != "dense":
        args.append(mask)
    if case == "token_types":
        args.append(types)
    jax_model = JaxBert(vocab_size=VOCAB, num_classes=CLASSES,
                        size_name="tiny", max_len=MAX_LEN, dropout_rate=0.0,
                        attention_fn=(jax_make_flash(interpret=True) if flash
                                      else jax_dense))
    ref = np.asarray(jax.jit(lambda p, *a: jax_model.apply(
        {"params": p}, *a, train=False))(params, *args))
    model = port_bert(params, **({"attention_fn": make_flash_attention()}
                                 if flash else {}))
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in args))
    assert out.shape == (3, CLASSES)
    assert rel_err(out, ref) <= FP32_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_logits_round_no_worse_than_jax(trees, dtype):
    """Both models' weights cast to 16 bits: the port's logits are finite
    (the padding bias is built in fp32 and cast: -1e9 is -inf in fp16),
    and their error against the fp32 logits is at most twice the JAX
    package's own. A bound of four units of roundoff of the largest logit
    (2^-7, 2^-10) does not hold here for the JAX package against itself:
    its bf16 logits are 7.7e-3 and its fp16 logits 1.5e-3 of the largest
    off its fp32 ones (a tanh-pooled classifier's logits are small next to
    the hidden states they are read from)."""
    ids, mask, _ = inputs()
    params = trees[0]
    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[dtype]
    jax_model = JaxBert(vocab_size=VOCAB, num_classes=CLASSES,
                        size_name="tiny", max_len=MAX_LEN, dropout_rate=0.0)
    apply = jax.jit(lambda p, i, m: jax_model.apply(
        {"params": p}, i, m, train=False))
    jax32 = np.asarray(apply(params, ids, mask), np.float64)
    jax16 = np.asarray(apply(jax.tree_util.tree_map(
        lambda x: x.astype(jdtype), params), ids, mask), np.float64)
    model = port_bert(params)
    args = (torch.from_numpy(ids), torch.from_numpy(mask))
    with torch.no_grad():
        port32 = model(*args).double().numpy()
        port16 = model.to(dtype)(*args)
    assert torch.isfinite(port16).all()
    port16 = port16.double().numpy()
    scale = np.abs(jax32).max()
    jax_err = np.abs(jax16 - jax32).max() / scale
    port_err = np.abs(port16 - port32).max() / scale
    assert port_err <= 2 * jax_err, (port_err, jax_err)
    assert np.abs(port16 - jax16).max() / scale <= 3 * jax_err


def test_converter_errors_and_trees(trees):
    plain, typed = trees
    assert "encoder.seg_emb.weight" not in bert_state_dict_from_jax(plain)
    assert bert_state_dict_from_jax(typed)["encoder.seg_emb.weight"].shape \
        == (2, 128)
    missing = jax.tree_util.tree_map(lambda x: x, plain)
    del missing["encoder"]["layer_1"]["ff_out"]
    with pytest.raises(KeyError, match="layer_1/ff_out/kernel"):
        bert_state_dict_from_jax(missing)
    extra = dict(plain, head={"kernel": np.zeros((128, 2), np.float32)})
    with pytest.raises(ValueError, match="head/kernel"):
        bert_state_dict_from_jax(extra)
    with pytest.raises(ValueError, match="token_type_ids"):
        port_bert(plain)(torch.zeros(1, 4, dtype=torch.long),
                         token_type_ids=torch.zeros(1, 4, dtype=torch.long))


def test_remat_is_refused_naming_its_item():
    """Refused until ROADMAP item 13 landed: ``remat=True`` now builds on
    the three constructors, recomputes each block (the flag rides the
    module) and gives the output of the module without it, exactly, in
    eval and in training with dropout 0.1 (the masks replayed)."""
    from stoke_tpu_torch.models.vit import ViT

    for cls, x in (
            (lambda **kw: BertForSequenceClassification(
                vocab_size=VOCAB, size_name="tiny", **kw),
             torch.randint(0, VOCAB, (2, 8))),
            (lambda **kw: ViT(num_classes=4, patch_size=8, **kw),
             torch.randn(2, 3, 32, 32)),
            (lambda **kw: BertEncoder(VOCAB, BERT_SIZES["tiny"], **kw),
             torch.randint(0, VOCAB, (2, 8)))):
        plain, remat = cls(), cls(remat=True)
        remat.load_state_dict(plain.state_dict())
        assert remat.remat if hasattr(remat, "remat") else (
            remat.encoder.remat)
        outs = []
        for m in (plain, remat):
            gen = torch.Generator().manual_seed(3)
            for d in m.modules():
                if hasattr(d, "generator"):
                    d.generator = gen
            m.train()
            y = m(x)
            y.float().square().sum().backward()
            outs.append((y.detach(), [p.grad.clone()
                                      for p in m.parameters()]))
        assert torch.equal(outs[0][0], outs[1][0])
        assert all(torch.equal(a, b) for a, b in zip(outs[0][1],
                                                     outs[1][1]))


# --------------------------------------------------------------------------- #
# progressive layer drop
# --------------------------------------------------------------------------- #


def _encoder(**kw):
    torch.manual_seed(0)
    enc = BertEncoder(VOCAB, BERT_SIZES["mini"], max_len=MAX_LEN,
                      dropout_rate=0.0, **kw)
    return enc.train()


def test_layer_drop_off_is_exact():
    ids = torch.from_numpy(inputs()[0]).long()
    base = _encoder()
    drop = _encoder(layer_drop_rate=0.5)
    drop.load_state_dict(base.state_dict())
    with torch.no_grad():
        assert torch.equal(drop.eval()(ids), base.eval()(ids))
        zero = _encoder(layer_drop_rate=0.0)
        zero.load_state_dict(base.state_dict())
        assert torch.equal(zero.train()(ids), base.train()(ids))


def test_each_layer_is_its_block_or_its_input():
    ids = torch.from_numpy(inputs()[0]).long()
    enc = _encoder(layer_drop_rate=0.6)
    outs = []
    hooks = [layer.register_forward_hook(
        lambda m, a, o: outs.append((a[0], o))) for layer in enc.layers]
    enc.layer_drop.generator = torch.Generator().manual_seed(3)
    kept_patterns = set()
    with torch.no_grad():
        for _ in range(8):
            outs.clear()
            h = enc(ids)
            pattern = []
            for i, (x, y) in enumerate(outs):
                nxt = outs[i + 1][0] if i + 1 < len(outs) else h
                kept = torch.equal(nxt, y)
                assert kept or torch.equal(nxt, x)
                pattern.append(kept)
            kept_patterns.add(tuple(pattern))
    for hk in hooks:
        hk.remove()
    assert len(kept_patterns) > 1


def test_keep_frequencies_follow_depth():
    enc = _encoder(layer_drop_rate=0.8)
    n, draws = len(enc.layers), 4000
    gen = torch.Generator().manual_seed(5)
    enc.layer_drop.generator = gen
    depth = torch.arange(1, n + 1, dtype=torch.float32) / n
    keep_p = 1.0 - enc.layer_drop_fraction() * depth
    kept = torch.stack([enc.layer_drop.keep(keep_p) for _ in range(draws)])
    freq = kept.float().mean(0)
    want = 1.0 - 0.8 * np.arange(1, n + 1) / n
    sigma = np.sqrt(want * (1 - want) / draws)
    assert np.all(np.abs(freq.numpy() - want) <= 5 * sigma + 1e-9)


@pytest.mark.parametrize("step", [0, 1, 250, 10_000])
def test_theta_gamma_fraction_equals_the_jax_formula(step):
    enc = _encoder(layer_drop_theta=0.5, layer_drop_gamma=0.001)
    theta, gamma = jnp.float32(0.5), jnp.float32(0.001)
    theta_bar = (1.0 - theta) * jnp.exp(
        -gamma * jnp.asarray(step, jnp.float32)) + theta
    want = float(1.0 - theta_bar)
    got = float(enc.layer_drop_fraction(step))
    assert abs(got - want) <= 1e-7 * max(abs(want), 1e-30) + 1e-9


def test_theta_without_global_step_raises_the_jax_message():
    ids = torch.from_numpy(inputs()[0]).long()
    enc = _encoder(layer_drop_theta=0.5)
    with pytest.raises(ValueError) as ours:
        enc(ids)
    jax_model = JaxBert(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN,
                        dropout_rate=0.0, layer_drop_theta=0.5)
    with pytest.raises(ValueError) as theirs:
        jax_model.init({"params": jax.random.PRNGKey(0),
                        "layer_drop": jax.random.PRNGKey(1)},
                       inputs()[0], train=True)
    assert str(ours.value) == str(theirs.value)
    enc(ids, global_step=torch.tensor(10))  # with the step it runs


def test_layer_drop_draws_from_the_stoke_generator():
    model = BertTiny(vocab_size=VOCAB, max_len=MAX_LEN, dropout_rate=0.0,
                     layer_drop_rate=0.5)
    s = port.Stoke(model, port.StokeOptimizer(torch.optim.SGD, lr=0.1),
                   lambda out, y: torch.nn.functional.cross_entropy(out, y),
                   batch_size_per_device=2, device="cpu", seed=4,
                   model_rng_keys=("dropout", "layer_drop"))
    assert s.model_rng_keys == ("dropout", "layer_drop")
    assert model.encoder.layer_drop.generator is s._generator


# --------------------------------------------------------------------------- #
# 3 optimizer steps against the JAX facade
# --------------------------------------------------------------------------- #


def ragged_corpus(n=400, seed=0):
    rng = np.random.default_rng(seed)
    lens = np.clip((rng.pareto(2.5, size=n) + 1.0) * 8, 8, 48).astype(int)
    seqs = [rng.integers(1, VOCAB, size=L) for L in lens]
    labels = np.asarray([int(s[0] % CLASSES) for s in seqs], np.int64)
    return seqs, labels


def test_adamw_steps_match_the_jax_facade(trees):
    params = trees[0]
    seqs, labels = ragged_corpus()
    sampler_kw = dict(buckets=2, batch_size=8, num_replicas=1, rank=0,
                      seed=3)
    jds = JaxRagged(seqs, labels, pad_multiple=16)
    pds = RaggedSequenceDataset(seqs, labels, pad_multiple=16)
    jax_model = JaxBert(vocab_size=VOCAB, num_classes=CLASSES,
                        size_name="tiny", max_len=MAX_LEN, dropout_rate=0.0)
    js = stoke_tpu.Stoke(
        jax_model,
        stoke_tpu.StokeOptimizer(optimizer=optax.adamw,
                                 optimizer_kwargs={"learning_rate": 3e-4}),
        lambda logits, y: optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(),
        {"params": jax.tree_util.tree_map(np.array, params)},
        batch_size_per_device=8, grad_accum=2, device="cpu",
        grad_clip=stoke_tpu.ClipGradNormConfig(max_norm=1.0),
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)
    model = port_bert(params).train()
    ps = stoke_from_config(
        model, lambda logits, y: torch.nn.functional.cross_entropy(logits, y),
        None, {"batch_size_per_device": 8, "grad_accum": 2, "device": "cpu",
               "grad_clip": {"type": "norm", "max_norm": 1.0},
               "optimizer": {"name": "adamw", "learning_rate": 3e-4}})
    losses = {}
    for name, s, ds, sampler_cls in (("jax", js, jds, JaxSampler),
                                     ("port", ps, pds,
                                      BucketedDistributedSampler)):
        sampler = sampler_cls(ds, sorted_idx=ds.sorted_idx(), **sampler_kw)
        out = []
        for i, (batch, y) in enumerate(s.DataLoader(ds, sampler=sampler)):
            if i == 6:
                break
            loss = s.loss(s.model(batch["input_ids"],
                                  batch["attention_mask"]), y)
            s.backward(loss)
            s.step()
            out.append(float(loss))
        assert s.optimizer_steps == 3
        losses[name] = np.asarray(out)
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=TRAIN_RTOL)
