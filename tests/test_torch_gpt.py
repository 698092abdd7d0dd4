"""Port parity: GPT weights carried over from JAX, and its forward.

GPT-tiny is built and initialised by the JAX package from a seed, its
params converted by ``stoke_tpu_torch.convert.gpt_state_dict_from_jax``,
and the port's ``GPT`` held against ``GPT.apply`` on the same token ids
(atol 1e-4 on the logits: fp32 matmuls and LayerNorm variance summed in
different orders). In 16 bits (both models' weights cast, dense attention
with the in-model causal bias) the logits agree within four units of
the type's roundoff relative to their largest magnitude: bf16 2^-7, fp16
2^-10 (seen 4.9e-3 and 6.1e-4).

The port's model constructors default ``dropout_rate`` as the JAX
dataclasses do.
"""

import inspect

import numpy as np
import pytest
import torch

import jax

from stoke_tpu.models.bert import MultiHeadAttention as JaxMultiHeadAttention
from stoke_tpu.models.bert import TransformerBlock as JaxTransformerBlock
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.utils import init_module
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.models.bert import MultiHeadAttention, TransformerBlock
from stoke_tpu_torch.models.gpt import GPT

pytestmark = pytest.mark.torch_port

VOCAB, MAX_LEN = 257, 128


@pytest.fixture(scope="module")
def jax_gpt():
    model = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN,
                   dropout_rate=0.0)
    variables = init_module(model, jax.random.PRNGKey(0),
                            np.zeros((1, 8), np.int32), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, params


def _to_flax(sd, hidden, heads):
    """Inverse of the conversion, written out independently."""
    D = hidden // heads
    out = {"tok_emb": {"embedding": sd["tok_emb.weight"]},
           "pos_emb": {"embedding": sd["pos_emb.weight"]},
           "ln_final": {"scale": sd["ln_final.weight"],
                        "bias": sd["ln_final.bias"]}}
    n = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers."))
    for i in range(n):
        p = f"layers.{i}."
        out[f"layer_{i}"] = {
            "attention": {
                "qkv": {
                    "kernel": sd[p + "attention.qkv.weight"].T.reshape(
                        hidden, 3, heads, D),
                    "bias": sd[p + "attention.qkv.bias"].reshape(3, heads, D),
                },
                "out": {"kernel": sd[p + "attention.out.weight"].T,
                        "bias": sd[p + "attention.out.bias"]},
            },
            "ln_attn": {"scale": sd[p + "ln_attn.weight"],
                        "bias": sd[p + "ln_attn.bias"]},
            "ff_in": {"kernel": sd[p + "ff_in.weight"].T,
                      "bias": sd[p + "ff_in.bias"]},
            "ff_out": {"kernel": sd[p + "ff_out.weight"].T,
                       "bias": sd[p + "ff_out.bias"]},
            "ln_ff": {"scale": sd[p + "ln_ff.weight"],
                      "bias": sd[p + "ln_ff.bias"]},
        }
    return out


def test_convert_round_trip(jax_gpt):
    _, params = jax_gpt
    sd = gpt_state_dict_from_jax(params)
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN).eval()
    model.load_state_dict(sd, strict=True)
    back = _to_flax({k: v.numpy() for k, v in model.state_dict().items()},
                    hidden=128, heads=2)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_logits_match_jax_apply(jax_gpt):
    jmodel, params = jax_gpt
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN).eval()
    model.load_state_dict(gpt_state_dict_from_jax(params))
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(2, 24)).astype(
        np.int32)
    ref = np.asarray(jmodel.apply({"params": params}, ids, train=False))
    with torch.inference_mode():
        out = model(torch.from_numpy(ids)).numpy()
    assert out.shape == (2, 24, VOCAB)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("dtype,bound", [(torch.bfloat16, 2.0**-7),
                                         (torch.float16, 2.0**-10)])
def test_16bit_logits_match_jax_apply(jax_gpt, dtype, bound):
    """The causal bias is built in fp32 and cast, as the JAX package
    builds it: -1e9 is -inf in fp16, not an overflow error."""
    jmodel, params = jax_gpt
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN).eval()
    model.load_state_dict(gpt_state_dict_from_jax(params))
    model.to(dtype)
    jdtype = {torch.bfloat16: jax.numpy.bfloat16,
              torch.float16: jax.numpy.float16}[dtype]
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(2, 24)).astype(
        np.int32)
    cast = jax.tree_util.tree_map(lambda x: x.astype(jdtype), params)
    ref = np.asarray(jmodel.apply({"params": cast}, ids, train=False),
                     np.float32)
    with torch.inference_mode():
        out = model(torch.from_numpy(ids)).float().numpy()
    assert np.abs(out - ref).max() <= bound * np.abs(ref).max()


def _drop(params, path):
    out = jax.tree_util.tree_map(lambda x: x, params)
    node = out
    for key in path[:-1]:
        node = node[key]
    del node[path[-1]]
    return out


def test_convert_raises_on_missing_key(jax_gpt):
    _, params = jax_gpt
    with pytest.raises(KeyError, match="layer_1/ff_in/kernel"):
        gpt_state_dict_from_jax(_drop(params, ("layer_1", "ff_in", "kernel")))


def test_convert_raises_on_extra_key(jax_gpt):
    _, params = jax_gpt
    extra = dict(params, lm_head={"kernel": np.zeros((128, VOCAB),
                                                      np.float32)})
    with pytest.raises(ValueError, match="lm_head"):
        gpt_state_dict_from_jax(extra)


def test_convert_raises_on_shape_mismatch(jax_gpt):
    _, params = jax_gpt
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["layer_0"]["ff_out"]["kernel"] = np.zeros((256, 128), np.float32)
    with pytest.raises(ValueError, match="ff_out"):
        gpt_state_dict_from_jax(bad)


def test_forward_guards():
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=16).eval()
    ids = torch.zeros(1, 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="kv_cache"):
        model(ids, torch.zeros(1, 1, dtype=torch.int64), decode=True)
    with pytest.raises(ValueError, match="max_len"):
        model(torch.zeros(1, 17, dtype=torch.int64))
    with pytest.raises(ValueError, match="positions"):
        model(ids, torch.tensor([[16]]))


@pytest.mark.parametrize("port_cls, jax_cls", [
    (GPT, JaxGPT),
    (MultiHeadAttention, JaxMultiHeadAttention),
    (TransformerBlock, JaxTransformerBlock),
])
def test_dropout_default_matches_jax(port_cls, jax_cls):
    port = inspect.signature(port_cls).parameters["dropout_rate"].default
    assert port == jax_cls.__dataclass_fields__["dropout_rate"].default
