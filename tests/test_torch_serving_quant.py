"""Port parity: int8 and bf16 serving weights (spec: the quant cases of
``tests/test_serving.py``).

GPT-tiny weights are initialised by the JAX package from a seed and
converted. ``quantize_params`` runs on the flax params tree in the JAX
package and on the port's state dict with the model's JAX layout; the
payloads, the scales, the byte counts and the per-leaf errors are equal
exactly (the same function on the same elements in the same order). So
the dequantized weights are equal, and the port's int8 engine emits the
JAX int8 engine's greedy streams token for token (dense attention, both
packages' engines). Against the unquantized engine the int8 streams
agree on >= 99% of tokens with >= 3.5x compression (the JAX test's
acceptance).
"""

import jax
import numpy as np
import pytest
import torch

from stoke_tpu.configs import ServeConfig as JaxServeConfig
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.serving import ServingEngine as JaxServingEngine
from stoke_tpu.serving import quant as jq
from stoke_tpu.utils import init_module
from stoke_tpu_torch.configs import ServeConfig
from stoke_tpu_torch.convert import gpt_state_dict_from_jax, jax_param_layout
from stoke_tpu_torch.models.gpt import GPT
from stoke_tpu_torch.serving import ServingEngine
from stoke_tpu_torch.serving import quant as pq

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


VOCAB, MAX_LEN = 257, 64
SERVE = dict(max_seqs=3, kv_block_size=8, max_seq_len=48, max_new_tokens=8,
             prefill_pad_multiple=16)
QUANT = dict(quant="int8", quant_min_size=256)


@pytest.fixture(scope="module")
def weights():
    model = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN,
                   dropout_rate=0.0)
    variables = init_module(model, jax.random.PRNGKey(0),
                            np.zeros((1, 8), np.int32), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return model, params, gpt_state_dict_from_jax(params)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, VOCAB, size=int(n)).astype(np.int32)
            for n in rng.integers(4, 20, size=5)]


def _port_model():
    return GPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN,
               dropout_rate=0.0).eval()


def _port(weights, **kw):
    return ServingEngine(_port_model(), weights[2],
                         ServeConfig(**{**SERVE, **kw}), device="cpu")


def _jax(weights, **kw):
    return JaxServingEngine(weights[0], weights[1],
                            JaxServeConfig(**{**SERVE, **kw}))


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda l: isinstance(l, jq.QuantizedTensor))


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("chunk", [128, 512])
def test_quantize_params_matches_jax(weights, stochastic, chunk):
    """Which leaves quantize, their payloads and scales, in the JAX
    flatten order and layout; each leaf's stochastic key is
    ``fold_in(PRNGKey(seed), i)``."""
    kw = dict(chunk_elems=chunk, stochastic=stochastic, min_size=256,
              seed=4)
    want = _jax_leaves(jq.quantize_params(weights[1], "int8", **kw))
    got = pq.quantize_params(weights[2], "int8", **kw,
                             layout=jax_param_layout(_port_model()))
    assert len(got) == len(want)
    quantized = 0
    for (name, g), w in zip(got.items(), want):
        assert isinstance(g, pq.QuantizedTensor) == isinstance(
            w, jq.QuantizedTensor), name
        if not isinstance(w, jq.QuantizedTensor):
            continue
        quantized += 1
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q), name)
        np.testing.assert_array_equal(g.scales.numpy(), np.asarray(w.scales))
        assert (g.shape, g.pad) == (w.shape, w.pad)
        np.testing.assert_array_equal(g.dequantize().numpy(),
                                      np.asarray(w.dequantize()))
    assert quantized >= 8
    # the dequantized store, in the port's layout, is the JAX one carried
    # over by the converter
    jdeq = jax.tree_util.tree_map(np.asarray, jq.dequantize_params(
        jq.quantize_params(weights[1], "int8", **kw)))
    for name, t in gpt_state_dict_from_jax(jdeq).items():
        np.testing.assert_array_equal(pq.dequantize_params(got)[name].numpy(),
                                      t.numpy(), name)


def test_bytes_compression_and_errors_match_jax(weights):
    kw = dict(chunk_elems=128, min_size=256)
    layout = jax_param_layout(_port_model())
    jqp = jq.quantize_params(weights[1], "int8", **kw)
    qp = pq.quantize_params(weights[2], "int8", **kw, layout=layout)
    assert pq.param_bytes(weights[2]) == jq.param_bytes(weights[1])
    assert pq.param_bytes(qp) == jq.param_bytes(jqp)
    assert pq.compression_stats(weights[2], qp) == jq.compression_stats(
        weights[1], jqp)
    got = pq.quantization_error(weights[2], qp, layout)
    want = jq.quantization_error(weights[1], jqp)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_bf16_mode_matches_jax(weights):
    """bf16 casts every float leaf (2x) and dequantizes back to fp32, as
    the JAX package does; ``none`` is the identity; other modes raise."""
    got = pq.quantize_params(weights[2], "bf16")
    want = jq.quantize_params(weights[1], "bf16")
    assert pq.compression_stats(weights[2], got) == jq.compression_stats(
        weights[1], want)
    assert pq.compression_stats(weights[2], got)["compression"] == 2.0
    deq = gpt_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jq.dequantize_params(want)))
    for name, t in pq.dequantize_params(got).items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), deq[name].numpy())
    assert pq.quantize_params(weights[2], "none") is weights[2]
    with pytest.raises(ValueError):
        pq.quantize_params(weights[2], "int4")


def test_int8_serving_compression_and_agreement(weights, prompts):
    """>= 3.5x parameter-bytes compression while the greedy streams agree
    with the unquantized engine's on >= 99% of tokens; the module keeps
    no storage of the quantized leaves."""
    ref = _port(weights).generate(prompts)
    eng = _port(weights, **QUANT)
    assert eng.quant_stats["compression"] >= 3.5
    assert eng.metrics.quant_compression.value >= 3.5
    assert eng.metrics.event_fields()["serve/quant_compression"] >= 3.5
    streams = eng.generate(prompts)
    pairs = [(x, y) for a, b in zip(streams, ref) for x, y in zip(a, b)]
    assert sum(x == y for x, y in pairs) / len(pairs) >= 0.99
    freed = [n for n, p in eng.model.named_parameters()
             if p.untyped_storage().nbytes() == 0]
    assert sorted(freed) == sorted(
        n for n, v in eng.qparams.items()
        if isinstance(v, pq.QuantizedTensor))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_streams_equal_the_jax_engines(weights, prompts, mode):
    """The port's quantized engine and the JAX one serve the same
    dequantized weights, so their greedy streams are equal; the
    engines' compression and per-leaf errors too."""
    kw = {**QUANT, "quant": mode}
    jax_eng = _jax(weights, **kw)
    eng = _port(weights, **kw)
    assert eng.generate(prompts) == jax_eng.generate(prompts)
    assert eng.quant_stats == jax_eng.quant_stats
    assert sorted(eng.quant_errors) == sorted(jax_eng.quant_errors)
    for k, v in jax_eng.quant_errors.items():
        assert eng.quant_errors[k] == pytest.approx(v, rel=1e-12)


def test_stochastic_quantization_rides_the_transport_rounding():
    """``stochastic=True`` goes through the transports' unbiased rounding:
    over seeds the dequantized mean is no farther from the truth than
    round-to-nearest's (the JAX test)."""
    x = {"w": torch.full((64, 64), 0.3)}
    draws = [pq.dequantize_params(pq.quantize_params(
        x, "int8", chunk_elems=64, min_size=1, stochastic=True, seed=s))["w"]
        for s in range(8)]
    mean = torch.stack(draws).mean(0)
    det = pq.dequantize_params(pq.quantize_params(
        x, "int8", chunk_elems=64, min_size=1))["w"]
    assert abs(float(mean.mean()) - 0.3) <= abs(float(det.mean()) - 0.3) + 1e-4
    jx = {"w": np.full((64, 64), 0.3, np.float32)}
    want = jq.quantize_params(jx, "int8", chunk_elems=64, min_size=1,
                              stochastic=True, seed=3)["w"]
    got = pq.quantize_params(x, "int8", chunk_elems=64, min_size=1,
                             stochastic=True, seed=3)["w"]
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
