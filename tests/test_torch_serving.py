"""Port parity: the serving slice against the JAX serving engine.

GPT-tiny weights are initialised by the JAX package from a seed and
converted; both engines serve the same prompts under the same staggered
admission with ``attention="flash"`` and ``decode_kernel="pallas"`` (the
port on the CPU runs its kernels' plain versions; JAX runs its Pallas
kernels in interpret mode). Greedy streams must be token-identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stoke_tpu.configs import ServeConfig as JaxServeConfig
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.serving import BlockAllocator as JaxBlockAllocator
from stoke_tpu.serving import ServingEngine as JaxServingEngine
from stoke_tpu.serving.kv_cache import PagedAttentionHook as JaxHook
from stoke_tpu.serving.telemetry import ServeMetrics as JaxServeMetrics
from stoke_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from stoke_tpu.utils import init_module
from stoke_tpu_torch.configs import ServeConfig
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.models.gpt import GPT
from stoke_tpu_torch.serving import (
    SCRATCH_BLOCK,
    BlockAllocator,
    PagedAttentionHook,
    ServeMetrics,
    ServingEngine,
    resolve_device,
)
from stoke_tpu_torch.telemetry import MetricsRegistry

pytestmark = pytest.mark.torch_port

VOCAB, MAX_LEN = 257, 128
SERVE = dict(max_seqs=3, kv_block_size=8, max_seq_len=64, max_new_tokens=5,
             prefill_pad_multiple=16, attention="flash",
             decode_kernel="pallas")


@pytest.fixture(scope="module")
def weights():
    model = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN,
                   dropout_rate=0.0)
    variables = init_module(model, jax.random.PRNGKey(0),
                            np.zeros((1, 8), np.int32), train=False)
    params = variables["params"]
    sd = gpt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    return model, params, sd


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(1, VOCAB, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 30, size=6)]


def _port_engine(sd, **kw):
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN).eval()
    return ServingEngine(model, sd, ServeConfig(**{**SERVE, **kw}),
                         device="cpu")


def _staggered(engine, prompts):
    rids = [engine.submit(p) for p in prompts[:3]]
    engine.step()
    engine.step()
    rids += [engine.submit(p) for p in prompts[3:5]]
    engine.step()
    rids += [engine.submit(p) for p in prompts[5:]]
    engine.run()
    return [list(engine.result(r).tokens) for r in rids]


@pytest.fixture(scope="module")
def jax_streams(weights, prompts):
    model, params, _ = weights
    engine = JaxServingEngine(model, params, JaxServeConfig(**SERVE))
    return _staggered(engine, prompts)


# --------------------------------------------------------------------------- #
# the slice as a whole
# --------------------------------------------------------------------------- #


def test_engine_streams_match_jax_engine(weights, prompts, jax_streams):
    engine = _port_engine(weights[2])
    streams = _staggered(engine, prompts)
    assert streams == jax_streams
    assert all(len(s) == SERVE["max_new_tokens"] for s in streams)
    assert engine.allocator.occupancy == 0.0
    assert engine.metrics.kv_occupancy.value == 0.0
    assert engine.metrics.completed.value == len(prompts)


def test_paged_forward_logits_match_jax(weights, prompts):
    """Logits of the paged prefill and of two decode steps (fed tokens
    that are not the argmax, so decode attends over a varied context)
    through both packages' hooks and kernels' paths, atol 1e-4."""
    jmodel, params, sd = weights
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN).eval()
    model.load_state_dict(sd)
    prompt = prompts[0]
    plen, P, NB, BS = prompt.size, 32, 9, 8
    padded = np.zeros((1, P), np.int32)
    padded[0, :plen] = prompt
    table = np.array([[2, 4, 6, 8]], np.int32)
    shape = (2, NB, BS, 2, 64)
    kt, vt = torch.zeros(shape), torch.zeros(shape)
    kj, vj = jnp.zeros(shape), jnp.zeros(shape)
    impl = dict(attention_impl="flash", decode_impl="pallas")

    def step(tokens, positions, mode, lengths):
        nonlocal kj, vj
        ours = PagedAttentionHook(
            kt, vt, torch.from_numpy(table), torch.from_numpy(positions),
            mode=mode, lengths=torch.from_numpy(lengths), **impl)
        with torch.inference_mode():
            out = model(torch.from_numpy(tokens), torch.from_numpy(positions),
                        decode=mode == "decode", kv_cache=ours)
        theirs = JaxHook(kj, vj, jnp.asarray(table), jnp.asarray(positions),
                         mode=mode, lengths=jnp.asarray(lengths), **impl)
        ref = jmodel.apply({"params": params}, jnp.asarray(tokens),
                           train=False, positions=jnp.asarray(positions),
                           decode=mode == "decode", kv_cache=theirs)
        kj, vj = theirs.k_pages, theirs.v_pages
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)

    step(padded, np.arange(P, dtype=np.int32)[None], "prefill",
         np.array([plen], np.int32))
    for i, tok in enumerate((17, 200)):
        pos = plen + i
        step(np.array([[tok]], np.int32), np.array([[pos]], np.int32),
             "decode", np.array([pos + 1], np.int32))
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-5)


def test_staggered_admission_matches_sequential(weights, prompts):
    seq = _port_engine(weights[2])
    sequential = [seq.generate([p])[0] for p in prompts]
    assert _staggered(_port_engine(weights[2]), prompts) == sequential
    # the plain attention path gives the same greedy streams
    plain = _port_engine(weights[2], attention="dense",
                         decode_kernel="reference")
    assert plain.generate(prompts) == sequential


def test_summary_counts(weights, prompts):
    engine = _port_engine(weights[2])
    engine.generate(prompts[:2], max_new_tokens=3)
    s = engine.summary()
    assert s["device"] == "cpu"
    assert s["prefills"] == 2 and s["tokens_out"] == 6
    assert s["completed"] == 2 and s["kv_blocks_used"] == 0
    assert s["ttft_p50_s"] is not None and s["tpot_p99_s"] is not None
    wall = sum(s["goodput_s"].values())
    assert wall > 0


def test_serve_metrics_event_fields_match_jax():
    ours, theirs = ServeMetrics(MetricsRegistry()), JaxServeMetrics(
        JaxRegistry())
    for m in (ours, theirs):
        for v in (0.02, 0.5, 0.1):
            m.observe_ttft(v)
        for v in (0.004, 0.006):
            m.observe_tpot(v)
        m.requests.inc(3)
        m.tokens_out.inc(17)
        m.kv_occupancy.set(0.25)
    a, b = ours.event_fields(), theirs.event_fields()
    assert set(a) <= set(b)
    assert a == {k: b[k] for k in a}
    assert a["serve/ttft_p50_s"] == 0.1 and a["serve/tpot_p99_s"] == 0.006


# --------------------------------------------------------------------------- #
# block allocator and the hook's page writes
# --------------------------------------------------------------------------- #


def test_block_allocator_parity():
    rng = np.random.default_rng(3)
    ours, theirs = BlockAllocator(17, 8), JaxBlockAllocator(17, 8)
    held = []
    for _ in range(40):
        if held and rng.random() < 0.5:
            blocks = held.pop(int(rng.integers(len(held))))
            ours.free(blocks)
            theirs.free(blocks)
        else:
            n = int(rng.integers(1, 6))
            got = ours.alloc(n)
            assert got == theirs.alloc(n)
            if got is not None:
                assert SCRATCH_BLOCK not in got
                held.append(got)
        assert ours.free_blocks == theirs.free_blocks
        assert ours.occupancy == theirs.occupancy
    for blocks in held:
        ours.free(blocks)
    assert ours.occupancy == 0.0
    assert ours.blocks_for(9) == theirs.blocks_for(9) == 2
    with pytest.raises(ValueError, match="scratch"):
        ours.free([SCRATCH_BLOCK])
    got = ours.alloc(2)
    ours.free(got)
    with pytest.raises(ValueError, match="double free"):
        ours.free(got[:1])
    with pytest.raises(ValueError):
        BlockAllocator(1, 8)


def _hook_case(mode, seed=0):
    """Pools, tables, positions, lengths and fresh q/k/v for one hook call
    (2 layers, 9 blocks of 4 tokens, 2 heads of dim 8)."""
    rng = np.random.default_rng(seed)
    NL, NB, BS, H, D = 2, 9, 4, 2, 8
    pools = [rng.normal(size=(NL, NB, BS, H, D)).astype(np.float32)
             for _ in range(2)]
    if mode == "prefill":
        tables = np.array([[3, 5, 7, 0]], np.int32)
        positions = np.arange(12, dtype=np.int32)[None]  # padded prompt
        lengths = np.array([9], np.int32)
    else:
        tables = np.array([[3, 5, 7, 0], [2, 6, 0, 0], [0, 0, 0, 0]],
                          np.int32)
        positions = np.array([[9], [4], [0]], np.int32)
        lengths = np.array([10, 5, 1], np.int32)  # slot 2 inactive
    B, L = positions.shape
    qkv = [rng.normal(size=(B, H, L, D)).astype(np.float32)
           for _ in range(3)]
    return pools, tables, positions, lengths, qkv


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_hook_page_writes_match_jax_hook(mode):
    pools, tables, positions, lengths, qkv = _hook_case(mode)
    impl = dict(attention_impl="flash", decode_impl="pallas")
    ours = PagedAttentionHook(
        *(torch.from_numpy(a.copy()) for a in pools),
        torch.from_numpy(tables), torch.from_numpy(positions),
        mode=mode, lengths=torch.from_numpy(lengths), **impl,
    )
    theirs = JaxHook(
        *(jnp.asarray(a) for a in pools), jnp.asarray(tables),
        jnp.asarray(positions), mode=mode, lengths=jnp.asarray(lengths),
        **impl,
    )
    out = ours.layer_attention(1)(*map(torch.from_numpy, qkv), None)
    ref = theirs.layer_attention(1)(*map(jnp.asarray, qkv), None)
    np.testing.assert_array_equal(ours.k_pages.numpy(),
                                  np.asarray(theirs.k_pages))
    np.testing.assert_array_equal(ours.v_pages.numpy(),
                                  np.asarray(theirs.v_pages))
    # layer 0 untouched, and only the written rows moved
    np.testing.assert_array_equal(ours.k_pages[0].numpy(), pools[0][0])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_hook_refuses_later_modes():
    """Every mode of the JAX hook is served now; a mode neither package
    knows is refused."""
    z = torch.zeros(1, 2, 4, 1, 8)
    for mode in ("draft", "Verify", ""):
        with pytest.raises(ValueError, match="unknown PagedAttentionHook"):
            PagedAttentionHook(z, z, torch.zeros(1, 1, dtype=torch.int32),
                               torch.zeros(1, 1, dtype=torch.int32),
                               mode=mode, lengths=torch.ones(1))


# --------------------------------------------------------------------------- #
# construction
# --------------------------------------------------------------------------- #


def test_default_device_without_cuda_raises(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN).eval()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, weights[2], ServeConfig(**SERVE))
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


# the first four were later-slice refusals before sampling, speculative
# decoding and chunked prefill were ported; they are now the serve status
# rules' ValueErrors. The fifth, int8 weights, was refused until item 3b
# and now builds (exc None: the engine serves the quantized store). The
# last two, the cost cards and the SLO targets, were refused until item
# 10c: cost cards without an AttributionConfig's peaks raise the JAX
# engine's ValueError, and an SLO default builds (exc None)
LATER = [
    (dict(sampling=True, top_k=0), ValueError, "top_k must be >= 1"),
    (dict(speculative_k=2), ValueError, "needs sampling=True"),
    (dict(temperature=0.7), ValueError, "sampling=False"),
    (dict(prefill_chunk_tokens=40), ValueError,
     "multiple of prefill_pad_multiple"),
    (dict(quant="int8"), None, None),
    (dict(cost_cards=True), ValueError, "needs the hardware peaks"),
    (dict(slo_ttft_target_s=1.0), None, None),
]


@pytest.mark.parametrize("later", range(len(LATER)),
                         ids=[f"later{i}" for i in range(len(LATER))])
def test_later_slice_features_raise(weights, later):
    kw, exc, match = LATER[later]
    if exc is None:
        engine = _port_engine(weights[2], **kw)
        if "quant" in kw:
            assert engine.quant_stats["compression"] > 1.0
            assert engine.qparams is not None and engine.quant_errors
        else:
            assert engine.cfg.slo_ttft_target_s == 1.0
            assert engine.summary()["slo"] == {"active": False}
        return
    with pytest.raises(exc, match=match):
        _port_engine(weights[2], **kw)


@pytest.mark.parametrize(
    "bad",
    [dict(decode_pages_per_block=0), dict(attention="ring"),
     dict(decode_kernel="triton"), dict(kv_dtype="float16"),
     dict(max_seq_len=256)],
)
def test_engine_rejects_bad_config(weights, bad):
    with pytest.raises(ValueError):
        _port_engine(weights[2], **bad)


def test_engine_takes_the_pages_knobs_and_refuses_a_head_block(weights):
    """decode_pages_per_block (under the JAX rule: the pallas decode
    kernel) is accepted and has no effect, as the kernels' tile is fixed;
    a head block is a grid dimension of the CUDA kernels, and refused."""
    engine = _port_engine(weights[2], decode_kernel="pallas",
                          decode_pages_per_block=4)
    assert engine.cfg.decode_pages_per_block == 4
    with pytest.raises(ValueError, match="grid dimension"):
        _port_engine(weights[2], decode_kernel="pallas", decode_block_h=1)


def test_engine_serves_gpt_only(weights):
    with pytest.raises(TypeError):
        ServingEngine(torch.nn.Linear(2, 2), weights[2],
                      ServeConfig(**SERVE), device="cpu")


def test_engine_bf16_kv_pool(weights, prompts):
    """bf16 pages with fp32 weights: the pool's dtype differs from the
    query's, and streams stay whole."""
    engine = _port_engine(weights[2], kv_dtype="bfloat16")
    assert engine.cache.k_pages.dtype == torch.bfloat16
    out = engine.generate(prompts[:3])
    assert [len(s) for s in out] == [SERVE["max_new_tokens"]] * 3
