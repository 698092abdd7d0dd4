"""Port parity: speculative decoding, chunked prefill and the verify kernel.

GPT-tiny weights come from the JAX package's seeded init, carried over by
``gpt_state_dict_from_jax``. Both engines serve the same prompt-lookup
traffic (a short random segment repeated, plus a random tail) in two
waves, with a mix of greedy and seeded sampled requests, under
``ServeConfig(attention="flash", decode_kernel="pallas", sampling=True,
speculative_k=3)``, with and without ``prefill_chunk_tokens``: the port on
the CPU runs its kernels' plain versions, JAX runs its Pallas kernels in
interpret mode. Streams must be token-identical, dispatch counts equal,
and the captured pre-sampling logits within atol 1e-4 (fp32 sums in
different orders). The verify attention is held at atol 1e-5 with fp32
pools and 2e-2 with bf16 pools.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoke_tpu.configs import ServeConfig as JaxServeConfig
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.ops.flash_attention import (
    paged_prefill_chunk_attention as jax_chunk_attention,
    paged_verify_attention as jax_verify_ref,
    paged_verify_attention_pallas as jax_verify_kernel,
)
from stoke_tpu.serving import ServingEngine as JaxServingEngine
from stoke_tpu.serving import propose_draft as jax_propose_draft
from stoke_tpu.serving.kv_cache import PagedAttentionHook as JaxHook
from stoke_tpu.serving.sampling import SamplingParams as JaxSamplingParams
from stoke_tpu.serving.telemetry import ServeMetrics as JaxServeMetrics
from stoke_tpu.status import StokeStatus as JaxStatus
from stoke_tpu.status import StokeValidationError as JaxValidationError
from stoke_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from stoke_tpu.utils import init_module
from stoke_tpu_torch.configs import ServeConfig
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.models.gpt import GPT
from stoke_tpu_torch.ops import (
    paged_prefill_chunk_attention,
    paged_verify_attention,
    paged_verify_attention_pallas,
)
from stoke_tpu_torch.serving import (
    SCRATCH_BLOCK,
    PagedAttentionHook,
    PagedKVCache,
    SamplingParams,
    ServeMetrics,
    ServingEngine,
    propose_draft,
)
from stoke_tpu_torch.status import serve_config_error
from stoke_tpu_torch.telemetry import MetricsRegistry

pytestmark = pytest.mark.torch_port

VOCAB, MAX_LEN = 257, 128
SPEC = dict(max_seqs=3, kv_block_size=8, max_seq_len=64, max_new_tokens=12,
            prefill_pad_multiple=16, attention="flash",
            decode_kernel="pallas", sampling=True, speculative_k=3)
CHUNK = 16
#: per-request sampling: greedy (config default), then seeded draws
KNOBS = [None, dict(temperature=0.8, top_k=50, top_p=0.95, seed=11), None,
         dict(temperature=1.0, seed=5), dict(temperature=0.7, top_p=0.9)]


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
    """Prompt-lookup traffic: a random 3-5 token segment repeated, plus a
    random 3-token tail; 37 and 28 tokens take several 16-token chunks."""
    rng = np.random.default_rng(7)
    out = []
    for n in (12, 20, 37, 9, 28):
        seg = rng.integers(1, VOCAB, size=int(rng.integers(3, 6)))
        body = np.tile(seg, 20)[: n - 3]
        out.append(np.concatenate([body, rng.integers(1, VOCAB, 3)])
                   .astype(np.int32))
    return out


def _port_engine(sd, **kw):
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN).eval()
    return ServingEngine(model, sd, ServeConfig(**{**SPEC, **kw}),
                         device="cpu")


def _drive(engine, prompts, params_cls):
    """Two waves (3 requests, two steps, 2 more), logits captured; returns
    the streams in submission order."""
    engine.capture_logits = True
    sps = [None if k is None else params_cls(**k) for k in KNOBS]
    rids = [engine.submit(p, sampling=s) for p, s in zip(prompts[:3], sps)]
    engine.step()
    engine.step()
    rids += [engine.submit(p, sampling=s)
             for p, s in zip(prompts[3:], sps[3:])]
    engine.run()
    return [list(engine.result(r).tokens) for r in rids], rids


@pytest.fixture(scope="module")
def jax_runs(weights, prompts):
    model, params, _ = weights
    runs = {}
    for name, extra in (("whole", {}),
                        ("chunked", {"prefill_chunk_tokens": CHUNK})):
        engine = JaxServingEngine(model, params,
                                  JaxServeConfig(**SPEC, **extra))
        streams, rids = _drive(engine, prompts, JaxSamplingParams)
        runs[name] = (engine, streams, rids)
    return runs


# --------------------------------------------------------------------------- #
# the slice as a whole
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["whole", "chunked"])
def test_speculative_engine_matches_jax_engine(weights, prompts, jax_runs,
                                               name):
    jeng, jstreams, jrids = jax_runs[name]
    extra = {"prefill_chunk_tokens": CHUNK} if name == "chunked" else {}
    engine = _port_engine(weights[2], **extra)
    streams, rids = _drive(engine, prompts, SamplingParams)
    assert streams == jstreams
    assert all(len(s) == SPEC["max_new_tokens"] for s in streams)
    m, jm = engine.metrics, jeng.metrics
    assert m.decode_steps.value == jm.decode_steps.value
    assert m.prefill_chunks.value == jm.prefill_chunks.value
    assert m.spec_draft_tokens.value == jm.spec_draft_tokens.value
    assert m.spec_accepted_tokens.value == jm.spec_accepted_tokens.value
    assert m.sampled_tokens.value == jm.sampled_tokens.value > 0
    assert m.spec_accepted_tokens.value > 0
    if name == "chunked":
        assert m.prefill_chunks.value > 0
    for rid, jrid in zip(rids, jrids):
        ours = np.stack(engine.captured_logits[rid])
        theirs = np.stack(jeng.captured_logits[jrid])
        assert ours.shape == theirs.shape == (SPEC["max_new_tokens"], VOCAB)
        np.testing.assert_allclose(ours, theirs, atol=1e-4)
    # the slots' key streams end where the JAX engine's end
    assert engine._key_data.dtype == np.uint32
    np.testing.assert_array_equal(engine._key_data, jeng._key_data)
    assert engine.allocator.occupancy == 0.0


def test_speculative_streams_equal_nonspeculative(weights, prompts):
    """Exact-match acceptance changes dispatch counts, never tokens: the
    speculative engine gives the non-speculative sampling engine's greedy
    and seeded sampled streams in fewer decode dispatches."""
    spec = _port_engine(weights[2])
    plain = _port_engine(weights[2], speculative_k=None)
    spec_streams, _ = _drive(spec, prompts, SamplingParams)
    plain_streams, _ = _drive(plain, prompts, SamplingParams)
    assert spec_streams == plain_streams
    assert spec.metrics.decode_steps.value < plain.metrics.decode_steps.value
    assert spec.metrics.sampled_tokens.value == \
        plain.metrics.sampled_tokens.value
    assert plain.metrics.spec_draft_tokens is None
    # the same config replays the same sampled streams
    again, _ = _drive(_port_engine(weights[2]), prompts, SamplingParams)
    assert again == spec_streams


def test_packed_chunks_match_unpacked_chunks(weights):
    """Packing every prefilling slot's chunk into one dispatch gives the
    one-chunk-per-iteration streams in fewer chunk dispatches."""
    long_a = list(range(1, 21)) + [5, 9, 3] * 4   # 32 tokens: 2 chunks
    long_b = list(range(30, 50)) + [11, 2] * 6    # 32 tokens: 2 chunks
    prompts = [np.asarray(p, np.int32) for p in (long_a, long_b)]
    unpacked = _port_engine(weights[2], speculative_k=None, sampling=False,
                            prefill_chunk_tokens=CHUNK)
    packed = _port_engine(weights[2], prefill_chunk_tokens=CHUNK)
    whole = _port_engine(weights[2], speculative_k=None, sampling=False)
    ref = unpacked.generate(prompts, 8)
    assert packed.generate(prompts, 8) == ref == whole.generate(prompts, 8)
    assert unpacked.metrics.prefill_chunks.value == 4.0
    assert packed.metrics.prefill_chunks.value == 2.0
    assert whole.metrics.prefill_chunks.value == 0.0


def test_engine_refuses_sampling_params_without_sampling(weights):
    engine = _port_engine(weights[2], speculative_k=None, sampling=False)
    with pytest.raises(ValueError, match="sampling=True"):
        engine.submit([1, 2, 3], sampling=SamplingParams(temperature=0.5))
    with pytest.raises(ValueError, match="top_k"):
        _port_engine(weights[2]).submit([1, 2], sampling=SamplingParams(
            temperature=0.5, top_k=0))


# --------------------------------------------------------------------------- #
# the verify kernel's wrapper and the chunk attention
# --------------------------------------------------------------------------- #

B, H, D, BS, MB, S = 4, 2, 16, 8, 4, 4
NB = B * MB + 1
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _verify_inputs(seed=0):
    """Slot 0 idle (all-scratch table, positions 0..S-1); slot 1 a short
    draft whose padding rows carry the clamped position 31; slots 2, 3
    full drafts at mixed contexts, one crossing a block boundary."""
    rng = np.random.default_rng(seed)
    tables = np.zeros((B, MB), np.int32)
    perm = rng.permutation(np.arange(1, NB)).astype(np.int32)
    for b in range(1, B):
        tables[b] = perm[b * MB: (b + 1) * MB]
    positions = np.stack([
        np.arange(S),
        np.minimum(28 + np.arange(S), 31),
        5 + np.arange(S),
        14 + np.arange(S),
    ]).astype(np.int32)
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    return q, k, v, tables, positions


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_paged_verify_matches_jax_kernel_and_reference(pool_dtype):
    q, k, v, tables, positions = _verify_inputs()
    tdt, jdt = getattr(torch, pool_dtype), getattr(jnp, pool_dtype)
    out = paged_verify_attention_pallas(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(tables),
        torch.from_numpy(positions),
    )
    assert out.shape == (B, H, S, D) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    jargs = (jnp.asarray(q), jnp.asarray(k).astype(jdt),
             jnp.asarray(v).astype(jdt), jnp.asarray(tables),
             jnp.asarray(positions))
    kern = np.asarray(jax_verify_kernel(*jargs, interpret=True))
    ref = np.asarray(jax_verify_ref(*jargs))
    np.testing.assert_allclose(out.numpy(), kern, atol=ATOL[pool_dtype])
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL[pool_dtype])


def test_paged_verify_idle_slot_row_0_attends_scratch_position_0():
    q, k, v, tables, positions = _verify_inputs(seed=1)
    out = paged_verify_attention_pallas(
        *map(torch.from_numpy, (q, k, v, tables, positions)))
    # position 0 on an all-scratch table: one key, block 0's first value
    np.testing.assert_allclose(out[0, :, 0].numpy(), v[0, 0], atol=1e-6)


def test_paged_verify_wrapper_on_cpu_is_the_plain_version():
    args = tuple(map(torch.from_numpy, _verify_inputs(seed=2)))
    assert torch.equal(paged_verify_attention_pallas(*args),
                       paged_verify_attention(*args))
    assert torch.equal(paged_verify_attention(*args),
                       paged_prefill_chunk_attention(*args))


@pytest.mark.parametrize(
    "bad",
    [
        dict(k=(NB, BS, H + 1, D)),           # heads mismatch
        dict(v=(NB, BS + 1, H, D)),           # pools differ
        dict(tables=(B + 1, MB)),             # table rows != B
        dict(positions=(B, S + 1)),           # positions not [B, S]
    ],
)
def test_paged_verify_rejects_bad_shapes(bad):
    shapes = dict(q=(B, H, S, D), k=(NB, BS, H, D), v=(NB, BS, H, D),
                  tables=(B, MB), positions=(B, S))
    shapes.update(bad)
    q, k, v = (torch.zeros(shapes[n]) for n in "qkv")
    with pytest.raises(ValueError):
        paged_verify_attention_pallas(
            q, k, v, torch.zeros(shapes["tables"], dtype=torch.int32),
            torch.zeros(shapes["positions"], dtype=torch.int32))


def test_paged_verify_refuses_other_devices():
    args = [torch.from_numpy(a) for a in _verify_inputs()]
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_verify_attention_pallas(*args)


def test_paged_prefill_chunk_attention_matches_jax():
    """A 6-query chunk at global positions 10..15 of two requests (the
    second's padding rows clamped), fp32 pools."""
    q, k, v, tables, _ = _verify_inputs(seed=3)
    rng = np.random.default_rng(3)
    qc = rng.normal(size=(2, H, 6, D)).astype(np.float32)
    positions = np.stack([10 + np.arange(6),
                          np.minimum(20 + np.arange(6), 22)]).astype(np.int32)
    ours = paged_prefill_chunk_attention(
        torch.from_numpy(qc), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables[2:]), torch.from_numpy(positions))
    ref = jax_chunk_attention(jnp.asarray(qc), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(tables[2:]),
                              jnp.asarray(positions))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


# --------------------------------------------------------------------------- #
# the hook's chunk and verify modes, and rollback
# --------------------------------------------------------------------------- #


def _hook_case(mode, seed=0):
    """Pools (2 layers, 9 blocks of 4 tokens, 2 heads of dim 8), tables,
    positions, lengths and fresh q/k/v for a 3-query call."""
    rng = np.random.default_rng(seed)
    pools = [rng.normal(size=(2, 9, 4, 2, 8)).astype(np.float32)
             for _ in range(2)]
    tables = np.array([[3, 5, 7, 0], [2, 6, 0, 0], [0, 0, 0, 0]], np.int32)
    if mode == "chunk":
        positions = np.array([[8, 9, 10], [4, 5, 6], [0, 1, 2]], np.int32)
        lengths = np.array([11, 6, 0], np.int32)  # slot 1: one padding row
    else:
        positions = np.array([[6, 7, 8], [3, 4, 5], [0, 1, 2]], np.int32)
        lengths = np.array([9, 5, 0], np.int32)  # slot 1: a 1-token draft
    qkv = [rng.normal(size=(3, 2, 3, 8)).astype(np.float32)
           for _ in range(3)]
    return pools, tables, positions, lengths, qkv


@pytest.mark.parametrize("mode", ["chunk", "verify"])
def test_hook_multi_query_modes_match_jax_hook(mode):
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
        decode_interpret=True, **impl,
    )
    out = ours.layer_attention(1)(*map(torch.from_numpy, qkv), None)
    ref = theirs.layer_attention(1)(*map(jnp.asarray, qkv), None)
    for a, b in ((ours.k_pages, theirs.k_pages),
                 (ours.v_pages, theirs.v_pages)):
        # scratch block 0 takes several padding writes at one address,
        # whose winner is unspecified in both packages
        np.testing.assert_array_equal(a[:, 1:].numpy(), np.asarray(b)[:, 1:])
    np.testing.assert_array_equal(ours.k_pages[0].numpy(), pools[0][0])
    # the idle slot's rows attend scratch and are discarded
    np.testing.assert_allclose(out[:2].numpy(), np.asarray(ref)[:2],
                               atol=1e-5)
    if mode == "verify":
        n_keep = np.array([2, 1, 1], np.int32)
        ours.rollback(torch.from_numpy(n_keep))
        theirs.rollback(jnp.asarray(n_keep))
        for a, b in ((ours.k_pages, theirs.k_pages),
                     (ours.v_pages, theirs.v_pages)):
            np.testing.assert_array_equal(a[:, 1:].numpy(),
                                          np.asarray(b)[:, 1:])


def test_verify_rollback_never_dirties_cache():
    """After ``rollback(n_keep)`` every verify row past the accepted
    window holds its bytes from before the dispatch, kept rows hold the
    fresh write, and nothing else but the scratch block moved (the JAX
    package's ``test_verify_rollback_never_dirties_cache``)."""
    NB_, BS_, H_, D_ = 5, 4, 2, 3
    rng = np.random.default_rng(0)
    k0 = rng.normal(size=(1, NB_, BS_, H_, D_)).astype(np.float32)
    v0 = rng.normal(size=(1, NB_, BS_, H_, D_)).astype(np.float32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    positions = np.array([[2, 3, 4], [0, 1, 2]], np.int32)
    lengths = np.array([5, 3], np.int32)
    hook = PagedAttentionHook(
        torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()),
        torch.from_numpy(tables), torch.from_numpy(positions),
        mode="verify", lengths=torch.from_numpy(lengths))
    kw = torch.from_numpy(rng.normal(size=(2, H_, 3, D_)).astype(np.float32))
    vw = torch.from_numpy(rng.normal(size=(2, H_, 3, D_)).astype(np.float32))
    hook._write_layer(0, kw, vw)
    written_k = hook.k_pages.numpy().copy()
    hook.rollback(torch.tensor([2, 1], dtype=torch.int32))
    k_after, v_after = hook.k_pages.numpy(), hook.v_pages.numpy()

    def addr(slot, pos):
        return (0, int(tables[slot, pos // BS_]), pos % BS_)

    for slot, pos in [(0, 2), (0, 3), (1, 0)]:  # kept
        np.testing.assert_array_equal(k_after[addr(slot, pos)],
                                      written_k[addr(slot, pos)])
    rejected = [(0, 4), (1, 1), (1, 2)]
    for slot, pos in rejected:
        np.testing.assert_array_equal(k_after[addr(slot, pos)],
                                      k0[addr(slot, pos)])
        np.testing.assert_array_equal(v_after[addr(slot, pos)],
                                      v0[addr(slot, pos)])
    diff = np.argwhere(written_k != k_after)
    assert set(diff[:, 1]) <= {SCRATCH_BLOCK} | {
        int(tables[s, p // BS_]) for s, p in rejected}


def test_rollback_is_verify_only_and_unknown_modes_raise():
    z = torch.zeros(1, 2, 4, 1, 8)
    one = torch.zeros(1, 1, dtype=torch.int32)
    hook = PagedAttentionHook(z, z, one, one, mode="chunk",
                              lengths=torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="verify-mode"):
        hook.rollback(torch.ones(1, dtype=torch.int32))


def test_kv_pool_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(1, 3, 4, 2, 8)
    pool = PagedKVCache(1, 3, 4, 2, 8, device="cpu")
    assert pool.k_pages.device.type == "cpu"
    assert pool.nbytes == 2 * 3 * 4 * 2 * 8 * 4


# --------------------------------------------------------------------------- #
# drafter, telemetry and the serve status rules
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(4))
def test_propose_draft_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(0, 40))
        history = rng.integers(0, int(rng.integers(2, 6)), size=n)
        k = int(rng.integers(0, 6))
        lo = int(rng.integers(1, 3))
        hi = lo + int(rng.integers(0, 3))
        assert propose_draft(history, k, ngram_max=hi, ngram_min=lo) == \
            jax_propose_draft(history, k, ngram_max=hi, ngram_min=lo)


def test_serve_metrics_speculative_fields_match_jax():
    ours, theirs = ServeMetrics(MetricsRegistry()), JaxServeMetrics(
        JaxRegistry())
    assert "serve/spec_draft_tokens" not in ours.event_fields()
    for m in (ours, theirs):
        m.enable_speculative()
        m.spec_draft_tokens.inc(9)
        m.spec_accepted_tokens.inc(4)
        m.prefill_chunks.inc(2)
        m.sampled_tokens.inc(5)
    a, b = ours.event_fields(), theirs.event_fields()
    assert set(a) <= set(b)
    assert a == {key: b[key] for key in a}
    assert a["serve/spec_accepted_tokens"] == 4


SERVE_RULES = [
    (dict(prefill_chunk_tokens=0), "prefill_chunk_tokens must be >= 1"),
    (dict(prefill_chunk_tokens=20), "multiple of prefill_pad_multiple"),
    (dict(prefill_chunk_tokens=128), "no prompt could"),
    (dict(sampling=True, temperature=-1.0), "temperature must be >= 0"),
    (dict(sampling=True, top_k=0), "top_k must be >= 1"),
    (dict(sampling=True, top_p=1.5), "top_p must be in"),
    (dict(temperature=0.5), "sampling=False"),
    (dict(sampling=True, speculative_k=0), "speculative_k must be >= 1"),
    (dict(speculative_k=3), "needs sampling=True"),
    (dict(sampling=True, speculative_k=8, prefill_chunk_tokens=8,
          prefill_pad_multiple=8), "chunk budget"),
    (dict(sampling=True, speculative_k=3, speculative_ngram_min=0),
     "speculative_ngram_min must be >= 1"),
    (dict(sampling=True, speculative_k=3, speculative_ngram_min=3,
          speculative_ngram_max=2), "range is empty"),
    (dict(speculative_ngram_max=5), "drafter knobs set"),
    (dict(verify_pages_per_block=4), "speculative_k=None"),
    (dict(sampling=True, speculative_k=3, verify_block_h=1), "pallas"),
]


@pytest.mark.parametrize("kw,match", SERVE_RULES,
                         ids=[m for _, m in SERVE_RULES])
def test_serve_status_messages_match_jax(kw, match):
    cfg = {**dict(max_seqs=2, kv_block_size=8, max_seq_len=64,
                  prefill_pad_multiple=16), **kw}
    ours = serve_config_error(ServeConfig(**cfg))
    with pytest.raises(JaxValidationError) as theirs:
        JaxStatus(batch_size_per_device=1,
                  configs=[JaxServeConfig(**cfg)])
    assert ours is not None and match in ours
    assert str(theirs.value) == f"Stoke -- illegal combination: {ours}"


def test_serve_status_accepts_the_slice_configs():
    for kw in (SPEC, {**SPEC, "prefill_chunk_tokens": CHUNK},
               dict(sampling=True, temperature=0.7, top_k=5, top_p=0.9),
               dict(prefill_chunk_tokens=64)):
        assert serve_config_error(ServeConfig(**kw)) is None
