"""Port parity: the sampler against ``stoke_tpu.serving.sampling``.

The port's threefry-2x32, partitionable ``split`` and 32-bit bits are held
bit-exact against ``jax.random`` for several seeds. Gumbel values go
through two float32 ``log``s, and XLA's CPU ``log`` is one ulp away from
torch's in about 14% of elements, so they are held at rtol 1e-6 with atol
1e-6 (one ulp of the inner log near ``g = 0``, where a relative tolerance
means nothing). The draws themselves (``sample_tokens``,
``speculative_sample_tokens``, ``accept_drafts``, ``select_key_data``) must
give the same tokens and key data as the JAX functions on the same numpy
logits and key data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoke_tpu.serving import sampling as jsamp
from stoke_tpu_torch.serving import sampling as psamp

pytestmark = pytest.mark.torch_port

SEEDS = [0, 1, 3, 123, 2**31 - 1, 2**31 + 7, -1]
V = 257


def _kd(seeds):
    """Host uint32 key data of ``seeds`` (the JAX package's)."""
    return np.stack([jsamp.initial_key_data(s) for s in seeds])


def _dev(kd):
    return psamp.key_data_to_device(kd)


def _host(kd):
    return kd.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_split_and_bits_are_bit_exact(seed):
    kd = jsamp.initial_key_data(seed)
    np.testing.assert_array_equal(psamp.initial_key_data(seed), kd)
    assert psamp.initial_key_data(seed).dtype == np.uint32
    carry, sub = psamp.split_key_data(_dev(kd[None]))
    jcarry, jsub = jsamp.split_key_data(jnp.asarray(kd[None]))
    np.testing.assert_array_equal(_host(carry), np.asarray(jcarry))
    np.testing.assert_array_equal(_host(sub),
                                  np.asarray(jax.random.key_data(jsub)))
    key = jax.random.wrap_key_data(jnp.asarray(kd))
    bits = np.asarray(jax.random.bits(key, (1000,), jnp.uint32))
    np.testing.assert_array_equal(
        psamp.random_bits(_dev(kd), 1000).numpy().astype(np.uint32), bits)


def test_split_chain_stays_bit_exact():
    """Eight splits in a row from five seeds: the carried state never
    drifts from ``jax.random.split``."""
    kd = _kd(SEEDS[:5])
    ours, theirs = _dev(kd), jnp.asarray(kd)
    for _ in range(8):
        ours, _ = psamp.split_key_data(ours)
        theirs, _ = jsamp.split_key_data(theirs)
        np.testing.assert_array_equal(_host(ours), np.asarray(theirs))


def test_host_split_chain_matches_device_and_jax():
    """The engine splits on the host in numpy uint32 (wrapping
    arithmetic); the chain equals the device's int64 chain and
    ``speculative_sample_tokens``'s key stack, from host or device key
    data alike."""
    kd = _kd(SEEDS)
    carries, subs = psamp.split_chain(kd, 5)
    assert carries.dtype == subs.dtype == np.uint32
    dev_carries, dev_subs = psamp.split_chain(_dev(kd), 5)
    np.testing.assert_array_equal(carries, _host(dev_carries))
    np.testing.assert_array_equal(subs, _host(dev_subs))
    theirs = jnp.asarray(kd)
    for i in range(5):
        theirs, jsub = jsamp.split_key_data(theirs)
        np.testing.assert_array_equal(carries[i], np.asarray(theirs))
        np.testing.assert_array_equal(subs[i],
                                      np.asarray(jax.random.key_data(jsub)))
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(len(SEEDS), 5, V))
                              .astype(np.float32))
    knobs = [torch.from_numpy(a) for a in _knobs("mixed", 6)]
    knobs = [torch.cat([a, a[:1]]) for a in knobs]  # 7 rows
    host = psamp.speculative_sample_tokens(logits, kd, *knobs)
    dev = psamp.speculative_sample_tokens(logits, _dev(kd), *knobs)
    assert torch.equal(host[0], dev[0])
    np.testing.assert_array_equal(host[1], _host(dev[1]))


def test_threefry_known_answer():
    """Random123's known-answer vector for Threefry-2x32 (20 rounds):
    key (0, 0), counter (0, 0)."""
    z = torch.zeros(1, dtype=torch.int64)
    x1, x2 = psamp.threefry2x32(z, z, z, z)
    assert (int(x1), int(x2)) == (0x6B200159, 0x99BA4EFE)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_gumbel_matches_jax(seed):
    kd = jsamp.initial_key_data(seed)
    key = jax.random.wrap_key_data(jnp.asarray(kd))
    ref = np.asarray(jax.random.gumbel(key, (4096,), jnp.float32))
    ours = psamp.gumbel(_dev(kd), 4096)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)


def _knobs(mode, B):
    """(temperature, top_k, top_p) rows of one sampling mode."""
    t = np.full(B, 0.8, np.float32)
    k = np.zeros(B, np.int32)
    p = np.ones(B, np.float32)
    if mode == "greedy":
        t[:] = 0.0
    elif mode == "top_k":
        k[:] = [1, 2, 5, 40, 257, 300][:B]
    elif mode == "top_p":
        p[:] = [0.05, 0.5, 0.9, 0.95, 0.99, 1.0][:B]
    elif mode == "mixed":
        t[:] = [0.0, 0.7, 1.3, 0.9, 0.5, 1.0][:B]
        k[:] = [0, 0, 7, 50, 0, 3][:B]
        p[:] = [1.0, 0.9, 1.0, 0.95, 0.3, 0.8][:B]
    return t, k, p


@pytest.mark.parametrize("mode",
                         ["greedy", "temperature", "top_k", "top_p", "mixed"])
def test_sample_tokens_matches_jax(mode):
    rng = np.random.default_rng(1)
    B = 6
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    t, k, p = _knobs(mode, B)
    kd = _kd(range(10, 10 + B))
    _, jsub = jsamp.split_key_data(jnp.asarray(kd))
    ref = np.asarray(jsamp.sample_tokens(
        jnp.asarray(logits), jsub, jnp.asarray(t), jnp.asarray(k),
        jnp.asarray(p)))
    _, sub = psamp.split_key_data(_dev(kd))
    ours = psamp.sample_tokens(torch.from_numpy(logits), sub,
                               *map(torch.from_numpy, (t, k, p)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    if mode == "greedy":
        np.testing.assert_array_equal(ours.numpy(), logits.argmax(-1))


def test_sample_tokens_top_k_one_and_tiny_top_p_are_greedy():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(size=(4, V)).astype(np.float32))
    _, sub = psamp.split_key_data(_dev(_kd(range(4))))
    t = torch.full((4,), 1.5)
    for k, p in ((1, 1.0), (0, 1e-6)):
        tok = psamp.sample_tokens(logits, sub, t,
                                  torch.full((4,), k, dtype=torch.int32),
                                  torch.full((4,), p))
        assert torch.equal(tok, logits.argmax(-1))


def test_speculative_sample_tokens_matches_jax():
    rng = np.random.default_rng(3)
    B, S = 6, 5
    logits = (rng.normal(size=(B, S, V)) * 3).astype(np.float32)
    t, k, p = _knobs("mixed", B)
    kd = _kd(range(20, 20 + B))
    jt, jstack = jsamp.speculative_sample_tokens(
        jnp.asarray(logits), jnp.asarray(kd), jnp.asarray(t), jnp.asarray(k),
        jnp.asarray(p))
    targets, stack = psamp.speculative_sample_tokens(
        torch.from_numpy(logits), _dev(kd), *map(torch.from_numpy, (t, k, p)))
    assert targets.shape == (B, S) and stack.shape == (S, B, 2)
    np.testing.assert_array_equal(targets.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(_host(stack), np.asarray(jstack))
    # position s draws what split-then-sample gives at step s
    kdev = _dev(kd)
    for s in range(S):
        kdev, sub = psamp.split_key_data(kdev)
        tok = psamp.sample_tokens(torch.from_numpy(logits[:, s]), sub,
                                  *map(torch.from_numpy, (t, k, p)))
        assert torch.equal(tok, targets[:, s])


def test_accept_drafts_and_select_key_data_match_jax():
    rng = np.random.default_rng(4)
    B, K = 8, 4
    targets = rng.integers(0, 5, size=(B, K + 1)).astype(np.int32)
    drafts = targets[:, :K].copy()
    flip = rng.random((B, K)) < 0.3
    drafts[flip] = (drafts[flip] + 1) % 5
    lens = rng.integers(0, K + 1, size=B).astype(np.int32)
    ref = np.asarray(jsamp.accept_drafts(
        jnp.asarray(drafts), jnp.asarray(lens), jnp.asarray(targets)))
    ours = psamp.accept_drafts(*map(torch.from_numpy,
                                    (drafts, lens, targets)))
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ours.min() >= 1 and ours.max() <= K + 1
    stack = np.stack([_kd(range(s * B, (s + 1) * B)) for s in range(K + 1)])
    picked = psamp.select_key_data(_dev(stack), ours)
    np.testing.assert_array_equal(
        _host(picked),
        np.asarray(jsamp.select_key_data(jnp.asarray(stack),
                                         jnp.asarray(ref))))


def test_sampling_params_and_validation_match_jax():
    for kw in (dict(), dict(temperature=0.7, top_k=5, top_p=0.9, seed=3)):
        assert psamp.SamplingParams(**kw).as_arrays() == \
            jsamp.SamplingParams(**kw).as_arrays()
        assert psamp.SamplingParams(**kw).is_greedy == \
            jsamp.SamplingParams(**kw).is_greedy
    for bad in (dict(temperature=-0.1), dict(top_k=0), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError) as ours:
            psamp.validate_sampling_params(psamp.SamplingParams(**bad))
        with pytest.raises(ValueError) as theirs:
            jsamp.validate_sampling_params(jsamp.SamplingParams(**bad))
        assert str(ours.value) == str(theirs.value)
