"""The JAX package's random numbers, bit for bit: Threefry-2x32 and the
partitionable ``split``, ``fold_in``, ``bits`` and ``uniform``.

Shared by the sampler (:mod:`stoke_tpu_torch.serving.sampling`) and the
gradient transports (:mod:`stoke_tpu_torch.parallel.collectives`), whose
stochastic rounding draws ``jax.random.uniform``.

- **Threefry-2x32** (20 rounds, the Random123 rotation schedule of
  ``jax/_src/prng.py``). Key data is the JAX typed key's raw ``uint32[2]``
  pair. On the host it is a numpy ``uint32`` array, whose arithmetic wraps
  modulo 2**32; on the device it is carried as int64 and masked with
  ``& 0xFFFFFFFF`` after every add, rotate and xor, since torch has no
  arithmetic on uint32. The same code serves both;
- the **partitionable** ``split`` and 32-bit ``random_bits`` that
  ``jax_threefry_partitionable=True`` selects (the default): counters are
  a 64-bit iota over the flat index split into hi/lo words, a split key is
  the pair of hash words, and 32 random bits are ``bits1 ^ bits2``;
- ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under the key
  (``threefry_2x32(key, threefry_seed(uint32(d)))``);
- ``uniform`` in float32 on ``[0, 1)``: the top 23 bits under the exponent
  of 1.0 give a float in ``[1, 2)``, minus 1.

A plain int64 Threefry costs about 170 elementwise passes; the transport's
per-element draws run inside the quantize kernel instead
(``csrc/quant.cu``), and this module is their specification.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
#: Threefry-2x32's rotation constants, alternating per block of 4 rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter words ``(x1, x2)`` under key
    ``(k1, k2)``, broadcast together: numpy uint32 arrays, or int64
    tensors holding uint32 values. Returns the two hashed words in the
    inputs' type."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _hash_iota(key_data, n: int, offset: int = 0):
    """Both hash words of counters ``offset..offset+n-1`` (a 64-bit index
    split into hi and lo words) under every key of ``key_data [..., 2]``
    (numpy uint32 or int64 tensor): two ``[..., n]`` arrays of its
    type."""
    if isinstance(key_data, np.ndarray):
        idx = np.arange(offset, offset + n, dtype=np.uint64)
        lo = (idx & _MASK).astype(np.uint32)
        hi = (idx >> np.uint64(32)).astype(np.uint32)
    else:
        idx = torch.arange(offset, offset + n, dtype=torch.int64,
                           device=key_data.device)
        lo, hi = idx & _MASK, idx >> 32
    return threefry2x32(key_data[..., 0:1], key_data[..., 1:2], hi, lo)


def _stack(a, b):
    if isinstance(a, np.ndarray):
        return np.stack((a, b), axis=-1)
    return torch.stack((a, b), dim=-1)


def initial_key_data(seed: int) -> np.ndarray:
    """Raw key data of ``jax.random.key(seed)`` (32-bit keys: the high
    word 0, the low word the seed modulo 2**32), ``uint32 [2]``."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def key_data_to_device(key_data: np.ndarray, device=None) -> torch.Tensor:
    """Host ``uint32 [..., 2]`` key data as the int64 tensor the sampler
    takes."""
    return torch.from_numpy(
        np.asarray(key_data, np.uint32).astype(np.int64)
    ).to(device)


def split_key_data(key_data):
    """Split every key of ``key_data [..., 2]`` once, as
    ``jax.random.split(key)``: returns ``(carry, sub)``, each
    ``[..., 2]`` of the input's type (host uint32 or device int64). The
    carry is the key's next state, the sub key feeds one draw."""
    bits1, bits2 = _hash_iota(key_data, 2)
    return (_stack(bits1[..., 0], bits2[..., 0]),
            _stack(bits1[..., 1], bits2[..., 1]))


def split_chain(key_data, n: int):
    """``n`` sequential splits of every key: ``(carries [n, ..., 2], subs
    [n, ..., 2])``, ``carries[i]`` the state after ``i + 1`` splits and
    ``subs[i]`` the sub key of the (i+1)-th draw."""
    carries, subs = [], []
    for _ in range(n):
        key_data, sub = split_key_data(key_data)
        carries.append(key_data)
        subs.append(sub)
    if isinstance(key_data, np.ndarray):
        return np.stack(carries), np.stack(subs)
    return torch.stack(carries), torch.stack(subs)


def fold_in(key_data, data: int):
    """``jax.random.fold_in(key, data)`` for every key of ``key_data
    [..., 2]``: the hash of the counter pair ``(0, data mod 2**32)``,
    in the input's type."""
    k1, k2 = key_data[..., 0:1], key_data[..., 1:2]
    full = np.full_like if isinstance(key_data, np.ndarray) else torch.full_like
    b1, b2 = threefry2x32(k1, k2, full(k1, 0), full(k1, int(data) & _MASK))
    return _stack(b1[..., 0], b2[..., 0])


def random_bits(key_data, n: int, offset: int = 0):
    """``jax.random.bits(key, (n,))`` (32-bit) for every key of
    ``key_data [..., 2]``: ``[..., n]`` int64 in ``[0, 2**32)``; with
    ``offset`` the elements ``offset..offset+n-1`` of a longer draw."""
    bits1, bits2 = _hash_iota(key_data, n, offset)
    return bits1 ^ bits2


def uniform(key_data, n: int, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` flattened, for one key
    (int64 tensor ``[2]``): ``[n]`` float32 in ``[0, 1)``; with ``offset``
    the elements ``offset..offset+n-1`` of a longer draw (of any shape:
    the counter is the flat index)."""
    float_bits = (random_bits(key_data, n, offset) >> 9) | 0x3F800000
    return float_bits.to(torch.int32).view(torch.float32) - 1.0
