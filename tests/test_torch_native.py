"""Port parity: the native batcher.

The port builds its own copy of ``batcher.cpp`` into
``build/stoke_tpu_torch/`` and its outputs equal the JAX package's
``NativeBatcher`` and the numpy versions bit for bit (the fused uint8
normalisation: bit for bit against the JAX batcher's C++ path, within
fp32 rounding against numpy, which divides in another order).
"""

import warnings

import numpy as np
import pytest

from stoke_tpu.native import NativeBatcher as JaxBatcher
from stoke_tpu_torch import native
from stoke_tpu_torch.native import NativeBatcher

pytestmark = pytest.mark.torch_port

ROOT = native.SRC.parent.parent.parent


@pytest.fixture(scope="module")
def batchers():
    return (NativeBatcher(n_threads=4), JaxBatcher(n_threads=4),
            NativeBatcher(native=False))


def test_library_builds_into_the_port_build_dir(batchers):
    ours, _, plain = batchers
    assert ours.available and not plain.available
    path = native.library_path()
    assert path.exists()
    assert path.parent == ROOT / "build" / "stoke_tpu_torch"
    assert native.SRC == ROOT / "stoke_tpu_torch" / "native" / "batcher.cpp"
    assert "stoke_tpu/" not in native.SRC.read_text()


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64, np.float32])
def test_gather_rows_equal(batchers, dtype):
    rng = np.random.default_rng(0)
    src = (rng.normal(size=(300, 5, 7)) * 50).astype(dtype)
    idx = rng.integers(0, 300, size=129)
    outs = [b.gather_rows(src, idx) for b in batchers]
    for out in outs:
        assert out.dtype == dtype
        np.testing.assert_array_equal(out, src[idx])


def test_gather_rows_checks_indices(batchers):
    with pytest.raises(IndexError):
        batchers[0].gather_rows(np.zeros((4, 2)), [0, 4])


def test_u8_norm_equal(batchers):
    ours, theirs, plain = batchers
    rng = np.random.default_rng(1)
    src = rng.integers(0, 256, size=(64, 16, 16, 3)).astype(np.uint8)
    mean, std = [0.49, 0.48, 0.44], [0.2, 0.2, 0.25]
    got = ours.u8_to_f32_norm(src, mean, std)
    np.testing.assert_array_equal(got, theirs.u8_to_f32_norm(src, mean, std))
    np.testing.assert_allclose(got, plain.u8_to_f32_norm(src, mean, std),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="one entry per channel"):
        ours.u8_to_f32_norm(src, [0.5], [0.5])


def _ragged(rng, n=40, hi=40):
    lengths = rng.integers(1, hi, size=n).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths[:-1])]).astype(np.int64)
    ragged = rng.integers(1, 1000, size=int(lengths.sum())).astype(np.int32)
    return ragged, offsets, lengths


@pytest.mark.parametrize("kwargs", [{}, {"pad_multiple": 8},
                                    {"pad_multiple": 32}, {"max_len": 16},
                                    {"max_len": 5, "pad_multiple": 4}])
def test_gather_pad_equal(batchers, kwargs):
    ragged, offsets, lengths = _ragged(np.random.default_rng(2))
    idx = [3, 3, 0, 39, 11, 20]
    outs = [b.gather_pad(ragged, offsets, lengths, idx, **kwargs)
            for b in batchers]
    for out, mask in outs[1:]:
        np.testing.assert_array_equal(outs[0][0], out)
        np.testing.assert_array_equal(outs[0][1], mask)
    out, mask = outs[0]
    for i, r in enumerate(idx):
        n = min(int(lengths[r]), out.shape[1])
        np.testing.assert_array_equal(out[i, :n],
                                      ragged[offsets[r]:offsets[r] + n])
        assert (out[i, n:] == 0).all() and mask[i].sum() == n


def test_serve_request_packing(batchers):
    """``tests/test_native.py``'s serve packing case: one request a call,
    padded to its bucket, the max_len clamp, a batch with repeats."""
    ours, theirs, plain = batchers
    rng = np.random.default_rng(3)
    ragged, offsets, lengths = _ragged(rng, n=20)
    for r in (0, 7, 19):
        got = [b.gather_pad(ragged, offsets, lengths, [r], pad_multiple=16)
               for b in batchers]
        L = int(lengths[r])
        assert got[0][0].shape == (1, -(-L // 16) * 16)
        for out, mask in got:
            np.testing.assert_array_equal(out, got[0][0])
            np.testing.assert_array_equal(mask, got[0][1])
        assert got[0][1][0].sum() == L
    r = int(np.argmax(lengths))
    cap = max(int(lengths[r]) // 2, 1)
    out, mask = ours.gather_pad(ragged, offsets, lengths, [r], max_len=cap)
    np.testing.assert_array_equal(out[0], ragged[offsets[r]:offsets[r] + cap])
    np.testing.assert_array_equal(
        out, theirs.gather_pad(ragged, offsets, lengths, [r], max_len=cap)[0])
    assert mask[0].sum() == cap


def test_gather_pad_checks_its_inputs(batchers):
    ragged, offsets, lengths = _ragged(np.random.default_rng(4))
    with pytest.raises(IndexError):
        batchers[0].gather_pad(ragged, offsets, lengths, [len(lengths)])
    with pytest.raises(ValueError, match="overrun"):
        batchers[0].gather_pad(ragged[:-1], offsets, lengths, [0])


def test_no_toolchain_warns_once_and_runs_numpy(monkeypatch):
    def no_compiler():
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    monkeypatch.setattr(native, "_build", no_compiler)
    with pytest.warns(UserWarning, match="numpy"):
        b = NativeBatcher()
    assert not b.available
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not NativeBatcher().available  # no second warning
    ragged, offsets, lengths = _ragged(np.random.default_rng(5))
    out, _ = b.gather_pad(ragged, offsets, lengths, [1, 2], pad_multiple=8)
    want, _ = JaxBatcher().gather_pad(ragged, offsets, lengths, [1, 2],
                                      pad_multiple=8)
    np.testing.assert_array_equal(out, want)
