"""Native (C++) host batching of the port: :class:`NativeBatcher`.

``batcher.cpp`` (the port's copy of the JAX package's batcher) is a
GIL-free thread pool for the memory-bound jobs of host batching: the
sampler's row gather, a fused uint8 -> float32 normalisation, and the
ragged gather + pad + mask of token sequences. It is built at first use
with ``g++ -O3 -shared -fPIC -pthread -std=c++17`` into
``build/stoke_tpu_torch/`` at the root of the checkout (beside the CUDA
kernels), named by a hash of the source, and loaded with ``ctypes``.

The numpy versions are the plain versions: where no toolchain exists the
batcher warns once and runs them (``NativeBatcher.available`` says which
path is active), with the same results bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "batcher.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / \
    "stoke_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Optional[str] = None


def library_path() -> Path:
    """Where the library of the current ``batcher.cpp`` is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libstoke_batcher-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile ``batcher.cpp`` unless its library exists; raises
    ``OSError`` or ``subprocess.SubprocessError`` when it cannot."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, path)
    return path


def load() -> Optional[ctypes.CDLL]:
    """The batcher library, built on first call; None (with one warning)
    when it cannot be built or loaded."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as e:
            _failed = str(e)
            warnings.warn(
                f"stoke_tpu_torch.native: the C++ batcher could not be "
                f"built ({e}); batches are assembled by numpy", stacklevel=3)
            return None
        lib.stoke_pool_new.restype = ctypes.c_void_p
        lib.stoke_pool_new.argtypes = [ctypes.c_int]
        lib.stoke_pool_free.restype = None
        lib.stoke_pool_free.argtypes = [ctypes.c_void_p]
        lib.stoke_pool_size.restype = ctypes.c_int
        lib.stoke_pool_size.argtypes = [ctypes.c_void_p]
        lib.stoke_gather_rows.restype = None
        lib.stoke_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.stoke_u8_to_f32_norm.restype = None
        lib.stoke_u8_to_f32_norm.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.stoke_gather_pad_i32.restype = None
        lib.stoke_gather_pad_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeBatcher:
    """Thread-pool batch assembler; numpy where the library is missing.

    Args:
        n_threads: worker threads (default: the CPU count, at most 8;
            host batching saturates memory bandwidth quickly).
        native: False runs the numpy versions (the plain versions the
            native ones are held against).
    """

    def __init__(self, n_threads: Optional[int] = None, native: bool = True):
        self._lib = load() if native else None
        n = n_threads or min(os.cpu_count() or 1, 8)
        self._pool = self._lib.stoke_pool_new(n) if self._lib else None

    @property
    def available(self) -> bool:
        """True when the C++ path is active (False: numpy)."""
        return self._pool is not None

    def close(self) -> None:
        """Stop the worker threads (also on garbage collection)."""
        if getattr(self, "_pool", None) and self._lib:
            self._lib.stoke_pool_free(self._pool)
            self._pool = None

    __del__ = close

    def gather_rows(self, src: np.ndarray, idx: Sequence[int]) -> np.ndarray:
        """``out[i] = src[idx[i]]``: the sampler -> batch gather."""
        idx_arr = np.ascontiguousarray(idx, np.int64)
        src = np.ascontiguousarray(src)
        if len(idx_arr) and (idx_arr.min() < 0 or idx_arr.max() >= len(src)):
            raise IndexError(f"gather_rows: index out of range for "
                             f"{len(src)} rows")
        out = np.empty((len(idx_arr),) + src.shape[1:], src.dtype)
        if not self.available or src.nbytes == 0:
            np.take(src, idx_arr, axis=0, out=out)
            return out
        row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                     dtype=np.int64))
        self._lib.stoke_gather_rows(self._pool, _ptr(src), _ptr(idx_arr),
                                    len(idx_arr), row_bytes, _ptr(out))
        return out

    def u8_to_f32_norm(self, src: np.ndarray, mean: Sequence[float],
                       std: Sequence[float]) -> np.ndarray:
        """Fused uint8 -> float32 ``(x/255 - mean)/std`` over a
        channels-last array."""
        src = np.ascontiguousarray(src, np.uint8)
        channels = src.shape[-1]
        mean_a = np.ascontiguousarray(mean, np.float32)
        std_a = np.ascontiguousarray(std, np.float32)
        if mean_a.size != channels or std_a.size != channels:
            raise ValueError("mean/std must have one entry per channel")
        out = np.empty(src.shape, np.float32)
        if not self.available:
            out[:] = (src.astype(np.float32) / 255.0 - mean_a) / std_a
            return out
        self._lib.stoke_u8_to_f32_norm(self._pool, _ptr(src), src.size,
                                       _ptr(mean_a), _ptr(std_a), channels,
                                       _ptr(out))
        return out

    def gather_pad(self, ragged: np.ndarray, offsets: np.ndarray,
                   lengths: np.ndarray, idx: Sequence[int],
                   max_len: Optional[int] = None,
                   pad_multiple: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Variable-length int32 sequences ``idx`` of a ragged buffer as a
        zero-padded ``[n, max_len]`` matrix and its 0/1 mask; ``max_len``
        defaults to the longest chosen sequence, rounded up to a multiple
        of ``pad_multiple``."""
        idx_arr = np.ascontiguousarray(idx, np.int64)
        lengths = np.ascontiguousarray(lengths, np.int32)
        offsets = np.ascontiguousarray(offsets, np.int64)
        ragged = np.ascontiguousarray(ragged, np.int32)
        if len(idx_arr) and (idx_arr.min() < 0
                             or idx_arr.max() >= len(lengths)):
            raise IndexError(f"gather_pad: index out of range for "
                             f"{len(lengths)} sequences")
        if len(lengths) and (offsets.min() < 0 or int(
                (offsets + lengths).max()) > len(ragged)):
            raise ValueError("gather_pad: offsets + lengths overrun the "
                             "ragged buffer")
        if max_len is None:
            max_len = int(lengths[idx_arr].max()) if len(idx_arr) else 0
        if pad_multiple > 1:
            max_len = -(-max_len // pad_multiple) * pad_multiple
        out = np.empty((len(idx_arr), max_len), np.int32)
        mask = np.empty((len(idx_arr), max_len), np.int32)
        if not self.available:
            for i, r in enumerate(idx_arr):
                n = min(int(lengths[r]), max_len)
                out[i, :n] = ragged[offsets[r]:offsets[r] + n]
                out[i, n:] = 0
                mask[i, :n] = 1
                mask[i, n:] = 0
            return out, mask
        self._lib.stoke_gather_pad_i32(
            self._pool, _ptr(ragged), _ptr(offsets), _ptr(lengths),
            _ptr(idx_arr), len(idx_arr), max_len, _ptr(out), _ptr(mask))
        return out, mask


__all__ = ["NativeBatcher", "library_path", "load"]
