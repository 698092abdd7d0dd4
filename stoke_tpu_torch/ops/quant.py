"""Per-chunk absmax int8 quantization: the wrappers of ``csrc/quant.cu``
and their plain PyTorch versions.

Counterpart of ``quantize_chunks`` and ``dequantize_chunks``
(``stoke_tpu/parallel/collectives.py:61``, ``:91``): the wire format of
the quantized gradient transports and the store of the int8 serving
weights. Elements ``[i*chunk, (i+1)*chunk)`` of a flat fp32 vector share
one fp32 scale ``max|x| / 127``; each becomes ``floor(x / scale + u)``
with ``u`` the JAX package's ``jax.random.uniform`` under the key
(stochastic rounding, unbiased), or the nearest integer with ties to even
(``jnp.round``), clipped to ``[-127, 127]``.

The key is an int64 tensor ``[2]`` holding the ``uint32`` key words
(:mod:`stoke_tpu_torch.utils.prng`); ``folds`` (at most two) are
``jax.random.fold_in``'s applied to it first, and ``offset`` is the flat
index of ``x[0]`` in the draw (a rank quantizing its part of a longer
vector draws that part's uniforms). The kernel reads the key on the
device, so a replayed CUDA graph draws from its current value.

The wrappers run the plain versions for CPU tensors only; for a CUDA
tensor they launch the kernel or raise. Each launch adds one to
``LAUNCHES["quantize_chunks"]`` or ``LAUNCHES["dequantize_chunks"]``
(the flash module's table, which a captured window counts). Under a
``TorchDispatchMode`` (a cost count, a program's recording) each call
goes through the custom op ``stoke_tpu_torch::quantize_chunks`` /
``dequantize_chunks``, as the flash and paged kernels do: the mode sees
the kernel by name, on the CPU as on the card, and not the plain
version's ops inside it.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from stoke_tpu_torch.ops.flash_attention import (
    LAUNCHES,
    _DTYPE_CODES,
    _check_cuda,
    _kernel,
    _raise_on,
    _stream_ptr,
    _watched,
)
from stoke_tpu_torch.utils.prng import fold_in, uniform

#: the int8 wire's symmetric range (-128 unused, so negation is exact)
INT8_MAX = 127.0
#: the dtypes the dequantize kernel writes
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint


def _check_args(x: torch.Tensor, chunk: int, key, stochastic: bool,
                folds: Sequence[int]) -> None:
    if x.dtype != torch.float32 or x.dim() != 1:
        raise ValueError(
            f"quantize_chunks takes a flat float32 vector, got "
            f"{x.dtype}{list(x.shape)}")
    if chunk < 1 or x.numel() % chunk:
        raise ValueError(
            f"quantize_chunks: length {x.numel()} is not a multiple of "
            f"chunk={chunk}")
    if stochastic and key is None:
        raise ValueError("stochastic rounding needs an rng key")
    if len(folds) > 2:
        raise ValueError("quantize_chunks takes at most two fold_in's")


def quantize_chunks_plain(x: torch.Tensor, chunk: int,
                          key: Optional[torch.Tensor] = None,
                          stochastic: bool = True, folds: Sequence[int] = (),
                          offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(q int8 [L], scales float32 [L/chunk])``."""
    _check_args(x, chunk, key, stochastic, folds)
    x2 = x.reshape(-1, chunk)
    absmax = x2.abs().amax(dim=1)
    # a tensor divisor: torch divides a CUDA tensor by a host scalar as a
    # multiply by its rounded reciprocal, which is not IEEE division
    scales = absmax / torch.full_like(absmax, INT8_MAX)
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    v = x2 / safe[:, None]
    if stochastic:
        k = key
        for f in folds:
            k = fold_in(k, f)
        u = uniform(k, x.numel(), offset).view_as(v)
        q = torch.floor(v + u)
    else:
        q = torch.round(v)
    q = q.clamp(-INT8_MAX, INT8_MAX).to(torch.int8)
    return q.reshape(-1), scales


def dequantize_chunks_plain(q: torch.Tensor, scales: torch.Tensor,
                            chunk: int, dtype: torch.dtype = torch.float32,
                            n: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: ``q * scale`` in float32, the first ``n``
    elements (all by default), cast to ``dtype``."""
    _check_payload(q, scales, chunk)
    out = (q.reshape(-1, chunk).to(torch.float32) * scales[:, None])
    out = out.reshape(-1)
    if n is not None:
        out = out[:n]
    return out.to(dtype)


def _quantize_cuda(x, chunk, key, stochastic, folds, offset):
    _check_args(x, chunk, key, stochastic, folds)
    if stochastic and key.dtype != torch.int64:
        raise ValueError(f"quantize_chunks key must be int64, got {key.dtype}")
    _check_cuda("quantize_chunks", x.device, x=x,
                key=key if stochastic else None)
    fn, err = _kernel(
        "quantize_chunks",
        [_P, _P, _P, _LL, _I, _P, _I, _U, _U, _LL, _I, _P], source="quant")
    q = torch.empty(x.numel(), dtype=torch.int8, device=x.device)
    scales = torch.empty(x.numel() // chunk, dtype=torch.float32,
                         device=x.device)
    f = [int(v) & 0xFFFFFFFF for v in folds] + [0, 0]
    rc = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), scales.numel(),
            chunk, key.data_ptr() if stochastic else None, len(folds), f[0],
            f[1], int(offset), int(bool(stochastic)), _stream_ptr(x.device))
    _raise_on(err, "quantize_chunks", rc)
    LAUNCHES["quantize_chunks"] += 1
    return q, scales


def _check_payload(q: torch.Tensor, scales: torch.Tensor,
                   chunk: int) -> None:
    if chunk < 1 or q.numel() != scales.numel() * chunk:
        raise ValueError(
            f"dequantize_chunks: {q.numel()} elements for {scales.numel()} "
            f"chunks of {chunk}")


def _dequantize_cuda(q, scales, chunk, dtype, n):
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(
            f"dequantize_chunks takes int8 q and float32 scales, got "
            f"{q.dtype}/{scales.dtype}")
    if dtype not in OUT_DTYPES:
        raise ValueError(f"dequantize_chunks writes {OUT_DTYPES}, not {dtype}")
    _check_payload(q, scales, chunk)
    n = q.numel() if n is None else int(n)
    if not 0 <= n <= q.numel():
        raise ValueError(f"dequantize_chunks: n={n} outside [0, {q.numel()}]")
    _check_cuda("dequantize_chunks", q.device, q=q, scales=scales)
    fn, err = _kernel("dequantize_chunks", [_P, _P, _P, _LL, _I, _I, _P],
                      source="quant")
    out = torch.empty(n, dtype=dtype, device=q.device)
    rc = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, chunk,
            _DTYPE_CODES[dtype], _stream_ptr(q.device))
    _raise_on(err, "dequantize_chunks", rc)
    LAUNCHES["dequantize_chunks"] += 1
    return out


def quantize_chunks(x: torch.Tensor, chunk: int,
                    key: Optional[torch.Tensor] = None,
                    stochastic: bool = True, folds: Sequence[int] = (),
                    offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize flat float32 ``x`` in chunks of ``chunk``: ``(q int8 [L],
    scales float32 [L/chunk])``. ``key`` (int64 ``[2]``, on ``x``'s
    device) feeds stochastic rounding after ``folds``; ``offset`` is
    ``x[0]``'s index in the draw. The kernel on the card, the plain
    version on the CPU."""
    if _watched():
        return torch.ops.stoke_tpu_torch.quantize_chunks(
            x, chunk, key, stochastic, list(folds), offset)
    return _quantize_direct(x, chunk, key, stochastic, folds, offset)


def _quantize_direct(x, chunk, key, stochastic, folds, offset):
    if x.device.type == "cpu":
        return quantize_chunks_plain(x, chunk, key, stochastic, folds, offset)
    return _quantize_cuda(x, chunk, key, stochastic, folds, offset)


def dequantize_chunks(q: torch.Tensor, scales: torch.Tensor, chunk: int,
                      dtype: torch.dtype = torch.float32,
                      n: Optional[int] = None) -> torch.Tensor:
    """The inverse of :func:`quantize_chunks` up to rounding: ``q * scale``
    in float32, its first ``n`` elements, in ``dtype``. The kernel on the
    card, the plain version on the CPU."""
    if _watched():
        return torch.ops.stoke_tpu_torch.dequantize_chunks(
            q, scales, chunk, dtype, n)
    return _dequantize_direct(q, scales, chunk, dtype, n)


def _dequantize_direct(q, scales, chunk, dtype, n):
    if q.device.type == "cpu":
        return dequantize_chunks_plain(q, scales, chunk, dtype, n)
    return _dequantize_cuda(q, scales, chunk, dtype, n)


# --------------------------------------------------------------------------- #
# the pair as custom ops, for a TorchDispatchMode
# --------------------------------------------------------------------------- #


@torch.library.custom_op("stoke_tpu_torch::quantize_chunks", mutates_args=())
def _quantize_op(x: torch.Tensor, chunk: int, key: Optional[torch.Tensor],
                 stochastic: bool, folds: List[int],
                 offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return _quantize_direct(x, chunk, key, stochastic, folds, offset)


@_quantize_op.register_fake
def _(x, chunk, key, stochastic, folds, offset):
    return (x.new_empty(x.numel(), dtype=torch.int8),
            x.new_empty(x.numel() // chunk))


@torch.library.custom_op("stoke_tpu_torch::dequantize_chunks",
                         mutates_args=())
def _dequantize_op(q: torch.Tensor, scales: torch.Tensor, chunk: int,
                   dtype: torch.dtype, n: Optional[int]) -> torch.Tensor:
    return _dequantize_direct(q, scales, chunk, dtype, n)


@_dequantize_op.register_fake
def _(q, scales, chunk, dtype, n):
    return q.new_empty(q.numel() if n is None else n, dtype=dtype)


__all__ = ["INT8_MAX", "OUT_DTYPES", "dequantize_chunks",
           "dequantize_chunks_plain", "quantize_chunks",
           "quantize_chunks_plain"]
