"""Attention kernels of the port: flash forward and paged decode.

Counterpart of ``stoke_tpu/ops/flash_attention.py``. Each kernel has two
versions here, computing the same function:

- a hand-written CUDA kernel for Hopper (``csrc/flash_fwd.cu``,
  ``csrc/paged_decode.cu``), built at first use by :mod:`._build` and
  launched on the current stream for tensors on the card;
- a plain PyTorch version (:func:`flash_attention_plain`,
  :func:`paged_decode_attention`), which the wrapper takes for tensors on
  the CPU only, and against which the kernel is checked on the card.

The public wrappers keep the JAX package's names and layouts:
:func:`flash_attention` on ``[B, H, L, D]`` with a ``[B, L]`` key mask, and
:func:`paged_decode_attention_pallas` on ``[B, H, 1, D]`` queries over
``[NB, BS, H, D]`` page pools, so ``decode_kernel="pallas"`` names the same
path in both packages. The TPU's block knobs (``block_q``, ``block_k``,
``pages_per_block``, ``block_h``, ``interpret``) belong to the TPU and are
not carried over: the CUDA kernels choose their own tiles.
"""

from __future__ import annotations

import ctypes
import math

import torch

from stoke_tpu_torch.ops import _build

#: score of a masked position; p is forced to 0 for s <= NEG_INF / 2
NEG_INF = -1e30

#: tolerance of the flash forward against the dense reference at bf16
#: inputs (the JAX package's numerics contract)
FWD_ATOL_BF16 = 2e-2

#: launches of each CUDA kernel, counted by its wrapper where it launches it
LAUNCHES = {"flash_fwd": 0, "paged_decode": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_cuda(name: str, device: torch.device, **tensors) -> None:
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(
                f"{name}: {arg} is on {t.device}, expected {device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _kernel(name: str, argtypes):
    """The C entry ``stoke_<name>`` of ``csrc/<name>.cu``, built and loaded
    at first use, and its error-message function."""
    lib = _build.load(name)
    fn = getattr(lib, f"stoke_{name}")
    err = getattr(lib, f"stoke_{name}_error")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, _I
        err.argtypes, err.restype = [_I], ctypes.c_char_p
    return fn, err


def _raise_on(err, name: str, rc: int) -> None:
    if rc != 0:
        msg = err(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (code {rc})")


# --------------------------------------------------------------------------- #
# flash attention forward
# --------------------------------------------------------------------------- #


def flash_attention_plain(q, k, v, mask=None, causal: bool = False):
    """Plain PyTorch version of the flash forward: the same masking,
    sentinel and fp32 softmax as the kernel, over the whole score matrix.

    Returns ``(out [B, H, L, D] in q's dtype, lse [B, H, L] float32)``; a
    fully masked row gives ``out == 0`` and ``lse == NEG_INF``."""
    L, D = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / D**0.5)
    allow = torch.ones(L, L, dtype=torch.bool, device=q.device)
    if causal:
        allow = torch.tril(allow)
    allow = allow[None, None]
    if mask is not None:
        allow = allow & (mask[:, None, None, :] > 0)
    s = torch.where(allow, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / safe_l
    lse = torch.where(
        l > 0, m + torch.log(safe_l), torch.full_like(l, NEG_INF)
    )[..., 0]
    return out.to(q.dtype), lse


def _flash_fwd_cuda(q, k, v, mask, causal: bool):
    """Launch ``csrc/flash_fwd.cu`` on the current stream."""
    B, H, L, D = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if D not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel takes head dim in {_HEAD_DIMS}, got {D}"
        )
    if mask is not None and mask.dtype != torch.int32:
        raise ValueError(f"flash_attention mask must be int32, got {mask.dtype}")
    _check_cuda("flash_attention", q.device, q=q, k=k, v=v, mask=mask)
    fn, err = _kernel(
        "flash_fwd",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P],
    )
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        B * H, H, L, D, _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D),
        int(bool(causal)), _stream_ptr(q.device),
    )
    _raise_on(err, "flash_fwd", rc)
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_attention(q, k, v, mask=None, *, causal: bool = False,
                    return_lse: bool = False):
    """Flash attention on ``[B, H, L, D]`` inputs with an optional
    ``[B, L]`` int32 key mask (nonzero = attend).

    On the card it launches the CUDA kernel; on the CPU it runs
    :func:`flash_attention_plain`. ``return_lse=True`` also returns the
    ``[B, H, L]`` fp32 logsumexp rows (``NEG_INF`` on a fully masked row).
    The output is in the input dtype."""
    if q.ndim != 4:
        raise ValueError(f"expected [B, H, L, D] inputs, got {tuple(q.shape)}")
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(
            f"q/k/v shapes must match, got {tuple(q.shape)}/"
            f"{tuple(k.shape)}/{tuple(v.shape)}"
        )
    B, H, L, D = q.shape
    if mask is not None and tuple(mask.shape) != (B, L):
        raise ValueError(
            f"mask must be [B, L] = {(B, L)}, got {tuple(mask.shape)}"
        )
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, mask, causal)
    elif q.device.type == "cuda":
        out, lse = _flash_fwd_cuda(q, k, v, mask, causal)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return (out, lse) if return_lse else out


def dense_reference(q, k, v, mask=None, causal: bool = False):
    """O(L^2) dense attention in fp32 with a plain softmax (a fully masked
    row averages v): the ground truth of the JAX package's tests."""
    L = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (
        q.shape[-1] ** 0.5
    )
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s, torch.full_like(s, NEG_INF))
    if causal:
        tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=q.device))
        s = torch.where(tri[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


# --------------------------------------------------------------------------- #
# paged decode attention
# --------------------------------------------------------------------------- #


def paged_decode_attention(q, k_pages, v_pages, block_tables, context_lens):
    """Plain PyTorch decode attention over a paged KV pool: gather each
    slot's blocks, einsum, masked fp32 softmax, einsum.

    Args:
        q: ``[B, H, 1, D]`` current-token queries.
        k_pages / v_pages: ``[NB, BS, H, D]`` pool of one layer.
        block_tables: ``[B, MB]`` int block ids per slot (unused entries
            point at scratch block 0).
        context_lens: ``[B]`` valid tokens per slot, the current one
            included (positions ``>= context_lens[b]`` are masked).

    Returns ``[B, H, 1, D]`` in the query dtype."""
    B, H, one, D = q.shape
    if one != 1:
        raise ValueError(
            f"paged_decode_attention is single-token decode; got q-length "
            f"{one} (prefill goes through flash_attention/dense_attention)"
        )
    tables = block_tables.long()
    k = k_pages[tables].reshape(B, -1, H, D)
    v = v_pages[tables].reshape(B, -1, H, D)
    s = torch.einsum("bhqd,bwhd->bhqw", q.float(), k.float()) / (D**0.5)
    w_pos = torch.arange(k.shape[1], device=q.device)
    valid = w_pos[None, :] < context_lens.long()[:, None]  # [B, W]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqw,bwhd->bhqd", p, v.float())
    return out.to(q.dtype)


def _paged_decode_cuda(q, k_pages, v_pages, block_tables, context_lens):
    """Launch ``csrc/paged_decode.cu`` on the current stream."""
    B, H, _, D = q.shape
    NB, BS = k_pages.shape[0], k_pages.shape[1]
    MB = block_tables.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"paged decode kernel takes float32 or bfloat16 queries, got "
            f"{q.dtype}"
        )
    if k_pages.dtype not in _DTYPE_CODES or v_pages.dtype != k_pages.dtype:
        raise ValueError(
            f"paged decode kernel takes float32 or bfloat16 pools of one "
            f"dtype, got {k_pages.dtype}/{v_pages.dtype}"
        )
    if D not in _HEAD_DIMS:
        raise ValueError(
            f"paged decode kernel takes head dim in {_HEAD_DIMS}, got {D}"
        )
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError(
            f"block_tables and context_lens must be int32, got "
            f"{block_tables.dtype}/{context_lens.dtype}"
        )
    _check_cuda(
        "paged_decode_attention_pallas", q.device, q=q, k_pages=k_pages,
        v_pages=v_pages, block_tables=block_tables, context_lens=context_lens,
    )
    fn, err = _kernel(
        "paged_decode",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _P],
    )
    out = torch.empty_like(q)
    rc = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        B, H, D, NB, BS, MB, _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_pages.dtype], 1.0 / math.sqrt(D),
        _stream_ptr(q.device),
    )
    _raise_on(err, "paged_decode", rc)
    LAUNCHES["paged_decode"] += 1
    return out


def paged_decode_attention_pallas(q, k_pages, v_pages, block_tables,
                                  context_lens):
    """The decode kernel's wrapper, under the JAX package's name.

    Same contract as :func:`paged_decode_attention`. On the card it
    launches ``csrc/paged_decode.cu`` (int32 tables and lengths, float32
    or bfloat16 query and pools, head dim 64 or 128); on the CPU it runs
    :func:`paged_decode_attention`."""
    B, H, one, D = q.shape
    if one != 1:
        raise ValueError(
            f"paged_decode_attention_pallas is single-token decode; got "
            f"q-length {one}"
        )
    if k_pages.shape != v_pages.shape or k_pages.ndim != 4:
        raise ValueError(
            f"k_pages/v_pages must be identical [NB, BS, H, D] pools, got "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}"
        )
    if k_pages.shape[2] != H or k_pages.shape[3] != D:
        raise ValueError(
            f"page pool heads/dim {tuple(k_pages.shape[2:])} do not match "
            f"the query's {(H, D)}"
        )
    if block_tables.ndim != 2 or block_tables.shape[0] != B:
        raise ValueError(
            f"block_tables must be [B={B}, MAX_BLOCKS], got "
            f"{tuple(block_tables.shape)}"
        )
    if tuple(context_lens.shape) != (B,):
        raise ValueError(
            f"context_lens must be [B={B}], got {tuple(context_lens.shape)}"
        )
    if q.device.type == "cpu":
        return paged_decode_attention(
            q, k_pages, v_pages, block_tables, context_lens
        )
    if q.device.type == "cuda":
        return _paged_decode_cuda(
            q, k_pages, v_pages, block_tables, context_lens
        )
    raise ValueError(
        f"paged_decode_attention_pallas: unsupported device {q.device}"
    )
