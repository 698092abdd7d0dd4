"""Attention kernels of the port: flash forward and backward, paged decode
and paged speculative verify.

Counterpart of ``stoke_tpu/ops/flash_attention.py``. Each kernel has two
versions here, computing the same function:

- a hand-written CUDA kernel for Hopper (``csrc/flash_fwd.cu``,
  ``csrc/flash_bwd.cu``, ``csrc/paged_decode.cu``,
  ``csrc/paged_verify.cu``), built at first use by :mod:`._build` and
  launched on the current stream for tensors on the card;
- a plain PyTorch version (:func:`flash_attention_plain`,
  :func:`flash_attention_bwd_plain`, :func:`paged_decode_attention`,
  :func:`paged_verify_attention`), which the wrapper takes for tensors on
  the CPU only, and against which the kernel is checked on the card.

Chunked-prefill attention (:func:`paged_prefill_chunk_attention`) has no
kernel in either package: it is plain PyTorch on both devices.

:func:`flash_attention` is differentiable: two ``torch.autograd.Function``
s, one per ``return_lse`` (the JAX package's ``_flash`` and
``_flash_with_lse`` with their VJP rules), run the forward kernel and, in
backward, the dQ and dK/dV kernels from the saved LSE rows. A kernel
launched through ``ctypes`` dispatches no aten op, so under a
``TorchDispatchMode`` (``torch.utils.flop_counter.FlopCounterMode``) the
forward and backward go through the custom ops
``stoke_tpu_torch::flash_fwd`` and ``stoke_tpu_torch::flash_bwd``, which
the mode sees as one op each and counts by the FLOP formula registered
for them: that of dense attention (two ``[L, L]`` products forward, four
backward, the causal half not taken off), whichever version runs inside.

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
from typing import Optional, Tuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils.flop_counter import register_flop_formula

from stoke_tpu_torch.ops import _build

#: score of a masked position; p is forced to 0 for s <= NEG_INF / 2
NEG_INF = -1e30

#: tolerances of the flash kernels against the dense reference at bf16
#: inputs (the JAX package's numerics contract): the forward's absolute,
#: the backward's relative to the largest gradient element
FWD_ATOL_BF16 = 2e-2
BWD_RTOL_BF16 = 0.05
#: the fp16 forward kernel against its plain version: fp16 keeps three more
#: mantissa bits than bf16, so its rounding of P and O is ~8x smaller; the
#: fp16 backward is held to the bf16 bounds (BWD_RTOL_BF16, and
#: BWD_ROW_RTOL_BF16 row by row)
FWD_ATOL_FP16 = 4e-3
#: the 16-bit backward kernels against their plain version, per row of dQ,
#: dK and dV (see :func:`bwd_row_err`). BWD_RTOL_BF16 alone would pass a
#: kernel that zeroed the small late-key rows; rounding P and dS to bf16
#: for the tensor cores moves a row by about 0.5%
BWD_ROW_RTOL_BF16 = 2e-2
#: the floor of a row's norm in :func:`bwd_row_err`, as a share of the
#: largest row norm of its head. Some rows' exact gradient is ~0 (the first
#: causal query row attends key 0 alone, so P = 1 and dP - delta = 0), and
#: there both versions hold rounding noise of ~1e-8 that differs by ~100%
#: of itself. Against 1e-2 of the head's largest row norm (~1 with unit
#: normal inputs) that noise reads ~1e-6, far under the bound, while a
#: kernel that dropped a row still fails unless the row's norm is under
#: 2e-4 of the largest
BWD_ROW_FLOOR = 1e-2


def bwd_row_err(out, ref) -> float:
    """The row check of the bf16 and fp16 backward kernels: over every row
    (last axis) of ``out`` against the plain version ``ref``, the largest
    ``|out row - ref row|`` over ``max(|ref row|, BWD_ROW_FLOOR x the
    largest |ref row| of the same head)`` (L2 norms; the head is the
    second-last axis's slab). A kernel passes where it is at most
    ``BWD_ROW_RTOL_BF16``.

    A plain row that is zero is held to the floor as well: the first
    causal row's dP and delta can agree to the last bit in the plain
    version, which a kernel summing in another order does not reproduce.
    The rows that the masking rule makes zero (fully masked queries,
    masked keys) are for the caller to hold to exact zeros. Infinite only
    where a head's plain rows are all zero and ``out``'s are not."""
    diff = (out.float() - ref.float()).norm(dim=-1)
    norm = ref.float().norm(dim=-1)
    den = torch.maximum(norm, BWD_ROW_FLOOR * norm.amax(dim=-1, keepdim=True))
    return float(torch.where(diff == 0, 0.0, diff / den).max())


#: launches of each CUDA kernel, counted by its wrapper where it launches it
#: (the quantize pair's wrappers are in ops/quant.py)
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "paged_decode": 0, "paged_verify": 0, "quantize_chunks": 0,
            "dequantize_chunks": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: what the paged kernels take (the flash kernels also take float16)
_PAGED_DTYPES = (torch.float32, torch.bfloat16)
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


def _kernel(name: str, argtypes, source: str = None):
    """The C entry ``stoke_<name>`` of ``csrc/<source>.cu`` (``source``
    defaults to ``name``), built and loaded at first use, and the source's
    error-message function ``stoke_<source>_error``."""
    source = source or name
    lib = _build.load(source)
    fn = getattr(lib, f"stoke_{name}")
    err = getattr(lib, f"stoke_{source}_error")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, _I
        err.argtypes, err.restype = [_I], ctypes.c_char_p
    return fn, err


def _workspace_floats(name: str, *shape: int) -> int:
    """Floats of fp32 scratch that the C entry ``stoke_<name>`` needs at
    ``shape``, by its ``stoke_<name>_workspace_floats``."""
    fn = getattr(_build.load(name), f"stoke_{name}_workspace_floats")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_I] * len(shape), ctypes.c_longlong
    return fn(*shape)


def _raise_on(err, name: str, rc: int) -> None:
    if rc != 0:
        msg = err(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (code {rc})")


# --------------------------------------------------------------------------- #
# flash attention forward
# --------------------------------------------------------------------------- #


def _acc_dtype(t) -> torch.dtype:
    """The plain versions' accumulation type: float32, or float64 for
    float64 inputs (so ``gradcheck`` can hold them to float64)."""
    return torch.promote_types(t.dtype, torch.float32)


def _masked_scores(q, k, mask, causal: bool):
    """``q k^T / sqrt(D)`` in the accumulation type, ``NEG_INF`` where the
    key mask or the causal rule forbids the pair."""
    L, D = q.shape[2], q.shape[3]
    acc = _acc_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * (1.0 / D**0.5)
    allow = torch.ones(L, L, dtype=torch.bool, device=q.device)
    if causal:
        allow = torch.tril(allow)
    allow = allow[None, None]
    if mask is not None:
        allow = allow & (mask[:, None, None, :] > 0)
    return torch.where(allow, s, torch.full_like(s, NEG_INF))


def flash_attention_plain(q, k, v, mask=None, causal: bool = False):
    """Plain PyTorch version of the flash forward: the same masking,
    sentinel and fp32 softmax as the kernel, over the whole score matrix.

    Returns ``(out [B, H, L, D] in q's dtype, lse [B, H, L] float32)``; a
    fully masked row gives ``out == 0`` and ``lse == NEG_INF``."""
    acc = _acc_dtype(q)
    s = _masked_scores(q, k, mask, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc)) / safe_l
    lse = torch.where(
        l > 0, m + torch.log(safe_l), torch.full_like(l, NEG_INF)
    )[..., 0]
    return out.to(q.dtype), lse


def _check_flash_kernel_inputs(q, k, v, mask) -> None:
    D = q.shape[-1]
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention kernel takes float32, bfloat16 or float16 "
            f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if D not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention kernel takes head dim in {_HEAD_DIMS}, got {D}"
        )
    if mask is not None and mask.dtype != torch.int32:
        raise ValueError(f"flash_attention mask must be int32, got {mask.dtype}")


def _flash_fwd_cuda(q, k, v, mask, causal: bool):
    """Launch ``csrc/flash_fwd.cu`` on the current stream."""
    B, H, L, D = q.shape
    _check_flash_kernel_inputs(q, k, v, mask)
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


def flash_attention_bwd_plain(q, k, v, mask, out, lse, do, dlse=None,
                              causal: bool = False):
    """Plain PyTorch version of the flash backward over the whole score
    matrix (``_flash_backward`` of the JAX package): P recomputed from the
    saved LSE rows (``p = 0`` where the score holds the ``NEG_INF``
    sentinel, so a fully masked row gives no gradient),
    ``dS = P * (dO V^T - delta)`` with ``delta = rowsum(dO * O) - dlse``,
    ``dQ = scale dS K``, ``dK = scale dS^T Q``, ``dV = P^T dO``, summed in
    fp32 (float64 for float64 inputs).

    Args are ``[B, H, L, D]`` except ``mask`` (``[B, L]`` int or None) and
    ``lse``/``dlse`` (``[B, H, L]``; ``dlse`` None when the LSE output
    carries no gradient). Returns ``(dq, dk, dv)`` in q's, k's and v's
    dtypes."""
    acc = _acc_dtype(q)
    scale = 1.0 / q.shape[-1] ** 0.5
    s = _masked_scores(q, k, mask, causal)
    p = torch.where(s > NEG_INF * 0.5, torch.exp(s - lse.to(acc)[..., None]),
                    torch.zeros_like(s))
    delta = _delta(out, do, dlse).to(acc)
    do_, q_, k_, v_ = (t.to(acc) for t in (do, q, k, v))
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do_, v_) - delta[..., None])
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, k_)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, q_)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do_)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, do, dlse):
    """``rowsum(dO * O)`` in fp32 (float64 for float64 inputs), minus the
    LSE cotangent where the LSE is an output with a gradient: d lse_i /
    d s_ij = p_ij, so it folds into the same ``dS = P * (dP - delta)``."""
    acc = _acc_dtype(out)
    delta = (do.to(acc) * out.to(acc)).sum(-1)
    return delta if dlse is None else delta - dlse.to(acc)


def ds_bound(do, v, delta) -> torch.Tensor:
    """A bound on ``|dS| = P |dO V^T - delta|`` (P <= 1): ``max |dO row|
    max |V row| + max |delta|``, one float32 on the inputs' device, computed
    with no host sync. The fp16 backward kernels scale dS by a power of two
    from it before rounding dS to fp16 (``ds_scale_for`` in
    ``csrc/hopper.cuh``): the gradients carry the loss scale, and fp16 dS
    would otherwise overflow above 65504 or round in the subnormal range
    below 6.1e-5."""
    def rows(t):
        return torch.linalg.vector_norm(t, dim=-1, dtype=torch.float32).amax()

    return rows(do) * rows(v) + torch.linalg.vector_norm(delta, ord=math.inf)


def ds_scale(bound: float) -> float:
    """The power of two the fp16 backward kernels scale dS by for a bound
    ``bound`` (``ds_scale_for`` of ``csrc/hopper.cuh``, on the host in
    double precision): the largest that keeps ``bound`` at most 2^14,
    clamped to 2^-30 .. 2^30; 2^30 for a bound of 0, 2^-30 for inf or
    NaN."""
    if bound == 0:
        return 2.0 ** 30
    if not math.isfinite(bound):
        return 2.0 ** -30
    e = math.floor(math.log2(16384.0 / bound))
    return 2.0 ** min(max(e, -30), 30)


def _flash_bwd_launch(entry: str, outs, q, k, v, mask, do, lse, delta,
                      causal: bool, bound=None) -> None:
    """Launch ``stoke_<entry>`` of ``csrc/flash_bwd.cu`` on the current
    stream, writing ``outs``. fp16 passes the kernels ``bound`` (by default
    :func:`ds_bound` of these inputs); bf16 and fp32 pass none."""
    B, H, L, D = q.shape
    if q.device.type != "cuda":
        raise ValueError(
            f"{entry} launches a CUDA kernel and takes CUDA tensors, got "
            f"{q.device} (flash_attention_bwd_plain is the plain version)"
        )
    _check_flash_kernel_inputs(q, k, v, mask)
    if do.dtype != q.dtype:
        raise ValueError(
            f"flash_attention backward: dO is {do.dtype}, expected {q.dtype}"
        )
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(
            f"flash_attention backward: lse and delta must be float32, got "
            f"{lse.dtype}/{delta.dtype}"
        )
    if q.dtype != torch.float16:
        bound = None
    elif bound is None:
        bound = ds_bound(do, v, delta)
    _check_cuda("flash_attention backward", q.device, q=q, k=k, v=v,
                mask=mask, do=do, lse=lse, delta=delta, bound=bound)
    # q, k, v, dO, lse, delta, mask, the |dS| bound, the outputs, then BH,
    # H, L, D, dtype, scale, causal, stream
    fn, err = _kernel(entry, [_P] * (8 + len(outs)) + [_I] * 5
                      + [ctypes.c_float, _I, _P], source="flash_bwd")
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if bound is None else bound.data_ptr(),
        *(o.data_ptr() for o in outs),
        B * H, H, L, D, _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D),
        int(bool(causal)), _stream_ptr(q.device),
    )
    _raise_on(err, entry, rc)
    LAUNCHES[entry] += 1


def flash_bwd_dq(q, k, v, mask, do, lse, delta, causal: bool, bound=None):
    """dQ by ``csrc/flash_bwd.cu`` (replaces ``_dq_kernel``): CUDA tensors,
    ``[B, H, L, D]`` q/k/v/dO in float32, bfloat16 or float16, head dim 64
    or 128, ``[B, H, L]`` float32 ``lse`` and ``delta``, ``[B, L]`` int32
    mask or None, all contiguous; ``bound``, fp16's :func:`ds_bound` when
    the caller has it. Returns dQ in q's dtype."""
    dq = torch.empty_like(q)
    _flash_bwd_launch("flash_bwd_dq", (dq,), q, k, v, mask, do, lse, delta,
                      causal, bound)
    return dq


def flash_bwd_dkv(q, k, v, mask, do, lse, delta, causal: bool, bound=None):
    """dK and dV by ``csrc/flash_bwd.cu`` (replaces ``_dkv_kernel``); the
    inputs of :func:`flash_bwd_dq`. Returns ``(dk, dv)`` in k's and v's
    dtypes."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _flash_bwd_launch("flash_bwd_dkv", (dk, dv), q, k, v, mask, do, lse,
                      delta, causal, bound)
    return dk, dv


def _flash_bwd_cuda(q, k, v, mask, out, lse, do, dlse, causal: bool):
    """The backward on the card: delta (and, in fp16, the |dS| bound) with
    torch ops (where the JAX package computes delta outside Pallas), then
    the two kernels."""
    delta = _delta(out, do, dlse).contiguous()
    bound = ds_bound(do, v, delta) if q.dtype == torch.float16 else None
    dq = flash_bwd_dq(q, k, v, mask, do, lse, delta, causal, bound)
    return (dq, *flash_bwd_dkv(q, k, v, mask, do, lse, delta, causal,
                               bound))


def _flash_forward_direct(q, k, v, mask, causal: bool):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, causal)
    return _flash_fwd_cuda(q, k, v, mask, causal)


def _flash_backward_direct(q, k, v, mask, out, lse, do, dlse, causal: bool):
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, mask, out, lse, do, dlse,
                                         causal)
    # dO reaches here through the heads' transpose back to [B, L, H*D],
    # so it is often a strided view; the kernels take contiguous rows
    return _flash_bwd_cuda(q, k, v, mask, out, lse, do.contiguous(), dlse,
                           causal)


@torch.library.custom_op("stoke_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor],
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    out, lse = _flash_forward_direct(q, k, v, mask, causal)
    return out, lse


@_flash_fwd_op.register_fake
def _(q, k, v, mask, causal):
    B, H, L, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, L), dtype=torch.float32)


@torch.library.custom_op("stoke_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], out: torch.Tensor,
                  lse: torch.Tensor, do: torch.Tensor,
                  dlse: Optional[torch.Tensor], causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dq, dk, dv = _flash_backward_direct(q, k, v, mask, out, lse, do, dlse,
                                        causal)
    return dq, dk, dv


@_flash_bwd_op.register_fake
def _(q, k, v, mask, out, lse, do, dlse, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.stoke_tpu_torch.flash_fwd)
def _flash_fwd_flops(q, k, v, mask, causal, out_shape=None) -> int:
    """Dense attention's forward: ``Q K^T`` and ``P V``."""
    B, H, L, D = q
    return 4 * B * H * L * k[2] * D


@register_flop_formula(torch.ops.stoke_tpu_torch.flash_bwd)
def _flash_bwd_flops(q, k, v, mask, out, lse, do, dlse, causal,
                     out_shape=None) -> int:
    """Dense attention's backward: ``dP``, ``dV``, ``dQ`` and ``dK``."""
    B, H, L, D = q
    return 8 * B * H * L * k[2] * D


def _watched() -> bool:
    """Whether a ``TorchDispatchMode`` (a FLOP counter) is active: the
    flash calls then go through the custom ops it can see."""
    return _get_current_dispatch_mode() is not None


def _flash_forward(q, k, v, mask, causal: bool):
    if _watched():
        return torch.ops.stoke_tpu_torch.flash_fwd(q, k, v, mask, causal)
    return _flash_forward_direct(q, k, v, mask, causal)


def _flash_backward(ctx, do, dlse):
    q, k, v, mask, out, lse = ctx.saved_tensors
    if _watched():
        return torch.ops.stoke_tpu_torch.flash_bwd(q, k, v, mask, out, lse,
                                                   do, dlse, ctx.causal)
    return _flash_backward_direct(q, k, v, mask, out, lse, do, dlse,
                                  ctx.causal)


class _Flash(torch.autograd.Function):
    """``flash_attention(..., return_lse=False)``: the JAX package's
    ``_flash`` with its VJP rule."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = _flash_forward(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        return (*_flash_backward(ctx, do, None), None, None)


class _FlashWithLse(torch.autograd.Function):
    """``flash_attention(..., return_lse=True)``: the JAX package's
    ``_flash_with_lse``; the LSE rows carry a real gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = _flash_forward(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return (*_flash_backward(ctx, do, dlse), None, None)


def flash_attention(q, k, v, mask=None, *, causal: bool = False,
                    return_lse: bool = False):
    """Flash attention on ``[B, H, L, D]`` inputs with an optional
    ``[B, L]`` int32 key mask (nonzero = attend), differentiable in q, k
    and v (and through the LSE rows when ``return_lse=True``).

    On the card it launches the CUDA kernels (forward, and dQ and dK/dV
    in backward); on the CPU it runs :func:`flash_attention_plain` and
    :func:`flash_attention_bwd_plain`. ``return_lse=True`` also returns
    the ``[B, H, L]`` fp32 logsumexp rows (``NEG_INF`` on a fully masked
    row). The output is in the input dtype."""
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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if return_lse:
        return _FlashWithLse.apply(q, k, v, mask, causal)
    return _Flash.apply(q, k, v, mask, causal)


def make_flash_attention(causal: bool = False):
    """A flash ``attention_fn`` for the models' blocks (the contract of
    :func:`stoke_tpu_torch.models.bert.dense_attention`).

    A bias, if given, becomes the key mask as in the JAX package: key j
    is kept where ``bias[:, 0, 0, j] > -1e8``. Attention-probability
    dropout is refused, as the JAX package refuses it."""

    def attention_fn(q, k, v, bias, dropout=None):
        if dropout is not None:
            raise NotImplementedError(
                "flash attention does not support attention-prob dropout; "
                "set attention dropout to 0 (residual dropout is fine)"
            )
        mask = None
        if bias is not None:
            mask = (bias[:, 0, 0, :] > -1e8).to(torch.int32)
        return flash_attention(q, k, v, mask, causal=causal)

    return attention_fn


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
    if q.dtype not in _PAGED_DTYPES:
        raise ValueError(
            f"paged decode kernel takes float32 or bfloat16 queries, got "
            f"{q.dtype}"
        )
    if k_pages.dtype not in _PAGED_DTYPES or v_pages.dtype != k_pages.dtype:
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
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _P],
    )
    # the chunks' partial softmax states, which the merge kernel combines
    ws = torch.empty(_workspace_floats("paged_decode", B, H, D, BS, MB),
                     dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rc = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), B, H, D, NB, BS, MB, _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_pages.dtype], 1.0 / math.sqrt(D),
        _stream_ptr(q.device),
    )
    _raise_on(err, "paged_decode", rc)
    LAUNCHES["paged_decode"] += 1
    return out


def paged_decode_attention_pallas(q, k_pages, v_pages, block_tables,
                                  context_lens):
    """The decode kernel's wrapper, under the JAX package's name.

    Same contract as :func:`paged_decode_attention`, but for a slot at
    context 0, which the kernel gives exactly 0 as the JAX kernel does (the
    plain version, as the JAX package's jnp reference, gives the mean of V
    over the slot's table). On the card it launches ``csrc/paged_decode.cu``'s
    chunk and merge kernels, counted once in ``LAUNCHES["paged_decode"]``
    (contiguous int32 tables and lengths, contiguous float32 or bfloat16
    query and pools, head dim 64 or 128); on the CPU it runs
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


# --------------------------------------------------------------------------- #
# chunked-prefill and speculative-verify attention
# --------------------------------------------------------------------------- #


def paged_prefill_chunk_attention(q, k_pages, v_pages, block_tables,
                                  positions):
    """Chunked-prefill attention over a paged KV pool (plain PyTorch; the
    JAX package has no kernel for it either).

    A chunk's queries attend everything cached for the request: earlier
    chunks' K/V and this chunk's own, which the hook writes before the
    attention runs. Causality is positional: the query at global position
    ``p`` sees cache positions ``<= p``, which covers the intra-chunk
    causal mask and the prefix in one predicate.

    Args:
        q: ``[B, H, C, D]`` chunk queries.
        k_pages / v_pages: ``[NB, BS, H, D]`` pool of one layer.
        block_tables: ``[B, MB]`` int block ids per request.
        positions: ``[B, C]`` int global positions of the queries (padding
            rows may hold clamped positions; the caller discards them).

    Returns ``[B, H, C, D]`` in the query dtype."""
    B, H, C, D = q.shape
    tables = block_tables.long()
    k = k_pages[tables].reshape(B, -1, H, D)
    v = v_pages[tables].reshape(B, -1, H, D)
    s = torch.einsum("bhqd,bwhd->bhqw", q.float(), k.float()) / (D**0.5)
    w_pos = torch.arange(k.shape[1], device=q.device)
    valid = w_pos[None, None, :] <= positions.long()[:, :, None]  # [B, C, W]
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqw,bwhd->bhqd", p, v.float())
    return out.to(q.dtype)


def paged_verify_attention(q, k_pages, v_pages, block_tables, positions):
    """Plain PyTorch speculative-verify attention: S = k+1 query rows per
    slot (the pending token and k drafts), each attending the cache at its
    own global position. The same function as
    :func:`paged_prefill_chunk_attention`, kept under its own name as the
    verify kernel's plain version.

    Args:
        q: ``[B, H, S, D]`` verify queries.
        k_pages / v_pages: ``[NB, BS, H, D]`` pool of one layer.
        block_tables: ``[B, MB]`` int block ids per slot.
        positions: ``[B, S]`` int global positions of the queries (short
            drafts' padding rows carry clamped positions; their outputs
            are discarded).

    Returns ``[B, H, S, D]`` in the query dtype."""
    return paged_prefill_chunk_attention(q, k_pages, v_pages, block_tables,
                                         positions)


#: most query rows per slot the verify kernel takes (speculative_k + 1)
VERIFY_MAX_QUERIES = 16


def _paged_verify_cuda(q, k_pages, v_pages, block_tables, positions):
    """Launch ``csrc/paged_verify.cu`` on the current stream."""
    B, H, S, D = q.shape
    NB, BS = k_pages.shape[0], k_pages.shape[1]
    MB = block_tables.shape[1]
    if q.dtype not in _PAGED_DTYPES:
        raise ValueError(
            f"paged verify kernel takes float32 or bfloat16 queries, got "
            f"{q.dtype}"
        )
    if k_pages.dtype not in _PAGED_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(
            f"paged verify kernel takes float32 or bfloat16 pools of one "
            f"dtype, got {k_pages.dtype}/{v_pages.dtype}"
        )
    if D not in _HEAD_DIMS:
        raise ValueError(
            f"paged verify kernel takes head dim in {_HEAD_DIMS}, got {D}"
        )
    if S > VERIFY_MAX_QUERIES:
        raise ValueError(
            f"paged verify kernel takes at most {VERIFY_MAX_QUERIES} query "
            f"rows per slot (speculative_k <= {VERIFY_MAX_QUERIES - 1}), got "
            f"{S}"
        )
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError(
            f"block_tables and positions must be int32, got "
            f"{block_tables.dtype}/{positions.dtype}"
        )
    _check_cuda(
        "paged_verify_attention_pallas", q.device, q=q, k_pages=k_pages,
        v_pages=v_pages, block_tables=block_tables, positions=positions,
    )
    fn, err = _kernel(
        "paged_verify",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _P],
    )
    # the chunks' partial softmax states, which the merge kernel combines
    ws = torch.empty(_workspace_floats("paged_verify", B, H, S, D, BS, MB),
                     dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rc = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        ws.data_ptr(), B, H, S, D, NB, BS, MB, _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k_pages.dtype], 1.0 / math.sqrt(D),
        _stream_ptr(q.device),
    )
    _raise_on(err, "paged_verify", rc)
    LAUNCHES["paged_verify"] += 1
    return out


def paged_verify_attention_pallas(q, k_pages, v_pages, block_tables,
                                  positions):
    """The verify kernel's wrapper, under the JAX package's name.

    Same contract as :func:`paged_verify_attention`. On the card it
    launches ``csrc/paged_verify.cu``'s chunk and merge kernels, counted
    once in ``LAUNCHES["paged_verify"]`` (contiguous int32 tables and
    positions, contiguous float32 or bfloat16 query and pools, head dim 64
    or 128, at most ``VERIFY_MAX_QUERIES`` query rows); on the CPU it runs
    :func:`paged_verify_attention`."""
    B, H, S, D = q.shape
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
    if tuple(positions.shape) != (B, S):
        raise ValueError(
            f"positions must be [B={B}, S={S}], got {tuple(positions.shape)}"
        )
    if q.device.type == "cpu":
        return paged_verify_attention(q, k_pages, v_pages, block_tables,
                                      positions)
    if q.device.type == "cuda":
        return _paged_verify_cuda(q, k_pages, v_pages, block_tables,
                                  positions)
    raise ValueError(
        f"paged_verify_attention_pallas: unsupported device {q.device}"
    )
