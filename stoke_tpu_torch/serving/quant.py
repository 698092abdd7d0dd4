"""Serving-side weight quantization: int8 or bf16 weights, dequantized at
every dispatch.

Counterpart of ``stoke_tpu/serving/quant.py``: ``QuantizedTensor``
(``:39``), ``quantize_params`` (``:105``), ``dequantize_params``
(``:151``), ``quantization_error`` (``:170``), ``param_bytes`` (``:219``)
and ``compression_stats`` (``:232``), over the port's state dict.

The JAX package quantizes the flax params tree, so which leaves quantize
(``ndim >= 2`` and ``size >= min_size``), the chunks' contents (a chunk's
absmax is over its elements in the flat leaf) and each leaf's stochastic
key (``fold_in(PRNGKey(seed), i)``, ``i`` the leaf's place in the flatten
order) all follow the JAX view of each tensor: its flax path, layout and
shape (:func:`stoke_tpu_torch.convert.jax_param_layout`; a ``Dense``
kernel is the transposed ``Linear`` weight, the fused ``qkv`` kernel is
``[hidden, 3, heads, D]``). A :class:`QuantizedTensor` holds the int8
payload and fp32 scales of the JAX layout's flat leaf, and
:meth:`QuantizedTensor.to_port` views its dequantized values in the
port's layout without a copy (a transposed view, which the matmuls take
as it is). So the dequantized weights are the JAX engine's, element for
element, and the two engines' greedy streams agree.

On the card the dequantize kernel (``csrc/quant.cu``,
:func:`stoke_tpu_torch.ops.quant.dequantize_chunks`) writes each leaf in
its dtype at every dispatch; between dispatches only the payload and
scales stay on the device (``ServingEngine`` frees the module's own
storage of those leaves).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from stoke_tpu_torch.ops.quant import dequantize_chunks, quantize_chunks
from stoke_tpu_torch.utils.prng import fold_in, initial_key_data

#: the JAX view of a tensor: (flax path, permutation from the port's
#: layout or None, JAX shape), as :func:`~stoke_tpu_torch.convert
#: .jax_param_layout` gives it
JaxView = Tuple[Tuple[str, ...], Optional[Tuple[int, ...]], tuple]


class QuantizedTensor:
    """One int8-quantized weight: the payload ``q`` (int8, the JAX
    layout's flat leaf padded to a multiple of ``chunk``), the fp32
    ``scales`` (one a chunk), and how to read it back: the JAX ``shape``,
    the leaf's ``dtype``, the ``pad`` and the port's ``port_shape`` and
    ``perm`` (the permutation that takes the port's tensor to the JAX
    layout)."""

    def __init__(self, q: torch.Tensor, scales: torch.Tensor, shape: tuple,
                 dtype: torch.dtype, pad: int, chunk: int,
                 port_shape: tuple, perm: Optional[Tuple[int, ...]] = None):
        self.q, self.scales = q, scales
        self.shape, self.dtype = tuple(shape), dtype
        self.pad, self.chunk = int(pad), int(chunk)
        self.port_shape, self.perm = tuple(port_shape), perm

    def dequantize(self) -> torch.Tensor:
        """The leaf in the JAX layout and its dtype (the kernel on the
        card)."""
        n = self.q.numel() - self.pad
        return dequantize_chunks(self.q, self.scales, self.chunk, self.dtype,
                                 n).view(self.shape)

    def to_port(self, t: torch.Tensor) -> torch.Tensor:
        """A JAX-layout tensor of this leaf as a view in the port's
        layout."""
        if self.perm is None:
            return t.view(self.port_shape)
        permuted = tuple(self.port_shape[d] for d in self.perm)
        inverse = tuple(int(i) for i in np.argsort(self.perm))
        return t.reshape(permuted).permute(inverse)

    @property
    def nbytes(self) -> int:
        return int(self.q.numel()) + 4 * int(self.scales.numel())

    def __repr__(self):
        return (f"QuantizedTensor(shape={self.shape}, chunk={self.chunk}, "
                f"bytes={self.nbytes})")


def _views(params: Mapping[str, torch.Tensor],
           layout: Optional[Mapping[str, JaxView]]) -> Dict[str, JaxView]:
    """Each entry's JAX view, in the JAX flatten order (registration order
    and the port's layout for a model the converter does not know)."""
    if layout is not None and all(n in layout for n in params):
        return dict(sorted(((n, layout[n]) for n in params),
                           key=lambda kv: kv[1][0]))
    return {n: ((n,), None, tuple(t.shape)) for n, t in params.items()}


def _is_quantizable(t: torch.Tensor, shape: tuple, min_size: int) -> bool:
    return len(shape) >= 2 and t.numel() >= min_size and t.is_floating_point()


def _to_jax(t: torch.Tensor, view: JaxView) -> torch.Tensor:
    """``t`` in the JAX layout, flat."""
    _, perm, _ = view
    return (t.permute(perm) if perm else t).reshape(-1)


def quantize_params(params: Mapping[str, torch.Tensor], mode: str, *,
                    chunk_elems: int = 128, stochastic: bool = False,
                    min_size: int = 1024, seed: int = 0,
                    layout: Optional[Mapping[str, JaxView]] = None
                    ) -> Dict[str, Any]:
    """Quantize a state dict for serving (the JAX ``quantize_params``).

    ``mode``: ``"none"`` returns ``params``; ``"bf16"`` casts every float
    tensor to bfloat16 (2x); ``"int8"`` replaces each tensor that is at
    least 2-D in the JAX layout and has ``>= min_size`` elements with a
    :class:`QuantizedTensor` (~3.9x on those). ``stochastic=True`` rounds
    stochastically under ``fold_in(PRNGKey(seed), i)`` for the ``i``-th
    leaf of the JAX flatten order. ``layout``: the model's
    :func:`~stoke_tpu_torch.convert.jax_param_layout`. Returns the entries
    in the JAX order."""
    if mode == "none":
        return params
    if mode == "bf16":
        return {n: t.to(torch.bfloat16) if t.is_floating_point() else t
                for n, t in params.items()}
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r}")
    out: Dict[str, Any] = {}
    for i, (n, view) in enumerate(_views(params, layout).items()):
        t = params[n]
        if not _is_quantizable(t, view[2], min_size):
            out[n] = t
            continue
        x = _to_jax(t.detach(), view).to(torch.float32)
        pad = (-x.numel()) % chunk_elems
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        key = None
        if stochastic:
            key = torch.from_numpy(
                fold_in(initial_key_data(seed), i).astype(np.int64)).to(
                    x.device)
        q, scales = quantize_chunks(x.contiguous(), chunk_elems, key,
                                    stochastic)
        out[n] = QuantizedTensor(q, scales, view[2], t.dtype, pad,
                                 chunk_elems, tuple(t.shape), view[1])
    return out


def dequantize_params(qparams: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The dense state dict of a quantized one, in the port's layout:
    quantized entries dequantized (views of the JAX layout), bf16 entries
    cast up to float32 as the JAX ``dequantize_params`` does, the rest as
    they are."""
    out = {}
    for n, v in qparams.items():
        if isinstance(v, QuantizedTensor):
            out[n] = v.to_port(v.dequantize())
        elif torch.is_tensor(v) and v.dtype == torch.bfloat16:
            out[n] = v.float()
        else:
            out[n] = v
    return out


def quantization_error(params: Mapping[str, torch.Tensor],
                       qparams: Mapping[str, Any],
                       layout: Optional[Mapping[str, JaxView]] = None,
                       eps: float = 1e-12) -> Dict[str, Dict[str, float]]:
    """Per-leaf error of an int8 state dict against its source (the JAX
    ``quantization_error``): ``abs_err_max`` and ``rel_rms``, in float64,
    keyed by the leaf's ``"a/b/c"`` flax path; unquantized leaves are
    left out."""
    views = _views(params, layout)
    out: Dict[str, Dict[str, float]] = {}
    for n, view in views.items():
        q = qparams.get(n)
        if not isinstance(q, QuantizedTensor):
            continue
        orig = _to_jax(params[n].detach(), view).cpu().double().numpy()
        deq = q.dequantize().reshape(-1).cpu().double().numpy()
        err = deq - orig
        rms_src = float(np.sqrt(np.mean(orig ** 2)))
        out["/".join(view[0])] = {
            "abs_err_max": float(np.max(np.abs(err))),
            "rel_rms": float(np.sqrt(np.mean(err ** 2)) / (rms_src + eps)),
        }
    return out


def param_bytes(tree: Mapping[str, Any]) -> int:
    """Device bytes of a (possibly quantized) state dict."""
    total = 0
    for v in tree.values():
        if isinstance(v, QuantizedTensor):
            total += v.nbytes
        elif torch.is_tensor(v):
            total += v.numel() * v.element_size()
    return total


def compression_stats(params: Mapping[str, Any],
                      qparams: Mapping[str, Any]) -> Dict[str, float]:
    """``{param_bytes_fp, param_bytes_quant, compression}``, as the JAX
    package's."""
    fp = param_bytes(params)
    q = param_bytes(qparams)
    return {
        "param_bytes_fp": float(fp),
        "param_bytes_quant": float(q),
        "compression": float(fp) / float(q) if q else 1.0,
    }
