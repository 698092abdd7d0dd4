"""Carry a JAX ``GPT``'s weights over to the port.

:func:`gpt_state_dict_from_jax` maps the flax parameter tree of
``stoke_tpu.models.gpt.GPT`` (tied head, dense FFN), already turned into
nested dicts of numpy arrays by the caller, onto the names of
:class:`stoke_tpu_torch.models.gpt.GPT`'s ``state_dict()``. The port never
imports JAX; the caller does the ``np.asarray`` (for example with
``jax.tree_util.tree_map(np.asarray, params)``).

Layouts (``stoke_tpu/models/bert.py:72-106``):

- ``qkv`` is a ``DenseGeneral((3, heads, D))``: kernel ``[hidden, 3,
  heads, D]``, bias ``[3, heads, D]``; flattened in that order it is the
  port's ``Linear(hidden, 3 * hidden)``, whose output splits as
  ``[..., 3, heads, D]`` (the JAX ``moveaxis(qkv, 2, 0)``);
- ``out`` kernel is ``[hidden, hidden]`` over heads re-flattened in
  ``[B, L, H*D]`` order;
- ``Dense`` kernels are ``[in, out]``, so they are transposed into
  ``nn.Linear.weight``; LayerNorm ``scale`` is ``weight``; ``Embed``
  ``embedding`` is ``weight``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = np.asarray(val)
    return out


def gpt_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's GPT ``state_dict`` from a flax GPT ``params`` tree of
    numpy arrays (the ``params`` collection, not the variables dict).

    Raises ``KeyError`` on a missing leaf, ``ValueError`` on a leaf the
    port has no place for or on a shape that does not fit the model's
    widths."""
    flat = _flatten(params)
    layers = sorted(
        {int(m.group(1)) for k in flat if (m := re.match(r"layer_(\d+)/", k))}
    )
    n_layers = layers[-1] + 1 if layers else 0

    def take(path: str) -> np.ndarray:
        if path not in flat:
            raise KeyError(f"gpt_state_dict_from_jax: missing leaf {path!r}")
        return flat.pop(path)

    tok = take("tok_emb/embedding")
    vocab, hidden = tok.shape
    ff = flat.get("layer_0/ff_in/kernel", np.zeros((hidden, 0))).shape[1]

    sd: Dict[str, np.ndarray] = {
        "tok_emb.weight": tok,
        "pos_emb.weight": take("pos_emb/embedding"),
    }
    expect = {"tok_emb.weight": (vocab, hidden)}
    for i in range(n_layers):
        src, dst = f"layer_{i}", f"layers.{i}"
        qkv = take(f"{src}/attention/qkv/kernel")
        if qkv.ndim != 4 or qkv.shape[:2] != (hidden, 3):
            raise ValueError(
                f"gpt_state_dict_from_jax: {src}/attention/qkv/kernel has "
                f"shape {qkv.shape}, expected [{hidden}, 3, heads, head_dim]"
            )
        sd[f"{dst}.attention.qkv.weight"] = qkv.reshape(hidden, -1).T
        sd[f"{dst}.attention.qkv.bias"] = take(
            f"{src}/attention/qkv/bias").reshape(-1)
        sd[f"{dst}.attention.out.weight"] = take(
            f"{src}/attention/out/kernel").T
        sd[f"{dst}.attention.out.bias"] = take(f"{src}/attention/out/bias")
        for name in ("ff_in", "ff_out"):
            sd[f"{dst}.{name}.weight"] = take(f"{src}/{name}/kernel").T
            sd[f"{dst}.{name}.bias"] = take(f"{src}/{name}/bias")
        for name in ("ln_attn", "ln_ff"):
            sd[f"{dst}.{name}.weight"] = take(f"{src}/{name}/scale")
            sd[f"{dst}.{name}.bias"] = take(f"{src}/{name}/bias")
        expect.update({
            f"{dst}.attention.qkv.weight": (3 * hidden, hidden),
            f"{dst}.attention.qkv.bias": (3 * hidden,),
            f"{dst}.attention.out.weight": (hidden, hidden),
            f"{dst}.attention.out.bias": (hidden,),
            f"{dst}.ff_in.weight": (ff, hidden),
            f"{dst}.ff_in.bias": (ff,),
            f"{dst}.ff_out.weight": (hidden, ff),
            f"{dst}.ff_out.bias": (hidden,),
            f"{dst}.ln_attn.weight": (hidden,),
            f"{dst}.ln_attn.bias": (hidden,),
            f"{dst}.ln_ff.weight": (hidden,),
            f"{dst}.ln_ff.bias": (hidden,),
        })
    sd["ln_final.weight"] = take("ln_final/scale")
    sd["ln_final.bias"] = take("ln_final/bias")
    expect.update({"ln_final.weight": (hidden,), "ln_final.bias": (hidden,)})
    if flat:
        raise ValueError(
            f"gpt_state_dict_from_jax: leaves with no place in the port's "
            f"GPT (untied head or MoE are not served): {sorted(flat)}"
        )
    if sd["pos_emb.weight"].ndim != 2 or sd["pos_emb.weight"].shape[1] != hidden:
        raise ValueError(
            f"gpt_state_dict_from_jax: pos_emb/embedding has shape "
            f"{sd['pos_emb.weight'].shape}, expected [max_len, {hidden}]"
        )
    for name, shape in expect.items():
        if sd[name].shape != shape:
            raise ValueError(
                f"gpt_state_dict_from_jax: {name} has shape "
                f"{sd[name].shape}, expected {shape}"
            )
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in sd.items()
    }
