"""Carry a JAX model's weights over to the port.

Each function maps a flax variable tree, already turned into nested dicts
of numpy arrays by the caller, onto the names of the port's module's
``state_dict()``: :func:`gpt_state_dict_from_jax` for
``stoke_tpu.models.gpt.GPT`` (tied head, dense FFN),
:func:`vit_state_dict_from_jax` for ``ViT``, and
:func:`cnn_state_dict_from_jax` for ``BasicNN`` and every ``ResNet``
(``params`` and ``batch_stats``). The port never imports JAX; the caller
does the ``np.asarray`` (for example with ``jax.tree_util.tree_map(
np.asarray, variables)``). Each raises ``KeyError`` on a missing leaf and
``ValueError`` on a leaf the port has no place for or on a wrong shape.

Layouts (``stoke_tpu/models/bert.py:72-106``), one transformer block map
(:func:`_transformer_blocks`) shared by GPT and ViT:

- ``qkv`` is a ``DenseGeneral((3, heads, D))``: kernel ``[hidden, 3,
  heads, D]``, bias ``[3, heads, D]``; flattened in that order it is the
  port's ``Linear(hidden, 3 * hidden)``, whose output splits as
  ``[..., 3, heads, D]`` (the JAX ``moveaxis(qkv, 2, 0)``);
- ``out`` kernel is ``[hidden, hidden]`` over heads re-flattened in
  ``[B, L, H*D]`` order;
- ``Dense`` kernels are ``[in, out]``, so they are transposed into
  ``nn.Linear.weight``; LayerNorm ``scale`` is ``weight``; ``Embed``
  ``embedding`` is ``weight``;
- ``Conv`` kernels are ``[kh, kw, in, out]`` (NHWC), the port's
  ``[out, in, kh, kw]`` (NCHW); BatchNorm ``scale / bias / mean / var`` are
  ``weight / bias / running_mean / running_var``. The port's CNNs name
  their modules as the flax tree does, so a leaf ``a/b/kernel`` is
  ``a.b.weight``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Tuple

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


def _taker(flat: Dict[str, np.ndarray], who: str) -> Callable:
    """``take(path)``: pop ``path`` from ``flat``, ``KeyError`` if absent."""
    def take(path: str) -> np.ndarray:
        if path not in flat:
            raise KeyError(f"{who}: missing leaf {path!r}")
        return flat.pop(path)
    return take


def _transformer_blocks(flat: Dict[str, np.ndarray], take: Callable,
                        hidden: int, who: str) -> Tuple[dict, dict]:
    """Every ``layer_<i>`` ``TransformerBlock`` of ``flat`` as the port's
    ``layers.<i>``: ``(state, expected shapes)``."""
    layers = sorted(
        {int(m.group(1)) for k in flat if (m := re.match(r"layer_(\d+)/", k))}
    )
    n_layers = layers[-1] + 1 if layers else 0
    ff = flat.get("layer_0/ff_in/kernel", np.zeros((hidden, 0))).shape[1]
    sd, expect = {}, {}
    for i in range(n_layers):
        src, dst = f"layer_{i}", f"layers.{i}"
        qkv = take(f"{src}/attention/qkv/kernel")
        if qkv.ndim != 4 or qkv.shape[:2] != (hidden, 3):
            raise ValueError(
                f"{who}: {src}/attention/qkv/kernel has shape {qkv.shape}, "
                f"expected [{hidden}, 3, heads, head_dim]"
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
    return sd, expect


def _finish(sd: Dict[str, np.ndarray], expect: Dict[str, tuple],
            who: str) -> Dict[str, torch.Tensor]:
    """Check every shape in ``expect``; ``sd`` as fp32 tensors."""
    for name, shape in expect.items():
        if sd[name].shape != shape:
            raise ValueError(
                f"{who}: {name} has shape {sd[name].shape}, expected {shape}"
            )
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in sd.items()
    }


def gpt_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's GPT ``state_dict`` from a flax GPT ``params`` tree of
    numpy arrays (the ``params`` collection, not the variables dict).

    Raises ``KeyError`` on a missing leaf, ``ValueError`` on a leaf the
    port has no place for or on a shape that does not fit the model's
    widths."""
    who = "gpt_state_dict_from_jax"
    flat = _flatten(params)
    take = _taker(flat, who)
    tok = take("tok_emb/embedding")
    vocab, hidden = tok.shape
    sd: Dict[str, np.ndarray] = {
        "tok_emb.weight": tok,
        "pos_emb.weight": take("pos_emb/embedding"),
    }
    expect = {"tok_emb.weight": (vocab, hidden),
              "ln_final.weight": (hidden,), "ln_final.bias": (hidden,)}
    blocks, block_shapes = _transformer_blocks(flat, take, hidden, who)
    sd.update(blocks)
    expect.update(block_shapes)
    sd["ln_final.weight"] = take("ln_final/scale")
    sd["ln_final.bias"] = take("ln_final/bias")
    if flat:
        raise ValueError(
            f"{who}: leaves with no place in the port's GPT (untied head or "
            f"MoE are not served): {sorted(flat)}"
        )
    if sd["pos_emb.weight"].ndim != 2 or sd["pos_emb.weight"].shape[1] != hidden:
        raise ValueError(
            f"{who}: pos_emb/embedding has shape "
            f"{sd['pos_emb.weight'].shape}, expected [max_len, {hidden}]"
        )
    return _finish(sd, expect, who)


def vit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ViT ``state_dict`` from a flax ViT ``params`` tree of
    numpy arrays. Raises as :func:`gpt_state_dict_from_jax`."""
    who = "vit_state_dict_from_jax"
    flat = _flatten(params)
    take = _taker(flat, who)
    patch = take("patch_embed/kernel")
    if patch.ndim != 4:
        raise ValueError(f"{who}: patch_embed/kernel has shape "
                         f"{patch.shape}, expected [p, p, channels, hidden]")
    hidden = patch.shape[3]
    sd: Dict[str, np.ndarray] = {
        "patch_embed.weight": patch.transpose(3, 2, 0, 1),
        "patch_embed.bias": take("patch_embed/bias"),
        "cls_token": take("cls_token"),
        "pos_embed": take("pos_embed"),
    }
    blocks, expect = _transformer_blocks(flat, take, hidden, who)
    sd.update(blocks)
    sd["ln_final.weight"] = take("ln_final/scale")
    sd["ln_final.bias"] = take("ln_final/bias")
    head = take("head/kernel")
    sd["head.weight"], sd["head.bias"] = head.T, take("head/bias")
    if flat:
        raise ValueError(f"{who}: leaves with no place in the port's ViT: "
                         f"{sorted(flat)}")
    n_tokens = sd["pos_embed"].shape[1] if sd["pos_embed"].ndim == 3 else -1
    expect.update({
        "patch_embed.bias": (hidden,), "cls_token": (1, 1, hidden),
        "pos_embed": (1, n_tokens, hidden), "ln_final.weight": (hidden,),
        "ln_final.bias": (hidden,), "head.weight": (head.shape[1], hidden),
        "head.bias": (head.shape[1],),
    })
    return _finish(sd, expect, who)


def cnn_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` of ``BasicNN`` or a ``ResNet`` from the
    flax ``variables`` dict (``params`` and, with BatchNorm,
    ``batch_stats``) of numpy arrays.

    A module with ``scale`` (or running statistics) is a BatchNorm and needs
    ``scale``, ``bias``, ``mean`` and ``var`` of one length; one with a
    ``kernel`` is a ``Conv`` (4-D) or ``Dense`` (2-D), with an optional
    ``bias`` of its output width. Raises ``KeyError`` on a missing leaf or
    collection, ``ValueError`` on a leaf or collection the port has no
    place for, or on a wrong shape. A module none of whose leaves is
    there leaves no trace in the tree; the port's strict
    ``load_state_dict`` names it."""
    who = "cnn_state_dict_from_jax"
    if "params" not in variables:
        raise KeyError(f"{who}: missing collection 'params'")
    extra = sorted(set(variables) - {"params", "batch_stats"})
    if extra:
        raise ValueError(f"{who}: collections with no place in the port: "
                         f"{extra}")
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    take, take_stat = _taker(params, who), _taker(stats, who)
    norms = ({k.rpartition("/")[0] for k in params if k.endswith("/scale")}
             | {k.rpartition("/")[0] for k in stats})
    layers = {k.rpartition("/")[0] for k in params
              if k.endswith(("/kernel", "/bias"))} - norms
    sd: Dict[str, np.ndarray] = {}
    expect: Dict[str, tuple] = {}
    for mod in sorted(norms):
        dst = mod.replace("/", ".")
        scale = take(f"{mod}/scale")
        sd[f"{dst}.weight"] = scale
        sd[f"{dst}.bias"] = take(f"{mod}/bias")
        sd[f"{dst}.running_mean"] = take_stat(f"{mod}/mean")
        sd[f"{dst}.running_var"] = take_stat(f"{mod}/var")
        c = scale.shape[0] if scale.ndim == 1 else -1
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            expect[f"{dst}.{leaf}"] = (c,)
    for mod in sorted(layers):
        dst = mod.replace("/", ".")
        kernel = take(f"{mod}/kernel")
        if kernel.ndim == 4:
            sd[f"{dst}.weight"] = kernel.transpose(3, 2, 0, 1)
        elif kernel.ndim == 2:
            sd[f"{dst}.weight"] = kernel.T
        else:
            raise ValueError(f"{who}: {mod}/kernel has shape {kernel.shape}, "
                             f"expected a 4-D conv or 2-D dense kernel")
        if f"{mod}/bias" in params:
            sd[f"{dst}.bias"] = take(f"{mod}/bias")
            expect[f"{dst}.bias"] = (kernel.shape[-1],)
    if params or stats:
        raise ValueError(f"{who}: leaves with no place in the port's CNNs: "
                         f"{sorted(params) + sorted(stats)}")
    return _finish(sd, expect, who)
