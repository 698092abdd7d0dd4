"""Carry a JAX model's weights over to the port.

Each function maps a flax variable tree, already turned into nested dicts
of numpy arrays by the caller, onto the names of the port's module's
``state_dict()``: :func:`gpt_state_dict_from_jax` for
``stoke_tpu.models.gpt.GPT`` (tied or untied head, dense or MoE blocks),
:func:`vit_state_dict_from_jax` for ``ViT``,
:func:`cnn_state_dict_from_jax` for ``BasicNN`` and every ``ResNet``
(``params`` and ``batch_stats``), :func:`bert_state_dict_from_jax`
for ``BertForSequenceClassification``, and
:func:`pipelined_lm_state_dict_from_jax` for ``PipelinedLM`` (its
stage-stacked leaves slice by slice). The port never imports JAX; the
caller does the ``np.asarray`` (for example with ``jax.tree_util.tree_map(
np.asarray, variables)``). Each raises ``KeyError`` on a missing leaf and
``ValueError`` on a leaf the port has no place for or on a wrong shape.
:func:`jax_params_from_port` goes back, by :func:`jax_param_layout`.

:func:`jax_checkpoint_to_port` carries a whole checkpoint over: it reads a
tag the JAX package wrote (numpy, json and pickle only) and writes a port
tag that ``Stoke.load`` resumes, optimizer state included.

Layouts (``stoke_tpu/models/bert.py:72-106``), one transformer block map
(:func:`_transformer_blocks`) shared by GPT, ViT, BERT and a
``PipelinedLM``'s stages:

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

import json
import os
import pickle
import re
import shutil
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


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
    ``layers.<i>``: ``(state, expected shapes)``. A block with a
    ``moe`` subtree is a ``MoETransformerBlock``: ``moe/router/kernel``
    ``[hidden, E]`` (transposed into the router's weight), ``moe/w_in``
    ``[E, hidden, ff]`` and ``moe/w_out`` ``[E, ff, hidden]`` as they are."""
    layers = sorted(
        {int(m.group(1)) for k in flat if (m := re.match(r"layer_(\d+)/", k))}
    )
    n_layers = layers[-1] + 1 if layers else 0
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
        if f"{src}/moe/router/kernel" in flat:
            router = take(f"{src}/moe/router/kernel")
            w_in = take(f"{src}/moe/w_in")
            n_exp, ff = router.shape[1], w_in.shape[-1]
            sd[f"{dst}.moe.router.weight"] = router.T
            sd[f"{dst}.moe.w_in"] = w_in
            sd[f"{dst}.moe.w_out"] = take(f"{src}/moe/w_out")
            expect.update({
                f"{dst}.moe.router.weight": (n_exp, hidden),
                f"{dst}.moe.w_in": (n_exp, hidden, ff),
                f"{dst}.moe.w_out": (n_exp, ff, hidden),
            })
        else:
            for name in ("ff_in", "ff_out"):
                sd[f"{dst}.{name}.weight"] = take(f"{src}/{name}/kernel").T
                sd[f"{dst}.{name}.bias"] = take(f"{src}/{name}/bias")
            ff = sd[f"{dst}.ff_in.weight"].shape[0]
            expect.update({
                f"{dst}.ff_in.weight": (ff, hidden),
                f"{dst}.ff_in.bias": (ff,),
                f"{dst}.ff_out.weight": (hidden, ff),
                f"{dst}.ff_out.bias": (hidden,),
            })
        for name in ("ln_attn", "ln_ff"):
            sd[f"{dst}.{name}.weight"] = take(f"{src}/{name}/scale")
            sd[f"{dst}.{name}.bias"] = take(f"{src}/{name}/bias")
        expect.update({
            f"{dst}.attention.qkv.weight": (3 * hidden, hidden),
            f"{dst}.attention.qkv.bias": (3 * hidden,),
            f"{dst}.attention.out.weight": (hidden, hidden),
            f"{dst}.attention.out.bias": (hidden,),
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


def rank_state_dict(state: Mapping[str, Any], cuts: Mapping[str, Any],
                    rank: int) -> Dict[str, Any]:
    """Rank ``rank``'s slice of each entry of a whole ``state`` (tensors or
    numpy arrays by name, e.g. a converter's output) that ``cuts`` (a
    :class:`~stoke_tpu_torch.parallel.tensor.TensorParallel`'s, by name)
    splits; the other entries as they are. With a converter this turns
    the JAX parameters into any rank's slice of a split model."""
    return {n: cuts[n].take(v, rank) if n in cuts else v
            for n, v in state.items()}


def whole_state_dict(parts: List[Mapping[str, Any]],
                     cuts: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`rank_state_dict`: the whole state from every
    rank's, by rank."""
    return {n: cuts[n].join([p[n] for p in parts]) if n in cuts else v
            for n, v in parts[0].items()}


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
    if "lm_head/kernel" in flat:
        # the untied head (``GPT(tie_embeddings=False)``): a flax Dense
        head = take("lm_head/kernel")
        sd["lm_head.weight"], sd["lm_head.bias"] = head.T, take(
            "lm_head/bias")
        expect.update({"lm_head.weight": (vocab, hidden),
                       "lm_head.bias": (vocab,)})
    if flat:
        raise ValueError(
            f"{who}: leaves with no place in the port's GPT: "
            f"{sorted(flat)}"
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


def bert_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``BertForSequenceClassification`` ``state_dict`` from a
    flax ``BertForSequenceClassification`` ``params`` tree of numpy arrays:
    the embeddings (``seg_emb`` when the tree has it, i.e. when ``init``
    saw ``token_type_ids``; build the port's module with
    ``token_types=True`` then), ``ln_emb``, the blocks, the pooler and the
    classifier. Raises as :func:`gpt_state_dict_from_jax`."""
    who = "bert_state_dict_from_jax"
    if "encoder" not in params:
        raise KeyError(f"{who}: missing leaf 'encoder'")
    head = _flatten({k: v for k, v in params.items() if k != "encoder"})
    flat = _flatten(params["encoder"])
    take, take_head = _taker(flat, who), _taker(head, who)
    tok = take("tok_emb/embedding")
    vocab, hidden = tok.shape
    sd: Dict[str, np.ndarray] = {
        "encoder.tok_emb.weight": tok,
        "encoder.pos_emb.weight": take("pos_emb/embedding"),
    }
    if "seg_emb/embedding" in flat:
        sd["encoder.seg_emb.weight"] = take("seg_emb/embedding")
    sd["encoder.ln_emb.weight"] = take("ln_emb/scale")
    sd["encoder.ln_emb.bias"] = take("ln_emb/bias")
    blocks, block_shapes = _transformer_blocks(flat, take, hidden, who)
    sd.update({f"encoder.{k}": v for k, v in blocks.items()})
    pooler, classifier = take_head("pooler/kernel"), take_head(
        "classifier/kernel")
    sd.update({"pooler.weight": pooler.T, "pooler.bias":
               take_head("pooler/bias"), "classifier.weight": classifier.T,
               "classifier.bias": take_head("classifier/bias")})
    if flat or head:
        raise ValueError(f"{who}: leaves with no place in the port's BERT: "
                         f"{sorted(flat) + sorted(head)}")
    max_len = sd["encoder.pos_emb.weight"].shape[0]
    classes = classifier.shape[-1]
    expect = {f"encoder.{k}": v for k, v in block_shapes.items()}
    expect.update({
        "encoder.tok_emb.weight": (vocab, hidden),
        "encoder.pos_emb.weight": (max_len, hidden),
        "encoder.ln_emb.weight": (hidden,), "encoder.ln_emb.bias": (hidden,),
        "pooler.weight": (hidden, hidden), "pooler.bias": (hidden,),
        "classifier.weight": (classes, hidden),
        "classifier.bias": (classes,),
    })
    if "encoder.seg_emb.weight" in sd:
        expect["encoder.seg_emb.weight"] = (2, hidden)
    return _finish(sd, expect, who)


def pipelined_lm_state_dict_from_jax(
        params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``PipelinedLM`` ``state_dict`` from a JAX
    ``PipelinedLM`` ``params`` tree of numpy arrays (``embed/tok``,
    ``embed/pos``, the stage-stacked ``stages/block_<i>/...`` leaves and
    ``head``). Each stacked leaf keeps its lead dim; its slices are
    converted one at a time by the blocks' map (the port's ``qkv`` layout
    a slice) and stacked again. Raises as
    :func:`gpt_state_dict_from_jax`."""
    who = "pipelined_lm_state_dict_from_jax"
    flat = _flatten(params)
    take = _taker(flat, who)
    tok = take("embed/tok")
    vocab, hidden = tok.shape
    sd: Dict[str, np.ndarray] = {"embed.tok": tok,
                                 "embed.pos": take("embed/pos"),
                                 "head": take("head")}
    expect = {"embed.tok": (vocab, hidden), "head": (hidden, vocab),
              "embed.pos": (sd["embed.pos"].shape[0], hidden)}
    stage = {k[len("stages/"):].replace("block_", "layer_", 1): flat.pop(k)
             for k in sorted(flat) if k.startswith("stages/")}
    if flat:
        raise ValueError(f"{who}: leaves with no place in the port's "
                         f"PipelinedLM: {sorted(flat)}")
    n = {a.shape[0] for a in stage.values()}
    if len(n) != 1:
        raise ValueError(f"{who}: the stage-stacked leaves' lead dims "
                         f"differ: {sorted(n)}")
    slices = []
    for i in range(n.pop()):
        part = {k: a[i] for k, a in stage.items()}
        blocks, shapes = _transformer_blocks(part, _taker(part, who),
                                             hidden, who)
        if part:
            raise ValueError(f"{who}: leaves with no place in a stage: "
                             f"{sorted(part)}")
        slices.append(blocks)
    for k in slices[0]:
        name = "stages." + k.replace("layers.", "block_", 1)
        sd[name] = np.stack([b[k] for b in slices])
        expect[name] = (len(slices), *shapes[k])
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


# --------------------------------------------------------------------------- #
# a JAX checkpoint carried over
# --------------------------------------------------------------------------- #


def _jax_leaf_names(module: nn.Module) -> Dict[str, str]:
    """The flax leaf names of one module's tensors, by the port's names:
    a kernel (``Conv``, ``Linear``), an embedding, a norm's scale, a
    BatchNorm's running statistics (in ``batch_stats``), the experts'
    stacked kernels and ViT's own ``cls_token`` and ``pos_embed``."""
    from stoke_tpu_torch.models.moe import MoEFFN
    from stoke_tpu_torch.models.pipelined_lm import PipelinedLM, _Embed
    from stoke_tpu_torch.models.resnet import BatchNorm, Conv
    from stoke_tpu_torch.models.vit import ViT

    if isinstance(module, MoEFFN):
        return {"w_in": "w_in", "w_out": "w_out"}
    if isinstance(module, PipelinedLM):
        return {"head": "head"}
    if isinstance(module, _Embed):
        return {"tok": "tok", "pos": "pos"}
    if isinstance(module, ViT):
        return {"cls_token": "cls_token", "pos_embed": "pos_embed"}
    if isinstance(module, (Conv, nn.Linear)):
        return {"weight": "kernel", "bias": "bias"}
    if isinstance(module, nn.Embedding):
        return {"weight": "embedding"}
    if isinstance(module, nn.LayerNorm):
        return {"weight": "scale", "bias": "bias"}
    if isinstance(module, BatchNorm):
        return {"weight": "scale", "bias": "bias", "running_mean": "mean",
                "running_var": "var"}
    return {}


def jax_paths(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """The inverse map of the weight converters: each entry of
    ``model.state_dict()`` by the path of its JAX leaf, ``(collection,
    *keys)``, with collection ``params`` or ``batch_stats`` (the port's
    ``layers.<i>`` is flax's ``layer_<i>``). Raises ``ValueError`` for an
    entry with no JAX leaf."""
    out: Dict[str, Tuple[str, ...]] = {}
    for mname, module in model.named_modules():
        leaves = _jax_leaf_names(module)
        keys = [k for k in re.sub(r"(^|\.)layers\.(\d+)", r"\1layer_\2",
                                  mname).split(".") if k]
        tensors = {**dict(module.named_parameters(recurse=False)),
                   **dict(module.named_buffers(recurse=False))}
        for tname in tensors:
            if tname not in leaves:
                continue
            coll = "batch_stats" if tname.startswith("running_") else "params"
            full = f"{mname}.{tname}" if mname else tname
            out[full] = (coll, *keys, leaves[tname])
    missing = sorted(set(model.state_dict()) - set(out))
    if missing:
        raise ValueError(f"jax_paths: no JAX leaf for {missing}")
    return out


def jax_param_layout(model: nn.Module) -> Dict[
        str, Tuple[Tuple[str, ...], Optional[Tuple[int, ...]], tuple]]:
    """Each parameter of ``model`` as the JAX package holds it: ``(path in
    the params tree, permutation, JAX shape)``. The permutation takes the
    port's tensor to the JAX layout (None where they agree): a ``Linear``
    weight is transposed to the flax ``Dense`` kernel ``[in, out]``, a
    ``Conv`` weight ``[out, in, kh, kw]`` becomes ``[kh, kw, in, out]``.
    The JAX shape is the permuted one, but for an attention block's fused
    ``qkv`` (a flax ``DenseGeneral((3, heads, D))``: kernel ``[hidden, 3,
    heads, D]``, bias ``[3, heads, D]``), whose flat order is the
    transposed weight's (under a Megatron split, this rank's heads:
    ``[hidden, 3, heads / T, D]``). A ``PipelinedLM``'s stage-stacked
    tensors keep their leading stage dim (the slices this rank holds)
    before a slice's layout. Sorting by path gives the JAX flatten order.
    Raises ``ValueError`` as :func:`jax_paths` for a tensor with no JAX
    leaf."""
    from stoke_tpu_torch.models.bert import MultiHeadAttention
    from stoke_tpu_torch.models.pipelined_lm import PipelinedLM
    from stoke_tpu_torch.models.resnet import Conv

    paths = jax_paths(model)
    stacked = tuple(f"{n}.stages." if n else "stages."
                    for n, m in model.named_modules()
                    if isinstance(m, PipelinedLM))
    out = {}
    for mname, module in model.named_modules():
        heads = None
        if mname.endswith("qkv") or mname == "qkv":
            parent = model.get_submodule(mname.rpartition(".")[0])
            if isinstance(parent, MultiHeadAttention):
                heads = parent.heads
        for tname, p in module.named_parameters(recurse=False):
            full = f"{mname}.{tname}" if mname else tname
            # a stacked tensor: the layout of one slice, after its lead
            lead = tuple(p.shape[:1]) if full.startswith(stacked) else ()
            sshape = tuple(p.shape[len(lead):])
            perm = None
            if tname == "weight" and isinstance(module, (Conv, nn.Linear)):
                perm = (1, 0) if len(sshape) == 2 else (2, 3, 1, 0)
            # by shape alone: fsdp's parameters may hold no storage
            shape = tuple(sshape[d] for d in perm) if perm else sshape
            if heads is not None:
                d = parent.hidden // heads
                cols = shape[1] if tname == "weight" else shape[0]
                tail = (3, cols // (3 * d), d)
                shape = (shape[0], *tail) if tname == "weight" else tail
            if lead and perm:
                perm = (0, *(i + 1 for i in perm))
            out[full] = (paths[full][1:], perm, (*lead, *shape))
    return out


def jax_params_from_port(model: nn.Module) -> dict:
    """The inverse of the converters: the JAX ``params`` tree (nested
    dicts of fp32 numpy arrays) of ``model``'s parameters as it holds
    them, each permuted and reshaped by :func:`jax_param_layout` (for a
    ``PipelinedLM``, the stage-stacked leaves whole; a consolidated tag
    loads into one)."""
    flat = {}
    for name, (path, perm, shape) in jax_param_layout(model).items():
        t = model.get_parameter(name).detach()
        t = t.permute(perm) if perm else t
        flat[path] = t.reshape(shape).float().cpu().numpy()
    return _nest(flat)


#: the optax optimizers the port pairs with a torch optimizer, by optax
#: name: the torch class, and the fields of the chain's first state in
#: flatten order (optax ``adamw``: ``ScaleByAdamState(count, mu, nu)`` then
#: two empty states; ``sgd`` with momentum: ``TraceState(trace)`` then an
#: empty state), each with the torch state key it becomes. The checkpoint
#: converter carries these states; the YAML builder builds these classes
#: (and ``adam``, whose state no converter reads yet)
OPTAX_PAIRS = {
    "adamw": (torch.optim.AdamW, (("count", "step"), ("mu", "exp_avg"),
                                  ("nu", "exp_avg_sq"))),
    "sgd": (torch.optim.SGD, (("trace", "momentum_buffer"),)),
}

#: optax's optimizer constructors (``optax._src.alias``, optax 0.2): a
#: name outside it is one optax does not have
OPTAX_OPTIMIZERS = (
    "adabelief", "adadelta", "adafactor", "adagrad", "adam", "adamax",
    "adamaxw", "adamw", "adan", "amsgrad", "fromage", "lamb", "lars",
    "lbfgs", "lion", "noisy_sgd", "novograd", "optimistic_adam",
    "optimistic_adam_v2", "optimistic_gradient_descent", "polyak_sgd",
    "radam", "rmsprop", "rprop", "sgd", "sign_sgd", "sm3", "yogi",
)

#: optax's keyword arguments and defaults of the constructors the port
#: builds (optax 0.2.6)
_OPTAX_DEFAULTS = {
    "adamw": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
                  weight_decay=1e-4, mask=None, nesterov=False),
    "adam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None,
                 nesterov=False),
    "sgd": dict(momentum=None, nesterov=False, accumulator_dtype=None),
}
#: the torch class of each: the checkpoint pairs, and Adam
_OPTAX_TORCH = {**{n: c for n, (c, _) in OPTAX_PAIRS.items()},
                "adam": torch.optim.Adam}
#: optax arguments that have no torch counterpart unless at their default
_OPTAX_ONLY = ("eps_root", "mu_dtype", "mask", "accumulator_dtype")


def torch_optimizer_from_optax(name: str, kwargs: Mapping[str, Any]):
    """``(torch optimizer class, its keyword arguments)`` that compute
    what ``optax.<name>(**kwargs)`` computes, with optax's defaults where
    ``kwargs`` is silent (optax's ``adamw`` decays weights by 1e-4, where
    torch's ``AdamW`` would take 1e-2):

    - ``adamw`` -> ``AdamW(lr=learning_rate, betas=(b1, b2), eps=eps,
      weight_decay=weight_decay)``, ``adam`` -> ``Adam`` likewise;
    - ``sgd`` -> ``SGD(lr=learning_rate, momentum=momentum or 0,
      nesterov=nesterov)`` (optax ignores ``nesterov`` without momentum).

    Raises ``ValueError`` for a name optax does not have, one the port
    does not build, a missing ``learning_rate``, an argument optax's
    constructor does not take, and one that torch has no counterpart for
    (``eps_root``, ``mu_dtype``, ``mask``, ``accumulator_dtype`` away from
    their defaults, Adam's ``nesterov``)."""
    if name not in OPTAX_OPTIMIZERS:
        raise ValueError(f"Stoke -- optax has no optimizer named {name!r}")
    if name not in _OPTAX_DEFAULTS:
        raise ValueError(
            f"Stoke -- optax.{name} has no torch.optim counterpart in the "
            f"port; supported: {sorted(_OPTAX_DEFAULTS)}"
        )
    cls, defaults = _OPTAX_TORCH[name], _OPTAX_DEFAULTS[name]
    kw = dict(kwargs)
    if "learning_rate" not in kw:
        raise ValueError(f"Stoke -- optax.{name} needs learning_rate")
    lr = kw.pop("learning_rate")
    unknown = sorted(set(kw) - set(defaults))
    if unknown:
        raise ValueError(
            f"Stoke -- optax.{name} takes no argument(s) {unknown}; valid: "
            f"{['learning_rate', *defaults]}"
        )
    args = {**defaults, **kw}
    for key in _OPTAX_ONLY:
        if key in args and args[key] != defaults[key]:
            raise ValueError(
                f"Stoke -- optax.{name}({key}={args[key]!r}) has no "
                f"{cls.__name__} counterpart in the port"
            )
    if name == "sgd":
        momentum = args["momentum"] or 0.0
        return cls, dict(lr=lr, momentum=momentum,
                         nesterov=bool(args["nesterov"]) and momentum > 0)
    if args["nesterov"]:
        raise ValueError(f"Stoke -- optax.{name}(nesterov=True) has no "
                         f"{cls.__name__} counterpart in the port")
    out = dict(lr=lr, betas=(args["b1"], args["b2"]), eps=args["eps"])
    if name == "adamw":
        out["weight_decay"] = args["weight_decay"]
    return cls, out


def _optax_fields(optimizer: torch.optim.Optimizer):
    """``(optax label, ((field, torch key), ...))`` for ``optimizer``, or
    ``ValueError`` naming what it got."""
    kind = type(optimizer)
    pair = next(((n, f) for n, (c, f) in OPTAX_PAIRS.items() if c is kind),
                None)
    if pair is None:
        raise ValueError(
            f"jax_checkpoint_to_port: {kind.__name__} has no optax "
            f"counterpart here; torch.optim.AdamW (optax.adamw) and "
            f"torch.optim.SGD with momentum (optax.sgd) are carried over"
        )
    for group in optimizer.param_groups:
        if kind is torch.optim.SGD and not group.get("momentum"):
            raise ValueError(
                "jax_checkpoint_to_port: torch.optim.SGD without momentum "
                "keeps no state; optax.sgd with momentum is carried over")
        if group.get("amsgrad") or group.get("nesterov"):
            raise ValueError(
                f"jax_checkpoint_to_port: {kind.__name__} with amsgrad or "
                f"nesterov has no counterpart in optax.adamw / optax.sgd "
                f"as the JAX package builds them")
    name, fields = pair
    label = f"optax.{name}" + (" with momentum" if name == "sgd" else "")
    return label, fields


def jax_flatten_order(model: nn.Module, key: str,
                      optimizer: torch.optim.Optimizer = None
                      ) -> List[Tuple[str, ...]]:
    """The JAX key paths of the leaves of a JAX tag's ``key``.npz, in
    ``jax.tree_util`` flatten order (dict keys sorted at every level; a
    state tuple's fields in their own order): ``variables`` by
    ``(collection, *keys)``, ``grad_buf`` by the params' keys, and
    ``opt_state`` by ``(field, *keys)`` (``("count",)`` alone)."""
    paths = sorted(jax_paths(model).values())
    params = [p[1:] for p in paths if p[0] == "params"]
    if key == "variables":
        return paths
    if key == "grad_buf":
        return params
    if key == "opt_state":
        _, fields = _optax_fields(optimizer)
        out: List[Tuple[str, ...]] = []
        for field, _ in fields:
            out += [(field,)] if field == "count" else [(field, *p)
                                                        for p in params]
        return out
    raise ValueError(f"jax_flatten_order: unknown state key {key!r}")


def _nest(flat: Dict[Tuple[str, ...], np.ndarray]) -> dict:
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a
    return tree


def _read_leaves(tag_dir: str, key: str) -> List[np.ndarray]:
    with np.load(os.path.join(tag_dir, f"{key}.npz")) as data:
        n = len(data.files)
        if sorted(data.files) != sorted(f"leaf_{i}" for i in range(n)):
            raise ValueError(
                f"jax_checkpoint_to_port: {key}.npz of {tag_dir} is not the "
                f"JAX package's (its arrays are not leaf_0..leaf_{n - 1})")
        return [data[f"leaf_{i}"] for i in range(n)]


def jax_checkpoint_to_port(jax_tag_dir: str, out_path: str, model: nn.Module,
                           optimizer: Any) -> str:
    """Write a port tag that ``Stoke.load`` resumes from a tag that the
    JAX package's ``Stoke.save`` wrote (consolidated).

    ``model`` is the port's module of the same architecture (a ``GPT``,
    ``BasicNN`` or ``ResNet``) and ``optimizer`` the run's
    optimizer over its parameters (a ``torch.optim.Optimizer``, or a
    ``StokeOptimizer`` to build one): ``torch.optim.AdamW`` takes
    ``optax.adamw``'s state (``count`` -> ``step``, ``mu`` -> ``exp_avg``,
    ``nu`` -> ``exp_avg_sq``), ``torch.optim.SGD`` with momentum
    ``optax.sgd``'s (``trace`` -> ``momentum_buffer``); any other raises.
    The weights go through :func:`gpt_state_dict_from_jax` or
    :func:`cnn_state_dict_from_jax`,
    and so do the optimizer's moments and the accumulated gradients
    (``grad_buf``, when the tag was saved mid-window); the scaler state,
    ``meta.json`` and ``extras.pkl`` are carried as they are, the param
    groups come from ``optimizer``. The JAX ``.npz`` names its leaves only
    by flatten order: :func:`jax_flatten_order` rebuilds their paths, and
    each count of leaves is checked. Returns the port tag's directory
    (``out_path`` joined with the JAX tag's name)."""
    from stoke_tpu_torch.engine import build_optimizer
    from stoke_tpu_torch.io_ops import PORT_FILE, STATE_KEYS
    from stoke_tpu_torch.models.basic import BasicNN
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.models.resnet import ResNet

    if not isinstance(model, (GPT, BasicNN, ResNet)):
        raise TypeError(
            f"jax_checkpoint_to_port: carries GPT, BasicNN and ResNet "
            f"checkpoints; got {type(model).__name__}")
    if not isinstance(optimizer, torch.optim.Optimizer):
        optimizer = build_optimizer(optimizer, model.parameters())
    optax_name, fields = _optax_fields(optimizer)
    who = "jax_checkpoint_to_port"
    with open(os.path.join(jax_tag_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != "consolidated" or meta.get("staged"):
        raise ValueError(f"{who}: {jax_tag_dir} is not a consolidated tag")

    def leaves_by_path(key):
        leaves = _read_leaves(jax_tag_dir, key)
        order = jax_flatten_order(model, key, optimizer)
        if len(leaves) != len(order):
            raise ValueError(
                f"{who}: {key}.npz holds {len(leaves)} leaves; "
                f"{type(model).__name__} with {optax_name} needs "
                f"{len(order)}")
        return dict(zip(order, leaves))

    variables = _nest(leaves_by_path("variables"))
    names = [n for n, _ in model.named_parameters()]

    def to_port(params: dict) -> Dict[str, torch.Tensor]:
        """A params-shaped tree (weights, moments or gradients) by the
        port's parameter names."""
        if isinstance(model, GPT):
            sd = gpt_state_dict_from_jax(params)
        else:
            sd = cnn_state_dict_from_jax(
                {"params": params, **({"batch_stats": variables["batch_stats"]}
                                      if "batch_stats" in variables else {})})
        return {n: sd[n] for n in names}

    if isinstance(model, GPT):
        weights = gpt_state_dict_from_jax(variables["params"])
    else:
        weights = cnn_state_dict_from_jax(variables)
    state: Dict[str, Dict[str, np.ndarray]] = {
        "variables": {n: t.numpy() for n, t in weights.items()}}

    opt = leaves_by_path("opt_state")
    opt_state: Dict[str, np.ndarray] = {}
    for field, tkey in fields:
        if field == "count":
            count = np.asarray(opt[("count",)], np.float32)
            opt_state.update({f"{n}/{tkey}": count for n in names})
            continue
        tree = _nest({p[1:]: a for p, a in opt.items() if p[0] == field})
        opt_state.update({f"{n}/{tkey}": t.numpy()
                          for n, t in to_port(tree).items()})
    state["opt_state"] = opt_state

    scaler = _read_leaves(jax_tag_dir, "scaler_state")
    keys = {2: ("growth_count", "scale"),
            3: ("finite", "growth_count", "scale")}.get(len(scaler))
    if keys is None:
        raise ValueError(f"{who}: scaler_state.npz holds {len(scaler)} "
                         f"leaves; the JAX scaler has 2 (3 per loss)")
    state["scaler_state"] = dict(zip(keys, scaler))
    if os.path.exists(os.path.join(jax_tag_dir, "grad_buf.npz")):
        grads = _nest(leaves_by_path("grad_buf"))
        state["grad_buf"] = {n: t.numpy() for n, t in to_port(grads).items()}

    tag_dir = os.path.join(os.path.abspath(out_path),
                           os.path.basename(os.path.normpath(jax_tag_dir)))
    os.makedirs(tag_dir, exist_ok=True)
    for key in STATE_KEYS:
        if key in state:
            np.savez(os.path.join(tag_dir, f"{key}.npz"), **state[key])
    index = {p: n for n, p in model.named_parameters()}
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": [index[p] for p in g["params"]]}
              for g in optimizer.param_groups]
    with open(os.path.join(tag_dir, PORT_FILE), "wb") as f:
        pickle.dump({"param_groups": groups, "opt_values": {}}, f)
    # extras before meta.json, the tag's "loadable" marker
    extras = os.path.join(jax_tag_dir, "extras.pkl")
    if os.path.exists(extras):
        shutil.copyfile(extras, os.path.join(tag_dir, "extras.pkl"))
    shutil.copyfile(os.path.join(jax_tag_dir, "meta.json"),
                    os.path.join(tag_dir, "meta.json"))
    return tag_dir
