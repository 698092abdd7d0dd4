"""One rank of a tensor- and expert-parallel world of the port, for
``tests/test_torch_tensor_parallel.py``.

Spawned 4 times by the test; each process joins a gloo group through a
file store, runs the scenarios below in the same order as the others, and
writes what it saw to ``{out_dir}/rank{r}.pt`` (a traceback instead when a
scenario raised). It imports torch and the port only: no JAX.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

#: the (data, model) and (data, expert) mesh shape over the world of 4
SHAPE = (2, 2)
SGD_LR, STEPS = 0.05, 3
AUX_WEIGHT, CLIP = 0.01, 0.5


def _stoke(model, loss, axes, rules, batch, **kw):
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import MeshConfig, PartitionRulesConfig

    return Stoke(model, StokeOptimizer(torch.optim.SGD, lr=SGD_LR), loss,
                 batch_size_per_device=batch, device="cpu",
                 distributed="dp",
                 configs=[MeshConfig(axes=axes, shape=SHAPE),
                          PartitionRulesConfig(rules=rules)], **kw)


def _whole(s) -> dict:
    """The model's whole state dict (the slices gathered), as numpy."""
    tp = s.tensor_parallel
    return {n: tp.gather(n, t).detach().numpy().copy()
            for n, t in s.model_access.state_dict().items()}


def _rows(s, b: np.ndarray) -> torch.Tensor:
    """This process's rows of the global batch ``b``: its data
    coordinate's."""
    d = s.mesh.get_local_rank("data")
    n = b.shape[0] // SHAPE[0]
    return torch.from_numpy(b[d * n:(d + 1) * n])


def _replicated_grads_equal(s) -> dict:
    """After a backward (no step): for each parameter the split leaves
    whole, whether its gradient is the same bit for bit on every rank of
    the model group; and whether some split leaf's differs (it should)."""
    tp = s.tensor_parallel
    group = tp.group.group
    out = {}
    for n, p in s.model_access.named_parameters():
        g = (p.grad if p.grad is not None
             else torch.zeros_like(p)).contiguous()
        parts = [torch.empty_like(g) for _ in range(tp.size)]
        dist.all_gather(parts, g, group=group)
        out[n] = (n in tp.cuts, all(torch.equal(parts[0], q)
                                    for q in parts[1:]))
    return out


def gpt(inputs, rank, world) -> dict:
    """GPT-tiny under ``gpt_tensor_parallel_rules`` at (data 2, model 2):
    STEPS SGD steps on the global batch (each process its data
    coordinate's rows), the whole weights after each; the gradients of
    one more backward; a consolidated save, loaded back into a fresh
    split run."""
    from stoke_tpu_torch.models import (
        GPT,
        causal_lm_loss,
        gpt_tensor_parallel_rules,
    )

    g = inputs["gpt"]
    model = GPT(vocab_size=g["vocab"], size_name="tiny", max_len=g["len"],
                dropout_rate=0.0)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in g["weights"].items()})
    B = g["batches"][0].shape[0] // SHAPE[0]
    s = _stoke(model, causal_lm_loss, ("data", "model"),
               gpt_tensor_parallel_rules(), B)
    tp = s.tensor_parallel
    shapes = {n: tuple(p.shape) for n, p in
              s.model_access.named_parameters() if n in tp.cuts}
    losses, weights = [], []
    for b in g["batches"][:STEPS]:
        x = _rows(s, b)
        losses.append(float(s.train_step(x, x)))
        weights.append(_whole(s))
    x = _rows(s, g["batches"][STEPS])
    s.backward(s.loss(s.model(x), x))
    invariant = _replicated_grads_equal(s)
    s.step()
    # the split made whole again (collective), against the split's logits
    whole = tp.whole_copy(s.model_access)
    with torch.no_grad():
        s.eval()
        whole_copy = {"split": s.model(x).numpy(),
                      "whole": whole.eval()(x).numpy(),
                      "heads": whole.layers[0].attention.local_heads}
        s.train()
    tag = s.save(os.path.join(inputs["out_dir"], "tp_ckpt"))
    saved = _whole(s)
    local = {n: t.detach().clone()
             for n, t in s.model_access.state_dict().items()}
    # a fresh split run of other weights loads the tag and holds the
    # same slices bit for bit
    other = GPT(vocab_size=g["vocab"], size_name="tiny", max_len=g["len"],
                dropout_rate=0.0)
    other.init_weights(7)
    s2 = _stoke(other, causal_lm_loss, ("data", "model"),
                gpt_tensor_parallel_rules(), B)
    s2.load(os.path.dirname(tag))
    reloaded = all(torch.equal(local[n], t) for n, t in
                   s2.model_access.state_dict().items())
    # a sampler of the world's defaults reads by the data coordinate
    from stoke_tpu_torch import ArrayDataset
    from stoke_tpu_torch.data import BucketedDistributedSampler

    ds = ArrayDataset(np.zeros((512, 4), np.int64))
    loader = s.DataLoader(ds, sampler=BucketedDistributedSampler(
        ds, buckets=1, batch_size=B, sorted_idx=range(512), info_rank=-1))
    sampler = (loader.sampler.num_replicas, loader.sampler.rank)
    out = {"losses": losses, "weights": weights, "shapes": shapes,
           "sampler": sampler,
           "invariant": invariant, "tag": tag, "saved": saved,
           "whole_copy": whole_copy,
           "reloaded": reloaded, "counts": s.num_model_parameters(),
           "overrides": len(s.sharding_rules.overrides),
           "data_rank": s.mesh.get_local_rank("data"),
           "model_rank": s.mesh.get_local_rank("model")}
    for t in (s, s2):
        t.close_telemetry()
    return out


def bert(inputs, rank, world) -> dict:
    """BERT-tiny under ``bert_tensor_parallel_rules`` at (data 2, model
    2): STEPS SGD steps, the whole weights after each."""
    import torch.nn.functional as F

    from stoke_tpu_torch.models import (
        BertForSequenceClassification,
        bert_tensor_parallel_rules,
    )

    b = inputs["bert"]
    model = BertForSequenceClassification(
        vocab_size=b["vocab"], num_classes=2, size_name="tiny",
        max_len=b["len"], dropout_rate=0.0)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in b["weights"].items()})
    B = b["ids"][0].shape[0] // SHAPE[0]
    s = _stoke(model, lambda logits, y: F.cross_entropy(logits, y),
               ("data", "model"), bert_tensor_parallel_rules(), B)
    losses, weights = [], []
    for ids, mask, y in zip(b["ids"], b["mask"], b["y"]):
        losses.append(float(s.train_step(
            (_rows(s, ids), _rows(s, mask)), _rows(s, y))))
        weights.append(_whole(s))
    s.close_telemetry()
    return {"losses": losses, "weights": weights}


def moe(inputs, rank, world) -> dict:
    """GPT-tiny-MoE under ``moe_expert_parallel_rules`` at (data 2,
    expert 2), ``aux_loss_weight`` AUX_WEIGHT and a norm clip: STEPS SGD
    steps, the whole weights and the aux losses after each; the gradients
    of one more backward."""
    from stoke_tpu_torch.configs import ClipGradNormConfig
    from stoke_tpu_torch.models import (
        GPT,
        causal_lm_loss,
        moe_expert_parallel_rules,
    )

    g = inputs["moe"]
    model = GPT(vocab_size=g["vocab"], size_name="tiny", max_len=g["len"],
                dropout_rate=0.0, moe_num_experts=g["experts"],
                moe_capacity_factor=g["capacity"], moe_top_k=g["top_k"])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in g["weights"].items()})
    B = g["batches"][0].shape[0] // SHAPE[0]
    s = _stoke(model, causal_lm_loss, ("data", "expert"),
               moe_expert_parallel_rules(), B, aux_loss_weight=AUX_WEIGHT,
               grad_clip=ClipGradNormConfig(max_norm=CLIP))
    losses, weights, aux = [], [], []
    for b in g["batches"][:STEPS]:
        x = _rows(s, b)
        losses.append(float(s.train_step(x, x)))
        weights.append(_whole(s))
        aux.append(float(s.aux_losses["layer_1"]["moe"]["aux_loss"]))
    x = _rows(s, g["batches"][STEPS])
    s.backward(s.loss(s.model(x), x))
    invariant = _replicated_grads_equal(s)
    s.close_telemetry()
    return {"losses": losses, "weights": weights, "aux": aux,
            "invariant": invariant,
            "local_experts": s.model_access.layers[1].moe.local_experts}


SCENARIOS = (gpt, bert, moe)


def run(rank: int, world: int, store: str, out_dir: str,
        inputs: str) -> None:
    """The entry point of one spawned rank (the port's explicit rendezvous
    at the file store); ``inputs`` is the file the test saved them to: a
    payload larger than a pipe's buffer would hold each ``Process.start``
    until that child had started up."""
    from stoke_tpu_torch.configs import DistributedInitConfig
    from stoke_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    out = {}
    try:
        inputs = torch.load(inputs, weights_only=False)
        initialize_distributed(DistributedInitConfig(
            coordinator_address=f"file://{store}", num_processes=world,
            process_id=rank), torch.device("cpu"))
        for scenario in SCENARIOS:
            out[scenario.__name__] = scenario({**inputs, "out_dir": out_dir},
                                              rank, world)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    if "error" in out:
        raise SystemExit(1)
