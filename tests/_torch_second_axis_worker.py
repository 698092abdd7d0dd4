"""One rank of a world of the port on two-axis meshes, for
``tests/test_torch_second_axis.py``.

Spawned 4 times by the test; each process joins a gloo group through a
file store, runs the scenarios below in the same order as the others, and
writes what it saw to ``{out_dir}/rank{r}.pt`` (a traceback instead when a
scenario raised). Every mesh is (2, 2): the data axis and one of ``seq``,
``model``, ``expert`` or ``stage``. It imports torch and the port only: no
JAX.
"""

from __future__ import annotations

import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

SHAPE = (2, 2)
LR, MOMENTUM, STEPS = 0.05, 0.9, 2
AUX_WEIGHT, CLIP = 0.01, 0.5
TIERS = {"oss": dict(oss=True), "sddp": dict(oss=True, sddp=True),
         "fsdp": dict(fsdp=True)}
#: run -> (the model's inputs key, the second axis)
RUNS = {"gpt_seq": ("gpt", "seq"), "gpt_model": ("gpt", "model"),
        "bert_model": ("bert", "model"), "moe_expert": ("moe", "expert"),
        "lm_stage": ("lm", "stage")}
#: the transports' cases: CommConfig fields
TRANSPORTS = {f"{d}_{s}": dict(dtype=d, strategy=s)
              for d in ("int8", "bf16") for s in ("all_reduce", "rs_ag")}
COMM = dict(bucket_mb=0.25, chunk_elems=128)
#: the sharded format's runs, one a second axis
FORMAT_RUNS = ("gpt_seq", "gpt_model", "moe_expert", "lm_stage")


def _model(name: str, inputs, one_axis: bool = False):
    """The run's model with the inputs' weights (``one_axis``: for a 1-D
    data mesh, GPT with flash attention in place of the ring)."""
    from stoke_tpu_torch.models import GPT, BertForSequenceClassification
    from stoke_tpu_torch.models.pipelined_lm import PipelinedLM
    from stoke_tpu_torch.ops.attention import make_ring_attention

    kind, axis = RUNS[name]
    g = inputs[kind]
    if kind == "bert":
        m = BertForSequenceClassification(
            vocab_size=g["vocab"], num_classes=2, size_name="tiny",
            max_len=g["len"], dropout_rate=0.0)
    elif kind == "lm":
        m = PipelinedLM(vocab_size=g["vocab"], size_name="tiny",
                        max_len=g["len"], num_microbatches=2,
                        layers_per_stage=1, stages=SHAPE[1])
    else:
        kw = (dict(moe_num_experts=g["experts"],
                   moe_capacity_factor=g["capacity"],
                   moe_top_k=g["top_k"]) if kind == "moe" else {})
        if axis == "seq" and not one_axis:
            kw.update(attention_fn=make_ring_attention(causal=True),
                      attention_is_causal=True)
        m = GPT(vocab_size=g["vocab"], size_name="tiny", max_len=g["len"],
                dropout_rate=0.0, **kw)
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in g["weights"].items()})
    return m


def _stoke(name: str, inputs, tier: dict, extra=(), one_axis=False):
    """The run's ``Stoke`` on its (2, 2) mesh with its rules, or with
    ``one_axis`` on the 1-D data mesh of the world without rules."""
    import torch.nn.functional as F

    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch import configs as pc
    from stoke_tpu_torch.models import (
        bert_tensor_parallel_rules,
        causal_lm_loss,
        gpt_tensor_parallel_rules,
        moe_expert_parallel_rules,
        pipeline_parallel_rules,
    )

    kind, axis = RUNS[name]
    cfgs = [pc.MeshConfig(axes=("data", axis), shape=SHAPE),
            pc.OSSConfig(min_shard_size=1), pc.SDDPConfig(min_shard_size=1),
            pc.FSDPConfig(min_weight_size=1), *extra]
    rules = {"gpt_model": gpt_tensor_parallel_rules,
             "bert_model": bert_tensor_parallel_rules,
             "moe_expert": moe_expert_parallel_rules,
             "lm_stage": pipeline_parallel_rules}.get(name)
    if one_axis:
        cfgs[0], rules = pc.MeshConfig(), None
    if rules is not None:
        cfgs.append(pc.PartitionRulesConfig(rules=rules()))
    if axis == "seq" and not one_axis:
        cfgs.append(pc.DataParallelConfig(shard_seq_dim=1))
    kw = dict(tier)
    if kind == "moe":
        kw.update(aux_loss_weight=AUX_WEIGHT,
                  grad_clip=pc.ClipGradNormConfig(max_norm=CLIP))
    loss = ((lambda logits, y: F.cross_entropy(logits, y))
            if kind == "bert" else causal_lm_loss)
    batch = inputs[kind]["batch"] // SHAPE[0]
    return Stoke(_model(name, inputs, one_axis),
                 StokeOptimizer(torch.optim.SGD, lr=LR, momentum=MOMENTUM),
                 loss, batch_size_per_device=batch, device="cpu",
                 distributed="dp", configs=cfgs, **kw)


def _rows(s, a: np.ndarray) -> torch.Tensor:
    """This process's rows of a global batch: its data coordinate's."""
    d = s.mesh.get_local_rank("data")
    n = a.shape[0] // SHAPE[0]
    return torch.from_numpy(a[d * n:(d + 1) * n])


def _args(s, name: str, inputs, step: int):
    """``(model args, loss args)`` of step ``step``, this process's
    rows."""
    kind = RUNS[name][0]
    g = inputs[kind]
    if kind == "bert":
        return ((_rows(s, g["ids"][step]), _rows(s, g["mask"][step])),
                _rows(s, g["y"][step]))
    x = _rows(s, g["batches"][step])
    return x, x


def _whole(s) -> dict:
    """The model's whole state dict (fsdp's slices and the split's
    gathered), as numpy."""
    tp = s.tensor_parallel
    with s._whole_params():
        sd = s.model_access.state_dict()
        # a clone: numpy's view of a tensor pins its storage, which fsdp
        # frees after the block
        return {n: (tp.gather(n, t) if tp is not None else t)
                .detach().clone().numpy() for n, t in sd.items()}


def _placement(s) -> dict:
    """What this rank holds of each parameter, by name: the dim the
    optimizer's slice is cut along (None: stepped whole), the sharded
    accumulator's dim, the values it steps on (the slice, or the
    parameter: a model split's slice), and whether fsdp freed it."""
    ladder = s._ladder
    names = {p: n for n, p in s.model_access.named_parameters()}
    out = {}
    for i, p in enumerate(ladder.params):
        o = ladder.opt_params[i]
        freed = p.untyped_storage().nbytes() == 0
        out[names[p]] = {"dim": ladder.sliced_dim(i),
                         "acc_dim": ladder.accumulator_dim(i),
                         "held": o.detach().clone().numpy(),
                         "freed": freed}
    return out


def tiers(inputs, rank, world) -> dict:
    """Each run under oss, sddp and fsdp: what each rank holds at the
    start, the losses and whole weights after each of STEPS SGD steps,
    and the shapes of the momentum the optimizer keeps."""
    out = {}
    for name in RUNS:
        for tier, flags in TIERS.items():
            s = _stoke(name, inputs, flags)
            placed = _placement(s)
            losses, weights = [], []
            for step in range(STEPS):
                margs, largs = _args(s, name, inputs, step)
                losses.append(float(s.train_step(margs, largs)))
                weights.append(_whole(s))
            names = {p: n for n, p in s.model_access.named_parameters()}
            state = {names[p]: tuple(s.optimizer.state[o]["momentum_buffer"]
                                     .shape)
                     for p, o in zip(s._ladder.params, s._ladder.opt_params)}
            out[(name, tier)] = {
                "placement": placed, "losses": losses, "weights": weights,
                "momentum": state,
                "coords": (s.mesh.get_local_rank("data"),
                           s.mesh.get_local_rank(RUNS[name][1]))}
            s.close_telemetry()
    return out


def transports(inputs, rank, world) -> dict:
    """The replicated transport of each case in TRANSPORTS on GPT-tiny
    under the Megatron rules on the model mesh and under the sequence
    shard on the seq mesh: the global JAX-layout leaves of the inputs
    (each rank handed its slices) through two steps of the engine's
    transport; each step's output leaves, gathered whole, and the
    residual; the accounting."""
    from stoke_tpu_torch import configs as pc

    out = {}
    for name in ("gpt_model", "gpt_seq"):
        for case, fields in TRANSPORTS.items():
            s = _stoke(name, inputs, {},
                       (pc.CommConfig(**fields, **COMM),))
            eng = s._engine
            order = eng.comm_order
            steps = []
            for leaves in inputs["transport"]["grads"]:
                grads = [torch.empty_like(p) for p in eng.params]
                order.from_jax([torch.from_numpy(a) for a in leaves], grads)
                eng._transport_grads(grads)
                steps.append({
                    "out": [t.detach().numpy().copy()
                            for t in order.to_jax(grads)],
                    "residual": [r.numpy().copy() for r in
                                 eng.comm_state.get("residual", [])]})
            out[(name, case)] = {
                "steps": steps, "bytes": s.comm_bytes,
                "sizes": order.sizes(),
                "descriptor": s._comm_layout(),
                "data_rank": s.mesh.get_local_rank("data")}
            s.close_telemetry()
    return out


def formats(inputs, rank, world) -> dict:
    """Each of FORMAT_RUNS under fsdp with an int8 transport and a
    ``ResilienceConfig``: one step, then an emergency save in the
    sharded format (its extras carry the residual and the key) and a
    consolidated save of the same state; a fresh run resumes the sharded
    tag, and both take one more step: the losses and whole weights of
    each, and the tags. Then the whole weights of the sharded tag loaded
    under a 1-D data mesh of the world, and of the consolidated tag
    loaded under the run's mesh."""
    from stoke_tpu_torch import configs as pc

    out = {}
    for name in FORMAT_RUNS:
        root = os.path.join(inputs["out_dir"], f"fmt_{name}")
        extra = (pc.CommConfig(dtype="int8", **COMM),
                 pc.CheckpointConfig(format=pc.CheckpointFormat.sharded),
                 pc.ResilienceConfig(save_path=os.path.join(root, "emg"),
                                     exit_on_preempt=False))
        s = _stoke(name, inputs, TIERS["fsdp"], extra)
        margs, largs = _args(s, name, inputs, 0)
        s.train_step(margs, largs)
        tag = s._emergency_save()
        cons = s._save_with_config(os.path.join(root, "cons"), "stoke",
                                   pc.CheckpointConfig(), None)
        fresh = _stoke(name, inputs, TIERS["fsdp"], extra)
        resumed = fresh.resume()
        margs, largs = _args(s, name, inputs, 1)
        runs = []
        for t in (s, fresh):
            runs.append({"loss": float(t.train_step(margs, largs)),
                         "weights": _whole(t),
                         "residual": [r.numpy().copy() for r in
                                      t._engine.comm_state["residual"]]})
        with open(os.path.join(tag, "meta.json")) as f:
            meta = json.load(f)
        loaded = {}
        for kind, path, kw in (("one_axis", tag, dict(one_axis=True)),
                               ("cons", cons, {})):
            t = _stoke(name, inputs, TIERS["fsdp"], **kw)
            t.load(os.path.dirname(path), tag=os.path.basename(path))
            loaded[kind] = _whole(t)
            t.close_telemetry()
        out[name] = {"tag": tag, "cons": cons, "resumed": resumed,
                     "runs": runs, "meta": meta, "loaded": loaded,
                     "files": sorted(os.listdir(tag))}
        for t in (s, fresh):
            t.close_telemetry()
    return out


def chunked(inputs, rank, world) -> dict:
    """GPT's chunked head under a sequence shard: over the seq groups of
    the (2, 2) mesh (S = 2) and over the world (S = 4), this shard's loss
    and its gradients of its hidden states and of the embedding, with and
    without the padding mask."""
    from torch.distributed.device_mesh import init_device_mesh

    from stoke_tpu_torch.ops.attention import SeqShard, using_seq_shard
    from stoke_tpu_torch.ops.chunked_ce import chunked_causal_lm_loss

    c = inputs["chunked"]
    mesh = init_device_mesh("cpu", SHAPE, mesh_dim_names=("data", "seq"))
    seq = mesh.get_group("seq")
    shards = {2: SeqShard(seq, dist.get_rank(seq), 2),
              4: SeqShard(dist.group.WORLD, rank, world)}
    out = {}
    for S, shard in shards.items():
        for masked in (False, True):
            Ls = c["hidden"].shape[1] // S
            sl = slice(shard.rank * Ls, (shard.rank + 1) * Ls)
            h = torch.from_numpy(c["hidden"][:, sl].copy()).requires_grad_()
            e = torch.from_numpy(c["emb"]).requires_grad_()
            ids = torch.from_numpy(c["ids"][:, sl].copy())
            m = (torch.from_numpy(c["mask"][:, sl].copy()) if masked
                 else None)
            with using_seq_shard(shard):
                loss = chunked_causal_lm_loss((h, e), ids, m, chunk=c["chunk"])
            loss.backward()
            out[(S, masked)] = {"loss": float(loss), "rows": (sl.start,
                                                              sl.stop),
                                "dh": h.grad.numpy(), "de": e.grad.numpy()}
    return out


def audit(inputs, rank, world) -> dict:
    """The program auditor where a group is larger than 1: GPT-tiny under
    the Megatron rules on the (data, model) mesh, one ``train_step`` and
    one window; the audit as built (clean), at a byte threshold of 0
    (every parameter the split leaves whole fires
    ``audit-replicated-bytes``), and with no exchange accounting the
    ladder's and the split's collectives (``audit-comm-bytes``). The
    dispatch and launch counts across the audits."""
    from stoke_tpu_torch.analysis.program import audit_program_specs
    from stoke_tpu_torch.ops.flash_attention import LAUNCHES

    s = _stoke("gpt_model", inputs, {})
    x, y = _args(s, "gpt_model", inputs, 0)
    s.train_step(x, y)
    s.train_step_window(x[None], y[None])
    before = (s.dispatch_count, dict(LAUNCHES))
    clean = s.audit()
    low = s.audit(replicated_bytes_threshold=0)
    unaccounted = audit_program_specs(s._engine.audit_specs(),
                                      exchange_active=False)
    out = {"clean": [f.to_dict() for f in clean.findings],
           "programs": clean.programs,
           "replicated": [f.to_dict() for f in low.findings],
           "comm": [f.to_dict() for f in unaccounted.findings],
           "cut": sorted(s.tensor_parallel.cuts),
           "counts_equal": before == (s.dispatch_count, dict(LAUNCHES))}
    s.close_telemetry()
    return out


SCENARIOS = (tiers, transports, formats, chunked, audit)


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
