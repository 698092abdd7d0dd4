"""One rank of a world of the port on three-axis meshes, for
``tests/test_torch_three_axes.py``.

Spawned 8 times by the test; each process joins a gloo group through a
file store, runs the scenarios below in the same order as the others, and
writes what it saw to ``{out_dir}/rank{r}.pt`` (a traceback instead when a
scenario raised). Every mesh is (2, 2, 2). It imports torch and the port
only: no JAX.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

SHAPE = (2, 2, 2)
LR, MOMENTUM, STEPS = 0.05, 0.9, 2
AUX_WEIGHT, CLIP = 0.01, 0.5
COMM = dict(bucket_mb=0.25, chunk_elems=128)
TIERS = {"none": {}, "oss": dict(oss=True), "sddp": dict(oss=True, sddp=True),
         "fsdp": dict(fsdp=True)}
#: the rules that place GPT's first LayerNorm scale on the model axis and
#: its FFN's input kernel over the flattened (model, expert) axes: two
#: gathered placements
GATHERED_RULES = ((r"ln_attn/scale", ("model",)),
                  (r"ff_in/kernel", (None, ("model", "expert"))))
#: PipelinedLM's qkv kernels also on the model axis (a gathered level
#: inside the stage cut), ahead of the stage set
STAGE_QKV_RULE = ((r"^stages/.*attention/qkv/kernel",
                   ("stage", None, None, "model", None)),)
#: run -> (the model's inputs key, the mesh axes, the tier, whether it
#: carries the int8 transport)
RUNS = {
    "moe": ("moe", ("data", "model", "expert"), "fsdp", True),
    "gathered": ("gpt", ("data", "model", "expert"), "sddp", False),
    "seq": ("gpt", ("data", "seq", "model"), "oss", False),
    "stage": ("lm", ("data", "stage", "model"), "fsdp", False),
}
#: the sharded format's runs
FORMAT_RUNS = ("moe", "gathered", "stage")
#: the runs whose whole copy serves
SERVE_RUNS = ("gathered", "seq")


def rules_of(name: str):
    """The run's partition rules (the port's rule sets)."""
    from stoke_tpu_torch.models import (
        bert_tensor_parallel_rules,
        moe_expert_parallel_rules,
        pipeline_parallel_rules,
    )

    return {"moe": bert_tensor_parallel_rules()
            + moe_expert_parallel_rules(),
            "gathered": GATHERED_RULES,
            "seq": bert_tensor_parallel_rules(),
            "stage": STAGE_QKV_RULE + pipeline_parallel_rules()}[name]


def _model(name: str, inputs):
    """The run's model with the inputs' weights (under ``seq``, GPT with
    ring attention)."""
    from stoke_tpu_torch.models import GPT
    from stoke_tpu_torch.models.pipelined_lm import PipelinedLM
    from stoke_tpu_torch.ops.attention import make_ring_attention

    kind, axes = RUNS[name][:2]
    g = inputs[kind]
    if kind == "lm":
        m = PipelinedLM(vocab_size=g["vocab"], size_name="tiny",
                        max_len=g["len"], num_microbatches=2,
                        layers_per_stage=1, stages=2)
    else:
        kw = (dict(moe_num_experts=g["experts"],
                   moe_capacity_factor=g["capacity"],
                   moe_top_k=g["top_k"]) if kind == "moe" else {})
        if "seq" in axes:
            kw.update(attention_fn=make_ring_attention(causal=True),
                      attention_is_causal=True)
        m = GPT(vocab_size=g["vocab"], size_name="tiny", max_len=g["len"],
                dropout_rate=0.0, **kw)
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in g["weights"].items()})
    return m


def _stoke(name: str, inputs, extra=(), transport=None):
    """The run's ``Stoke`` on its (2, 2, 2) mesh with its rules and tier
    (with the int8 transport where the run carries it, or
    ``transport``)."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch import configs as pc
    from stoke_tpu_torch.models import causal_lm_loss

    kind, axes, tier, int8 = RUNS[name]
    cfgs = [pc.MeshConfig(axes=axes, shape=SHAPE),
            pc.OSSConfig(min_shard_size=1), pc.SDDPConfig(min_shard_size=1),
            pc.FSDPConfig(min_weight_size=1),
            pc.PartitionRulesConfig(rules=rules_of(name)), *extra]
    if int8 or transport:
        cfgs.append(pc.CommConfig(dtype="int8", strategy="rs_ag", **COMM))
    if "seq" in axes:
        cfgs.append(pc.DataParallelConfig(shard_seq_dim=1))
    kw = dict(TIERS[tier])
    if kind == "moe":
        # the norm clip sums each cut leaf's squares over its own group
        kw.update(aux_loss_weight=AUX_WEIGHT,
                  grad_clip=pc.ClipGradNormConfig(max_norm=CLIP))
    batch = inputs[kind]["batch"] // SHAPE[0]
    return Stoke(_model(name, inputs),
                 StokeOptimizer(torch.optim.SGD, lr=LR, momentum=MOMENTUM),
                 causal_lm_loss, batch_size_per_device=batch, device="cpu",
                 distributed="dp", configs=cfgs, **kw)


def _rows(s, a: np.ndarray) -> torch.Tensor:
    """This process's rows of a global batch: its data coordinate's (the
    seq shards of a row take the same rows; Stoke cuts their shard)."""
    d = s.mesh.get_local_rank("data")
    n = a.shape[0] // SHAPE[0]
    return torch.from_numpy(a[d * n:(d + 1) * n])


def _args(s, name: str, inputs, step: int):
    x = _rows(s, inputs[RUNS[name][0]]["batches"][step])
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


def _held(s) -> dict:
    """What this rank's optimizer steps on for each parameter, by name:
    its fsdp slice, or the parameter (a model split's slice) where the
    tier keeps it whole."""
    ladder = s._ladder
    names = {p: n for n, p in s.model_access.named_parameters()}
    return {names[p]: o.detach().clone().numpy()
            for p, o in zip(ladder.params, ladder.opt_params)}


def _coords(s) -> tuple:
    """This process's coordinate on each mesh axis."""
    return tuple(s.mesh.get_local_rank(a) for a in s.mesh.mesh_dim_names)


def train(inputs, rank, world) -> dict:
    """Each run: what each rank holds at the start, the losses and whole
    weights after each of STEPS SGD steps, the cut leaves and their
    groups."""
    out = {}
    for name in RUNS:
        s = _stoke(name, inputs)
        tp = s.tensor_parallel
        held = _held(s)
        losses, weights = [], []
        for step in range(STEPS):
            margs, largs = _args(s, name, inputs, step)
            losses.append(float(s.train_step(margs, largs)))
            weights.append(_whole(s))
        out[name] = {
            "held": held, "losses": losses, "weights": weights,
            "coords": _coords(s), "axes": tuple(s.mesh.mesh_dim_names),
            "cuts": {n: (c.group_axes, c.gathered_level is not None)
                     for n, c in tp.cuts.items()},
            "comm_bytes": s.comm_bytes,
            "params": s.num_model_parameters()}
        s.close_telemetry()
    return out


def formats(inputs, rank, world) -> dict:
    """Each of FORMAT_RUNS under fsdp with the int8 transport and a
    ``ResilienceConfig``: one step, then an emergency save in the sharded
    format and a consolidated save of the same state; a fresh run resumes
    the sharded tag, and both take one more step: the losses, whole
    weights and residuals of each, and the tags."""
    import json

    from stoke_tpu_torch import configs as pc

    out = {}
    for name in FORMAT_RUNS:
        root = os.path.join(inputs["out_dir"], f"fmt_{name}")
        extra = (pc.CheckpointConfig(format=pc.CheckpointFormat.sharded),
                 pc.ResilienceConfig(save_path=os.path.join(root, "emg"),
                                     exit_on_preempt=False))
        s = _stoke(name, inputs, extra, transport=True)
        margs, largs = _args(s, name, inputs, 0)
        s.train_step(margs, largs)
        tag = s._emergency_save()
        cons = s._save_with_config(os.path.join(root, "cons"), "stoke",
                                   pc.CheckpointConfig(), None)
        fresh = _stoke(name, inputs, extra, transport=True)
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
        out[name] = {"tag": tag, "cons": cons, "resumed": resumed,
                     "runs": runs, "meta": meta,
                     "files": sorted(os.listdir(tag))}
        for t in (s, fresh):
            t.close_telemetry()
    return out


def serve(inputs, rank, world) -> dict:
    """Each of SERVE_RUNS with a ``ServeConfig``: one step, then
    ``serve()``'s whole copy's logits on a probe batch, and the whole
    weights they come from."""
    from stoke_tpu_torch import configs as pc

    out = {}
    for name in SERVE_RUNS:
        s = _stoke(name, inputs, (pc.ServeConfig(
            max_seqs=2, kv_block_size=8, max_seq_len=32, max_new_tokens=2,
            prefill_pad_multiple=16, attention="flash"),))
        margs, largs = _args(s, name, inputs, 0)
        s.train_step(margs, largs)
        engine = s.serve()
        probe = torch.from_numpy(inputs["gpt"]["probe"])
        with torch.no_grad():
            logits = engine.model(probe).numpy()
        out[name] = {"logits": logits, "weights": _whole(s),
                     "groups": [m.group is None
                                for m in engine.model.modules()
                                if hasattr(m, "sync_widths")]}
        s.close_telemetry()
    return out


SCENARIOS = (train, formats, serve)


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
