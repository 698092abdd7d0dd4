"""One rank of a world of the port with placements on the data, seq and
stage axes, for ``tests/test_torch_data_axes.py``.

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

STEPS = 3
#: AdamW with an eps of 1e-4: a coordinate whose gradient g is near 0
#: moves by lr·g/(|g| + eps) in the first step, whose slope lr/eps turns
#: the last bits of a gradient's reduction order (~1e-9 here, which the
#: port and XLA sum in other orders) into lr/eps times as much; at 1e-8
#: or 1e-6 that is above the tolerance
ADAMW = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-4, weight_decay=1e-4)
COMM = dict(bucket_mb=0.25, chunk_elems=128)
TIERS = {"none": {}, "oss": dict(oss=True), "fsdp": dict(fsdp=True)}
#: GPT-base's 2-D rules: the Megatron set with each kernel's other dim on
#: the data axis, and the embedding's hidden dim on it
TWO_D_RULES = ((r"attention/qkv/kernel", ("data", None, "model", None)),
               (r"attention/qkv/bias", (None, "model", None)),
               (r"attention/out/kernel", ("model", "data")),
               (r"ff_in/kernel", ("data", "model")),
               (r"ff_in/bias", ("model",)),
               (r"ff_out/kernel", ("model", "data")),
               (r"tok_emb/embedding", (None, "data")))
#: the rule sets by name (the stage cases are
#: ``tests/test_torch_pipeline.py``'s, the stage set beside the embedding)
RULES = {
    "ff_in_data": ((r"ff_in/kernel", (None, "data")),),
    "two_d": TWO_D_RULES,
    "pos_seq": ((r"pos_emb/embedding", ("seq", None)),),
    "part_of_the_set": ((r"^stages/block_0/attention/", ("stage", "...")),),
    "embedding": ((r"^embed/tok", ("stage", None)),
                  (r"^stages/", ("stage", "..."))),
}
#: run -> (the model's inputs key, the mesh axes, its shape, the tier,
#: whether it carries the int8 transport, its rules, grad_accum)
RUNS = {
    "data_dp": ("gpt", ("data",), (4,), "none", False, "ff_in_data", 1),
    "data_oss": ("gpt", ("data",), (4,), "oss", False, "ff_in_data", 1),
    "two_d": ("gpt", ("data", "model"), (2, 2), "none", False, "two_d", 2),
    "two_d_fsdp": ("gpt", ("data", "model"), (2, 2), "fsdp", True, "two_d",
                   1),
    "seq": ("gpt", ("data", "seq"), (2, 2), "none", False, "pos_seq", 1),
    "part_of_the_set": ("lm", ("data", "stage"), (2, 2), "none", False,
                        "part_of_the_set", 1),
    "embedding": ("lm", ("data", "stage"), (2, 2), "none", False,
                  "embedding", 1),
}
#: the runs with a norm clip (each cut leaf's squares summed over its own
#: group: the 2-D leaves' over (model, data))
CLIPPED = ("two_d",)
CLIP = 0.5
#: the run whose sharded emergency tag resumes (its transport's residual
#: too)
FORMAT_RUN = "two_d_fsdp"


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
        kw = {}
        if "seq" in axes:
            kw.update(attention_fn=make_ring_attention(causal=True),
                      attention_is_causal=True)
        m = GPT(vocab_size=g["vocab"], size_name="tiny", max_len=g["len"],
                dropout_rate=0.0, **kw)
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in g["weights"].items()})
    return m


def stoke(name: str, inputs, extra=(), model=None):
    """The run's ``Stoke`` on its mesh with its rules, tier, transport and
    ``grad_accum``."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch import configs as pc
    from stoke_tpu_torch.models import causal_lm_loss

    kind, axes, shape, tier, int8, rules, accum = RUNS[name]
    cfgs = [pc.MeshConfig(axes=axes, shape=shape),
            pc.OSSConfig(min_shard_size=1), pc.SDDPConfig(min_shard_size=1),
            pc.FSDPConfig(min_weight_size=1),
            pc.PartitionRulesConfig(rules=RULES[rules]), *extra]
    if int8:
        cfgs.append(pc.CommConfig(dtype="int8", strategy="rs_ag", **COMM))
    if "seq" in axes:
        cfgs.append(pc.DataParallelConfig(shard_seq_dim=1))
    batch = inputs[kind]["batch"] // shape[0]
    clip = (pc.ClipGradNormConfig(max_norm=CLIP) if name in CLIPPED
            else None)
    return Stoke(model if model is not None else _model(name, inputs),
                 StokeOptimizer(torch.optim.AdamW, **ADAMW),
                 causal_lm_loss, batch_size_per_device=batch, device="cpu",
                 distributed="dp", grad_accum=accum, grad_clip=clip,
                 configs=cfgs, **TIERS[tier])


def rows(s, a: np.ndarray) -> torch.Tensor:
    """This process's rows of a global batch: its data coordinate's (the
    seq shards and the stage ranks of a row take the same rows)."""
    d = s.mesh.get_local_rank("data")
    n = a.shape[0] // s.mesh.shape[0]
    return torch.from_numpy(a[d * n:(d + 1) * n])


def whole(s) -> dict:
    """The model's whole state dict (fsdp's slices and the split's
    gathered), as numpy."""
    tp = s.tensor_parallel
    with s._whole_params():
        sd = s.model_access.state_dict()
        # a clone: numpy's view of a tensor pins its storage, which fsdp
        # frees after the block
        return {n: (tp.gather(n, t) if tp is not None else t)
                .detach().clone().numpy() for n, t in sd.items()}


def held(s) -> dict:
    """What this rank's optimizer steps on for each parameter, by name:
    its fsdp or oss slice, or the parameter (a rule's slice) where the
    tier keeps it whole."""
    ladder = s._ladder
    names = {p: n for n, p in s.model_access.named_parameters()}
    return {names[p]: o.detach().clone().numpy()
            for p, o in zip(ladder.params, ladder.opt_params)}


def state_bytes(s) -> dict:
    """This rank's bytes of each parameter (a slice where the tier frees
    the leaf or a rule cuts it) and of its AdamW moments, by name."""
    ladder = s._ladder
    names = {p: n for n, p in s.model_access.named_parameters()}
    freed = {i for b in ladder.buckets if b.frees for i in b.index}
    state = s._engine.optimizer.state
    out = {}
    for i, (p, o) in enumerate(zip(ladder.params, ladder.opt_params)):
        held_ = o if i in freed else p
        out[names[p]] = {"param": held_.numel() * p.element_size(), **{
            k: state[o][k].numel() * state[o][k].element_size()
            for k in ("exp_avg", "exp_avg_sq")}}
    return out


def coords(s) -> tuple:
    return tuple(s.mesh.get_local_rank(a) for a in s.mesh.mesh_dim_names)


def train(inputs, rank, world) -> dict:
    """Each run: what each rank holds at the start and after the steps,
    the losses and whole weights after each optimizer step, the cuts, the
    bytes, the transport's accounting."""
    out = {}
    for name, (kind, *_, accum) in RUNS.items():
        s = stoke(name, inputs)
        tp = s.tensor_parallel
        start = held(s)
        losses, weights = [], []
        for b in inputs[kind]["batches"][:STEPS * accum]:
            x = rows(s, b)
            losses.append(float(s.train_step(x, x)))
            if s.optimizer_steps * accum == len(losses):
                weights.append(whole(s))
        out[name] = {
            "start": start, "end": held(s), "losses": losses,
            "weights": weights, "coords": coords(s),
            "cuts": {n: (c.group_axes, c.mean_axes)
                     for n, c in tp.cuts.items()},
            "split": [type(m).__name__ for m in s.model_access.modules()
                      if getattr(m, "group", None) is not None],
            "bytes": state_bytes(s), "comm_bytes": s.comm_bytes,
            "params": s.num_model_parameters()}
        s.close_telemetry()
    return out


def formats(inputs, rank, world) -> dict:
    """FORMAT_RUN with a ``ResilienceConfig``: one optimizer step, an
    emergency save in the sharded format and a consolidated save of the
    same state; a fresh run resumes the sharded tag, and both take one
    more step: the losses, whole weights and residuals of each, and the
    tags."""
    from stoke_tpu_torch import configs as pc

    name = FORMAT_RUN
    kind, accum = RUNS[name][0], RUNS[name][-1]
    root = os.path.join(inputs["out_dir"], "fmt")
    extra = (pc.CheckpointConfig(format=pc.CheckpointFormat.sharded),
             pc.ResilienceConfig(save_path=os.path.join(root, "emg"),
                                 exit_on_preempt=False))
    batches = inputs[kind]["batches"]
    s = stoke(name, inputs, extra)
    for b in batches[:accum]:
        x = rows(s, b)
        s.train_step(x, x)
    tag = s._emergency_save()
    cons = s._save_with_config(os.path.join(root, "cons"), "stoke",
                               pc.CheckpointConfig(), None)
    fresh = stoke(name, inputs, extra)
    resumed = fresh.resume()
    runs = []
    for t in (s, fresh):
        losses = []
        for b in batches[accum:2 * accum]:
            x = rows(t, b)
            losses.append(float(t.train_step(x, x)))
        runs.append({"losses": losses, "weights": whole(t),
                     "residual": [r.numpy().copy() for r in
                                  t._engine.comm_state["residual"]]})
    for t in (s, fresh):
        t.close_telemetry()
    return {"tag": tag, "cons": cons, "resumed": resumed, "runs": runs,
            "files": sorted(os.listdir(tag))}


SCENARIOS = (train, formats)


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
