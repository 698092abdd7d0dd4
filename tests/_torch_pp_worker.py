"""One rank of a pipeline-parallel world of the port, for
``tests/test_torch_pipeline.py``.

Spawned 4 times by the test; each process joins a gloo group through a
file store, runs the function-level pipeline and then the scenarios of
``RUNS`` in the same order as the others, and writes what it saw to
``{out_dir}/rank{r}.pt`` (a traceback instead when a scenario raised).
It imports torch and the port only: no JAX.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

SGD_LR, EAGER, WINDOWS = 0.05, 3, 2
VOCAB, MAX_LEN = 32, 32

#: name -> (mesh axes, mesh shape, rounds, remat, microbatches, global
#: batch); ``stage4_m2`` takes the all-reduce emission (4 stages do not
#: divide 2 microbatches), the others the reduce-scatter
RUNS = {
    "stage4": (("stage",), (4,), 1, False, 4, 4),
    "stage4_m2": (("stage",), (4,), 1, False, 2, 4),
    "dp_pp": (("data", "stage"), (2, 2), 1, False, 2, 4),
    "dp_pp_circular": (("data", "stage"), (2, 2), 2, True, 2, 4),
}


#: the function-level pipeline's cases over the world of 4 as one stage
#: group: (microbatches, rounds, remat); 6 takes the all-reduce emission
FUNCTION_CASES = ((6, 1, False), (8, 1, False), (6, 2, True))


def function(inputs, rank: int, world: int) -> list:
    """``pipeline`` of ``tanh(x @ w + b)`` stages over the world as one
    stage group, each case's whole stack and stream: this rank's emitted
    rows, its gradients of the whole stack (nonzero at its slices) and of
    the stream, for the objective ``sum(out ** 2)`` over every rank's
    rows (each rank its own rows' part; all of them where S does not
    divide M)."""
    from stoke_tpu_torch.parallel import ModelGroup, pipeline

    group = ModelGroup(dist.group.WORLD, world, rank, "stage")
    out = []
    for (n_micro, rounds, remat), case in zip(FUNCTION_CASES,
                                              inputs["cases"]):
        stacked = {k: torch.from_numpy(v).requires_grad_()
                   for k, v in case["stacked"].items()}
        xs = torch.from_numpy(case["xs"]).requires_grad_()
        piped = pipeline(lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                         group, rounds=rounds, remat=remat)
        y = piped(stacked, xs)
        (y ** 2).sum().backward()
        out.append({"out": y.detach().numpy(),
                    "grads": {k: v.grad.numpy() for k, v in stacked.items()},
                    "xs_grad": xs.grad.numpy()})
    return out


def model_for(name: str, weights=None):
    """The run's PipelinedLM-tiny (one block a stage), with ``weights``
    (the port's names) when given."""
    from stoke_tpu_torch.models import PipelinedLM

    axes, shape, rounds, remat, M, _ = RUNS[name]
    m = PipelinedLM(vocab_size=VOCAB, size_name="tiny", max_len=MAX_LEN,
                    num_microbatches=M, layers_per_stage=1, rounds=rounds,
                    remat=remat, stages=shape[-1])
    if weights is not None:
        m.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    return m


def stoke_for(name: str, model):
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import MeshConfig, PartitionRulesConfig
    from stoke_tpu_torch.models import causal_lm_loss, pipeline_parallel_rules

    axes, shape, _, _, _, batch = RUNS[name]
    return Stoke(model, StokeOptimizer(torch.optim.SGD, lr=SGD_LR),
                 causal_lm_loss, batch_size_per_device=batch // (
                     shape[0] if len(shape) == 2 else 1),
                 device="cpu", distributed="dp",
                 configs=[MeshConfig(axes=axes, shape=shape),
                          PartitionRulesConfig(
                              rules=pipeline_parallel_rules())])


def _whole(s) -> dict:
    """The model's whole state dict (the stage slices gathered), as
    numpy."""
    tp = s.tensor_parallel
    return {n: tp.gather(n, t).detach().numpy().copy()
            for n, t in s.model_access.state_dict().items()}


def _rows(s, name: str, b: np.ndarray) -> torch.Tensor:
    """This process's rows of the global batch ``b``: its data
    coordinate's (every stage rank of a data row the same)."""
    shape = RUNS[name][1]
    if len(shape) == 1:
        return torch.from_numpy(b)
    d = s.mesh.get_local_rank("data")
    n = b.shape[0] // shape[0]
    return torch.from_numpy(b[d * n:(d + 1) * n])


def _edge_grads_equal(s) -> dict:
    """After a backward (no step): for each parameter, whether it is cut
    and whether its gradient is the same bit for bit on every rank of the
    stage group."""
    tp = s.tensor_parallel
    out = {}
    for n, p in s.model_access.named_parameters():
        g = p.grad.contiguous()
        parts = [torch.empty_like(g) for _ in range(tp.size)]
        dist.all_gather(parts, g, group=tp.group.group)
        out[n] = (n in tp.cuts, all(torch.equal(parts[0], q)
                                    for q in parts[1:]))
    return out


def train(name: str, inputs) -> dict:
    """EAGER ``train_step``s then ``train_steps`` of WINDOWS one-step
    windows, on each step's global batch: the losses and the whole
    weights after each step; the gradients of one more backward; the
    cut's shapes; a consolidated save (the (2, 2) runs), loaded back into
    a fresh split run of other weights."""
    s = stoke_for(name, model_for(name, inputs["weights"]))
    tp = s.tensor_parallel
    batches = inputs["batches"]
    losses, weights = [], []
    for b in batches[:EAGER]:
        x = _rows(s, name, b)
        losses.append(float(s.train_step(x, x)))
        weights.append(_whole(s))
    seg = torch.stack([_rows(s, name, b)
                       for b in batches[EAGER:EAGER + WINDOWS]])
    for i in range(WINDOWS):
        one = seg[i:i + 1]
        losses.append(float(s.train_steps(one, one).reshape(-1)[0]))
        weights.append(_whole(s))
    x = _rows(s, name, batches[-1])
    s.backward(s.loss(s.model(x), x))
    edges = _edge_grads_equal(s)
    s.step()
    out = {"losses": losses, "weights": weights, "edges": edges,
           "shapes": {n: tuple(p.shape) for n, p in
                      s.model_access.named_parameters() if n in tp.cuts},
           "stage_rank": tp.rank, "stages": tp.size,
           "counts": s.num_model_parameters()}
    # the cut made whole again (collective): the whole stack, no group,
    # and the split model's logits on the last batch
    whole = tp.whole_copy(s.model_access)
    with torch.no_grad():
        s.eval()
        split_logits = s.model(x).numpy()
        s.train()
        out["whole_copy"] = {
            "group": whole.group,
            "stages": int(whole.stages.block_0.ln_ff.weight.shape[0]),
            "logits": whole(x).numpy(), "split_logits": split_logits}
    if len(RUNS[name][1]) == 2:
        tag = s.save(os.path.join(inputs["out_dir"], f"{name}_ckpt"))
        local = {n: t.detach().clone()
                 for n, t in s.model_access.state_dict().items()}
        other = model_for(name)
        other.init_weights(7)
        s2 = stoke_for(name, other)
        s2.load(os.path.dirname(tag))
        out.update(tag=tag, saved=_whole(s), reloaded=all(
            torch.equal(local[n], t)
            for n, t in s2.model_access.state_dict().items()))
        s2.close_telemetry()
    s.close_telemetry()
    return out


def run(rank: int, world: int, store: str, out_dir: str, inputs) -> None:
    """The entry point of one spawned rank (the port's explicit
    rendezvous at the file store)."""
    from stoke_tpu_torch.configs import DistributedInitConfig
    from stoke_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    out = {}
    try:
        initialize_distributed(DistributedInitConfig(
            coordinator_address=f"file://{store}", num_processes=world,
            process_id=rank), torch.device("cpu"))
        out["function"] = function(inputs["function"], rank, world)
        for name in RUNS:
            out[name] = train(name, {**inputs[name], "out_dir": out_dir})
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    if "error" in out:
        raise SystemExit(1)
