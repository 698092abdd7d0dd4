"""One rank of a data-parallel world of the port, for
``tests/test_torch_distributed.py``.

Spawned W times by the test; each process joins a gloo group through a
file store, runs every scenario below in the same order as the others,
and writes what it saw to ``{out_dir}/rank{r}.pt`` (a traceback instead
when a scenario raised). It imports torch and the port only: no JAX.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

IN, HID, OUT = 8, 64, 4
GLOBAL_BATCH, STEPS = 32, 5
TIERS = {"dp": {}, "oss": dict(oss=True), "sddp": dict(oss=True, sddp=True),
         "fsdp": dict(fsdp=True)}
CLIP = 0.05
SAMPLES = 224
#: placements: (tier, OSS min size, SDDP and FSDP min size); "sddp_gap"
#: shards ``0.weight``'s gradient buffer (512 >= 300) but not its
#: optimizer state (512 < 600)
PLACEMENTS = {**{t: (t, 300, 300) for t in TIERS},
              "sddp_gap": ("sddp", 600, 300)}


def mlp(w1: np.ndarray, w2: np.ndarray) -> nn.Module:
    """The JAX tests' MLP, ``relu(x @ w1) @ w2``, as torch modules."""
    m = nn.Sequential(nn.Linear(IN, HID, bias=False), nn.ReLU(),
                      nn.Linear(HID, OUT, bias=False))
    with torch.no_grad():
        m[0].weight.copy_(torch.from_numpy(w1.T.copy()))
        m[2].weight.copy_(torch.from_numpy(w2.T.copy()))
    return m


def mse(out, y):
    return ((out - y) ** 2).mean()


def mlp_data(n: int = STEPS):
    """The JAX test's batches: ``n`` global batches of 32 rows."""
    r = np.random.default_rng(3)
    w = r.normal(size=(IN, OUT)).astype(np.float32)
    xs = [r.normal(size=(GLOBAL_BATCH, IN)).astype(np.float32)
          for _ in range(n)]
    return [(x, (x @ w).astype(np.float32)) for x in xs]


def rows(a, rank: int, world: int):
    """This rank's rows of a global batch."""
    b = len(a) // world
    return torch.from_numpy(np.ascontiguousarray(a[rank * b:(rank + 1) * b]))


def mlp_stoke(inputs, world, tier="dp", min_size=1, precision=None,
              grad_accum=None, grad_clip=None, extra=(), oss_min=None):
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import FSDPConfig, OSSConfig, SDDPConfig

    return Stoke(mlp(*inputs["mlp_w"]),
                 StokeOptimizer(torch.optim.Adam, lr=1e-2), mse,
                 batch_size_per_device=GLOBAL_BATCH // world, device="cpu",
                 distributed="dp", precision=precision,
                 grad_accum=grad_accum, grad_clip=grad_clip,
                 configs=[OSSConfig(min_shard_size=min_size if oss_min is None
                                    else oss_min),
                          SDDPConfig(min_shard_size=min_size),
                          FSDPConfig(min_weight_size=min_size), *extra],
                 **TIERS[tier])


def weights(s) -> dict:
    with s._whole_params():
        return {n: p.detach().clone().numpy()
                for n, p in s.model_access.named_parameters()}


def four_calls(s, batches, rank, world) -> list:
    losses = []
    for x, y in batches:
        loss = s.loss(s.model(rows(x, rank, world)), rows(y, rank, world))
        s.backward(loss)
        s.step()
        losses.append(float(loss))
    return losses


def tiers(inputs, rank, world) -> dict:
    """Each tier over the JAX test's 5 steps, unclipped and under a
    binding clip norm."""
    from stoke_tpu_torch.configs import ClipGradNormConfig

    out = {}
    for clip in (None, CLIP):
        for tier in TIERS:
            s = mlp_stoke(inputs, world, tier, grad_clip=None if clip is None
                          else ClipGradNormConfig(max_norm=clip))
            losses = four_calls(s, mlp_data(), rank, world)
            out[(tier, clip)] = {"losses": losses, "weights": weights(s)}
    return out


def placements(inputs, rank, world) -> dict:
    """What each rank holds under each case of PLACEMENTS (with the min
    sizes at 300 elements ``0.weight``, 512 elements, shards and
    ``2.weight``, 256, stays replicated). Per leaf: elements of AdamW's
    ``exp_avg``, of the gradient held mid-window (after one of two
    micro-steps), and of the parameter's storage plus its slice after the
    apply; and the weights after it."""
    out = {}
    data = mlp_data(2)
    for case, (tier, oss_min, min_size) in PLACEMENTS.items():
        s = mlp_stoke(inputs, world, tier, min_size=min_size, grad_accum=2,
                      oss_min=oss_min)
        names = [n for n, _ in s.model_access.named_parameters()]
        ladder = s._ladder
        x, y = data[0]
        s.backward(s.loss(s.model(rows(x, rank, world)),
                          rows(y, rank, world)))
        s.step()
        grads = {}
        for i, (n, p) in enumerate(s.model_access.named_parameters()):
            acc = ladder.accumulator(i)
            grads[n] = (acc.numel() if acc is not None
                        else 0 if p.grad is None else p.grad.numel())
        x, y = data[1]
        s.backward(s.loss(s.model(rows(x, rank, world)),
                          rows(y, rank, world)))
        s.step()
        opt = {}
        for n, o in zip(names, ladder.opt_params):
            opt[n] = s.optimizer.state[o]["exp_avg"].numel()
        params = {}
        for i, (n, p) in enumerate(s.model_access.named_parameters()):
            held = p.untyped_storage().nbytes() // p.element_size()
            o = ladder.opt_params[i]
            params[n] = held + (o.numel() if o is not p and tier == "fsdp"
                                else 0)
        out[case] = {"opt": opt, "grad": grads, "param": params,
                     "steps": s.optimizer_steps, "weights": weights(s)}
    return out


def accumulation(inputs, rank, world) -> dict:
    """oss+sddp at grad_accum=2 over 4 micro-batches (2 steps)."""
    s = mlp_stoke(inputs, world, "sddp", grad_accum=2)
    losses = four_calls(s, mlp_data(4), rank, world)
    return {"losses": losses, "weights": weights(s),
            "steps": s.optimizer_steps}


def fsdp_eval(inputs, rank, world) -> dict:
    """An eval-mode forward against fully sharded parameters, and what the
    parameters hold after it and after a training step."""
    s = mlp_stoke(inputs, world, "fsdp")
    x, y = mlp_data(1)[0]
    s.eval()
    before = s.model(rows(x, rank, world)).numpy()
    held_eval = [p.untyped_storage().nbytes()
                 for p in s.model_access.parameters()]
    s.train()
    four_calls(s, [(x, y)], rank, world)
    held_step = [p.untyped_storage().nbytes()
                 for p in s.model_access.parameters()]
    return {"eval_out": before, "held_after_eval": held_eval,
            "held_after_step": held_step}


def window(inputs, rank, world) -> dict:
    """oss+sddp at grad_accum=2: ``train_steps`` over 4 stacked
    micro-batches against the four calls over the same batches."""
    data = mlp_data(4)
    a = mlp_stoke(inputs, world, "sddp", grad_accum=2)
    calls = four_calls(a, data, rank, world)
    b = mlp_stoke(inputs, world, "sddp", grad_accum=2)
    xs = torch.stack([rows(x, rank, world) for x, _ in data])
    ys = torch.stack([rows(y, rank, world) for _, y in data])
    stacked = b.train_steps(xs, ys).reshape(-1).tolist()
    return {"calls": calls, "window": stacked, "calls_w": weights(a),
            "window_w": weights(b), "steps": (a.optimizer_steps,
                                              b.optimizer_steps)}


def fp16(inputs, rank, world) -> dict:
    """fp16 under oss+sddp: 3 steps, then a step whose loss is inf on
    rank 1 only."""
    s = mlp_stoke(inputs, world, "sddp", precision="fp16")
    data = mlp_data(4)
    four_calls(s, data[:3], rank, world)
    clean = {"skipped": s.skipped_optimizer_steps, "scale": s.loss_scale}
    before = [o.detach().clone() for o in s._ladder.opt_params]
    x, y = data[3]
    yr = rows(y, rank, world)
    if rank == 1:
        yr = torch.full_like(yr, float("inf"))
    s.backward(s.loss(s.model(rows(x, rank, world)), yr))
    s.step()
    after = [o.detach() for o in s._ladder.opt_params]
    return {**clean, "skipped_after_inf": s.skipped_optimizer_steps,
            "scale_after_inf": s.loss_scale,
            "unchanged": all(torch.equal(a, b)
                             for a, b in zip(before, after))}


def loss_sync(inputs, rank, world) -> dict:
    """``detach_and_sync_loss`` under each ``LossReduction``, with the
    counts the facade reports."""
    from stoke_tpu_torch.configs import DataParallelConfig, LossReduction

    out = {}
    x, y = mlp_data(1)[0]
    for red in LossReduction:
        s = mlp_stoke(inputs, world, "dp", grad_accum=2, extra=[
            DataParallelConfig(loss_reduction=red)])
        s.eval()
        loss = s.loss(s.model(rows(x, rank, world)), rows(y, rank, world))
        out[red.value] = {"mean": s.detach_and_sync_loss(loss),
                          "sum": s.detach_and_sync_loss(loss, "sum")}
    out["counts"] = {"world_size": s.world_size, "rank": s.rank,
                     "n_processes": s.n_processes,
                     "effective_batch_size": s.effective_batch_size,
                     "batch_size": s.batch_size}
    return out


def samplers(inputs, rank, world) -> dict:
    """Each rank's indices from ``DistributedSampler`` and
    ``BucketedDistributedSampler`` over ``SAMPLES`` samples (two buckets
    of 112, a multiple of 4 batches of 4: no padding), and whether
    ``Stoke.DataLoader`` refuses a run of several processes without a
    sampler."""
    from torch.utils.data import DistributedSampler

    from stoke_tpu_torch import ArrayDataset, BucketedDistributedSampler

    ds = ArrayDataset(np.arange(SAMPLES, dtype=np.int64))
    plain = list(DistributedSampler(ds, num_replicas=world, rank=rank,
                                    seed=0))
    lengths = np.random.default_rng(1).integers(1, 50, size=SAMPLES)
    bucketed = list(BucketedDistributedSampler(
        ds, buckets=2, batch_size=4, sorted_idx=np.argsort(lengths),
        num_replicas=world, rank=rank, seed=0, info_rank=-1))
    s = mlp_stoke(inputs, world)
    try:
        s.DataLoader(ds)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    return {"plain": plain, "bucketed": bucketed, "refusal": refusal}


def dropout_masks(inputs, rank, world) -> dict:
    """The mask each rank's dropout draws in a train-mode forward of the
    same input from the same ``seed``."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.models.bert import Dropout

    s = Stoke(nn.Sequential(nn.Linear(16, 16), Dropout(0.5)),
              StokeOptimizer(torch.optim.SGD, lr=0.1), mse,
              batch_size_per_device=4, device="cpu", distributed="dp",
              seed=0)
    out = s.model(torch.ones(4, 16))
    return {"mask": (out != 0).numpy()}


def gpt(inputs, rank, world) -> dict:
    """GPT-tiny (2 layers, plain attention) from the JAX weights under dp
    and fsdp: 3 steps of SGD over the global batches."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import FSDPConfig
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss

    g = inputs["gpt"]
    out = {}
    for tier in ("dp", "fsdp"):
        model = GPT(vocab_size=g["vocab"], size_name="tiny",
                    max_len=g["len"], dropout_rate=0.0,
                    attention_is_causal=False)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in g["weights"].items()})
        s = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.1,
                                        momentum=0.9, dampening=0.0),
                  causal_lm_loss,
                  batch_size_per_device=len(g["batches"][0]) // world,
                  device="cpu", distributed="dp",
                  configs=[FSDPConfig(min_weight_size=1)], **TIERS[tier])
        losses = []
        for batch in g["batches"]:
            b = rows(batch, rank, world)
            losses.append(float(s.train_step(b, b)))
        out[tier] = {"losses": losses, "weights": weights(s)}
    return out


def resnet(inputs, rank, world) -> dict:
    """The two-stage ResNet (4 filters, BatchNorm) from the JAX variables
    under dp: 3 SGD steps; parameters and running statistics."""
    import torch.nn.functional as F

    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.models.resnet import BasicBlock, ResNet

    r = inputs["resnet"]
    model = ResNet(stage_sizes=(1, 1), block=BasicBlock, num_classes=10,
                   num_filters=4, cifar_stem=True)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in r["weights"].items()})
    s = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.05, momentum=0.9,
                                    dampening=0.0),
              lambda logits, y: F.cross_entropy(logits.float(), y.long()),
              batch_size_per_device=len(r["xs"][0]) // world, device="cpu",
              distributed="dp")
    losses = []
    for x, y in zip(r["xs"], r["ys"]):
        x = np.ascontiguousarray(np.moveaxis(x, -1, -3))
        losses.append(float(s.train_step(rows(x, rank, world),
                                          rows(y, rank, world))))
    return {"losses": losses,
            "state": {k: v.detach().clone().numpy() for k, v in
                      s.model_access.state_dict().items()}}


def multiprocess_checkpoints(inputs, rank, world) -> dict:
    """Saves, loads and the periodic auto-save across processes (refused
    until ROADMAP item 6b): each returns on every rank, the tag holds the
    run's counters, and ``barrier`` returns. Their numbers are
    ``tests/test_torch_io_distributed.py``'s."""
    import tempfile

    from stoke_tpu_torch.configs import CheckpointConfig

    out = {}
    data = mlp_data(2)
    with tempfile.TemporaryDirectory() as d:
        # one directory for every rank: rank 0's name, broadcast
        shared = [d]
        dist.broadcast_object_list(shared, 0)
        d = shared[0]
        s = mlp_stoke(inputs, world)
        four_calls(s, data, rank, world)
        out["save"] = os.path.basename(s.save(d))
        t = mlp_stoke(inputs, world)
        t.load(d)
        out["load"] = t.optimizer_steps
        a = mlp_stoke(inputs, world, extra=[
            CheckpointConfig(save_every_n_steps=1, auto_path=d + "/auto")])
        four_calls(a, data, rank, world)
        b = mlp_stoke(inputs, world, extra=[
            CheckpointConfig(save_every_n_steps=1, auto_path=d + "/auto")])
        out["auto_save"] = (b.maybe_resume(), b.optimizer_steps)
        s.barrier()
    s.barrier()
    out["barrier"] = True
    return out


def sentinel_rows(s, batches, rank, world) -> list:
    """The health sentinel row of each four-call step (the global batch's
    rows of this rank)."""
    out = []
    for x, y in batches:
        s.backward(s.loss(s.model(rows(x, rank, world)),
                          rows(y, rank, world)))
        s.step()
        out.append(s._last_sentinels.tolist())
    return out


def sentinels(inputs, rank, world) -> dict:
    """The health sentinels under dp and fsdp with a binding clip norm:
    each step's row, whose norms and non-finite flags are global (summed
    or maxed over the ranks inside the apply)."""
    import tempfile

    from stoke_tpu_torch.configs import (ClipGradNormConfig, HealthConfig,
                                         TelemetryConfig)

    out = {}
    for tier in ("dp", "fsdp"):
        cfgs = (TelemetryConfig(output_dir=tempfile.mkdtemp(), jsonl=False,
                                prometheus=False),
                HealthConfig(dump_signals=False))
        s = mlp_stoke(inputs, world, tier,
                      grad_clip=ClipGradNormConfig(max_norm=CLIP),
                      extra=cfgs)
        out[tier] = sentinel_rows(s, mlp_data(3), rank, world)
        s.close_telemetry()
    return out


SCENARIOS = (tiers, placements, accumulation, fsdp_eval, window, fp16,
             loss_sync, samplers, dropout_masks, gpt, resnet,
             multiprocess_checkpoints, sentinels)


def run(rank: int, world: int, store: str, out_dir: str,
        inputs: str) -> None:
    """The entry point of one spawned rank: it joins the world by the
    port's explicit rendezvous (``DistributedInitConfig``) at the file
    store; ``inputs`` is the file the test saved them to: a payload larger
    than a pipe's buffer would hold each ``Process.start`` until that
    child had started up."""
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
            out[scenario.__name__] = scenario(inputs, rank, world)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    if "error" in out:
        raise SystemExit(1)
