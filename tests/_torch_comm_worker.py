"""One rank of a data-parallel world of the port, for
``tests/test_torch_collectives.py``: the gradient transports across
processes.

Spawned W times by the test; each process joins a gloo group through a
file store, runs every scenario below in the same order as the others,
and writes what it saw to ``{out_dir}/rank{r}.pt`` (a traceback instead
when a scenario raised). It imports torch and the port only: no JAX.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

import _torch_dp_worker as dpw

#: the leaves of the transport cases, in the JAX flatten order (dict keys
#: sorted), and their configs (small buckets and chunks, so several
#: buckets and padded tails)
SHAPES = {"a": (40, 30), "b": (30,), "c": (7, 5, 3), "d": (1000,),
          "e": (300, 7)}
TRANSPORTS = {
    "int8_rs_ag": dict(dtype="int8", strategy="rs_ag"),
    "int8_all_reduce": dict(dtype="int8", strategy="all_reduce"),
    "int8_sharded": dict(dtype="int8", shard_updates=True),
    "int8_nearest": dict(dtype="int8", stochastic_rounding=False),
    "bf16_rs_ag": dict(dtype="bf16"),
    "bf16_sharded": dict(dtype="bf16", shard_updates=True),
    "int8_no_ef": dict(dtype="int8", error_feedback=False),
    "fp32": dict(dtype="fp32"),
}
COMMON = dict(bucket_mb=0.004, chunk_elems=64)
STEPS = 3
#: steps of the training cases: the JAX test's 40 for the MLP, fewer at a
#: larger learning rate for GPT-tiny (the tier-1 budget)
TRAIN_STEPS, GPT_STEPS = 40, 15
GPT_VOCAB, GPT_LEN, GPT_BATCH = 97, 16, 8


def rank_grads(step: int, rank: int):
    """Rank ``rank``'s gradients at ``step``: multiples of 2**-12 below 4
    in magnitude, so their mean is exact in any summation order."""
    r = np.random.default_rng(100 * step + rank)
    return {k: (r.integers(-2**14, 2**14, size=s) / 2.0**12).astype(
        np.float32) for k, s in SHAPES.items()}


def transports(inputs, rank, world) -> dict:
    """Each transport over STEPS steps of the ranks' mean gradients (the
    ladder's fp32 all-reduce): each step's output and residual on this
    rank, the accounting dicts."""
    from stoke_tpu_torch.configs import CommConfig, ShardingOptions
    from stoke_tpu_torch.parallel.zero import make_transport

    group = dist.group.WORLD
    sizes = [int(np.prod(s)) for s in SHAPES.values()]
    out = {}
    for name, kw in TRANSPORTS.items():
        cfg = CommConfig(**COMMON, **kw)
        t = make_transport(cfg, ShardingOptions.oss, group)
        state = t.init_state(sizes, "cpu")
        steps = []
        for step in range(STEPS):
            local = rank_grads(step, rank)
            flat = torch.cat([torch.from_numpy(local[k]).reshape(-1)
                              for k in SHAPES])
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
            leaves = list(flat.split(sizes))
            leaves = [l.view(s) for l, s in zip(leaves, SHAPES.values())]
            y = t.apply(leaves, state)
            steps.append({
                "out": [v.clone().numpy() for v in y],
                "residual": [r.clone().numpy()
                             for r in state.get("residual", [])],
                "rng": None if not state else state["rng"].clone().numpy()})
        out[name] = {"steps": steps, "kind": t.layout_kind,
                     "bytes": t.bytes_per_step(sizes),
                     "descriptor": t.layout_descriptor(sizes)}
    return out


def _gpt_stoke(world, tier, comm, accum=None):
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import (CommConfig, FSDPConfig, OSSConfig,
                                         SDDPConfig)
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss

    model = GPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=GPT_LEN,
                dropout_rate=0.0)
    model.init_weights(0)
    configs = [OSSConfig(min_shard_size=1), SDDPConfig(min_shard_size=1),
               FSDPConfig(min_weight_size=1)]
    if comm is not None:
        configs.append(CommConfig(dtype=comm, chunk_elems=128, bucket_mb=0.05))
    return Stoke(model, StokeOptimizer(torch.optim.Adam, lr=1e-2),
                 causal_lm_loss, batch_size_per_device=GPT_BATCH // world,
                 device="cpu", distributed="dp", grad_accum=accum,
                 configs=configs, **dpw.TIERS[tier])


def training(inputs, rank, world) -> dict:
    """int8 with error feedback against no transport, under every tier,
    on an overfit batch: the MLP and GPT-tiny, TRAIN_STEPS steps each;
    the final EMA losses, and each run's residual sizes."""
    from stoke_tpu_torch.configs import CommConfig

    x, y = dpw.mlp_data(1)[0]
    ids = np.random.default_rng(9).integers(
        0, GPT_VOCAB, size=(GPT_BATCH, GPT_LEN)).astype(np.int32)
    mine = dpw.rows(ids, rank, world)
    out = {}
    for tier in dpw.TIERS:
        for comm in (None, "int8"):
            extra = [] if comm is None else [
                CommConfig(dtype=comm, chunk_elems=64, bucket_mb=0.001)]
            s = dpw.mlp_stoke(inputs, world, tier, extra=extra)
            mlp0 = [float(s.train_step(dpw.rows(x, rank, world),
                                       (dpw.rows(y, rank, world),)))
                    for _ in range(TRAIN_STEPS)][0]
            g = _gpt_stoke(world, tier, comm)
            gpt0 = [float(g.train_step(mine, (mine,)))
                    for _ in range(GPT_STEPS)][0]
            out[(tier, comm)] = {
                "mlp": s.ema_loss, "gpt": g.ema_loss, "mlp0": mlp0,
                "gpt0": gpt0,
                "residual": [r.numel() for r in
                             g._engine.comm_state.get("residual", [])],
                "padded": [p for _, _, p in g._engine.transport._layout(
                    g._engine.comm_order.sizes()).buckets]
                if comm else [],
                "comm_bytes": g.comm_bytes}
    return out


def windows(inputs, rank, world) -> dict:
    """int8 transport under every tier at ``grad_accum=2``: eager
    ``train_step``s against ``train_steps`` windows on the same batches
    (losses)."""
    r = np.random.default_rng(11)
    ids = r.integers(0, GPT_VOCAB, size=(2, 2, GPT_BATCH, GPT_LEN)).astype(
        np.int32)
    out = {}
    for tier in dpw.TIERS:
        eager = _gpt_stoke(world, tier, "int8", accum=2)
        got = []
        for window in ids:
            for b in window:
                x = dpw.rows(b, rank, world)
                got.append(float(eager.train_step(x, (x,))))
        win = _gpt_stoke(world, tier, "int8", accum=2)
        stacked = torch.stack([dpw.rows(b, rank, world)
                               for w in ids for b in w])
        rep = win.train_steps(stacked, (stacked,))
        out[tier] = {"eager": got, "window": [
            float(v) for v in torch.as_tensor(rep).reshape(-1)]}
    return out


SCENARIOS = (transports, training, windows)


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
        for scenario in SCENARIOS:
            out[scenario.__name__] = scenario(inputs, rank, world)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    if "error" in out:
        raise SystemExit(1)
