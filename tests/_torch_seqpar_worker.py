"""One rank of a sequence-parallel world of the port, for
``tests/test_torch_attention.py``.

Spawned 4 times by the test; each process joins a gloo group through a
file store, runs the scenarios below in the same order as the others, and
writes what it saw to ``{out_dir}/rank{r}.pt`` (a traceback instead when a
scenario raised). It imports torch and the port only: no JAX.
"""

from __future__ import annotations

import traceback

import numpy as np
import torch
import torch.distributed as dist

#: (data, seq) mesh shapes over the world of 4
MESHES = ((1, 4), (2, 2))
#: GPT-tiny under shard_seq_dim=1: attention and mesh of each run
GPT_RUNS = (("ring", (2, 2)), ("zigzag", (1, 4)), ("ulysses", (2, 2)))
GPT_LR, GPT_STEPS = 0.5, 2


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "seq"))


def attention(inputs, rank, world) -> dict:
    """Ring, zigzag and Ulysses of this rank's shard on each mesh: the
    local output and the gradients of ``sum(out ** 2)`` in q, k and v."""
    from stoke_tpu_torch.ops.attention import (
        SeqShard,
        ring_attention,
        ulysses_attention,
        zigzag_ring_attention,
    )

    a = inputs["attention"]
    out = {}
    for shape in MESHES:
        mesh = _mesh(shape)
        seq = mesh.get_group("seq")
        d = mesh.get_local_rank("data")
        rows = slice(d * a["B"] // shape[0], (d + 1) * a["B"] // shape[0])
        for impl in ("ring", "zigzag", "ulysses"):
            layout = "zigzag" if impl == "zigzag" else "contiguous"
            shard = SeqShard(seq, dist.get_rank(seq), shape[1], layout)
            q, k, v = (shard.take(torch.from_numpy(a[n][rows]), 2)
                       .clone().requires_grad_() for n in ("q", "k", "v"))
            m = shard.take(torch.from_numpy(a["mask"][rows]), 1)
            if impl == "ring":
                o = ring_attention(q, k, v, m, shard=shard, causal=True,
                                   inner="flash")
            elif impl == "zigzag":
                o = zigzag_ring_attention(q, k, v, m, shard=shard)
            else:
                o = ulysses_attention(q, k, v, m, shard=shard, causal=True,
                                      inner="flash")
            o.backward(2 * o.detach())
            out[(shape, impl)] = {
                "rows": (rows.start, rows.stop),
                "pos": shard.global_index(q.shape[2]).numpy(),
                "out": o.detach().numpy(),
                "grads": [t.grad.numpy() for t in (q, k, v)]}
    return out


def gpt(inputs, rank, world) -> dict:
    """GPT-tiny trained by ``Stoke`` under ``shard_seq_dim=1`` on a
    ("data", "seq") mesh: the eval logits of the shard gathered to the
    whole sequence, each step's loss, and the weights after each step."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import DataParallelConfig, MeshConfig
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
    from stoke_tpu_torch.ops.attention import (
        make_ring_attention,
        make_ulysses_attention,
        make_zigzag_ring_attention,
    )

    g = inputs["gpt"]
    makers = {"ring": lambda: make_ring_attention(causal=True),
              "zigzag": make_zigzag_ring_attention,
              "ulysses": lambda: make_ulysses_attention(causal=True)}
    out = {}
    for impl, shape in GPT_RUNS:
        model = GPT(vocab_size=g["vocab"], size_name="tiny",
                    max_len=g["len"], dropout_rate=0.0,
                    attention_fn=makers[impl](), attention_is_causal=True)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in g["weights"].items()})
        B = g["batches"][0].shape[0] // shape[0]
        s = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=GPT_LR),
                  causal_lm_loss, batch_size_per_device=B, device="cpu",
                  distributed="dp",
                  configs=[MeshConfig(axes=("data", "seq"), shape=shape),
                           DataParallelConfig(shard_seq_dim=1)])
        d = s.mesh.get_local_rank("data")
        mine = [torch.from_numpy(b[d * B:(d + 1) * B]) for b in g["batches"]]
        s.eval()
        with torch.no_grad():
            logits = s.seq_shard.gather(s.model(mine[0]), 1)
        s.train()
        losses, weights = [], []
        for b in mine[:GPT_STEPS]:
            losses.append(float(s.train_step(b, b)))
            weights.append({k: v.detach().clone().numpy()
                            for k, v in s.model_access.state_dict().items()})
        out[impl] = {"rows": (d * B, (d + 1) * B), "logits": logits.numpy(),
                     "losses": losses, "weights": weights,
                     "layout": s.seq_shard.layout}
        s.close_telemetry()
    return out


def _message(fn) -> str:
    """The message of the ``NotImplementedError`` that ``fn()`` raises
    (an empty string when it returns)."""
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return ""


def scoping(inputs, rank, world) -> dict:
    """What ``Stoke`` refuses on a (2, 2) ("data", "seq") mesh, and its
    sequence shard kept to its own calls: a mesh-less ``Stoke`` built after
    it computes the whole sequence, and the sharded one's logits and its
    ``loss(model(x), x)`` are unchanged by it."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import (
        DataParallelConfig,
        FleetConfig,
        MeshConfig,
        TelemetryConfig,
    )
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
    from stoke_tpu_torch.ops.attention import make_ring_attention, seq_shard

    g = inputs["gpt"]
    shape = (2, 2)
    B = g["batches"][0].shape[0] // shape[0]

    def stoke(*configs, distributed="dp"):
        model = GPT(vocab_size=g["vocab"], size_name="tiny",
                    max_len=g["len"], dropout_rate=0.0,
                    attention_fn=make_ring_attention(causal=True),
                    attention_is_causal=True)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in g["weights"].items()})
        mesh = ([MeshConfig(axes=("data", "seq"), shape=shape)]
                if distributed else [])
        return Stoke(model, StokeOptimizer(torch.optim.SGD, lr=GPT_LR),
                     causal_lm_loss, batch_size_per_device=B, device="cpu",
                     distributed=distributed, configs=mesh + list(configs))

    out = {"no_shard_seq_dim": _message(lambda: stoke()),
           "rebalance": _message(lambda: stoke(
               DataParallelConfig(shard_seq_dim=1),
               TelemetryConfig(output_dir=f"{inputs['out_dir']}/tel{rank}"),
               FleetConfig(rebalance=True)))}
    s = stoke(DataParallelConfig(shard_seq_dim=1)).eval()
    d = s.mesh.get_local_rank("data")
    mine = torch.from_numpy(g["batches"][0][d * B:(d + 1) * B])
    out["indivisible"] = _message(lambda: s.model(mine[:, :-1]))
    with torch.no_grad():
        logits = s.model(mine)
        out["sharded"] = {"logits": s.seq_shard.gather(logits, 1).numpy(),
                          "loss": float(s.loss(logits, mine))}
        whole = stoke(distributed=None).eval()
        logits = whole.model(mine)
        out["whole"] = {"logits": logits.numpy(),
                        "loss": float(whole.loss(logits, mine))}
        out["sharded_after"] = s.seq_shard.gather(s.model(mine), 1).numpy()
    out["outside"] = seq_shard()
    s.close_telemetry()
    whole.close_telemetry()
    return out


SCENARIOS = (attention, gpt, scoping)


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
            out[scenario.__name__] = scenario({**inputs, "out_dir": out_dir},
                                              rank, world)
        dist.destroy_process_group()
    except BaseException:
        out = {"error": traceback.format_exc()}
    torch.save(out, f"{out_dir}/rank{rank}.pt")
    if "error" in out:
        raise SystemExit(1)
