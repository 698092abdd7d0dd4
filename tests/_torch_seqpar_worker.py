"""One rank of a sequence-parallel world of the port, for
``tests/test_torch_attention.py``.

Spawned 4 times by the test; each process joins a gloo group through a
file store, runs the scenarios below in the same order as the others, and
writes what it saw to ``{out_dir}/rank{r}.pt`` (a traceback instead when a
scenario raised). It imports torch and the port only: no JAX.
"""

from __future__ import annotations

import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

#: (data, seq) mesh shapes over the world of 4
MESHES = ((1, 4), (2, 2))
#: GPT-tiny under shard_seq_dim=1: attention and mesh of each run
GPT_RUNS = (("ring", (2, 2)), ("zigzag", (1, 4)), ("ulysses", (2, 2)))
GPT_LR, GPT_STEPS = 0.5, 2
#: the global view (no shard_seq_dim) on the (2, 2) mesh: every attention
GLOBAL_KINDS = ("ring", "zigzag", "ulysses", "flash")
#: the paths the global view runs under ring attention besides
#: train_step: the call pattern and the Stoke's flags of each
GLOBAL_PATHS = {"four_calls": {}, "window_oss": dict(oss=True),
                "sddp": dict(oss=True, sddp=True),
                "steps_fsdp_remat": dict(fsdp=True, remat=True)}
#: a length the 2 shards of the (2, 2) mesh do not divide (2·S + 1)
ODD_LEN = 5
#: ("data", "seq", "model") with the Megatron rules, no shard_seq_dim
THREE_AXES = ("data", "seq", "model")
THREE_SHAPE = (1, 2, 2)
#: the loader's and the rebalancer's rows (each carries its index)
N_ROWS, ROWS_BATCH, FEATURES, REBALANCE_STEPS = 256, 8, 4, 14
#: the process with the planted slow read (data row 1) and its delay a row
SLOW_RANK, SLOW_READ_S = 2, 0.003


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


def scoping(inputs, rank, world) -> dict:
    """On a (2, 2) ("data", "seq") mesh, the sequence shard kept to its
    Stoke's own calls: a mesh-less ``Stoke`` built after it computes the
    whole sequence, and the sharded one's logits and its
    ``loss(model(x), x)`` are unchanged by it."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import DataParallelConfig, MeshConfig
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

    out = {}
    s = stoke(DataParallelConfig(shard_seq_dim=1)).eval()
    d = s.mesh.get_local_rank("data")
    mine = torch.from_numpy(g["batches"][0][d * B:(d + 1) * B])
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


def _makers():
    from stoke_tpu_torch.ops import make_flash_attention
    from stoke_tpu_torch.ops.attention import (
        make_ring_attention,
        make_ulysses_attention,
        make_zigzag_ring_attention,
    )

    return {"ring": lambda: make_ring_attention(causal=True),
            "zigzag": make_zigzag_ring_attention,
            "ulysses": lambda: make_ulysses_attention(causal=True),
            "flash": lambda: make_flash_attention(causal=True)}


def _gpt_stoke(g, kind, shape, *configs, axes=("data", "seq"), remat=False,
               **flags):
    """GPT-tiny with the inputs' weights and ``kind``'s attention, trained
    by SGD under ``Stoke`` on a mesh of ``shape`` (the tiers shard every
    leaf)."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import (
        FSDPConfig,
        MeshConfig,
        OSSConfig,
        SDDPConfig,
    )
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss

    model = GPT(vocab_size=g["vocab"], size_name="tiny", max_len=g["len"],
                dropout_rate=0.0, attention_fn=_makers()[kind](),
                attention_is_causal=True, remat=remat)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in g["weights"].items()})
    return Stoke(model, StokeOptimizer(torch.optim.SGD, lr=GPT_LR),
                 causal_lm_loss,
                 batch_size_per_device=g["batches"][0].shape[0] // shape[0],
                 device="cpu", distributed="dp",
                 configs=[MeshConfig(axes=axes, shape=shape),
                          OSSConfig(min_shard_size=1),
                          SDDPConfig(min_shard_size=1),
                          FSDPConfig(min_weight_size=1), *configs], **flags)


def _mine(s, batches):
    """This process's rows of each global batch: its data coordinate's
    whole sequences (the processes of a data row take the same rows)."""
    d = s.mesh.get_local_rank("data")
    n = batches[0].shape[0] // s.mesh.size(0)
    return (d * n, (d + 1) * n), [torch.from_numpy(b[d * n:(d + 1) * n])
                                  for b in batches]


def _weights(s) -> dict:
    """The whole model's weights, as numpy (fsdp's slices and a model
    split's gathered)."""
    tp = s.tensor_parallel
    with s._whole_params():
        return {n: (tp.gather(n, t) if tp is not None else t)
                .detach().clone().numpy()
                for n, t in s.model_access.state_dict().items()}


def global_view(inputs, rank, world) -> dict:
    """GPT-tiny on the (2, 2) mesh without ``shard_seq_dim`` under every
    attention (zigzag on zigzag-ordered rows with ``positions=perm``):
    the eval logits of the first batch, each ``train_step``'s loss and
    the weights after it."""
    from stoke_tpu_torch.ops.attention import zigzag_permutation

    g = inputs["gpt"]
    shape = (2, 2)
    perm = zigzag_permutation(g["len"], shape[1])
    out = {}
    for kind in GLOBAL_KINDS:
        s = _gpt_stoke(g, kind, shape)
        rows, mine = _mine(s, g["batches"])
        kw = {}
        if kind == "zigzag":
            mine = [b[:, perm] for b in mine]
            kw = {"positions": torch.from_numpy(perm)}
        s.eval()
        logits = s.model(mine[0], **kw).numpy()
        s.train()
        losses, weights = [], []
        for b in mine[:GPT_STEPS]:
            losses.append(float(s.train_step(b, b, model_kwargs=kw)))
            weights.append(_weights(s))
        out[kind] = {"rows": rows, "logits": logits, "losses": losses,
                     "weights": weights,
                     "view": (s.seq_shard.whole, s.seq_shard.size)}
        s.close_telemetry()
    return out


def global_paths(inputs, rank, world) -> dict:
    """Under the global view with ring attention on the (2, 2) mesh: the
    four calls (dp), ``train_step_window`` (oss), ``train_step`` (sddp),
    ``train_steps`` over both batches (fsdp with remat): the losses and
    the weights after each step (after both for ``train_steps``); and the
    oss run's save loaded by a dp Stoke."""
    g = inputs["gpt"]
    shape = (2, 2)
    out = {}
    for name, flags in GLOBAL_PATHS.items():
        s = _gpt_stoke(g, "ring", shape, **flags)
        _, mine = _mine(s, g["batches"][:GPT_STEPS])
        losses, weights = [], []
        if name.startswith("steps"):
            stacked = torch.stack(mine)
            losses = [float(v) for v in
                      s.train_steps(stacked, stacked).reshape(-1)]
            weights.append(_weights(s))
            mine = []
        for b in mine:
            if name == "four_calls":
                loss = s.loss(s.model(b), b)
                s.backward(loss)
                s.step()
            elif name.startswith("window"):
                loss = s.train_step_window(b[None], b[None])[0]
            else:
                loss = s.train_step(b, b)
            losses.append(float(loss))
            weights.append(_weights(s))
        out[name] = {"losses": losses, "weights": weights}
        if name == "window_oss":
            path = f"{inputs['out_dir']}/global_ckpt"
            s.save(path)
            loaded = _gpt_stoke(g, "ring", shape)
            loaded.load(path)
            out["loaded"] = {"weights": _weights(loaded),
                             "steps": loaded.optimizer_steps}
            loaded.close_telemetry()
        s.close_telemetry()
    return out


def global_draws(inputs, rank, world) -> dict:
    """Under the global view on the (2, 2) mesh, GPT-tiny-MoE (4 experts
    every 2nd block, router noise 0.1) with residual dropout 0.1 and ring
    attention: the weights and the aux losses after each of two steps.
    A data row's processes draw the same masks and noise, and take the
    MoE's batch means over the data sub-group."""
    from torch.utils._pytree import tree_leaves

    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import MeshConfig
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss

    g = inputs["gpt"]
    shape = (2, 2)
    model = GPT(vocab_size=g["vocab"], size_name="tiny", max_len=g["len"],
                dropout_rate=0.1, attention_fn=_makers()["ring"](),
                attention_is_causal=True, moe_num_experts=4,
                moe_router_noise=0.1)
    for block in model.layers:
        block.attention.prob_dropout.rate = 0.0
    model.init_weights(0)
    s = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=GPT_LR),
              causal_lm_loss,
              batch_size_per_device=g["batches"][0].shape[0] // shape[0],
              device="cpu", distributed="dp",
              configs=[MeshConfig(axes=("data", "seq"), shape=shape)])
    rows, mine = _mine(s, g["batches"])
    weights, aux = [], []
    for b in mine[:GPT_STEPS]:
        s.train_step(b, b)
        weights.append(_weights(s))
        aux.append([float(v) for v in tree_leaves(s.aux_losses)])
    s.close_telemetry()
    return {"rows": rows, "weights": weights, "aux": aux}


def indivisible(inputs, rank, world) -> dict:
    """Under ``shard_seq_dim=1`` on the (2, 2) mesh, rows of
    ``ODD_LEN`` tokens (which 2 shards do not divide) with flash
    attention: the eval logits and loss, one ``train_step`` and the same
    step by ``train_step_window``, and the view each call took; with ring
    attention, the message the adapter raises at that length."""
    from stoke_tpu_torch.configs import DataParallelConfig

    g = inputs["gpt"]
    shape = (2, 2)
    cfg = DataParallelConfig(shard_seq_dim=1)
    s = _gpt_stoke(g, "flash", shape, cfg)
    rows, mine = _mine(s, g["batches"])
    x = mine[0][:, :ODD_LEN]
    s.eval()
    logits = s.model(x)
    out = {"rows": rows, "logits": logits.numpy(),
           "eval_loss": float(s.loss(logits, x)),
           "eval_view": logits._stoke_seq_view.whole,
           # a length the shards divide, on the same Stoke: the sharded view
           "divisible_view": s.model(mine[0])._stoke_seq_view.whole}
    s.train()
    out["loss"] = float(s.train_step(x, x))
    out["weights"] = _weights(s)
    w = _gpt_stoke(g, "flash", shape, cfg)
    out["window_loss"] = float(w.train_step_window(x[None], x[None])[0])
    out["window_weights"] = _weights(w)
    r = _gpt_stoke(g, "ring", shape, cfg).eval()
    try:
        r.model(x)
        out["ring_message"] = ""
    except ValueError as e:
        out["ring_message"] = str(e)
    for t in (s, w, r):
        t.close_telemetry()
    return out


def three_axes(inputs, rank, world) -> dict:
    """GPT-tiny on a (1, 2, 2) ("data", "seq", "model") mesh with the
    Megatron rules and ring attention, without ``shard_seq_dim``: each
    step's loss and the whole weights after it."""
    from stoke_tpu_torch.configs import PartitionRulesConfig
    from stoke_tpu_torch.models import bert_tensor_parallel_rules

    g = inputs["gpt"]
    s = _gpt_stoke(g, "ring", THREE_SHAPE, PartitionRulesConfig(
        rules=bert_tensor_parallel_rules()), axes=THREE_AXES)
    _, mine = _mine(s, g["batches"])
    losses, weights = [], []
    for b in mine[:GPT_STEPS]:
        losses.append(float(s.train_step(b, b)))
        weights.append(_weights(s))
    s.close_telemetry()
    return {"losses": losses, "weights": weights,
            "view": (s.seq_shard.whole, s.seq_shard.size)}


class IdRows:
    """Rows that carry their own index; reads sleep where ``slow``."""

    def __init__(self, slow: bool = False):
        self.slow = slow

    def __len__(self):
        return N_ROWS

    def __getitem__(self, i):
        if self.slow:
            time.sleep(SLOW_READ_S)
        return np.full((FEATURES,), i, np.float32), np.float32(i)


def _rows_stoke(*configs):
    """A linear model on the (2, 2) ("data", "seq") mesh, fed ``IdRows``."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import MeshConfig

    return Stoke(nn.Linear(FEATURES, 1), StokeOptimizer(torch.optim.SGD,
                                                        lr=1e-4),
                 lambda out, y: ((out[:, 0] - y) ** 2).mean(),
                 batch_size_per_device=ROWS_BATCH, device="cpu",
                 distributed="dp",
                 configs=[MeshConfig(axes=("data", "seq"), shape=(2, 2)),
                          *configs])


def _sampler(data, **kw):
    from stoke_tpu_torch.data import BucketedDistributedSampler

    return BucketedDistributedSampler(
        data, buckets=1, batch_size=ROWS_BATCH,
        sorted_idx=list(range(N_ROWS)), seed=5, **kw)


def loader(inputs, rank, world) -> dict:
    """``Stoke.DataLoader`` on the (2, 2) mesh, with and without
    ``shard_seq_dim``, over a sampler built with the world's defaults:
    the row ids of its first two batches; and the message that refuses a
    sampler built for other replicas."""
    from stoke_tpu_torch.configs import DataParallelConfig

    data = IdRows()
    out = {}
    for name, cfgs in (("global", ()),
                       ("sharded", (DataParallelConfig(shard_seq_dim=1),))):
        s = _rows_stoke(*cfgs)
        it = iter(s.DataLoader(data, sampler=_sampler(data)))
        out[name] = [next(it)[1].numpy().astype(np.int64).tolist()
                     for _ in range(2)]
        try:
            s.DataLoader(data, sampler=_sampler(data, num_replicas=3,
                                                rank=0))
            out[f"{name}_refused"] = ""
        except ValueError as e:
            out[f"{name}_refused"] = str(e)
        s.close_telemetry()
    return out


def rebalance(inputs, rank, world) -> dict:
    """``FleetConfig(rebalance=True)`` on the (2, 2) mesh without
    ``shard_seq_dim``, the reads of one process of data row 1 slowed: the
    rows each step yields, the canonical plan of this data row, and after
    each step the exchanged matrix, the verdict and the shares."""
    from stoke_tpu_torch.configs import FleetConfig, TelemetryConfig

    tdir = f"{inputs['out_dir']}/rebalance/r{rank}"
    s = _rows_stoke(
        TelemetryConfig(output_dir=tdir, log_every_n_steps=1,
                        jsonl_all_ranks=True, prometheus=False,
                        tensorboard=False, sample_device_time=False),
        FleetConfig(window_steps=1, straggler_rel_frac=0.2,
                    straggler_windows=2, straggler_action="record",
                    rebalance=True, rebalance_rows=2,
                    rebalance_max_frac=0.5))
    data = IdRows(slow=rank == SLOW_RANK)
    d = s.mesh.get_local_rank("data")
    plan = _sampler(data, num_replicas=2, rank=d).global_batches()
    loader = s.DataLoader(data, sampler=_sampler(data))
    got, matrices, verdicts, shares = [], [], [], []
    for step, (x, y) in enumerate(loader):
        if step == REBALANCE_STEPS:
            break
        s.train_step(x, (y,))
        got.append(y.numpy().astype(np.int64).tolist())
        f = s.fleet
        matrices.append(None if f.last_matrix is None
                        else f.last_matrix.copy())
        verdicts.append(f.last_verdict)
        shares.append(list(loader._rebalancer.shares))
    rb = loader._rebalancer
    out = {"data": d, "batches": got,
           "plan": [p[d] for p in plan[:len(got)]], "matrices": matrices,
           "verdicts": verdicts, "shares": shares, "shifts": rb.shifts,
           "hosts": (rb.n_hosts, rb.rank),
           "stragglers": s.fleet_summary["straggler_events"]}
    s.close_telemetry()
    return out


SCENARIOS = (attention, gpt, scoping, global_view, global_paths, global_draws,
             indivisible, three_axes, loader, rebalance)


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
