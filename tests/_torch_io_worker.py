"""One rank of a data-parallel world of the port, for
``tests/test_torch_io_distributed.py``: checkpoints across processes.

Spawned W times by the test; each process joins a gloo group through a
file store, runs every scenario below in the same order as the others,
and writes what it saw to ``{out_dir}/rank{r}.pt`` (a traceback instead
when a scenario raised). The tags live under ``inputs["root"]``, shared
by the worlds the test spawns one after the other. It imports torch and
the port only: no JAX.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

import _torch_dp_worker as dpw

FORMATS = ("consolidated", "sharded")
#: micro-batches of the resume runs (grad_accum=2): the boundary tag
#: after BOUNDARY, the mid-window tag one later, the run on to the end
MICRO, BOUNDARY = 8, 4
GPT_VOCAB, GPT_LEN = 97, 16


def _ckpt(fmt: str, is_async: bool = False, **kw):
    from stoke_tpu_torch.configs import CheckpointConfig, CheckpointFormat

    return CheckpointConfig(format=CheckpointFormat(fmt),
                            async_save=is_async, **kw)


def _micro(s, batch, rank, world) -> float:
    x, y = batch
    loss = s.loss(s.model(dpw.rows(x, rank, world)), dpw.rows(y, rank, world))
    s.backward(loss)
    s.step()
    return float(loss)


def whole_state(s) -> dict:
    """The run's parameters and every optimizer state tensor, whole (the
    slices all-gathered), as numpy by name; every rank calls it."""
    ladder = s._ladder
    names = s._param_names()
    with s._whole_params():
        out = {n: p.detach().clone().numpy()
               for n, p in s.model_access.named_parameters()}
    index = s._leaf_index() if ladder is not None else {}
    for o, st in sorted(s.optimizer.state.items(), key=lambda kv: names[kv[0]]):
        n = names[o]
        for key, v in sorted(st.items()):
            if not torch.is_tensor(v):
                continue
            dim = ladder.sliced_dim(index[n]) if ladder is not None else None
            if dim is not None and v.dim():
                v = ladder.gather_slice(v, dim)
            out[f"{n}/{key}"] = v.detach().clone().numpy()
    return out


def resume(inputs, rank, world) -> dict:
    """Each tier x format x sync/async: a run saves at a boundary and
    mid-window and trains on; fresh runs load each tag and continue.
    Returns, per case, the saver's losses and weights, each resumed
    run's, and the tags' meta."""
    import json

    data = dpw.mlp_data(MICRO)
    root = os.path.join(inputs["root"], f"resume{world}")
    out = {}
    for tier in dpw.TIERS:
        for fmt in FORMATS:
            for is_async in (False, True):
                case = (tier, fmt, is_async)
                path = os.path.join(root, "_".join(map(str, case)))
                mk = lambda: dpw.mlp_stoke(  # noqa: E731
                    inputs, world, tier, grad_accum=2,
                    extra=[_ckpt(fmt, is_async)])
                s = mk()
                losses, tags = [], []
                for i, batch in enumerate(data):
                    if i in (BOUNDARY, BOUNDARY + 1):
                        tags.append((i, os.path.basename(
                            s.save(os.path.join(path, str(i))))))
                    losses.append(_micro(s, batch, rank, world))
                s.wait_for_checkpoint()
                s.barrier()
                res = {"losses": losses, "weights": dpw.weights(s),
                       "resumed": {}}
                for i, tag in tags:
                    r = mk()
                    r.load(os.path.join(path, str(i)))
                    got = [_micro(r, b, rank, world) for b in data[i:]]
                    res["resumed"][i] = {
                        "losses": got, "weights": dpw.weights(r)}
                    with open(os.path.join(path, str(i), tag,
                                           "meta.json")) as f:
                        meta = json.load(f)
                    res["resumed"][i]["meta"] = {
                        k: meta.get(k) for k in ("format", "world", "writer",
                                                 "leaves", "grad_local")}
                    res["resumed"][i]["files"] = sorted(os.listdir(
                        os.path.join(path, str(i), tag)))
                out[case] = res
    return out


def auto_resume(inputs, rank, world) -> dict:
    """The periodic auto-save every 2 steps of 5 and ``maybe_resume`` in
    a fresh run, under fsdp (sharded, async) and oss (consolidated,
    sync): the resumed run (at step 4) takes the fifth batch; its loss
    against the saver's."""
    data = dpw.mlp_data(5)
    out = {}
    for tier, fmt, is_async in (("fsdp", "sharded", True),
                                ("oss", "consolidated", False)):
        path = os.path.join(inputs["root"], f"auto{world}_{tier}")
        mk = lambda: dpw.mlp_stoke(  # noqa: E731
            inputs, world, tier, extra=[_ckpt(
                fmt, is_async, save_every_n_steps=2, auto_path=path)])
        s = mk()
        losses = [_micro(s, b, rank, world) for b in data]
        s.wait_for_checkpoint()
        s.barrier()
        r = mk()
        found = r.maybe_resume()
        out[(tier, fmt, is_async)] = {
            "found": found, "steps": r.optimizer_steps,
            "losses": losses[4:],
            "resumed": [_micro(r, b, rank, world) for b in data[4:]]}
    return out


def gpt_dropout(inputs, rank, world) -> dict:
    """GPT-tiny with dropout under fsdp, sharded and async, saved
    mid-window: the resumed run draws each rank's own masks again."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import FSDPConfig
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss

    ids = np.random.default_rng(4).integers(
        0, GPT_VOCAB, size=(6, 8, GPT_LEN)).astype(np.int32)
    path = os.path.join(inputs["root"], f"gpt{world}")

    def mk():
        model = GPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=GPT_LEN,
                    dropout_rate=0.1)
        model.init_weights(0)
        return Stoke(model, StokeOptimizer(torch.optim.AdamW, lr=1e-3),
                     causal_lm_loss, batch_size_per_device=8 // world,
                     device="cpu", distributed="dp", fsdp=True, grad_accum=2,
                     seed=3, configs=[FSDPConfig(min_weight_size=1),
                                      _ckpt("sharded", True)])

    def micro(s, b):
        x = dpw.rows(b, rank, world)
        loss = s.loss(s.model(x), x)
        s.backward(loss)
        s.step()
        return float(loss)

    s = mk()
    losses = []
    for i, b in enumerate(ids):
        if i == 3:
            s.save(path)
        losses.append(micro(s, b))
    s.wait_for_checkpoint()
    r = mk()
    r.load(path)
    return {"losses": losses, "resumed": [micro(r, b) for b in ids[3:]]}


def cross_world(inputs, rank, world) -> dict:
    """Tags across world sizes: each tier loads the one-process
    consolidated tag; W=4 loads W=2's sharded tag; each world saves a
    sharded and a consolidated tag of an fsdp run (for the next world and
    for one process). Whole states, as numpy, for the test to compare."""
    out = {"loaded_one": {}, "loaded_w2": None, "saved": None}
    for tier in dpw.TIERS:
        s = dpw.mlp_stoke(inputs, world, tier)
        s.load(inputs["one_tag"])
        out["loaded_one"][tier] = whole_state(s)
    if world == 4:
        s = dpw.mlp_stoke(inputs, world, "fsdp")
        s.load(os.path.join(inputs["root"], "xw2", "sharded"))
        out["loaded_w2"] = whole_state(s)
    base = os.path.join(inputs["root"], f"xw{world}")
    for fmt in FORMATS:
        # the same steps twice (gloo's sums are deterministic), one tag each
        s = dpw.mlp_stoke(inputs, world, "fsdp", extra=[_ckpt(fmt)])
        for batch in dpw.mlp_data(3):
            _micro(s, batch, rank, world)
        s.save(os.path.join(base, fmt))
    out["saved"] = whole_state(s)
    return out


def save_rank(inputs, rank, world) -> dict:
    """``save_rank=1``: rank 1 writes the tag (its ``meta.json`` names
    it)."""
    import json

    path = os.path.join(inputs["root"], f"save_rank{world}")
    s = dpw.mlp_stoke(inputs, world, "oss",
                      extra=[_ckpt("consolidated", save_rank=1)])
    _micro(s, dpw.mlp_data(1)[0], rank, world)
    tag = s.save(path)
    with open(os.path.join(tag, "meta.json")) as f:
        return {"writer": json.load(f)["writer"]}


def jax_resume(inputs, rank, world) -> dict:
    """The JAX package's consolidated tag (from a 2-device dp mesh,
    carried over by ``jax_checkpoint_to_port``) resumed under dp and
    fsdp: the losses of the batches after it."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import FSDPConfig
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss

    if world != 2:
        return {}
    out = {}
    for tier in ("dp", "fsdp"):
        model = GPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=GPT_LEN,
                    dropout_rate=0.0)
        s = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.1, momentum=0.9),
                  causal_lm_loss, batch_size_per_device=4, device="cpu",
                  distributed="dp", configs=[FSDPConfig(min_weight_size=1)],
                  **dpw.TIERS[tier])
        s.load(inputs["jax_tag_root"])
        losses = []
        for b in inputs["jax_after"]:
            x = dpw.rows(b, rank, world)
            losses.append(float(s.train_step(x, (x,))))
        out[tier] = losses
    return out


def serve_tiers(inputs, rank, world) -> dict:
    """``serve()`` after the same steps under dp, oss and fsdp: each
    rank's greedy streams."""
    from stoke_tpu_torch import Stoke, StokeOptimizer
    from stoke_tpu_torch.configs import FSDPConfig, OSSConfig, ServeConfig
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss

    cfg = ServeConfig(max_seqs=2, kv_block_size=8, max_seq_len=32,
                      max_new_tokens=5, prefill_pad_multiple=16)
    prompts = np.random.default_rng(7).integers(
        1, GPT_VOCAB, size=(2, 6)).astype(np.int32)
    out = {}
    for tier in ("dp", "oss", "fsdp"):
        model = GPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=32,
                    dropout_rate=0.0)
        model.init_weights(0)
        s = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.1),
                  causal_lm_loss, batch_size_per_device=2, device="cpu",
                  distributed="dp", configs=[
                      cfg, OSSConfig(min_shard_size=1),
                      FSDPConfig(min_weight_size=1)], **dpw.TIERS[tier])
        engine = s.serve()
        rids = [engine.submit(p) for p in prompts]
        engine.run()
        out[tier] = [list(engine.result(r).tokens) for r in rids]
    return out


SCENARIOS = (resume, auto_resume, gpt_dropout, cross_world, save_rank,
             jax_resume, serve_tiers)


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
