"""Port parity: partition rules that place a leaf on the data, seq or
stage axis (``parallel/tensor.py``'s ``mean`` levels, ``parallel/ladder.py``,
``engine.py``, ``facade.py``, ``io_ops.py``) against the JAX package on the
same meshes and rules, whose overrides win over the tier for the
parameter, its gradient and its optimizer state
(``stoke_tpu/parallel/sharding.py:153-190``).

A gloo world of 4 (``tests/_torch_data_axes_worker.py``) is spawned once
for the module through a file store, and the JAX references are computed
on 4 CPU devices while it runs; the join has a 240 s deadline. The JAX
parameters are drawn at ``jax.eval_shape`` shapes from a numpy seed. The
runs:

- ``("data",)`` of 4: GPT-tiny with ``ff_in/kernel`` on ``(None,
  "data")``, under dp and under oss (the rule wins over the tier);
- ``("data", "model")`` (2, 2): GPT-tiny under the 2-D rules (the Megatron
  set with each kernel's other dim on the data axis, the embedding's
  hidden dim on it), under dp at ``grad_accum=2`` and under fsdp with the
  int8 ``rs_ag`` transport;
- ``("data", "seq")`` (2, 2): GPT-tiny with ``shard_seq_dim=1`` (ring
  attention in the port, dense in JAX) and ``pos_emb/embedding`` on
  ``("seq", None)``;
- ``("data", "stage")`` (2, 2): PipelinedLM-tiny with the block's
  attention leaves on the stage axis (part of the stage set: no pipeline,
  gathered placements), and with the embedding on the stage axis beside
  the stage set.

Each trains three AdamW steps on the global batch: the losses and the
whole weights after each step within rtol 5e-4, atol 5e-6 of the JAX
``Stoke``; each rank's slice of each leaf (what its optimizer steps on)
equals the JAX addressable shard of the device at the same mesh
coordinate exactly at the start and within the tolerance after the
steps; each rank's bytes of parameters and of AdamW's two moments equal
the JAX shards' on its device; the transport's accounting equals JAX's.
The 2-D run under fsdp has its sharded emergency tag resume bit for bit
(the transport's residual too) and load at world 1 into the unsplit
model as the consolidated tag's arrays exactly. The 2-D run under dp
clips its norm (each leaf's squares summed over its own group).

In this process, at world 1: each of the four meshes at all ones trains
bit for bit against the run without the new placements.
"""

import json
import os
import pickle
import re
import sys
import time

import jax
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

import stoke_tpu
from stoke_tpu import configs as jc
from stoke_tpu.models import GPT as JaxGPT
from stoke_tpu.models import PipelinedLM as JaxPipelinedLM
from stoke_tpu.models import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu_torch import Stoke, StokeOptimizer, io_ops
from stoke_tpu_torch import configs as pc
from stoke_tpu_torch.convert import (
    gpt_state_dict_from_jax,
    jax_param_layout,
    pipelined_lm_state_dict_from_jax,
)
from stoke_tpu_torch.models import (
    GPT,
    bert_tensor_parallel_rules,
    causal_lm_loss,
)
from stoke_tpu_torch.models.pipelined_lm import (
    PipelinedLM,
    pipeline_parallel_rules,
)
from stoke_tpu_torch.parallel.zero import residual_to_flat

sys.path.insert(0, os.path.dirname(__file__))
import _torch_data_axes_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

WORLD = 4
JOIN_TIMEOUT_S = 240
VOCAB, LEN, BATCH, SEQ = 64, 32, 4, 16
TOL = dict(rtol=5e-4, atol=5e-6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's torch work (the spawned ranks
    take one each too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_process_group():
    """The world-1 runs' one-process group (made by the first ``Stoke``
    with ``distributed="dp"``), torn down after the module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _draw(shapes, seed):
    """A params tree at ``shapes`` from a numpy seed (LayerNorm scales
    near 1, small biases and weights)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.normal(size=leaf.shape)
        name = path[-1].key
        x = 1.0 + 0.1 * x if name == "scale" else x * (
            0.02 if name == "bias" else 0.05)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _mesh(name):
    shape, axes = worker.RUNS[name][2], worker.RUNS[name][1]
    return Mesh(np.asarray(jax.devices("cpu")[:WORLD]).reshape(shape), axes)


def _gpt_model():
    return JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=LEN,
                  dropout_rate=0.0)


def _lm_model(mesh):
    return JaxPipelinedLM(mesh, vocab_size=VOCAB, size_name="tiny",
                          max_len=LEN, num_microbatches=2,
                          layers_per_stage=1, data_axis="data")


def _inputs():
    """The JAX params and the port's weights of each model, and the
    global batches."""
    r = np.random.default_rng(0)
    n = worker.STEPS * max(run[-1] for run in worker.RUNS.values())
    x = np.zeros((BATCH, SEQ), np.int32)
    model = _gpt_model()
    params = _draw(jax.eval_shape(lambda k: model.init(k, x, train=False),
                                  jax.random.PRNGKey(0))["params"], 1)
    out = {"gpt": {
        "vocab": VOCAB, "len": LEN, "batch": BATCH, "params": params,
        "weights": {k: v.numpy() for k, v in
                    gpt_state_dict_from_jax(params).items()},
        "batches": [r.integers(0, VOCAB, size=(BATCH, SEQ))
                    for _ in range(n)]}}
    params = _draw(jax.eval_shape(_lm_model(_mesh("embedding")).init,
                                  jax.random.PRNGKey(0))["params"], 4)
    out["lm"] = {
        "vocab": VOCAB, "len": LEN, "batch": BATCH, "params": params,
        "weights": {k: v.numpy() for k, v in
                    pipelined_lm_state_dict_from_jax(params).items()},
        "batches": [r.integers(0, VOCAB, size=(BATCH, SEQ))
                    for _ in range(n)]}
    return out


_INPUTS = {}


@pytest.fixture(scope="module")
def inputs():
    _INPUTS.update(_inputs())
    return _INPUTS


def _inputs_weights(kind):
    return _INPUTS[kind]["weights"]


def _spawn(inputs, tmp):
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
    send = {k: {n: v for n, v in d.items() if n != "params"}
            for k, d in inputs.items()}
    sent = os.path.join(tmp, "inputs.pt")
    torch.save(send, sent)
    procs = [ctx.Process(target=worker.run,
                         args=(r, WORLD, store, str(tmp), sent))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def _join(procs, tmp, started):
    deadline = started + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        pytest.fail(f"ranks {hung} still ran after {JOIN_TIMEOUT_S} s")
    out = []
    for r in range(WORLD):
        path = os.path.join(tmp, f"rank{r}.pt")
        if not os.path.exists(path):
            pytest.fail(f"rank {r} wrote nothing (exit code "
                        f"{procs[r].exitcode})")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            pytest.fail(f"rank {r} raised:\n{res['error']}")
        out.append(res)
    return out


def _shards(tree, devices):
    """Each leaf's addressable shards, by path, then device coordinate."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(p, "key", getattr(p, "name", None))
                    for p in path)
        out[key] = {
            tuple(int(c) for c in np.argwhere(devices == sh.device)[0]):
            np.asarray(sh.data) for sh in leaf.addressable_shards}
    return out


def _bytes_by_leaf(tree, devices, under=None):
    """Each leaf's bytes on each device: ``{path: {coordinate: bytes}}``
    (of the leaves under the path entry ``under``, by the path after it)."""
    out = {}
    for key, shards in _shards(tree, devices).items():
        if under is not None:
            if under not in key:
                continue
            key = key[key.index(under) + 1:]
        out[key] = {c: a.nbytes for c, a in shards.items()}
    return out


def _jax_train(name, inputs):
    """The JAX package's ``Stoke`` on the run's mesh with the same rules,
    tier, transport and ``grad_accum``: the addressable shards of its
    parameters at the start and at the end, the losses and the weights
    (the port's names) after each optimizer step, each device's bytes of
    parameters and moments, and the transport's accounting."""
    kind, axes, shape, tier, int8, rules, accum = worker.RUNS[name]
    g = inputs[kind]
    mesh = _mesh(name)
    if kind == "lm":
        model, conv, kw = (_lm_model(mesh), pipelined_lm_state_dict_from_jax,
                           {})
    else:
        model, conv = _gpt_model(), gpt_state_dict_from_jax
        kw = dict(model_train_kwargs={"train": True},
                  model_eval_kwargs={"train": False})
    cfgs = [stoke_tpu.MeshConfig(axes=axes, shape=shape,
                                 devices=jax.devices("cpu")[:WORLD]),
            stoke_tpu.PartitionRulesConfig(rules=worker.RULES[rules]),
            jc.OSSConfig(min_shard_size=1), jc.SDDPConfig(min_shard_size=1),
            jc.FSDPConfig(min_weight_size=1)]
    if int8:
        cfgs.append(jc.CommConfig(dtype="int8", strategy="rs_ag",
                                  **worker.COMM))
    if "seq" in axes:
        cfgs.append(jc.DataParallelConfig(shard_seq_dim=1))
    a = worker.ADAMW
    if name in worker.CLIPPED:
        kw["grad_clip"] = stoke_tpu.ClipGradNormConfig(max_norm=worker.CLIP)
    s = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.adamw, optimizer_kwargs=dict(
                learning_rate=a["lr"], b1=a["betas"][0], b2=a["betas"][1],
                eps=a["eps"], weight_decay=a["weight_decay"])),
        jax_causal_lm_loss,
        {"params": jax.tree_util.tree_map(np.array, g["params"])},
        batch_size_per_device=BATCH // shape[0], verbose=False,
        distributed="dp", grad_accum=accum, configs=cfgs,
        **worker.TIERS[tier], **kw)
    devices = s.mesh.devices
    start = _shards(s.params, devices)
    losses, weights = [], []
    for b in g["batches"][:worker.STEPS * accum]:
        b = b.astype(np.int32)
        losses.append(float(s.train_step(b, (b,))))
        if len(losses) % accum == 0:
            weights.append({k: v.numpy() for k, v in conv(
                jax.tree_util.tree_map(np.asarray, s.params)).items()})
    nbytes = {"param": _bytes_by_leaf(s.params, devices)}
    for k in ("mu", "nu"):
        nbytes[k] = _bytes_by_leaf(s.opt_state, devices, k)
    return {"start": start, "end": _shards(s.params, devices),
            "losses": losses, "weights": weights, "bytes": nbytes,
            "comm_bytes": s.comm_bytes}


@pytest.fixture(scope="module")
def run(inputs, tmp_path_factory):
    """The spawned world's per-rank results and the JAX references,
    computed while the world runs."""
    tmp = tmp_path_factory.mktemp("data_axes")
    started = time.monotonic()
    procs = _spawn(inputs, tmp)
    try:
        refs = {name: _jax_train(name, inputs) for name in worker.RUNS}
    finally:
        world = _join(procs, tmp, started)
    return world, refs


# ---------------------------------------------------------------------- #
# training, placement and bytes
# ---------------------------------------------------------------------- #


def _close(got: dict, want: dict, lossy: bool, what: str,
           share: float = 5e-3) -> None:
    """Each array of ``got`` within TOL of ``want``'s. Under the int8
    transport (``lossy``) a gradient element within float noise of a
    rounding threshold lands one int8 level off (the port and XLA reduce
    in other orders), which AdamW turns into up to a step's move (lr) of
    that weight; the next steps' gradients then move a little everywhere
    and cross more thresholds (the Megatron rules alone, in the same run
    of this test on the CPU: 3, 55 and 195 of 409088 weights after
    steps 1 to 3). There at most ``share`` of the elements may lie
    outside TOL, each within 4·lr·STEPS."""
    if not lossy:
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, err_msg=f"{what} {k}",
                                       **TOL)
        return
    off = total = 0
    for k, v in want.items():
        bad = ~np.isclose(got[k], v, **TOL)
        off += int(bad.sum())
        total += bad.size
        assert np.all(np.abs(got[k] - v)[bad]
                      <= 4 * worker.ADAMW["lr"] * worker.STEPS), (what, k)
    assert off <= share * total, (what, off, total)


@pytest.mark.parametrize("name", list(worker.RUNS))
def test_data_axes_match_jax(run, name):
    """Every rank's losses and whole weights after each optimizer step
    against the JAX package on the same mesh, rules and tier."""
    world, refs = run
    ref = refs[name]
    lossy = worker.RUNS[name][4]
    for res in world:
        got = res["train"][name]
        np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
        assert len(got["weights"]) == len(ref["weights"]) == worker.STEPS
        for step, want in enumerate(ref["weights"]):
            # one step: only the first flips
            _close(got["weights"][step], want, lossy, f"step {step}",
                   1e-4 if step == 0 else 5e-3)


def _unsplit(kind):
    if kind == "lm":
        return PipelinedLM(vocab_size=VOCAB, size_name="tiny", max_len=LEN,
                           num_microbatches=2, layers_per_stage=1, stages=2)
    return GPT(vocab_size=VOCAB, size_name="tiny", max_len=LEN)


#: the cuts each run must show: leaf -> (its group's axes, its mean axes)
CUTS = {
    "data_dp": {"layers.0.ff_in.weight": (("data",), ("data",))},
    "two_d": {
        "layers.0.attention.qkv.weight": (("model", "data"), ("data",)),
        "layers.0.attention.qkv.bias": (("model",), ()),
        "layers.1.attention.out.weight": (("model", "data"), ("data",)),
        "layers.0.ff_in.weight": (("model", "data"), ("data",)),
        "layers.0.ff_in.bias": (("model",), ()),
        "layers.1.ff_out.weight": (("model", "data"), ("data",)),
        "tok_emb.weight": (("data",), ("data",))},
    "seq": {"pos_emb.weight": (("seq",), ("seq",))},
    "part_of_the_set": {
        "stages.block_0.attention.qkv.weight": (("stage",), ())},
    "embedding": {"embed.tok": (("stage",), ()),
                  "stages.block_0.ff_in.weight": (("stage",), ())},
}


@pytest.mark.parametrize("name", list(worker.RUNS))
def test_slices_are_jax_shards(run, name):
    """Each rank's slice of each leaf a rule places (under oss and fsdp of
    every leaf: its data slice) equals exactly the JAX addressable shard
    of the device at the same mesh coordinate at the start, and within
    the tolerance after the steps. The cuts name the rules' axes; under
    the 2-D rules the blocks keep the Megatron split (the data level is a
    level inside it)."""
    world, refs = run
    kind, tier = worker.RUNS[name][0], worker.RUNS[name][3]
    layout = jax_param_layout(_unsplit(kind))
    coords = set()
    for res in world:
        got = res["train"][name]
        coords.add(got["coords"])
        placed = set(got["cuts"])
        for when in ("start", "end"):
            shards = refs[name][when]
            ports, wants = {}, {}
            for n, held in got[when].items():
                if tier != "fsdp" and n not in placed:
                    continue
                path, perm, _ = layout[n]
                wants[n] = shards[tuple(path)][got["coords"]]
                port = held.transpose(perm) if perm is not None else held
                ports[n] = port.reshape(wants[n].shape)
                if when == "start":
                    assert np.array_equal(ports[n], wants[n]), n
            if when == "end":
                _close(ports, wants, worker.RUNS[name][4], "end")
        want_cuts = dict(CUTS.get(name.replace("_oss", "_dp").replace(
            "_fsdp", ""), {}))
        for n, v in want_cuts.items():
            assert got["cuts"][n] == v, n
        if name.startswith("two_d"):
            assert got["split"].count("MultiHeadAttention") == 2
            assert got["split"].count("TransformerBlock") == 2
        elif kind == "lm":
            # the pipeline runs under the stage set alone
            assert got["split"] == (["PipelinedLM"] if name == "embedding"
                                    else [])
    assert len(coords) == WORLD


@pytest.mark.parametrize("name", list(worker.RUNS))
def test_state_bytes_are_jax(run, name):
    """Each rank's bytes of each parameter and of its AdamW moments equal
    the JAX shards' on the device at its mesh coordinate. Where a rule is
    anchored at the path's start (``^stages/``, ``^embed/tok``) the JAX
    package matches it against the parameter's path but not against its
    moments' (``0/mu/stages/...``), so there the JAX moments stay whole
    while the port's follow the parameter's slice (ROADMAP, documented
    divergences)."""
    world, refs = run
    want = refs[name]["bytes"]
    kind, rules = worker.RUNS[name][0], worker.RUNS[name][5]
    layout = jax_param_layout(_unsplit(kind))
    whole = {n: v.nbytes for n, v in _inputs_weights(kind).items()}
    for res in world:
        got = res["train"][name]
        c = got["coords"]
        for n, b in got["bytes"].items():
            path = tuple(layout[n][0])
            assert b["param"] == want["param"][path][c], n
            anchored = any(
                rx.startswith("^") and re.search(rx, "/".join(path))
                for rx, _ in worker.RULES[rules])
            for k, j in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                if anchored:
                    assert want[j][path][c] == whole[n], n
                    assert b[k] == b["param"], n
                else:
                    assert b[k] == want[j][path][c], (n, k)


def test_transport_accounting_is_jax(run):
    """The int8 transport over the 2-D placement: the accounting is the
    JAX package's analytic bytes, on every rank."""
    world, refs = run
    want = refs["two_d_fsdp"]["comm_bytes"]
    assert want
    for res in world:
        assert res["train"]["two_d_fsdp"]["comm_bytes"] == want


def test_parameter_counts_are_whole(run, inputs):
    """The parameter count on every rank is the whole model's."""
    world, _ = run
    for name, (kind, *_) in worker.RUNS.items():
        want = sum(v.size for v in inputs[kind]["weights"].values())
        assert {res["train"][name]["params"] for res in world} == {want}


# ---------------------------------------------------------------------- #
# the sharded format
# ---------------------------------------------------------------------- #


def _read(tag):
    with open(os.path.join(tag, "meta.json")) as f:
        meta = json.load(f)
    return meta, {k: io_ops._read_key(tag, k, meta)[0]
                  for k in ("variables", "opt_state")}


def test_sharded_tag_resumes_bit_for_bit(run):
    """The 2-D fsdp run's sharded emergency tag: its arrays, put together
    level by level, are the consolidated tag's exactly; every sliced leaf
    is in the files of exactly its writers, one writer a slice, and the
    data level is named; a fresh run resumes it, and the next step's
    losses, weights and transport residual are the uninterrupted run's
    bit for bit."""
    world, _ = run
    got = world[0]["formats"]
    meta, arrays = _read(got["tag"])
    _, cons = _read(got["cons"])
    for key in arrays:
        assert sorted(arrays[key]) == sorted(cons[key]), key
        for n, a in cons[key].items():
            assert np.array_equal(arrays[key][n], a), (key, n)
    files = {}
    for f in got["files"]:
        if ".rank" in f:
            key, r = f.split(".rank")
            with np.load(os.path.join(got["tag"], f)) as z:
                files[(key, int(r.split(".")[0]))] = set(z.files)
    cut_axes = set()
    for key, leaves in meta["leaves"].items():
        for label, leaf in leaves.items():
            writers = [r for row in leaf["ranks"] for r in row]
            assert len(writers) == len(set(writers)), (key, label)
            holders = {r for (k, r), names in files.items()
                       if k == key and label in names}
            assert holders == set(writers), (key, label)
            cut = leaf.get("cut")
            while cut is not None:
                cut_axes.add(tuple(cut["axes"]))
                cut = cut.get("inner")
    assert {("model",), ("data",)} <= cut_axes
    for res in world:
        mine = res["formats"]
        assert mine["resumed"]
        a, b = mine["runs"]
        assert a["losses"] == b["losses"]
        for k, v in a["weights"].items():
            assert np.array_equal(v, b["weights"][k]), k
        assert all(np.array_equal(x, y)
                   for x, y in zip(a["residual"], b["residual"]))


def test_sharded_tag_loads_at_world_one(run):
    """The 2-D fsdp run's sharded emergency tag resumed by the unsplit
    model at world 1 (no mesh, no rules; fsdp and the same transport):
    the weights are the consolidated tag's arrays exactly, and the
    residual is the saved one remapped to this world's layout."""
    world, _ = run
    got = world[0]["formats"]
    root = os.path.dirname(got["tag"])
    s = Stoke(_unsplit("gpt"), StokeOptimizer(torch.optim.AdamW,
                                              **worker.ADAMW),
              causal_lm_loss, batch_size_per_device=2, device="cpu",
              distributed="dp", fsdp=True,
              configs=[pc.FSDPConfig(min_weight_size=1),
                       pc.CommConfig(dtype="int8", strategy="rs_ag",
                                     **worker.COMM),
                       pc.ResilienceConfig(save_path=root,
                                           exit_on_preempt=False)])
    assert s.resume()
    _, arrays = _read(got["cons"])
    with s._whole_params():
        for n, t in s.model_access.state_dict().items():
            assert np.array_equal(t.detach().clone().numpy(),
                                  arrays["variables"][n]), n
    with open(os.path.join(got["tag"], "extras.pkl"), "rb") as f:
        saved = pickle.load(f)["resilience"]
    live = [r.numpy() for r in s._engine.comm_state["residual"]]
    assert np.array_equal(
        residual_to_flat(live, s._comm_layout()),
        residual_to_flat(saved["comm_state"]["residual"],
                         saved["comm_layout"]))
    s.close_telemetry()


# ---------------------------------------------------------------------- #
# world 1
# ---------------------------------------------------------------------- #


#: mesh -> (its axes, the rules with the new placements, the rules
#: without them)
WORLD_ONE = {
    "data": (("data",), worker.RULES["ff_in_data"], None),
    "data_model": (("data", "model"), worker.TWO_D_RULES,
                   bert_tensor_parallel_rules()),
    "data_model_tuple": (("data", "model"),
                         ((r"ff_in/kernel", (None, ("data", "model"))),),
                         None),
    "data_seq": (("data", "seq"), worker.RULES["pos_seq"], None),
    "data_stage_dim_1": (("data", "stage"),
                         ((r"^stages/", (None, "stage", "...")),), None),
    "data_stage_part": (("data", "stage"),
                        worker.RULES["part_of_the_set"], None),
    "data_stage_embedding": (("data", "stage"), worker.RULES["embedding"],
                             pipeline_parallel_rules()),
}


@pytest.mark.parametrize("mesh", list(WORLD_ONE))
def test_world_one_is_bit_for_bit(mesh):
    """At world 1 each mesh at all ones trains (AdamW, a norm clip, four
    four-call micro-steps at ``grad_accum=2``, then four ``train_step``s)
    bit for bit against the same run without the new placements; the new
    rules cut their leaves into one slice each, and under the 2-D rules
    each block keeps its Megatron split with the data level inside it.
    Every rule of the converted refusal cases builds a ``Stoke`` that
    trains (the tuple ``(None, ("data", "model"))``, the three stage
    placements)."""
    axes, rules, without = WORLD_ONE[mesh]
    lm = "stage" in axes
    r = np.random.default_rng(7)
    batches = [torch.from_numpy(r.integers(0, VOCAB, size=(2, SEQ)))
               for _ in range(4)]
    got = []
    for rs in (rules, without):
        m = _unsplit("lm") if lm else GPT(vocab_size=VOCAB, size_name="tiny",
                                          max_len=LEN, dropout_rate=0.0)
        m.init_weights(3)
        cfgs = [pc.MeshConfig(axes=axes, shape=(1,) * len(axes))]
        if rs is not None:
            cfgs.append(pc.PartitionRulesConfig(rules=rs))
        if "seq" in axes:
            cfgs.append(pc.DataParallelConfig(shard_seq_dim=1))
        s = Stoke(m, StokeOptimizer(torch.optim.AdamW, **worker.ADAMW),
                  causal_lm_loss, batch_size_per_device=2, device="cpu",
                  distributed="dp", grad_accum=2,
                  grad_clip=pc.ClipGradNormConfig(max_norm=0.5),
                  configs=cfgs)
        if rs is rules:
            tp = s.tensor_parallel
            assert any(c.parts == 1 and c.gathered_level is not None
                       for c in tp.cuts.values())
        if rs is worker.TWO_D_RULES:
            # split for compute: the Megatron cut on each block, the data
            # level inside it
            qkv = tp.cuts["layers.0.attention.qkv.weight"]
            assert not qkv.gathered and qkv.axes == ("model",)
            assert qkv.inner.mean and qkv.inner.axes == ("data",)
            assert all(b.attention.group is not None and b.group is not None
                       for b in s.model_access.layers)
        losses = []
        for b in batches:
            out = s.model(b)
            loss = s.loss(out, b)
            s.backward(loss)
            s.step()
            losses.append(float(loss))
        losses += [float(s.train_step(b, b)) for b in batches]
        got.append((losses, {n: p.detach().clone() for n, p in
                             s.model_access.named_parameters()}))
        s.close_telemetry()
    assert got[0][0] == got[1][0]
    for n, p in got[1][1].items():
        assert torch.equal(got[0][1][n], p), n
