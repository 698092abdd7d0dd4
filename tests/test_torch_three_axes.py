"""Port parity: meshes of three axes, ``dcn_axes`` and the gathered
placement (``parallel/mesh.py``, ``parallel/tensor.py``, ``engine.py``,
``facade.py``, ``io_ops.py``) against the JAX package on the same
meshes and rules.

A gloo world of 8 (``tests/_torch_three_axes_worker.py``) is spawned once
for the module through a file store, and the JAX references are computed
on the 8 CPU devices while it runs; the join has a 240 s deadline. Every
mesh is (2, 2, 2), and the JAX parameters are drawn at ``jax.eval_shape``
shapes from a numpy seed:

- GPT-tiny-MoE (4 experts, top-1, capacity 1.25) under ``("data",
  "model", "expert")`` with the Megatron and the expert rules, fsdp, the
  int8 ``rs_ag`` transport and a norm clip (each cut leaf's squares
  summed over its own group: an expert leaf's not over ``model``);
- GPT-tiny under the same mesh with ``ln_attn/scale`` on ``("model",)``
  and ``ff_in/kernel`` on ``(None, ("model", "expert"))`` (two gathered
  placements), sddp;
- GPT-tiny under ``("data", "seq", "model")`` with the Megatron rules,
  ``shard_seq_dim=1`` and ring attention (the JAX model runs its dense
  attention, which GSPMD splits), oss;
- PipelinedLM-tiny under ``("data", "stage", "model")`` with the qkv
  kernels also on ``model`` (a gathered level inside the stage cut)
  ahead of ``pipeline_parallel_rules``, GPipe, fsdp.

Each trains two SGD steps (momentum 0.9) on the global batch: the losses
and the whole weights after each step within rtol 5e-4, atol 5e-6 of the
JAX ``Stoke`` (``tests/test_torch_tensor_parallel.py``'s tolerance).
Each rank's slice of each leaf a rule places (of every leaf under fsdp)
equals, exactly, the JAX addressable shard of the device at the same
mesh coordinate. The sharded emergency tag of three runs writes no slice
twice, is the consolidated tag's arrays, resumes bit for bit under the
same mesh and loads at world 1 into the unsplit model; ``serve()``'s
whole copy gives the unsplit model's logits within 1e-5.

In this process: one MoE block over 2 x 2 virtual ``(model, expert)``
ranks against the unsplit block (fp32, 1e-5), and at world 1 a
``("model", "expert")`` mesh (built with a data axis of 1 in front) and
``dcn_axes`` trained bit for bit against the unsplit run.
"""

import json
import os
import pickle
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
from stoke_tpu.models import (
    bert_tensor_parallel_rules as jax_bert_rules,
    moe_expert_parallel_rules as jax_moe_rules,
    pipeline_parallel_rules as jax_pp_rules,
)
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
    moe_expert_parallel_rules,
)
from stoke_tpu_torch.models.moe import MoETransformerBlock
from stoke_tpu_torch.models.pipelined_lm import PipelinedLM
from stoke_tpu_torch.parallel import ModelGroup, shard_module
from stoke_tpu_torch.parallel.zero import residual_to_flat

sys.path.insert(0, os.path.dirname(__file__))
import _torch_three_axes_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

WORLD = 8
JOIN_TIMEOUT_S = 240
VOCAB, LEN, BATCH, SEQ = 64, 32, 4, 16
MOE = dict(experts=4, capacity=1.25, top_k=1)
TOL = dict(rtol=5e-4, atol=5e-6)
SERVE_TOL = 1e-5
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)


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


def _mesh(axes):
    return Mesh(np.asarray(jax.devices("cpu")[:WORLD]).reshape(worker.SHAPE),
                axes)


def _gpt_model(moe: bool):
    kw = (dict(moe_num_experts=MOE["experts"],
               moe_capacity_factor=MOE["capacity"],
               moe_top_k=MOE["top_k"]) if moe else {})
    return JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=LEN,
                  dropout_rate=0.0, **kw)


def _lm_model():
    return JaxPipelinedLM(_mesh(worker.RUNS["stage"][1]), vocab_size=VOCAB,
                          size_name="tiny", max_len=LEN, num_microbatches=2,
                          layers_per_stage=1, data_axis="data")


def _inputs():
    """Every model's JAX params and collections, the port's weights and
    the global batches; a probe batch for the served copy."""
    r = np.random.default_rng(0)
    x = np.zeros((BATCH, SEQ), np.int32)
    out = {}
    for kind, seed in (("gpt", 1), ("moe", 2)):
        model = _gpt_model(kind == "moe")
        shapes = jax.eval_shape(lambda k: model.init(k, x, train=False),
                                jax.random.PRNGKey(0))
        params = _draw(shapes["params"], seed)
        out[kind] = {
            "vocab": VOCAB, "len": LEN, "batch": BATCH, "params": params,
            # the MoE's sown "losses" collection: the JAX engine adds the
            # aux losses only where the variables hold it
            "collections": jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape, a.dtype),
                {k: v for k, v in shapes.items() if k != "params"}),
            "weights": {k: v.numpy() for k, v in
                        gpt_state_dict_from_jax(params).items()},
            "batches": [r.integers(0, VOCAB, size=(BATCH, SEQ))
                        for _ in range(worker.STEPS)], **MOE}
    out["gpt"]["probe"] = r.integers(0, VOCAB, size=(2, SEQ))
    params = _draw(jax.eval_shape(_lm_model().init,
                                  jax.random.PRNGKey(0))["params"], 4)
    out["lm"] = {
        "vocab": VOCAB, "len": LEN, "batch": BATCH, "params": params,
        "weights": {k: v.numpy() for k, v in
                    pipelined_lm_state_dict_from_jax(params).items()},
        "batches": [r.integers(0, VOCAB, size=(BATCH, SEQ))
                    for _ in range(worker.STEPS)]}
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _spawn(inputs, tmp):
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
    send = {k: {n: v for n, v in d.items()
                if n not in ("params", "collections")}
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


def _jax_rules(name):
    return {"moe": jax_bert_rules() + jax_moe_rules(),
            "gathered": worker.GATHERED_RULES,
            "seq": jax_bert_rules(),
            "stage": worker.STAGE_QKV_RULE + jax_pp_rules()}[name]


def _jax_train(name, inputs):
    """The JAX package's ``Stoke`` on the run's (2, 2, 2) mesh with the
    same rules, tier and transport: the addressable shards of its
    parameters at the start (by path, then device coordinate), and the
    losses and weights (the port's names) after each SGD step."""
    kind, axes, tier, int8 = worker.RUNS[name]
    g = inputs[kind]
    if kind == "lm":
        model, conv, kw = _lm_model(), pipelined_lm_state_dict_from_jax, {}
    else:
        model, conv = _gpt_model(kind == "moe"), gpt_state_dict_from_jax
        kw = dict(model_train_kwargs={"train": True},
                  model_eval_kwargs={"train": False})
    if kind == "moe":
        kw.update(aux_loss_weight=worker.AUX_WEIGHT,
                  grad_clip=stoke_tpu.ClipGradNormConfig(
                      max_norm=worker.CLIP))
    cfgs = [stoke_tpu.MeshConfig(axes=axes, shape=worker.SHAPE,
                                 devices=jax.devices("cpu")[:WORLD]),
            stoke_tpu.PartitionRulesConfig(rules=_jax_rules(name)),
            jc.OSSConfig(min_shard_size=1), jc.SDDPConfig(min_shard_size=1),
            jc.FSDPConfig(min_weight_size=1)]
    if int8:
        cfgs.append(jc.CommConfig(dtype="int8", strategy="rs_ag",
                                  **worker.COMM))
    if "seq" in axes:
        cfgs.append(jc.DataParallelConfig(shard_seq_dim=1))
    s = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd, optimizer_kwargs=dict(
                learning_rate=worker.LR, momentum=worker.MOMENTUM)),
        jax_causal_lm_loss,
        {"params": jax.tree_util.tree_map(np.array, g["params"]),
         **g.get("collections", {})},
        batch_size_per_device=BATCH // worker.SHAPE[0], verbose=False,
        distributed="dp", configs=cfgs, **worker.TIERS[tier], **kw)
    devices = s.mesh.devices
    shards = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(s.params)[0]:
        key = tuple(p.key for p in path)
        shards[key] = {
            tuple(int(c) for c in np.argwhere(devices == sh.device)[0]):
            np.asarray(sh.data) for sh in leaf.addressable_shards}
    losses, weights = [], []
    for b in g["batches"]:
        b = b.astype(np.int32)
        losses.append(float(s.train_step(b, (b,))))
        weights.append({k: v.numpy() for k, v in conv(
            jax.tree_util.tree_map(np.asarray, s.params)).items()})
    return shards, losses, weights


@pytest.fixture(scope="module")
def run(inputs, tmp_path_factory):
    """The spawned world's per-rank results and the JAX references,
    computed while the world runs."""
    tmp = tmp_path_factory.mktemp("three_axes")
    started = time.monotonic()
    procs = _spawn(inputs, tmp)
    try:
        refs = {name: _jax_train(name, inputs) for name in worker.RUNS}
    finally:
        world = _join(procs, tmp, started)
    return world, refs


# ---------------------------------------------------------------------- #
# training and placement
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(worker.RUNS))
def test_three_axes_match_jax(run, name):
    """Every rank's losses and whole weights after each SGD step against
    the JAX package on the same mesh, rules and tier."""
    world, refs = run
    _, losses, weights = refs[name]
    for res in world:
        got = res["train"][name]
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        for step, ref in enumerate(weights):
            for k, v in ref.items():
                np.testing.assert_allclose(got["weights"][step][k], v,
                                           err_msg=f"{step} {k}", **TOL)


def _unsplit(kind):
    if kind == "lm":
        return PipelinedLM(vocab_size=VOCAB, size_name="tiny", max_len=LEN,
                           num_microbatches=2, layers_per_stage=1, stages=2)
    return GPT(vocab_size=VOCAB, size_name="tiny", max_len=LEN,
               **(dict(moe_num_experts=MOE["experts"]) if kind == "moe"
                  else {}))


@pytest.mark.parametrize("name", list(worker.RUNS))
def test_three_axes_placement_is_jax(run, name):
    """Each rank's slice of each leaf a rule places (under fsdp of every
    leaf: its data slice) equals exactly the JAX addressable shard of the
    device at the same mesh coordinate; the cut leaves name the axes of
    the rules (the experts only ``expert``, the gathered ``ff_in`` both
    axes, the stage stack's qkv ``stage`` then ``model``)."""
    world, refs = run
    shards = refs[name][0]
    kind, _, tier, _ = worker.RUNS[name]
    layout = jax_param_layout(_unsplit(kind))
    coords = set()
    for res in world:
        got = res["train"][name]
        coords.add(got["coords"])
        placed = set(got["cuts"])
        for n, held in got["held"].items():
            if tier != "fsdp" and n not in placed:
                continue
            path, perm, _ = layout[n]
            want = shards[tuple(path)][got["coords"]]
            port = held.transpose(perm) if perm is not None else held
            assert np.array_equal(port.reshape(want.shape), want), n
        cuts = got["cuts"]
        if name == "moe":
            assert cuts["layers.1.moe.w_in"] == (("expert",), False)
            assert cuts["layers.0.attention.qkv.weight"] == (("model",),
                                                            False)
        elif name == "gathered":
            assert cuts["layers.0.ff_in.weight"] == (("model", "expert"),
                                                     True)
            assert cuts["layers.1.ln_attn.weight"] == (("model",), True)
            assert len(cuts) == 4
        elif name == "stage":
            assert cuts["stages.block_0.attention.qkv.weight"] == (
                ("stage", "model"), True)
            assert cuts["stages.block_0.ln_ff.weight"] == (("stage",), False)
        else:
            assert all(v == (("model",), False) for v in cuts.values())
    assert len(coords) == WORLD


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


@pytest.mark.parametrize("name", worker.FORMAT_RUNS)
def test_sharded_tag_on_three_axes(run, name):
    """The sharded emergency tag: its arrays, put together level by
    level, are the consolidated tag's exactly; the layout names the
    mesh's three axes and each cut's; every sliced leaf is in the files
    of exactly its writers, one writer a slice (no slice written twice);
    a fresh run resumes it, and the next step's loss, weights and
    residual are the uninterrupted run's bit for bit."""
    world, _ = run
    got = world[0]["formats"][name]
    meta, arrays = _read(got["tag"])
    _, cons = _read(got["cons"])
    for key in arrays:
        assert sorted(arrays[key]) == sorted(cons[key]), key
        for n, a in cons[key].items():
            assert np.array_equal(arrays[key][n], a), (key, n)
    axes = list(worker.RUNS[name][1])
    assert meta["mesh"] == {"axes": axes, "shape": list(worker.SHAPE)}
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
    want = {"moe": {("model",), ("expert",)},
            "gathered": {("model",), ("model", "expert")},
            "stage": {("stage",), ("model",)}}[name]
    assert want <= cut_axes
    for res in world:
        mine = res["formats"][name]
        assert mine["resumed"]
        a, b = mine["runs"]
        assert a["loss"] == b["loss"]
        for k, v in a["weights"].items():
            assert np.array_equal(v, b["weights"][k]), k
        assert all(np.array_equal(x, y)
                   for x, y in zip(a["residual"], b["residual"]))


@pytest.mark.parametrize("name", worker.FORMAT_RUNS)
def test_sharded_tag_loads_at_world_one(run, name):
    """The sharded emergency tag resumed by the unsplit model at world 1
    (fsdp, the same transport): the weights are the gathered ones, and
    the residual is the saved one remapped to the world's layout."""
    world, _ = run
    got = world[0]["formats"][name]
    root = os.path.dirname(got["tag"])
    kind = worker.RUNS[name][0]
    m = _unsplit(kind)
    s = Stoke(m, StokeOptimizer(torch.optim.SGD, lr=worker.LR,
                                momentum=worker.MOMENTUM),
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


@pytest.mark.parametrize("name", worker.SERVE_RUNS)
def test_serve_takes_the_whole_copy(run, inputs, name):
    """``serve()``'s copy (every slice gathered, every group dropped)
    gives the logits of the unsplit model with the run's whole weights,
    within 1e-5, on every rank."""
    world, _ = run
    for res in world:
        got = res["serve"][name]
        assert all(got["groups"])
        m = _unsplit("gpt")
        m.load_state_dict({k: torch.from_numpy(v)
                           for k, v in got["weights"].items()})
        m.eval()
        with torch.no_grad():
            want = m(torch.from_numpy(inputs["gpt"]["probe"])).numpy()
        assert np.max(np.abs(got["logits"] - want)) <= SERVE_TOL


# ---------------------------------------------------------------------- #
# in this process
# ---------------------------------------------------------------------- #


def _moe_block():
    torch.manual_seed(0)
    return MoETransformerBlock(32, 4, 64, num_experts=4, dropout_rate=0.0,
                               capacity_factor=2.0, top_k=2)


def test_virtual_model_expert_block():
    """One MoE block under the Megatron and expert rules over 2 x 2
    virtual ``(model, expert)`` ranks: each rank's attention slice is
    its model coordinate's and its experts its expert coordinate's; the
    attention's partial sums over the model ranks and the experts'
    outputs over the expert ranks give the unsplit block's output
    (fp32, within 1e-5)."""
    whole = _moe_block()
    x = torch.randn(2, 6, 32)
    with torch.no_grad():
        ref = whole(x, None)
    rules = bert_tensor_parallel_rules() + moe_expert_parallel_rules()
    ranks = {}
    for m in range(2):
        for e in range(2):
            b = _moe_block()
            tp = shard_module(b, rules, {
                "model": ModelGroup(None, 2, m, "model"),
                "expert": ModelGroup(None, 2, e, "expert")})
            assert b.attention.group.axis == "model"
            assert b.moe.group.axis == "expert"
            assert b.attention.local_heads == 2 and b.moe.local_experts == 2
            assert tp.cuts["moe.w_in"].group_axes == ("expert",)
            ranks[(m, e)] = b
    for (m, e), b in ranks.items():
        assert torch.equal(b.moe.w_in, whole.moe.w_in[2 * e:2 * e + 2])
        assert torch.equal(b.attention.qkv.weight,
                           ranks[(m, 1 - e)].attention.qkv.weight)
    with torch.no_grad():
        y = sum(ranks[(m, 0)].attention.partial(x, None) for m in range(2))
        h = whole.ln_attn(x + y + whole.attention.out.bias)
        slot, gates = ranks[(0, 0)].moe.route(h)
        outs = []
        for e in range(2):
            moe = ranks[(0, e)].moe
            mine = moe.dispatch(h, slot)[2 * e:2 * e + 2]
            outs.append(moe.experts(mine))
        f = moe.combine(torch.cat(outs), slot, gates)
        out = whole.ln_ff(h + f)
    torch.testing.assert_close(out, ref, **BLOCK_TOL)


def _world_one(mesh_cfg, rules):
    m = GPT(vocab_size=VOCAB, size_name="tiny", max_len=LEN,
            dropout_rate=0.0, moe_num_experts=MOE["experts"])
    m.init_weights(3)
    cfgs = [] if mesh_cfg is None else [
        mesh_cfg, pc.PartitionRulesConfig(rules=rules)]
    return Stoke(m, StokeOptimizer(torch.optim.SGD, lr=worker.LR,
                                   momentum=worker.MOMENTUM),
                 causal_lm_loss, batch_size_per_device=2, device="cpu",
                 distributed="dp", aux_loss_weight=worker.AUX_WEIGHT,
                 configs=cfgs)


@pytest.mark.parametrize("mesh", ["model_expert", "dcn_axes"])
def test_world_one_meshes_are_bit_for_bit(mesh):
    """At world 1 a ``("model", "expert")`` mesh (its data axis of 1 in
    front) and a three-axis mesh with ``dcn_axes`` train GPT-tiny-MoE
    under both rule sets bit for bit against the run without a mesh."""
    cfg = {"model_expert": pc.MeshConfig(axes=("model", "expert")),
           "dcn_axes": pc.MeshConfig(axes=("data", "model", "expert"),
                                     dcn_axes=("data",))}[mesh]
    rules = bert_tensor_parallel_rules() + moe_expert_parallel_rules()
    r = np.random.default_rng(7)
    batches = [torch.from_numpy(r.integers(0, VOCAB, size=(2, SEQ)))
               for _ in range(2)]
    got = []
    for c in (cfg, None):
        s = _world_one(c, rules)
        if c is not None:
            assert s.mesh.mesh_dim_names == ("data", "model", "expert")
            assert s.tensor_parallel.cuts
        losses = [float(s.train_step(b, b)) for b in batches]
        got.append((losses, {n: p.detach().clone() for n, p in
                             s.model_access.named_parameters()}))
        s.close_telemetry()
    assert got[0][0] == got[1][0]
    for n, p in got[1][1].items():
        assert torch.equal(got[0][1][n], p), n
