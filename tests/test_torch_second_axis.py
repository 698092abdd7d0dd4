"""Port parity: the DP / ZeRO tiers, the gradient transports, the sharded
checkpoint format and GPT's chunked head under a second mesh axis
(``parallel/ladder.py``, ``parallel/collectives.py``, ``parallel/zero.py``,
``facade.py``, ``io_ops.py``, ``ops/chunked_ce.py``) against the JAX
package's placement (``stoke_tpu/parallel/sharding.py:243-294``), its
transport on a two-axis mesh (``stoke_tpu/parallel/collectives.py:328-432``)
and its ``chunked_causal_lm_loss`` on the global batch.

A gloo world of 4 (``tests/_torch_second_axis_worker.py``) is spawned once
for the module through a file store, and the JAX references are computed
while it runs; the join has a 120 s deadline. Every mesh is (2, 2): the
data axis and ``seq`` (GPT-tiny, ``shard_seq_dim=1``, ring attention),
``model`` (GPT-tiny and BERT-tiny, the Megatron rules), ``expert``
(GPT-tiny-MoE, the expert rules, a norm clip) or ``stage``
(PipelinedLM-tiny, GPipe). The JAX parameters are drawn at
``jax.eval_shape`` shapes from a numpy seed.

- The tiers: oss, sddp and fsdp with every min size at 1, two SGD steps
  (momentum 0.9) on the global batch. GPT-tiny's losses within rtol 1e-3
  and each step's gradient within 1e-3 of its largest magnitude of JAX
  dp (``tests/test_torch_attention.py``'s measure); BERT, the MoE and
  PipelinedLM against the JAX ``Stoke`` with the same rules on a (2, 2)
  mesh, rtol 5e-4 and atol 5e-6 (``tests/test_torch_tensor_parallel.py``'s
  tolerance). The placement: each rank's slice of each leaf (what its
  optimizer steps on: the optimizer state's placement; the parameters'
  under fsdp) at the start equals, exactly, the JAX addressable shard of
  the device with the same (data, X) coordinate under the JAX rules of
  the tier, with the fused ``qkv`` bias the documented exception (ROADMAP
  Queue 3); the momentum is held in the same shape.
- The transports: int8 and bf16 under ``all_reduce`` and ``rs_ag`` on
  the model and seq meshes, two steps of error feedback, against the JAX
  transport under ``jax.jit`` on a (2, 2) mesh fed the same global
  leaves (``tests/test_torch_collectives.py``'s bounds: every element
  within one int8 level or one bf16 ulp, at least 99.9% on the same
  level); the accounting equal.
- The sharded format: under fsdp with an int8 transport, an emergency
  save in the sharded format on each of four meshes. Its arrays equal the
  consolidated tag's exactly; a fresh run resumes it bit for bit (the
  residual too); no slice is written twice; under ``stage`` the layout
  names the stride; at world 1 the tag of the model mesh loads into the
  unsplit model with its residual remapped.
- The chunked head under S = 2 and 4 sequence shards, with and without
  a padding mask: the loss and the gradients of the hidden states and of
  the embedding against JAX on the global batch, rtol 1e-5 (fp32).
"""

import json
import os
import pickle
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
import types
from jax.sharding import Mesh

import stoke_tpu
from stoke_tpu import configs as jc
from stoke_tpu.models import BertForSequenceClassification as JaxBert
from stoke_tpu.models import GPT as JaxGPT
from stoke_tpu.models import PipelinedLM as JaxPipelinedLM
from stoke_tpu.models import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.models import (
    bert_tensor_parallel_rules as jax_bert_rules,
    moe_expert_parallel_rules as jax_moe_rules,
    pipeline_parallel_rules as jax_pp_rules,
)
from stoke_tpu.ops.chunked_ce import (
    chunked_causal_lm_loss as jax_chunked_loss,
)
from stoke_tpu.parallel import zero as jzero
from stoke_tpu.parallel.sharding import make_sharding_rules as jax_rules
from stoke_tpu_torch import Stoke, StokeOptimizer, io_ops
from stoke_tpu_torch import configs as pc
from stoke_tpu_torch.convert import (
    bert_state_dict_from_jax,
    gpt_state_dict_from_jax,
    jax_param_layout,
    pipelined_lm_state_dict_from_jax,
)
from stoke_tpu_torch.models import GPT, BertForSequenceClassification
from stoke_tpu_torch.models.pipelined_lm import PipelinedLM
from stoke_tpu_torch.parallel.sharding import jax_dim_map
from stoke_tpu_torch.parallel.zero import residual_to_flat

sys.path.insert(0, os.path.dirname(__file__))
import _torch_second_axis_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

WORLD = 4
JOIN_TIMEOUT_S = 120
VOCAB, LEN, BATCH = 64, 32, 4
BERT_VOCAB, BERT_LEN = 100, 64
MOE = dict(experts=4, capacity=2.0, top_k=2)
GPT_TOL = 1e-3
TOL = dict(rtol=5e-4, atol=5e-6)
CE_TOL = dict(rtol=1e-5, atol=1e-7)
EQUAL_SHARE = 0.999


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's torch work (the spawned ranks
    take one each too): beside the suite's other workers each spare
    thread spins against theirs."""
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


def _mesh(axis):
    return Mesh(np.asarray(jax.devices("cpu")[:WORLD]).reshape(worker.SHAPE),
                ("data", axis))


def _gpt_model(moe: bool):
    kw = (dict(moe_num_experts=MOE["experts"],
               moe_capacity_factor=MOE["capacity"],
               moe_top_k=MOE["top_k"]) if moe else {})
    return JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=LEN,
                  dropout_rate=0.0, **kw)


def _inputs():
    """Every model's JAX params, the port's weights and the global
    batches; the transport's gradients; the chunked head's tensors."""
    r = np.random.default_rng(0)
    x = np.zeros((BATCH, 16), np.int32)
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
            "batches": [r.integers(0, VOCAB, size=(BATCH, 16))
                        for _ in range(worker.STEPS)], **MOE}
    bert = JaxBert(vocab_size=BERT_VOCAB, num_classes=2, size_name="tiny",
                   max_len=BERT_LEN, dropout_rate=0.0)
    params = _draw(jax.eval_shape(lambda k: bert.init(
        k, x, np.ones_like(x), train=False), jax.random.PRNGKey(0))[
        "params"], 3)
    mask = [np.ones((BATCH, 16), np.int64) for _ in range(worker.STEPS)]
    mask[1][:, 12:] = 0
    out["bert"] = {
        "vocab": BERT_VOCAB, "len": BERT_LEN, "batch": BATCH,
        "params": params,
        "weights": {k: v.numpy() for k, v in
                    bert_state_dict_from_jax(params).items()},
        "ids": [r.integers(1, BERT_VOCAB, size=(BATCH, 16))
                for _ in range(worker.STEPS)],
        "mask": mask, "y": [r.integers(0, 2, size=(BATCH,))
                            for _ in range(worker.STEPS)]}
    lm = _lm_model()
    params = _draw(jax.eval_shape(lm.init, jax.random.PRNGKey(0))["params"],
                   4)
    out["lm"] = {
        "vocab": VOCAB, "len": LEN, "batch": BATCH, "params": params,
        "weights": {k: v.numpy() for k, v in
                    pipelined_lm_state_dict_from_jax(params).items()},
        "batches": [r.integers(0, VOCAB, size=(BATCH, 16))
                    for _ in range(worker.STEPS)]}
    # the transport's global leaves, in the JAX flatten order of GPT-tiny
    leaves = jax.tree_util.tree_leaves(out["gpt"]["params"])
    out["transport"] = {"grads": [
        [(r.normal(size=l.shape) * 10.0 ** r.uniform(-3, 0)).astype(
            np.float32) for l in leaves] for _ in range(2)]}
    B, L, H, V = 2, 16, 32, 50
    m = np.ones((B, L), np.int64)
    m[0, 11:] = 0
    m[1, :3] = 0
    out["chunked"] = {
        "hidden": r.normal(size=(B, L, H)).astype(np.float32),
        "emb": (0.3 * r.normal(size=(V, H))).astype(np.float32),
        "ids": r.integers(0, V, size=(B, L)), "mask": m, "chunk": 3}
    return out


def _lm_model():
    return JaxPipelinedLM(_mesh("stage"), vocab_size=VOCAB, size_name="tiny",
                          max_len=LEN, num_microbatches=2,
                          layers_per_stage=1, data_axis="data")


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _spawn(inputs, tmp):
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
    send = {k: {n: v for n, v in d.items()
                if n not in ("params", "collections")}
            for k, d in inputs.items()}
    procs = [ctx.Process(target=worker.run,
                         args=(r, WORLD, store, str(tmp), send))
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


def _jax_train(kind, inputs):
    """The JAX package's losses and weights (the port's names) after each
    SGD step: GPT-tiny by dp on one device; BERT, the MoE and PipelinedLM
    with their rules on a (2, 2) mesh."""
    g = inputs[kind]
    mesh_kw, args = {}, []
    if kind == "gpt":
        model, loss, conv = _gpt_model(False), jax_causal_lm_loss, \
            gpt_state_dict_from_jax
    elif kind == "moe":
        model, loss, conv = _gpt_model(True), jax_causal_lm_loss, \
            gpt_state_dict_from_jax
        mesh_kw = dict(axes=("data", "expert"), rules=jax_moe_rules())
    elif kind == "bert":
        model, conv = JaxBert(vocab_size=BERT_VOCAB, num_classes=2,
                              size_name="tiny", max_len=BERT_LEN,
                              dropout_rate=0.0), bert_state_dict_from_jax

        def loss(logits, y):
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()

        mesh_kw = dict(axes=("data", "model"), rules=jax_bert_rules())
        args = [((i.astype(np.int32), m.astype(np.int32)), (y,))
                for i, m, y in zip(g["ids"], g["mask"], g["y"])]
    else:
        model, loss, conv = _lm_model(), jax_causal_lm_loss, \
            pipelined_lm_state_dict_from_jax
        mesh_kw = dict(axes=("data", "stage"), rules=jax_pp_rules())
    if not args:
        args = [(b.astype(np.int32), (b.astype(np.int32),))
                for b in g["batches"]]
    kw = dict(model_train_kwargs={"train": True},
              model_eval_kwargs={"train": False}) if kind != "lm" else {}
    if kind == "moe":
        kw.update(aux_loss_weight=worker.AUX_WEIGHT,
                  grad_clip=stoke_tpu.ClipGradNormConfig(
                      max_norm=worker.CLIP))
    if mesh_kw:
        kw.update(distributed="dp", configs=[
            stoke_tpu.MeshConfig(axes=mesh_kw["axes"], shape=worker.SHAPE,
                                 devices=jax.devices("cpu")[:WORLD]),
            stoke_tpu.PartitionRulesConfig(rules=mesh_kw["rules"])])
        bpd = BATCH // worker.SHAPE[0]
    else:
        bpd = BATCH
    s = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd, optimizer_kwargs=dict(
                learning_rate=worker.LR, momentum=worker.MOMENTUM)),
        loss, {"params": jax.tree_util.tree_map(np.array, g["params"]),
               **g.get("collections", {})},
        batch_size_per_device=bpd, verbose=False, **kw)
    losses, weights = [], []
    for margs, largs in args:
        losses.append(float(s.train_step(margs, largs)))
        weights.append({k: v.numpy() for k, v in conv(
            jax.tree_util.tree_map(np.asarray, s.params)).items()})
    return losses, weights


def _jax_transports(inputs):
    """Each transport case's two steps under ``jax.jit`` on a (2, 2)
    mesh (the other axis replicates), fed the global leaves; the
    accounting."""
    tree = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, jnp.float32),
                                  inputs["gpt"]["params"])
    treedef = jax.tree_util.tree_structure(tree)
    out = {}
    for case, fields in worker.TRANSPORTS.items():
        cfg = jc.CommConfig(**fields, **worker.COMM)
        t = jzero.make_transport(cfg, types.SimpleNamespace(
            mesh=_mesh("model"), axis_name="data",
            tier=jc.ShardingOptions.none))
        state = jax.tree_util.tree_map(jnp.asarray, t.init_state(tree))
        apply = jax.jit(t.apply)
        steps = []
        for leaves in inputs["transport"]["grads"]:
            y, state = apply(jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(a) for a in leaves]), state)
            steps.append({
                "out": [np.asarray(v) for v in jax.tree_util.tree_leaves(y)],
                "residual": [np.asarray(v) for v in
                             jax.tree_util.tree_leaves(state["residual"])]})
        sizes = [int(np.prod(a.shape)) for a in
                 jax.tree_util.tree_leaves(tree)]
        out[case] = {"steps": steps, "layout": t._layout(sizes),
                     "bytes": t.bytes_per_step(tree),
                     "descriptor": t.layout_descriptor(tree)}
    return out


def _jax_chunked(inputs):
    """JAX ``chunked_causal_lm_loss`` on the global batch, and its
    gradients of the hidden states and the embedding, with and without
    the mask."""
    c = inputs["chunked"]
    out = {}
    for masked in (False, True):
        def f(h, e):
            return jax_chunked_loss(
                (h, e), jnp.asarray(c["ids"]),
                jnp.asarray(c["mask"]) if masked else None,
                chunk=c["chunk"])

        loss, (dh, de) = jax.value_and_grad(f, argnums=(0, 1))(
            jnp.asarray(c["hidden"]), jnp.asarray(c["emb"]))
        out[masked] = (float(loss), np.asarray(dh), np.asarray(de))
    return out


@pytest.fixture(scope="module")
def run(inputs, tmp_path_factory):
    """The spawned world's per-rank results and the JAX references,
    computed while the world runs."""
    tmp = tmp_path_factory.mktemp("second_axis")
    started = time.monotonic()
    procs = _spawn(inputs, tmp)
    try:
        refs = {"train": {k: _jax_train(k, inputs)
                          for k in ("gpt", "bert", "moe", "lm")},
                "transport": _jax_transports(inputs),
                "chunked": _jax_chunked(inputs)}
    finally:
        world = _join(procs, tmp, started)
    return world, refs


def _rel(a, b):
    """The largest difference over the largest magnitude of ``b``."""
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# ---------------------------------------------------------------------- #
# the tiers
# ---------------------------------------------------------------------- #

CASES = [(r, t) for r in worker.RUNS for t in worker.TIERS]


@pytest.mark.parametrize("name,tier", CASES,
                         ids=[f"{r}-{t}" for r, t in CASES])
def test_tiers_match_jax(run, inputs, name, tier):
    """Every rank's losses and whole weights after each SGD step against
    the JAX package on the global batch."""
    world, refs = run
    kind = worker.RUNS[name][0]
    losses, weights = refs["train"][kind]
    start = inputs[kind]["weights"]
    for res in world:
        got = res["tiers"][(name, tier)]
        if kind == "gpt":
            np.testing.assert_allclose(got["losses"], losses, rtol=GPT_TOL)
            for step in range(worker.STEPS):
                before = start if step == 0 else got["weights"][step - 1]
                ref_before = start if step == 0 else weights[step - 1]
                for k in start:
                    g = before[k] - got["weights"][step][k]
                    ref = ref_before[k] - weights[step][k]
                    assert _rel(g, ref) <= GPT_TOL, (step, k, _rel(g, ref))
            continue
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        for step, ref in enumerate(weights):
            for k, v in ref.items():
                np.testing.assert_allclose(got["weights"][step][k], v,
                                           err_msg=f"{step} {k}", **TOL)


def _unsplit(kind):
    if kind == "bert":
        return BertForSequenceClassification(
            vocab_size=BERT_VOCAB, num_classes=2, size_name="tiny",
            max_len=BERT_LEN)
    if kind == "lm":
        return PipelinedLM(vocab_size=VOCAB, size_name="tiny", max_len=LEN,
                           num_microbatches=2, layers_per_stage=1,
                           stages=worker.SHAPE[1])
    return GPT(vocab_size=VOCAB, size_name="tiny", max_len=LEN,
               **(dict(moe_num_experts=MOE["experts"]) if kind == "moe"
                  else {}))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_specs(name, tier, params):
    """The JAX placement of the params tree under the tier and the run's
    rules on the run's (2, 2) mesh: the optimizer state's (oss, sddp) or
    the parameters' (fsdp) shardings."""
    axis = worker.RUNS[name][1]
    rules = {"gpt_model": jax_bert_rules(), "bert_model": jax_bert_rules(),
             "moe_expert": jax_moe_rules(),
             "lm_stage": jax_pp_rules()}.get(name)
    r = jax_rules(jc.ShardingOptions(tier), _mesh(axis), "data",
                  jc.OSSConfig(min_shard_size=1),
                  jc.SDDPConfig(min_shard_size=1),
                  jc.FSDPConfig(min_weight_size=1), rules)
    shapes = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    return (r.param_shardings(shapes) if tier == "fsdp"
            else r.opt_shardings(shapes)), _mesh(axis)


@pytest.mark.parametrize("name,tier", CASES,
                         ids=[f"{r}-{t}" for r, t in CASES])
def test_tier_placement_is_jax(run, inputs, name, tier):
    """What each rank's optimizer steps on at the start (its slice of a
    leaf, or the leaf or its model slice where the tier keeps it whole)
    equals exactly the JAX addressable shard of the device at the same
    (data, X) coordinate; the fused ``qkv`` bias alone is cut along the
    port's flat dim where the JAX rule cuts its head dim (Queue 3), and
    holds as many elements. fsdp frees exactly the cut leaves, sddp's
    accumulator is cut as its slices, the momentum has the slice's
    shape."""
    world, _ = run
    kind = worker.RUNS[name][0]
    params = inputs[kind]["params"]
    specs, mesh = _jax_specs(name, tier, params)
    model = _unsplit(kind)
    layout = jax_param_layout(model)
    off = set()
    for res in world:
        got = res["tiers"][(name, tier)]
        device = mesh.devices[got["coords"]]
        for n, held in got["placement"].items():
            path, perm, jshape = layout[n]
            whole = np.asarray(_leaf(params, path))
            idx = _leaf(specs, path).devices_indices_map(
                whole.shape)[device]
            want = whole[idx]
            h = held["held"]
            assert got["momentum"][n] == h.shape, n
            assert held["freed"] == (tier == "fsdp"
                                     and held["dim"] is not None), n
            if tier == "sddp":
                assert held["acc_dim"] == held["dim"], n
            port = h.transpose(perm) if perm is not None else h
            assert port.size == want.size, n
            cut = [k for k, sl in enumerate(idx)
                   if len(range(*sl.indices(whole.shape[k])))
                   != whole.shape[k]]
            dims = jax_dim_map(model.get_parameter(n).shape, perm,
                               whole.shape)
            if held["dim"] is not None and any(k not in dims for k in cut):
                off.add(n)
                continue
            assert np.array_equal(port.reshape(want.shape), want), n
    assert all(n.endswith("qkv.bias") for n in off), off
    if name == "gpt_seq":
        assert off


# ---------------------------------------------------------------------- #
# the transports
# ---------------------------------------------------------------------- #


def _pack(leaves, layout):
    """Leaves as their padded buckets."""
    out = []
    for idx, elems, padded in layout.buckets:
        flat = np.concatenate([np.asarray(leaves[i]).reshape(-1)
                               for i in idx])
        out.append(np.pad(flat, (0, padded - elems)))
    return out


def _levels(case, want, layout):
    """Per bucket, each element's tolerance: int8 one level of its chunk
    (the chunk's absmax over 127, from the JAX output), bf16 one bf16 ulp
    of the value."""
    out = []
    for b in _pack(want, layout):
        if worker.TRANSPORTS[case]["dtype"] == "bf16":
            out.append(np.abs(b) * 2.0**-7)
        else:
            c = worker.COMM["chunk_elems"]
            level = np.abs(b).reshape(-1, c).max(1, keepdims=True) / 127.0
            out.append(np.broadcast_to(level, (level.shape[0], c)).reshape(-1))
    return out


def _check(got, want, tol):
    """Every element within its tolerance, and >= 99.9% of them on the
    same level."""
    same = total = 0
    for a, b, t in zip(got, want, tol):
        d = np.abs(a - b)
        assert (d <= t * (1 + 1e-6)).all()
        same += int((d <= 1e-3 * t).sum())
        total += a.size
    assert same >= EQUAL_SHARE * total


TRANSPORT_CASES = [(m, c) for m in ("gpt_model", "gpt_seq")
                   for c in worker.TRANSPORTS]


@pytest.mark.parametrize("name,case", TRANSPORT_CASES,
                         ids=[f"{m}-{c}" for m, c in TRANSPORT_CASES])
def test_transport_matches_jax_on_two_axes(run, name, case):
    """Each rank's transported global leaves (its slices gathered over
    the model group) and its residual over two steps against the JAX
    transport on the (2, 2) mesh; ``comm_bytes`` and the residual's
    layout descriptor are the JAX accounting (the data axis's)."""
    world, refs = run
    want = refs["transport"][case]
    layout = want["layout"]
    for res in world:
        got = res["transports"][(name, case)]
        assert got["bytes"] == want["bytes"]
        assert got["descriptor"] == want["descriptor"]
        assert got["sizes"] == [int(np.prod(a.shape)) for a in
                                want["steps"][0]["out"]]
        for step, w in enumerate(want["steps"]):
            tol = _levels(case, w["out"], layout)
            _check(_pack(got["steps"][step]["out"], layout),
                   _pack(w["out"], layout), tol)
            _check(got["steps"][step]["residual"],
                   _pack(w["residual"], layout), tol)


# ---------------------------------------------------------------------- #
# the sharded format
# ---------------------------------------------------------------------- #


def _read(tag):
    with open(os.path.join(tag, "meta.json")) as f:
        meta = json.load(f)
    return meta, {k: io_ops._read_key(tag, k, meta)[0]
                  for k in ("variables", "opt_state")}


@pytest.mark.parametrize("name", worker.FORMAT_RUNS)
def test_sharded_tag_on_two_axes(run, name):
    """The sharded emergency tag: its arrays, put together in two levels,
    are the consolidated tag's exactly; the layout names the mesh (and
    under ``stage`` the stride of the stage cut); no rank writes a slice
    another rank writes (the rank at (1, 1) writes nothing, and under
    ``seq`` neither does any rank off seq coordinate 0); a fresh run
    resumes it, and the next step's loss, weights and residual are the
    uninterrupted run's bit for bit. Loaded under a 1-D data mesh of the
    world it gives the saved weights exactly, as the consolidated tag
    does loaded under the run's mesh."""
    world, _ = run
    axis = worker.RUNS[name][1]
    got = world[0]["formats"][name]
    meta, arrays = _read(got["tag"])
    _, cons = _read(got["cons"])
    for key in arrays:
        assert sorted(arrays[key]) == sorted(cons[key]), key
        for n, a in cons[key].items():
            assert np.array_equal(arrays[key][n], a), (key, n)
    assert meta["mesh"] == {"axes": ["data", axis], "shape": [2, 2]}
    cuts = [leaf["cut"] for leaves in meta["leaves"].values()
            for leaf in leaves.values() if leaf.get("cut")]
    if axis in ("seq",):
        assert not cuts
    else:
        assert cuts and all(c["axis"] == axis for c in cuts)
        assert all(c["stride"] == (2 if axis == "stage" else None)
                   for c in cuts)
    quiet = [3] + ([1] if axis == "seq" else [])
    assert not [f for f in got["files"] for r in quiet
                if f.endswith(f".rank{r}.npz")], got["files"]
    for res in world:
        mine = res["formats"][name]
        assert mine["resumed"]
        a, b = mine["runs"]
        assert a["loss"] == b["loss"]
        for k, v in a["weights"].items():
            assert np.array_equal(v, b["weights"][k]), k
        assert all(np.array_equal(x, y)
                   for x, y in zip(a["residual"], b["residual"]))
        for kind, weights in mine["loaded"].items():
            assert sorted(weights) == sorted(arrays["variables"]), kind
            for n, v in weights.items():
                assert np.array_equal(v, arrays["variables"][n]), (kind, n)


def test_sharded_tag_resumes_at_world_one(run, inputs, tmp_path):
    """The model mesh's sharded emergency tag resumed by an unsplit
    GPT-tiny at world 1 (fsdp, the same transport): the weights are the
    gathered ones, and the residual is the saved one remapped to the
    world's layout (the same flat vector)."""
    world, _ = run
    got = world[0]["formats"]["gpt_model"]
    root = os.path.dirname(got["tag"])
    m = GPT(vocab_size=VOCAB, size_name="tiny", max_len=LEN,
            dropout_rate=0.0)
    s = Stoke(m, StokeOptimizer(torch.optim.SGD, lr=worker.LR,
                                momentum=worker.MOMENTUM),
              _causal_lm_loss(), batch_size_per_device=2, device="cpu",
              distributed="dp", fsdp=True,
              configs=[pc.FSDPConfig(min_weight_size=1),
                       pc.CommConfig(dtype="int8", **worker.COMM),
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


def _causal_lm_loss():
    from stoke_tpu_torch.models import causal_lm_loss

    return causal_lm_loss


# ---------------------------------------------------------------------- #
# the chunked head
# ---------------------------------------------------------------------- #

CE_CASES = [(S, m) for S in (2, 4) for m in (False, True)]


@pytest.mark.parametrize("S,masked", CE_CASES,
                         ids=[f"S{S}-{'mask' if m else 'nomask'}"
                              for S, m in CE_CASES])
def test_chunked_head_under_a_sequence_shard(run, S, masked):
    """Every shard's loss is JAX's on the global batch; its gradient of
    its hidden states over S is JAX's at its positions, and the mean of
    the shards' embedding gradients JAX's (the ladder averages over the
    shards: each shard's backward carries the sum's cotangent, S times
    its part), within rtol 1e-5."""
    world, refs = run
    loss, dh, de = refs["chunked"][masked]
    parts, des = [], []
    for res in world:
        got = res["chunked"][(S, masked)]
        np.testing.assert_allclose(got["loss"], loss, **CE_TOL)
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["dh"] / S, dh[:, lo:hi], **CE_TOL)
        parts.append((lo, got["dh"] / S))
        des.append(got["de"])
    group = des if S == WORLD else des[:2]
    np.testing.assert_allclose(np.mean(group, 0), de, **CE_TOL)


# ---------------------------------------------------------------------- #
# the program auditor where a group is larger than 1
# ---------------------------------------------------------------------- #


def test_audit_rules_that_need_a_group(run):
    """On the (data, model) mesh every rank's audit of its own build is
    clean and dispatches nothing; at a byte threshold of 0 each parameter
    the Megatron rules leave whole fires ``audit-replicated-bytes`` (at
    most four a program) and no cut one does; with no exchange accounting
    them, the apply-family traces' c10d collectives fire
    ``audit-comm-bytes``."""
    world, _ = run
    for r, out in enumerate(world):
        a = out["audit"]
        assert a["clean"] == [], (r, a["clean"])
        assert a["counts_equal"]
        assert {"fused", "window"} <= set(a["programs"])
        repl = [f for f in a["replicated"]
                if f["rule"] == "audit-replicated-bytes"]
        assert repl and all(f["file"] in ("<trace:fused>", "<trace:window>")
                            for f in repl)
        for f in repl:
            name = f["message"].split(" keeps param:")[1].split(" ")[0]
            assert name not in a["cut"], name
        assert {f["rule"] for f in a["replicated"]} == \
            {"audit-replicated-bytes"}
        comm = {f["file"] for f in a["comm"] if f["rule"] ==
                "audit-comm-bytes"}
        assert comm == {"<trace:fused>", "<trace:window>"}

