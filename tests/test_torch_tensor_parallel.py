"""Port parity: tensor and expert parallelism (``stoke_tpu_torch/parallel/
tensor.py``, the partition rules of ``parallel/sharding.py``) against
``stoke_tpu/parallel/sharding.py`` and the JAX package's Megatron and
expert placements.

Without a spawn: rule compilation, first match and the rank-mismatch
messages (``tests/test_tensor_parallel.py:23-60``), the recognised rule
sets and the refusals (an unrecognised rule, a column-parallel product
without its partner, an indivisible head count, meshes of three axes,
``dcn_axes``, the tiers under a model axis), the qkv slice layout, and
at world 1 on (1, 1) meshes a YAML document's rules with ``"..."``.

A gloo world of 4 (``tests/_torch_tp_worker.py``) is spawned once for the
module through a file store and joined with a 120 s timeout. In it, on
(data 2, model 2) and (data 2, expert 2) meshes: GPT-tiny under
``gpt_tensor_parallel_rules`` and BERT-tiny under
``bert_tensor_parallel_rules``, three SGD steps each against the JAX
package with the same rules on a 4-device mesh of the same shape, on the
global batch (``tests/test_tensor_parallel.py:182-228``'s tolerance,
rtol 5e-4 and atol 5e-6); GPT-tiny-MoE under
``moe_expert_parallel_rules`` with ``aux_loss_weight`` 0.01 and a norm
clip, likewise; the gradients of the leaves the rules leave whole equal
bit for bit across the model group; a consolidated tag of the split run
equal to the one a world-1 run of the same parameters writes, and loaded
back at world 1 and into a split run bit for bit.
"""

import os
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
from jax.sharding import PartitionSpec as P

import stoke_tpu
from stoke_tpu.models import BertForSequenceClassification as JaxBert
from stoke_tpu.models import GPT as JaxGPT
from stoke_tpu.models import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.models import (
    bert_tensor_parallel_rules as jax_bert_rules,
    moe_expert_parallel_rules as jax_moe_rules,
)
from stoke_tpu.parallel.sharding import compile_partition_rules as jax_compile
from stoke_tpu.parallel.sharding import sharding_tree
from stoke_tpu.utils import init_module
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch import configs as pc
from stoke_tpu_torch.convert import (
    bert_state_dict_from_jax,
    gpt_state_dict_from_jax,
    rank_state_dict,
    whole_state_dict,
)
from stoke_tpu_torch.models import (
    GPT,
    bert_tensor_parallel_rules,
    causal_lm_loss,
    gpt_tensor_parallel_rules,
    moe_expert_parallel_rules,
    vit_tensor_parallel_rules,
)
from stoke_tpu_torch.models.bert import TransformerBlock
from stoke_tpu_torch.parallel import (
    ModelGroup,
    compile_partition_rules,
    rule_entries,
    shard_module,
)
from stoke_tpu_torch.status import StokeStatus

sys.path.insert(0, os.path.dirname(__file__))
import _torch_tp_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

WORLD = 4
JOIN_TIMEOUT_S = 120
TOL = dict(rtol=5e-4, atol=5e-6)
GPT_VOCAB, GPT_LEN, GPT_BATCH = 64, 32, 4
BERT_VOCAB, BERT_LEN = 100, 64
MOE_EXPERTS, MOE_CAPACITY, MOE_TOP_K = 4, 2.0, 2


@pytest.fixture(scope="module", autouse=True)
def one_process_group():
    """The world-1 runs' one-process group (made by the first ``Stoke``
    with ``distributed="dp"``), torn down after the module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------- #
# the rules, without a spawn
# ---------------------------------------------------------------------- #


def _jax_spec(tree, rules, strict=True):
    mesh = Mesh(np.asarray(jax.devices("cpu")).reshape(4, 2),
                ("data", "model"))
    return sharding_tree(tree, mesh, lambda shape: P(), jax_compile(rules),
                         strict_overrides=strict)


def test_override_beats_default_as_jax():
    rules = ((r"w1$", (None, "model")), (r"w2$", ("model", None)),
             (r"w", ("data", None)))
    tree = {"w1": np.zeros((8, 64)), "w2": np.zeros((64, 8)),
            "b": np.zeros((64,))}
    theirs = _jax_spec(tree, rules)
    mine = compile_partition_rules(rules)
    for k, a in tree.items():
        got = rule_entries(k, a.shape, mine)
        assert (P() if got is None else P(*got)) == theirs[k].spec, k


@pytest.mark.parametrize("rule,shape", [
    ((None, "model", None), (8, 64)),
    (("model", None, None, ...), (8, 64)),
    (("model", None, "..."), (8,)),
], ids=str)
def test_rank_mismatch_messages_as_jax(rule, shape):
    """Strict (parameters): the JAX package's ``ValueError``, letter for
    letter; lenient (optimizer state): the tier's placement."""
    rules = ((r"w1", rule),)
    with pytest.raises(ValueError) as theirs:
        _jax_spec({"w1": np.zeros(shape)}, rules)
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        rule_entries("w1", shape, compile_partition_rules(rules))
    assert _jax_spec({"w1": np.zeros(shape)}, rules,
                     strict=False)["w1"].spec == P()
    assert rule_entries("w1", shape, compile_partition_rules(rules),
                        strict=False) is None


def test_variadic_rules_and_yaml_ellipsis():
    """A trailing ``...`` or ``"..."`` pads with None, as JAX's."""
    for tail in (..., "..."):
        rules = ((r"k", ("model", tail)),)
        assert compile_partition_rules(rules)[0][1] == ("model", ...)
        assert jax_compile(rules)[0][1] == ("model", ...)
        got = rule_entries("k", (4, 3, 2), compile_partition_rules(rules))
        assert got == ("model", None, None)
    assert compile_partition_rules(()) is None


def test_published_rule_sets_are_jax():
    assert bert_tensor_parallel_rules() == jax_bert_rules()
    assert gpt_tensor_parallel_rules is bert_tensor_parallel_rules
    assert vit_tensor_parallel_rules is bert_tensor_parallel_rules
    assert moe_expert_parallel_rules() == jax_moe_rules()


def _block(heads=4, hidden=32, ff=64):
    torch.manual_seed(0)
    return TransformerBlock(hidden, heads, ff, dropout_rate=0.0)


@pytest.mark.parametrize("rules,what", [
    (((r"ln_attn/scale", ("model",)),), "8e"),
    (((r"attention/out/bias", ("model",)),), "8e"),
    (((r"ff_in/kernel", ("model", None)),), "8e"),
    (((r"attention/qkv/kernel", (None, None, "model", None)),
      (r"attention/qkv/bias", (None, "model", None))), "partner"),
    (((r"ff_in/kernel", (None, "model")), (r"ff_out/kernel",
                                            ("model", None))), "partner"),
    (((r"ff_in/kernel", (None, ("data", "model"))),), "8e"),
    (((r"ff_in/kernel", (None, "data")),), "8e"),
], ids=["norm", "row_bias", "wrong_dim", "no_row", "no_bias", "two_axes",
        "data_axis"])
def test_unrecognised_rules_are_refused(rules, what):
    with pytest.raises(NotImplementedError) as e:
        shard_module(_block(), rules, ModelGroup(None, 2, 0, "model"))
    msg = str(e.value)
    assert "8e" in msg and msg.startswith("Stoke -- ")
    if what == "partner":
        assert "partner" in msg


def test_indivisible_heads_name_the_leaf():
    with pytest.raises(ValueError, match=r"attention/qkv/kernel dim 2 "
                       r"\(4 heads\) on the 'model' axis of 3 devices"):
        shard_module(_block(ff=48), gpt_tensor_parallel_rules(),
                     ModelGroup(None, 3, 0, "model"))


@pytest.mark.parametrize("T", [1, 2, 4])
def test_qkv_slice_layout_and_virtual_ranks(T):
    """Rank r's qkv rows are its heads of the ``[3, heads, D, hidden]``
    view (not one block of rows); the ranks' slices put back give the
    whole; their summed partial products (the all-reduce done by hand)
    plus the row biases give the unsplit block's output."""
    whole = _block()
    x = torch.randn(2, 5, 32)
    ref = whole(x, None)
    blocks = []
    for r in range(T):
        b = _block()
        tp = shard_module(b, gpt_tensor_parallel_rules(),
                          ModelGroup(None, T, r, "model"))
        blocks.append(b)
        w = whole.attention.qkv.weight.view(3, 4, 8, 32)
        h = 4 // T
        want = w[:, r * h:(r + 1) * h].reshape(-1, 32)
        assert torch.equal(b.attention.qkv.weight, want)
        assert b.attention.local_heads == h and b.ff_in.out_features == 64 // T
        assert tp.cuts["attention.qkv.weight"].local == (3 * 32 // T, 32)
    sds = [b.state_dict() for b in blocks]
    back = whole_state_dict(sds, tp.cuts)
    for n, t in whole.state_dict().items():
        assert torch.equal(back[n], t), n
        assert torch.equal(rank_state_dict(whole.state_dict(), tp.cuts,
                                           T - 1)[n], sds[T - 1][n]), n
    with torch.no_grad():
        a = sum(b.attention.partial(x, None) for b in blocks)
        h1 = whole.ln_attn(x + a + whole.attention.out.bias)
        f = sum(b.ff_partial(h1) for b in blocks) + whole.ff_out.bias
        out = whole.ln_ff(h1 + f)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


REFUSED_MESHES = {
    "three_axes": ([pc.MeshConfig(axes=("data", "model", "expert"))], {},
                   "8e"),
    "model_beside_seq": ([pc.MeshConfig(axes=("data", "seq", "model"))], {},
                         "8e"),
    "no_data_axis": ([pc.MeshConfig(axes=("model", "expert"))], {}, "8e"),
    "dcn": ([pc.MeshConfig(dcn_axes=("data",))], {}, "8e"),
    "fsdp_under_model": ([pc.MeshConfig(axes=("data", "model"),
                                        shape=(1, 2))], dict(fsdp=True),
                         "8d"),
    "comm_under_expert": ([pc.MeshConfig(axes=("data", "expert"),
                                         shape=(2, 2)), pc.CommConfig()],
                          {}, "8d"),
    "sharded_format_under_model": (
        [pc.MeshConfig(axes=("data", "model"), shape=(-1, 2)),
         pc.CheckpointConfig(format=pc.CheckpointFormat.sharded)], {},
        "8d"),
}


@pytest.mark.parametrize("case", sorted(REFUSED_MESHES))
def test_meshes_and_tiers_not_ported_name_their_item(case):
    configs, flags, item = REFUSED_MESHES[case]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item {item}\\b"):
        StokeStatus(batch_size_per_device=4, device="cpu", distributed="dp",
                    configs=configs, **flags)


def test_tiers_under_a_model_axis_of_one_run():
    """A model axis of one leaves the tiers and the transports as they
    are (the split is the whole model)."""
    st = StokeStatus(batch_size_per_device=4, device="cpu", distributed="dp",
                     oss=True, configs=[
                         pc.MeshConfig(axes=("data", "model"), shape=(-1, 1)),
                         pc.CommConfig(),
                         pc.PartitionRulesConfig(
                             rules=gpt_tensor_parallel_rules())])
    assert st.sharding_tier.value == "oss"


def test_yaml_rules_with_ellipsis_run_at_world_one():
    """A YAML document's ``PartitionRulesConfig`` (lists, ``"..."``)
    builds through ``stoke_from_config`` and trains on a (1, 1) mesh bit
    for bit as the same run without it."""
    from stoke_tpu_torch.utils import stoke_from_config

    rules = [[r, [("..." if e is Ellipsis else e) for e in spec]]
             for r, spec in gpt_tensor_parallel_rules()]
    rules[-1] = ["ff_out/kernel", ["model", "..."]]
    doc = {"batch_size_per_device": 2, "device": "cpu", "distributed": "dp",
           "optimizer": {"name": "sgd", "learning_rate": 0.1},
           "configs": {"MeshConfig": {"axes": ["data", "model"],
                                      "shape": [1, 1]},
                       "PartitionRulesConfig": {"rules": rules}}}
    runs = []
    for d in (doc, {**doc, "configs": {}}):
        m = GPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=GPT_LEN,
                dropout_rate=0.0)
        m.init_weights(0)
        s = stoke_from_config(m, causal_lm_loss, None, d)
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, GPT_VOCAB, size=(2, 16)))
        runs.append(([float(s.train_step(x, x)) for _ in range(2)],
                     s.model_access.state_dict(), s))
    assert runs[0][2].tensor_parallel is not None
    assert runs[1][2].tensor_parallel is None
    assert runs[0][0] == runs[1][0]
    for n, t in runs[1][1].items():
        assert torch.equal(runs[0][1][n], t), n
    for r in runs:
        r[2].close_telemetry()


def _world_one_run(make, rules, axes, batch, loss):
    """Two SGD steps of ``make()`` at world 1, under ``rules`` on a (1, 1)
    mesh of ``axes``, or without (``rules`` None): losses and weights."""
    m = make()
    cfgs = ([] if rules is None else [
        pc.MeshConfig(axes=axes, shape=(1, 1)),
        pc.PartitionRulesConfig(rules=rules)])
    s = Stoke(m, StokeOptimizer(torch.optim.SGD, lr=0.1), loss,
              batch_size_per_device=2, device="cpu", distributed="dp",
              configs=cfgs)
    losses = [float(s.train_step(*batch)) for _ in range(2)]
    out = (losses, {k: v.clone() for k, v in
                    s.model_access.state_dict().items()})
    s.close_telemetry()
    return out


def _vit():
    from stoke_tpu_torch.models import ViT

    torch.manual_seed(0)
    return ViT(num_classes=10, size_name="tiny", patch_size=8,
               dropout_rate=0.0, image_size=32)


def _bert():
    from stoke_tpu_torch.models import BertForSequenceClassification

    return BertForSequenceClassification(
        vocab_size=BERT_VOCAB, num_classes=2, size_name="tiny",
        max_len=BERT_LEN, dropout_rate=0.0)


def _gpt_moe():
    m = GPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=GPT_LEN,
            dropout_rate=0.0, moe_num_experts=MOE_EXPERTS, moe_top_k=2)
    m.init_weights(0)
    return m


_CE = lambda logits, y: torch.nn.functional.cross_entropy(logits, y)  # noqa
_IDS = torch.from_numpy(np.random.default_rng(2).integers(
    1, BERT_VOCAB, size=(2, 16)))
WORLD_ONE = {
    "vit": (_vit, vit_tensor_parallel_rules(), ("data", "model"),
            ((torch.randn(2, 3, 32, 32, generator=torch.Generator()
                          .manual_seed(0)),), (torch.tensor([1, 7]),)), _CE),
    "bert": (_bert, bert_tensor_parallel_rules(), ("data", "model"),
             ((_IDS, torch.ones_like(_IDS)), (torch.tensor([0, 1]),)), _CE),
    "gpt_moe": (_gpt_moe, moe_expert_parallel_rules(), ("data", "expert"),
                (_IDS % GPT_VOCAB, _IDS % GPT_VOCAB), causal_lm_loss),
}


@pytest.mark.parametrize("case", sorted(WORLD_ONE))
def test_world_one_split_is_bit_for_bit(case):
    """ViT and BERT under the Megatron rules and GPT-MoE under the expert
    rules, on a (1, 1) mesh, train bit for bit as without the rules (the
    split's functions and norms are the identity at a group of one)."""
    make, rules, axes, batch, loss = WORLD_ONE[case]
    split = _world_one_run(make, rules, axes, batch, loss)
    plain = _world_one_run(make, None, axes, batch, loss)
    assert split[0] == plain[0]
    for n, t in plain[1].items():
        assert torch.equal(split[1][n], t), n


# ---------------------------------------------------------------------- #
# the world of 4 and its JAX references
# ---------------------------------------------------------------------- #


def _gpt_inputs(moe: bool):
    kw = (dict(moe_num_experts=MOE_EXPERTS, moe_capacity_factor=MOE_CAPACITY,
               moe_top_k=MOE_TOP_K) if moe else {})
    model = JaxGPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=GPT_LEN,
                   dropout_rate=0.0, **kw)
    r = np.random.default_rng(11 if moe else 5)
    batches = [r.integers(0, GPT_VOCAB, size=(GPT_BATCH, 16)).astype(
        np.int32) for _ in range(worker.STEPS + 1)]
    variables = init_module(model, jax.random.PRNGKey(1), batches[0],
                            train=False)
    weights = {k: v.numpy() for k, v in gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"])).items()}
    return model, variables, batches, weights


def _bert_inputs():
    model = JaxBert(vocab_size=BERT_VOCAB, num_classes=2, size_name="tiny",
                    max_len=BERT_LEN, dropout_rate=0.0)
    r = np.random.default_rng(1)
    ids = [r.integers(1, BERT_VOCAB, size=(4, 16)).astype(np.int32)
           for _ in range(worker.STEPS)]
    mask = [np.ones_like(i) for i in ids]
    mask[1][:, 12:] = 0
    y = [r.integers(0, 2, size=(4,)).astype(np.int64)
         for _ in range(worker.STEPS)]
    variables = init_module(model, jax.random.PRNGKey(0), ids[0],
                            mask[0], train=False)
    weights = {k: v.numpy() for k, v in bert_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"])).items()}
    return model, variables, (ids, mask, y), weights


@pytest.fixture(scope="module")
def refs():
    return {"gpt": _gpt_inputs(False), "bert": _bert_inputs(),
            "moe": _gpt_inputs(True)}


@pytest.fixture(scope="module")
def world(refs, tmp_path_factory):
    """The spawned world's per-rank results (fails, never hangs, when a
    rank raised or outlived the join timeout)."""
    tmp = tmp_path_factory.mktemp("tp")
    g, m = refs["gpt"], refs["moe"]
    ids, mask, y = refs["bert"][2]
    inputs = {
        "gpt": {"vocab": GPT_VOCAB, "len": GPT_LEN, "weights": g[3],
                "batches": [b.astype(np.int64) for b in g[2]]},
        "bert": {"vocab": BERT_VOCAB, "len": BERT_LEN,
                 "weights": refs["bert"][3], "ids": ids, "mask": mask,
                 "y": y},
        "moe": {"vocab": GPT_VOCAB, "len": GPT_LEN, "weights": m[3],
                "batches": [b.astype(np.int64) for b in m[2]],
                "experts": MOE_EXPERTS, "capacity": MOE_CAPACITY,
                "top_k": MOE_TOP_K},
    }
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=worker.run,
                         args=(r, WORLD, store, str(tmp), inputs))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
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


def _jax_run(model, variables, axes, rules, args, loss, convert, **kw):
    """The JAX package's run on a 4-device (2, 2) mesh of ``axes`` under
    ``rules``: the loss and the whole weights (in the port's names) after
    each SGD step."""
    s = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd,
            optimizer_kwargs=dict(learning_rate=worker.SGD_LR)),
        loss, jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=GPT_BATCH // worker.SHAPE[0],
        distributed="dp",
        configs=[stoke_tpu.MeshConfig(axes=axes, shape=worker.SHAPE,
                                      devices=jax.devices("cpu")[:WORLD]),
                 stoke_tpu.PartitionRulesConfig(rules=rules)],
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False, **kw)
    losses, weights, aux = [], [], []
    for margs, largs in args:
        losses.append(float(s.train_step(margs, largs)))
        weights.append({k: v.numpy() for k, v in convert(
            jax.tree_util.tree_map(np.asarray, s.params)).items()})
        if s.aux_losses is not None:
            aux.append(float(jax.tree_util.tree_leaves(s.aux_losses)[0]))
    return losses, weights, aux


@pytest.fixture(scope="module")
def jax_runs(refs):
    g, b, m = refs["gpt"], refs["bert"], refs["moe"]
    steps = range(worker.STEPS)
    ids, mask, y = b[2]
    return {
        "gpt": _jax_run(g[0], g[1], ("data", "model"), jax_bert_rules(),
                        [(g[2][i], (g[2][i],)) for i in steps],
                        jax_causal_lm_loss, gpt_state_dict_from_jax),
        "bert": _jax_run(
            b[0], b[1], ("data", "model"), jax_bert_rules(),
            [((ids[i], mask[i]), (y[i],)) for i in steps],
            lambda logits, t: optax.softmax_cross_entropy_with_integer_labels(
                logits, t).mean(), bert_state_dict_from_jax),
        "moe": _jax_run(m[0], m[1], ("data", "expert"), jax_moe_rules(),
                        [(m[2][i], (m[2][i],)) for i in steps],
                        jax_causal_lm_loss, gpt_state_dict_from_jax,
                        aux_loss_weight=worker.AUX_WEIGHT,
                        grad_clip=stoke_tpu.ClipGradNormConfig(
                            max_norm=worker.CLIP)),
    }


@pytest.mark.parametrize("run", ["gpt", "bert", "moe"])
def test_split_training_matches_jax(world, jax_runs, run):
    """Every rank's losses and whole weights after each of three SGD
    steps against the JAX package with the same rules on the global
    batch (the MoE run's aux losses too)."""
    losses, weights, aux = jax_runs[run]
    for res in world:
        got = res[run]
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        for step, ref in enumerate(weights):
            for k, v in ref.items():
                np.testing.assert_allclose(got["weights"][step][k], v,
                                           err_msg=f"{run} {step} {k}",
                                           **TOL)
        if run == "moe":
            np.testing.assert_allclose(got["aux"], aux, **TOL)
            assert got["local_experts"] == MOE_EXPERTS // worker.SHAPE[1]


@pytest.mark.parametrize("run", ["gpt", "moe"])
def test_whole_leaves_have_equal_gradients_across_the_group(world, run):
    """The invariant: every leaf the rules leave whole has the same
    gradient bit for bit on every rank of the model (expert) group,
    the router's included; the split leaves' differ."""
    for res in world:
        inv = res[run]["invariant"]
        whole = {n: eq for n, (cut, eq) in inv.items() if not cut}
        assert whole and all(whole.values()), [
            n for n, eq in whole.items() if not eq]
        assert any(not eq for cut, eq in inv.values() if cut)
        if run == "moe":
            assert "layers.1.moe.router.weight" in whole


def test_split_slices_and_counts(world, refs):
    """Each rank holds half the heads, ff and experts; the parameter
    count is the whole model's; the rules are the sharding rules'
    overrides."""
    whole = refs["gpt"][3]
    for res in world:
        got = res["gpt"]
        assert got["counts"] == sum(v.size for v in whole.values())
        assert got["overrides"] == len(gpt_tensor_parallel_rules())
        assert got["shapes"]["layers.0.attention.qkv.weight"] == (192, 128)
        assert got["shapes"]["layers.0.ff_in.weight"] == (256, 128)
        assert got["shapes"]["layers.0.attention.out.weight"] == (128, 64)
    coords = {(r["gpt"]["data_rank"], r["gpt"]["model_rank"]) for r in world}
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    # Stoke.DataLoader rebuilt the world's sampler over the data axis
    for r in world:
        assert r["gpt"]["sampler"] == (worker.SHAPE[0],
                                       r["gpt"]["data_rank"])


def test_whole_copy_matches_the_split(world):
    """``TensorParallel.whole_copy`` across processes (the group shared
    by the copy, then dropped): the unsplit model of all heads, whose
    logits are the split run's."""
    for res in world:
        got = res["gpt"]["whole_copy"]
        assert got["heads"] == 2
        np.testing.assert_allclose(got["whole"], got["split"], rtol=1e-5,
                                   atol=1e-6)


def test_consolidated_tag_is_a_whole_runs(world, refs, tmp_path):
    """The split world's consolidated tag holds the whole arrays: loaded
    at world 1 into the unsplit model they are the gathered weights bit
    for bit, and that run's own save writes the same arrays; a split run
    loads it back to its slices bit for bit."""
    res = world[0]["gpt"]
    tag = res["tag"]
    for r in world:
        assert r["gpt"]["reloaded"]
    m = GPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=GPT_LEN,
            dropout_rate=0.0)
    s = Stoke(m, StokeOptimizer(torch.optim.SGD, lr=worker.SGD_LR),
              causal_lm_loss, batch_size_per_device=2, device="cpu",
              distributed="dp")
    s.load(os.path.dirname(tag))
    for n, t in s.model_access.state_dict().items():
        assert np.array_equal(t.numpy(), res["saved"][n]), n
    mine = s.save(str(tmp_path / "dp"))
    for key in ("variables", "opt_state"):
        a = np.load(os.path.join(tag, f"{key}.npz"))
        b = np.load(os.path.join(mine, f"{key}.npz"))
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert np.array_equal(a[f], b[f]), (key, f)
    s.close_telemetry()
