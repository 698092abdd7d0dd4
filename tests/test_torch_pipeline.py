"""Port parity: pipeline parallelism (``stoke_tpu_torch/parallel/
pipeline.py``, ``models/pipelined_lm.py`` and the stage cut of
``parallel/tensor.py``) against ``stoke_tpu/parallel/pipeline.py`` and
``stoke_tpu/models/pipelined_lm.py``.

Without a spawn, each against the JAX function on a 4-device ``stage``
mesh of the 8-device CPU backend, on the same numpy-seeded inputs
(``tests/test_pipeline.py``'s cases and tolerances: outputs rtol 2e-5,
atol 2e-6; gradients rtol 1e-4, atol 1e-5): S = 4 virtual stages in one
process (``virtual_pipeline``), GPipe at M = 6 (the all-reduce emission)
and 8 (the reduce-scatter), the circular schedule at rounds 2 and 4,
too few microbatches and a wrong lead dim (the JAX messages), remat
against no remat, a tuple wire, edges, ``stack_stage_params``, the
schedule's counts; PipelinedLM-tiny's logits and gradients through the
converter (fp32, rtol 1e-4), whole and over virtual stages; the
converter's round trip and the JAX layout; the rules, the strided cut and
the refusals; at world 1 under (1, 1) ``("data", "stage")`` and
``("stage",)`` meshes, the four calls, ``train_step``, ``train_steps``
and ``train_step_window`` bit for bit against the run without.

A gloo world of 4 (``tests/_torch_pp_worker.py``) is spawned once for the
module through a file store and joined with a 120 s deadline. In it,
``pipeline`` runs over the world as one stage group (M = 6 and 8, and
circular with remat) against the JAX pipeline's outputs and gradients,
and PipelinedLM-tiny trains by SGD on a ``("stage",)`` mesh of 4 (GPipe, M =
4 and the all-reduce emission at M = 2) and on a (2, 2) ``("data",
"stage")`` mesh (GPipe, and circular at rounds 2 with remat): three
``train_step``s, then ``train_steps`` of two one-step windows, each
step's loss and whole weights against the JAX PipelinedLM ``Stoke`` on a
4-device mesh of the same shape (``tests/test_torch_tensor_parallel.py``'s
tolerance, rtol 5e-4 and atol 5e-6); ``embed`` and ``head`` gradients
equal bit for bit across the stage group; a consolidated tag of each
(2, 2) run loaded at world 1 and into a fresh split run.
"""

import os
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F
from jax.sharding import Mesh
from torch.func import functional_call

import stoke_tpu
from stoke_tpu.models import PipelinedLM as JaxPipelinedLM
from stoke_tpu.models import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.models import pipeline_parallel_rules as jax_pp_rules
from stoke_tpu.parallel.pipeline import pipeline as jax_pipeline
from stoke_tpu.parallel.pipeline import (
    pipeline_with_edges as jax_pipeline_with_edges,
)
from stoke_tpu.parallel.pipeline import stack_stage_params as jax_stack
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch import configs as pc
from stoke_tpu_torch.convert import (
    jax_param_layout,
    jax_params_from_port,
    pipelined_lm_state_dict_from_jax,
    rank_state_dict,
    whole_state_dict,
)
from stoke_tpu_torch.models import (
    PipelinedLM,
    causal_lm_loss,
    pipeline_parallel_rules,
)
from stoke_tpu_torch.parallel import (
    ModelGroup,
    Schedule,
    pipeline,
    pipeline_with_edges,
    shard_module,
    stack_stage_params,
    virtual_pipeline,
)
from stoke_tpu_torch.status import StokeStatus

sys.path.insert(0, os.path.dirname(__file__))
import _torch_pp_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

S, M, B, D = 4, 6, 8, 16  # stages, microbatches, micro-batch, width
TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LM_RTOL = 1e-4
TRAIN_TOL = dict(rtol=5e-4, atol=5e-6)
WORLD = 4
JOIN_TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_process_group():
    """The world-1 runs' one-process group (made by the first ``Stoke``
    with ``distributed="dp"``), torn down after the module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its small tensors gain nothing
    from more, and beside the suite's other workers each spare thread
    spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stage_mesh():
    return Mesh(np.asarray(jax.devices("cpu")[:S]), ("stage",))


def jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def port_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def make_trees(rng, n):
    return [{"w": rng.normal(size=(D, D)).astype(np.float32) * 0.3,
             "b": rng.normal(size=(D,)).astype(np.float32) * 0.1}
            for _ in range(n)]


def port_stack(trees):
    return stack_stage_params([{k: torch.from_numpy(v) for k, v in t.items()}
                               for t in trees])


def jax_pass(mesh, trees, xs, fn=jax_stage, **kw):
    """The JAX pipeline's output and the gradients of ``sum(out ** 2)``
    with respect to the stacked params and the stream."""
    piped = jax_pipeline(fn, mesh, "stage", **kw)
    stacked = jax_stack(
        [{k: jnp.asarray(v) for k, v in t.items()} for t in trees])
    out = jax.jit(piped)(stacked, jnp.asarray(xs))
    grads = jax.jit(jax.grad(lambda p, x: jnp.sum(piped(p, x) ** 2),
                             argnums=(0, 1)))(stacked, jnp.asarray(xs))
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


def port_global(outs, n_micro):
    """The S virtual stages' emissions as the JAX global array: their
    rows in order where S divides M, else any one (each holds all M)."""
    return torch.cat(outs) if n_micro % len(outs) == 0 else outs[0]


def port_pass(trees, xs, stages=S, **kw):
    run = virtual_pipeline(port_stage, stages, **kw)
    stacked = {k: v.requires_grad_() for k, v in port_stack(trees).items()}
    x = torch.from_numpy(xs).requires_grad_()
    out = port_global(run(stacked, x), xs.shape[0])
    (out ** 2).sum().backward()
    return out.detach().numpy(), ({k: v.grad.numpy()
                                   for k, v in stacked.items()},
                                  x.grad.numpy()), run


def sequential(trees, xs):
    out = []
    for m in range(xs.shape[0]):
        h = torch.from_numpy(xs[m])
        for t in trees:
            h = port_stage({k: torch.from_numpy(v) for k, v in t.items()}, h)
        out.append(h)
    return torch.stack(out).numpy()


def assert_grads(got, want):
    (gp, gx), (wp, wx) = got, want
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], err_msg=k, **GRAD_TOL)
    np.testing.assert_allclose(gx, wx, err_msg="xs", **GRAD_TOL)


# ---------------------------------------------------------------------- #
# the function over virtual stages
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("n_micro", [6, 8], ids=["all_reduce",
                                                 "reduce_scatter"])
def test_pipeline_matches_jax_and_sequential(stage_mesh, n_micro):
    """GPipe over 4 virtual stages equals running the stages in turn bit
    for bit, and the JAX pipeline (outputs and gradients); each stage
    ends with its M / S rows where S divides M, else with all M."""
    rng = np.random.default_rng(42)
    trees = make_trees(rng, S)
    xs = rng.normal(size=(n_micro, B, D)).astype(np.float32)
    out, grads, run = port_pass(trees, xs)
    np.testing.assert_array_equal(out, sequential(trees, xs))
    jout, jgrads = jax_pass(stage_mesh, trees, xs)
    np.testing.assert_allclose(out, jout, **TOL)
    assert_grads(grads, jgrads)
    stacked = port_stack(trees)
    outs = virtual_pipeline(port_stage, S)(stacked, torch.from_numpy(xs))
    want = n_micro // S if n_micro % S == 0 else n_micro
    assert [o.shape[0] for o in outs] == [want] * S


@pytest.mark.parametrize("rounds", [2, 4])
def test_circular_matches_jax(stage_mesh, rounds):
    """rounds=V: V·S stages interleaved over S virtual stages (stage d
    runs stages[d::S]) equal the V·S-stage sequential run and the JAX
    circular schedule, outputs and gradients."""
    rng = np.random.default_rng(7 + rounds)
    trees = make_trees(rng, rounds * S)
    xs = rng.normal(size=(M, B, D)).astype(np.float32)
    out, grads, _ = port_pass(trees, xs, rounds=rounds)
    np.testing.assert_array_equal(out, sequential(trees, xs))
    jout, jgrads = jax_pass(stage_mesh, trees, xs, rounds=rounds)
    np.testing.assert_allclose(out, jout, **TOL)
    assert_grads(grads, jgrads)


def test_circular_rejects_too_few_microbatches(stage_mesh):
    rng = np.random.default_rng(0)
    trees = make_trees(rng, 2 * S)
    xs = np.zeros((S - 1, B, D), np.float32)
    with pytest.raises(ValueError, match="microbatches") as theirs:
        jax_pass(stage_mesh, trees, xs, rounds=2)
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        virtual_pipeline(port_stage, S, rounds=2)(port_stack(trees),
                                                  torch.from_numpy(xs))
    with pytest.raises(ValueError, match="rounds must be >= 1"):
        pipeline(port_stage, rounds=0)


def test_wrong_lead_dim_raises_as_jax(stage_mesh):
    rng = np.random.default_rng(1)
    trees = make_trees(rng, S + 1)
    xs = np.zeros((M, B, D), np.float32)
    with pytest.raises(ValueError, match="lead dim") as theirs:
        jax_pass(stage_mesh, trees, xs)
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        virtual_pipeline(port_stage, S)(port_stack(trees),
                                        torch.from_numpy(xs))
    with pytest.raises(ValueError, match=r"lead dim 5 != rounds×stages "
                       r"= 4×1"):
        pipeline(port_stage, None, rounds=S)(port_stack(trees),
                                             torch.from_numpy(xs))
    with pytest.raises(ValueError, match="virtual_pipeline"):
        pipeline(port_stage, ModelGroup(None, S, 0, "stage"))


def test_remat_equals_no_remat():
    """remat=True recomputes each tick's stage application: the same
    outputs and gradients bit for bit."""
    rng = np.random.default_rng(3)
    trees = make_trees(rng, 2 * S)
    xs = rng.normal(size=(M, B, D)).astype(np.float32)
    plain = port_pass(trees, xs, rounds=2)
    remat = port_pass(trees, xs, rounds=2, remat=True)
    np.testing.assert_array_equal(remat[0], plain[0])
    for k in plain[1][0]:
        np.testing.assert_array_equal(remat[1][0][k], plain[1][0][k])
    np.testing.assert_array_equal(remat[1][1], plain[1][1])


def test_tuple_wire(stage_mesh):
    """The wire may be a tree, uniform over the stages: an (h, gate)
    pair, against the JAX pipeline of the same tuple."""

    def jstage(p, x):
        return jnp.tanh(x[0] @ p["w"] + p["b"]), x[1] * 0.9

    def tstage(p, x):
        return torch.tanh(x[0] @ p["w"] + p["b"]), x[1] * 0.9

    rng = np.random.default_rng(4)
    trees = make_trees(rng, S)
    h = rng.normal(size=(M, B, D)).astype(np.float32)
    g = np.ones((M, B, 1), np.float32)
    piped = jax.jit(jax_pipeline(jstage, stage_mesh, "stage"))
    jout = piped(jax_stack(
        [{k: jnp.asarray(v) for k, v in t.items()} for t in trees]),
        (jnp.asarray(h), jnp.asarray(g)))
    outs = virtual_pipeline(tstage, S)(
        port_stack(trees), (torch.from_numpy(h), torch.from_numpy(g)))
    for got, want in zip(outs[0], jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pipeline_with_edges(stage_mesh):
    """Non-uniform edges (token ids -> embedding, hidden -> logits) around
    the trunk, as the JAX ``pipeline_with_edges``; the port's at one
    process runs the four stages as rounds of one."""
    vocab = 11
    rng = np.random.default_rng(5)
    trees = make_trees(rng, S)
    emb = rng.normal(size=(vocab, D)).astype(np.float32) * 0.3
    head = rng.normal(size=(D, vocab)).astype(np.float32) * 0.3
    ids = rng.integers(0, vocab, size=(M, B)).astype(np.int64)
    run = jax_pipeline_with_edges(lambda e, x: e[x], jax_stage,
                                     lambda h, a: a @ h, stage_mesh, "stage")
    jout = np.asarray(jax.jit(run)((jnp.asarray(emb), jnp.asarray(head)),
                          jax_stack(
                              [{k: jnp.asarray(v) for k, v in t.items()}
                               for t in trees]), jnp.asarray(ids)))
    mine = pipeline_with_edges(lambda e, x: e[x], port_stage,
                               lambda h, a: a @ h, None, rounds=S)
    out = mine((torch.from_numpy(emb), torch.from_numpy(head)),
               port_stack(trees), torch.from_numpy(ids))
    assert out.shape == (M, B, vocab)
    np.testing.assert_allclose(out.numpy(), jout, **TOL)


def test_stack_stage_params():
    rng = np.random.default_rng(6)
    trees = make_trees(rng, 3)
    want = jax_stack(trees)
    got = port_stack(trees)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_schedule_counts_and_bubble():
    """The virtual schedule runs V·M + S - 1 ticks, every stage each
    tick, V·M·S of them useful; the circular bubble is the JAX
    accounting's (``test_bubble_accounting``)."""
    rng = np.random.default_rng(8)
    for V, n in ((1, 6), (2, 4)):
        trees = make_trees(rng, V * S)
        run = virtual_pipeline(port_stage, S, rounds=V)
        run(port_stack(trees), torch.zeros(n, B, D))
        sched = Schedule(S, V, n)
        assert run.counts == {"ticks": sched.ticks,
                              "applications": sched.applications,
                              "useful": sched.useful}
        assert sched.bubble == pytest.approx((S - 1) / (V * n + S - 1))
    assert Schedule(4, 4, 8).bubble < (15 / (8 + 15)) / 3


# ---------------------------------------------------------------------- #
# PipelinedLM and the converter
# ---------------------------------------------------------------------- #


LM_VOCAB, LM_LEN = 32, 32


def draw_params(model, seed):
    """The JAX model's ``params`` drawn from a numpy seed at the shapes of
    its init (``jax.eval_shape``: its per-stage flax inits run op by op,
    seconds each)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.normal(size=leaf.shape)
        name = path[-1].key
        x = 1.0 + 0.1 * x if name == "scale" else x * (
            0.02 if name == "bias" else 0.05)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_lm(stage_mesh, rounds, n_micro=4):
    model = JaxPipelinedLM(stage_mesh, vocab_size=LM_VOCAB, size_name="tiny",
                           max_len=LM_LEN, num_microbatches=n_micro,
                           layers_per_stage=1, rounds=rounds)
    return model, draw_params(model, rounds)


def port_lm(params, rounds, n_micro=4):
    m = PipelinedLM(vocab_size=LM_VOCAB, size_name="tiny", max_len=LM_LEN,
                    num_microbatches=n_micro, layers_per_stage=1,
                    rounds=rounds, stages=S)
    m.load_state_dict(pipelined_lm_state_dict_from_jax(params))
    return m


def virtual_lm(m, ids, stages, rounds):
    """PipelinedLM's forward with its stack over ``stages`` virtual
    stages (the model's own forward needs a process group for that)."""
    b, L = ids.shape
    n = m.num_microbatches
    h = F.embedding(ids, m.embed.tok) + m.embed.pos[:L][None]
    bias = torch.where(torch.tril(torch.ones(L, L, dtype=torch.bool)), 0.0,
                       -1e9)[None, None]
    run = virtual_pipeline(
        lambda p, x: functional_call(m.stages, p, (x, bias)), stages,
        rounds=rounds)
    outs = run(dict(m.stages.named_parameters()), h.reshape(n, b // n, L, -1))
    return port_global(outs, n).reshape(b, L, -1) @ m.head


@pytest.mark.parametrize("rounds", [1, 2])
def test_pipelined_lm_matches_jax(stage_mesh, rounds):
    """PipelinedLM-tiny (one block a stage, 4·rounds stages) from the JAX
    model's parameters through the converter: logits and the gradients
    of ``sum(logits * dout)`` against the JAX model on a 4-device stage
    mesh (fp32, rtol 1e-4 of each tensor's largest magnitude), the whole
    model and its stack over 4 virtual stages alike."""
    model, params = jax_lm(stage_mesh, rounds)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, LM_VOCAB, size=(8, 16)).astype(np.int32)
    dout = rng.normal(size=(8, 16, LM_VOCAB)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    logits, vjp = jax.vjp(jax.jit(lambda p: model._forward(
        p, jnp.asarray(ids))), jparams)
    want_sd = pipelined_lm_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, vjp(jnp.asarray(dout))[0]))
    for forward in (lambda m, x: m(x),
                    lambda m, x: virtual_lm(m, x, S, rounds)):
        m = port_lm(params, rounds)
        out = forward(m, torch.from_numpy(ids).long())
        (out * torch.from_numpy(dout)).sum().backward()
        np.testing.assert_allclose(
            out.detach().numpy(), np.asarray(logits),
            atol=LM_RTOL * float(np.abs(logits).max()))
        for n, p in m.named_parameters():
            w = want_sd[n].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, err_msg=n,
                                       atol=LM_RTOL * np.abs(w).max())


def test_converter_round_trip_and_jax_layout(stage_mesh):
    """JAX params -> the port -> JAX is exact; ``jax_param_layout`` names
    each stacked leaf by its JAX path and shape, and the port's tensor
    permuted and reshaped by it is the JAX leaf."""
    _, params = jax_lm(stage_mesh, 2)
    m = port_lm(params, 2)
    back = jax_params_from_port(m)
    theirs = jax.tree_util.tree_leaves_with_path(params)
    mine = jax.tree_util.tree_leaves_with_path(back)
    assert [k for k, _ in mine] == [k for k, _ in theirs]
    for (k, a), (_, b) in zip(mine, theirs):
        np.testing.assert_array_equal(a, b, err_msg=str(k))
    for name, (path, perm, shape) in jax_param_layout(m).items():
        leaf = params
        for k in path:
            leaf = leaf[k]
        t = m.state_dict()[name]
        t = t.permute(perm) if perm else t
        assert tuple(leaf.shape) == shape, name
        np.testing.assert_array_equal(t.reshape(shape).numpy(), leaf)
    assert jax_param_layout(m)["stages.block_0.attention.qkv.weight"][2] \
        == (8, 128, 3, 2, 64)


# ---------------------------------------------------------------------- #
# the rules and the stage cut
# ---------------------------------------------------------------------- #


def test_rules_are_jax():
    assert pipeline_parallel_rules() == jax_pp_rules()
    assert pipeline_parallel_rules("pp") == jax_pp_rules("pp")


@pytest.mark.parametrize("rounds", [1, 2])
def test_stage_cut_is_strided(rounds):
    """Rank d of S holds stages[d::S] of every stacked leaf (the JAX
    ``[V, S, ...]`` reshape sharded on dim 1), the rest stays whole; the
    ranks' slices put back give the whole stack; the model gets the
    group; the layout reports the held ``[V, ...]`` shapes."""
    whole = PipelinedLM(vocab_size=LM_VOCAB, size_name="tiny", max_len=LM_LEN,
                        layers_per_stage=1, rounds=rounds, stages=S)
    whole.init_weights(3)
    sd = whole.state_dict()
    parts = []
    for r in range(S):
        m = PipelinedLM(vocab_size=LM_VOCAB, size_name="tiny",
                        max_len=LM_LEN, layers_per_stage=1, rounds=rounds,
                        stages=S)
        m.init_weights(3)
        group = ModelGroup(None, S, r, "stage")
        tp = shard_module(m, pipeline_parallel_rules(), group)
        assert m.group is group
        for n, t in m.state_dict().items():
            if n.startswith("stages."):
                assert torch.equal(t, sd[n][r::S]), n
                assert tp.cuts[n].local == (rounds, *sd[n].shape[1:])
            else:
                assert torch.equal(t, sd[n]) and n not in tp.cuts, n
        assert set(tp.placed) == set(tp.cuts)
        layout = jax_param_layout(m)
        assert layout["stages.block_0.ff_in.weight"][2] == (rounds, 128,
                                                           512)
        parts.append(m.state_dict())
        assert all(torch.equal(v, rank_state_dict(sd, tp.cuts, r)[n])
                   for n, v in parts[-1].items())
    back = whole_state_dict(parts, tp.cuts)
    for n, t in sd.items():
        assert torch.equal(back[n], t), n


@pytest.mark.parametrize("rules", [
    ((r"^stages/", (None, "stage", "...")),),
    ((r"^stages/block_0/attention/", ("stage", "...")),),
    ((r"^embed/tok", ("stage", None)), (r"^stages/", ("stage", "..."))),
], ids=["stage_dim_1", "part_of_the_set", "embedding"])
def test_other_rules_under_a_stage_axis_name_8e(rules):
    """A placement on the stage axis outside the stage set stays refused:
    since item 8e landed its message names item 8f (the ranks of a stage
    axis compute different gradients)."""
    m = PipelinedLM(vocab_size=LM_VOCAB, size_name="tiny", max_len=LM_LEN,
                    layers_per_stage=1, stages=2)
    with pytest.raises(NotImplementedError, match=r"item 8f\b") as e:
        shard_module(m, rules, ModelGroup(None, 2, 0, "stage"))
    assert "8e" not in str(e.value)


def test_indivisible_stage_count_names_the_leaf():
    m = PipelinedLM(vocab_size=LM_VOCAB, size_name="tiny", max_len=LM_LEN,
                    layers_per_stage=1, stages=3)
    with pytest.raises(ValueError, match=r"dim 0 \(3 stages\) on the "
                       r"'stage' axis of 2 devices"):
        shard_module(m, pipeline_parallel_rules(),
                     ModelGroup(None, 2, 0, "stage"))


@pytest.mark.parametrize("case", ["fsdp", "comm", "sharded", "three_axes"])
def test_later_options_under_a_stage_axis_name_their_item(case):
    mesh = pc.MeshConfig(axes=("data", "stage"), shape=(1, 2))
    configs, flags, item = {
        "fsdp": ([mesh], dict(fsdp=True), "8d"),
        "comm": ([mesh, pc.CommConfig()], {}, "8d"),
        "sharded": ([mesh, pc.CheckpointConfig(
            format=pc.CheckpointFormat.sharded)], {}, "8d"),
        "three_axes": ([pc.MeshConfig(axes=("data", "stage", "model"))],
                       {}, "8e"),
    }[case]
    if item in ("8d", "8e"):
        # landed with items 8d and 8e: the status layer takes them
        st = StokeStatus(batch_size_per_device=4, device="cpu",
                         distributed="dp", configs=configs, **flags)
        assert (st.sharding_tier.value == "fsdp"
                or st.comm_config is not None
                or st.checkpoint_config.format
                is pc.CheckpointFormat.sharded
                or st.mesh_config.axes == ("data", "stage", "model"))
        return
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1 item {item}\\b"):
        StokeStatus(batch_size_per_device=4, device="cpu", distributed="dp",
                    configs=configs, **flags)


def _world_one(mesh, rounds, remat, n_micro=2):
    """PipelinedLM-tiny by AdamW at world 1: one four-call step, two
    ``train_step``s, ``train_steps`` of two and a ``train_step_window``,
    under ``pipeline_parallel_rules`` on ``mesh`` (or without a mesh):
    the losses, the weights, the split."""
    m = PipelinedLM(vocab_size=LM_VOCAB, size_name="tiny", max_len=LM_LEN,
                    num_microbatches=n_micro, rounds=rounds, remat=remat)
    m.init_weights(1)
    cfgs = [] if mesh is None else [
        mesh, pc.PartitionRulesConfig(rules=pipeline_parallel_rules())]
    s = Stoke(m, StokeOptimizer(torch.optim.AdamW, lr=3e-3), causal_lm_loss,
              batch_size_per_device=4, device="cpu",
              distributed=None if mesh is None else "dp", configs=cfgs)
    r = np.random.default_rng(0)
    xs = torch.from_numpy(r.integers(0, LM_VOCAB, size=(6, 4, 16)))
    s.backward(s.loss(s.model(xs[0]), xs[0]))
    s.step()
    losses = [float(s.train_step(x, x)) for x in xs[1:3]]
    losses += [float(v) for v in s.train_steps(xs[3:5], xs[3:5]).reshape(-1)]
    losses += [float(v) for v in s.train_step_window(xs[5:6], xs[5:6])]
    out = (losses, {k: v.clone() for k, v in
                    s.model_access.state_dict().items()}, s.tensor_parallel)
    s.close_telemetry()
    return out


@pytest.mark.parametrize("mesh,rounds,remat", [
    ("data_stage", 1, False), ("data_stage", 2, True), ("stage", 1, False),
], ids=["gpipe", "circular_remat", "stage_mesh"])
def test_world_one_stage_mesh_is_bit_for_bit(mesh, rounds, remat):
    """At world 1 the stage cut is the whole stack and the pipeline's
    hops and collectives are the identity: the four calls, train_step and
    the windows bit for bit against the same run without a mesh."""
    cfg = (pc.MeshConfig(axes=("data", "stage"), shape=(1, 1))
           if mesh == "data_stage" else pc.MeshConfig(axes=("stage",)))
    split = _world_one(cfg, rounds, remat)
    plain = _world_one(None, rounds, remat)
    assert split[2] is not None and split[2].size == 1
    assert sorted(split[2].cuts) == sorted(
        n for n in plain[1] if n.startswith("stages."))
    assert split[0] == plain[0]
    for n, t in plain[1].items():
        assert torch.equal(split[1][n], t), n


# ---------------------------------------------------------------------- #
# the world of 4 and its JAX references
# ---------------------------------------------------------------------- #


def _jax_mesh(axes, shape):
    return Mesh(np.asarray(jax.devices("cpu")[:WORLD]).reshape(shape), axes)


@pytest.fixture(scope="module")
def refs():
    """Each run's initial weights (the JAX model's, converted), global
    batches, and the JAX PipelinedLM ``Stoke``'s losses and weights (the
    port's names) after each SGD step on a 4-device mesh of the run's
    shape."""
    out = {}
    steps = worker.EAGER + worker.WINDOWS
    for name, (axes, shape, rounds, remat, n_micro, batch) in \
            worker.RUNS.items():
        mesh = _jax_mesh(axes, shape)
        model = JaxPipelinedLM(
            mesh, vocab_size=worker.VOCAB, size_name="tiny",
            max_len=worker.MAX_LEN, num_microbatches=n_micro,
            layers_per_stage=1, rounds=rounds, remat=remat,
            data_axis="data" if "data" in axes else None)
        variables = {"params": draw_params(model, 2)}
        r = np.random.default_rng(len(out))
        batches = [r.integers(0, worker.VOCAB, size=(batch, 16)).astype(
            np.int32) for _ in range(steps + 1)]
        weights = {k: v.numpy() for k, v in pipelined_lm_state_dict_from_jax(
            variables["params"]).items()}
        s = stoke_tpu.Stoke(
            model, stoke_tpu.StokeOptimizer(
                optimizer=optax.sgd,
                optimizer_kwargs=dict(learning_rate=worker.SGD_LR)),
            jax_causal_lm_loss, variables,
            batch_size_per_device=batch // shape[0], device="cpu",
            distributed="dp",
            configs=[stoke_tpu.MeshConfig(axes=axes, shape=shape,
                                          devices=jax.devices("cpu")[:WORLD]),
                     stoke_tpu.PartitionRulesConfig(rules=jax_pp_rules())],
            verbose=False)
        losses, after = [], []
        for b in batches[:steps]:
            losses.append(float(s.train_step(b, b)))
            after.append({k: v.numpy() for k, v in
                          pipelined_lm_state_dict_from_jax(
                              jax.tree_util.tree_map(np.asarray,
                                                     s.params)).items()})
        out[name] = {"weights": weights, "batches": [
            b.astype(np.int64) for b in batches], "losses": losses,
            "after": after}
    return out


@pytest.fixture(scope="module")
def function_refs(stage_mesh):
    """Each function case's whole stack and stream, and the JAX
    pipeline's output and gradients of ``sum(out ** 2)`` over them."""
    out = []
    for i, (n_micro, rounds, remat) in enumerate(worker.FUNCTION_CASES):
        rng = np.random.default_rng(20 + i)
        trees = make_trees(rng, rounds * S)
        xs = rng.normal(size=(n_micro, B, D)).astype(np.float32)
        jout, jgrads = jax_pass(stage_mesh, trees, xs, rounds=rounds,
                                remat=remat)
        out.append({"stacked": {k: v.numpy() for k, v in
                                port_stack(trees).items()},
                    "xs": xs, "out": jout, "grads": jgrads})
    return out


@pytest.fixture(scope="module")
def world(refs, function_refs, tmp_path_factory):
    """The spawned world's per-rank results (fails, never hangs, when a
    rank raised or outlived the deadline)."""
    tmp = tmp_path_factory.mktemp("pp")
    inputs = {n: {"weights": r["weights"], "batches": r["batches"]}
              for n, r in refs.items()}
    inputs["function"] = {"cases": [
        {"stacked": c["stacked"], "xs": c["xs"]} for c in function_refs]}
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


@pytest.mark.parametrize("case", range(len(worker.FUNCTION_CASES)),
                         ids=["all_reduce", "reduce_scatter",
                              "circular_remat"])
def test_function_pipeline_across_processes_matches_jax(world,
                                                         function_refs,
                                                         case):
    """``pipeline`` over a stage group of 4 processes: rank d emits
    microbatches [d·M/S, (d+1)·M/S) of the JAX global output where S
    divides M, else all of it; the ranks' stack gradients summed (each
    nonzero at its own slices only) and every rank's stream gradient
    (summed over the group by the entry's transpose) are the JAX
    gradients."""
    ref = function_refs[case]
    n_micro = worker.FUNCTION_CASES[case][0]
    rows = n_micro // WORLD if n_micro % WORLD == 0 else None
    for d, res in enumerate(world):
        got = res["function"][case]
        want = ref["out"] if rows is None else ref["out"][d * rows:
                                                          (d + 1) * rows]
        np.testing.assert_allclose(got["out"], want, **TOL)
        np.testing.assert_allclose(got["xs_grad"], ref["grads"][1],
                                   **GRAD_TOL)
        lead = ref["stacked"]["w"].shape[0]
        held = np.zeros(lead, bool)
        held[d::WORLD] = True
        assert not np.any(got["grads"]["w"][~held])
    for k in ref["grads"][0]:
        total = sum(r["function"][case]["grads"][k] for r in world)
        np.testing.assert_allclose(total, ref["grads"][0][k], err_msg=k,
                                   **GRAD_TOL)


@pytest.mark.parametrize("run", sorted(worker.RUNS))
def test_pipelined_training_matches_jax(world, refs, run):
    """Every rank's loss and whole weights after each of three
    ``train_step``s and two replayed ``train_steps`` windows against the
    JAX PipelinedLM ``Stoke`` on the global batch."""
    ref = refs[run]
    for res in world:
        got = res[run]
        np.testing.assert_allclose(got["losses"], ref["losses"], **TRAIN_TOL)
        for step, want in enumerate(ref["after"]):
            for k, v in want.items():
                np.testing.assert_allclose(got["weights"][step][k], v,
                                           err_msg=f"{run} {step} {k}",
                                           **TRAIN_TOL)


@pytest.mark.parametrize("run", sorted(worker.RUNS))
def test_edge_gradients_are_equal_across_the_stage_group(world, run):
    """``embed`` and ``head`` end a backward with the same gradient bit
    for bit on every rank of the stage group; the cut stage leaves'
    differ."""
    for res in world:
        edges = res[run]["edges"]
        whole = {n: eq for n, (cut, eq) in edges.items() if not cut}
        assert sorted(whole) == ["embed.pos", "embed.tok", "head"]
        assert all(whole.values()), whole
        assert any(not eq for cut, eq in edges.values() if cut)


def test_stage_cut_in_the_world(world, refs):
    """Each rank holds its V stages of every stacked leaf; the parameter
    count is the whole model's; the stage ranks cover the group."""
    for run, (axes, shape, rounds, *_) in worker.RUNS.items():
        whole = refs[run]["weights"]
        ranks = sorted(r[run]["stage_rank"] for r in world)
        assert ranks == sorted(list(range(shape[-1])) * (WORLD
                                                         // shape[-1]))
        for res in world:
            got = res[run]
            assert got["stages"] == shape[-1]
            assert got["counts"] == sum(v.size for v in whole.values())
            assert got["shapes"]["stages.block_0.ff_in.weight"] == (
                rounds, 512, 128)


@pytest.mark.parametrize("run", sorted(worker.RUNS))
def test_whole_copy_runs_the_stack_in_one_process(world, run):
    """``TensorParallel.whole_copy`` gathers the stage slices back into
    the whole stack and drops the model's group: in one process it runs
    all V·S stages in turn, and its logits are the split model's."""
    shape, rounds = worker.RUNS[run][1], worker.RUNS[run][2]
    for res in world:
        got = res[run]["whole_copy"]
        assert got["group"] is None
        assert got["stages"] == rounds * shape[-1]
        np.testing.assert_allclose(got["logits"], got["split_logits"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("run", ["dp_pp", "dp_pp_circular"])
def test_consolidated_tag_loads_at_world_one(world, run, tmp_path):
    """A (2, 2) run's consolidated tag holds the whole stack in the JAX
    layout's order: loaded at world 1 into the unsplit model it is the
    gathered weights bit for bit, and a fresh split run of other weights
    loaded it back to its own slices."""
    res = world[0][run]
    for r in world:
        assert r[run]["reloaded"]
    m = worker.model_for(run)
    s = Stoke(m, StokeOptimizer(torch.optim.SGD, lr=worker.SGD_LR),
              causal_lm_loss, batch_size_per_device=2, device="cpu",
              distributed="dp")
    s.load(os.path.dirname(res["tag"]))
    for n, t in s.model_access.state_dict().items():
        assert np.array_equal(t.numpy(), res["saved"][n]), n
    s.close_telemetry()
