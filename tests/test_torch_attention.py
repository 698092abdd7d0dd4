"""Port parity: sequence-parallel attention (``stoke_tpu_torch/ops/
attention.py``) and GPT under ``DataParallelConfig(shard_seq_dim=1)``
against ``stoke_tpu/ops/attention.py`` and the JAX package's dp.

A gloo world of 4 (``tests/_torch_seqpar_worker.py``) is spawned once for
the module through a file store (its inputs sent in a file) and joined
with a 120 s timeout; the JAX references are computed while it runs. In
it:

- ring, zigzag ring and Ulysses (flash inner, causal, a padding mask) on
  ("data", "seq") meshes (1, 4) and (2, 2), each rank on its shard,
  forward and the gradients of ``sum(out ** 2)``; the JAX functions run
  on the same global arrays over 4-device CPU meshes of the same shapes.
  Tolerances are ``tests/test_attention.py``'s: outputs rtol 2e-5, atol
  2e-6; gradients rtol 1e-4, atol 1e-5;
- GPT-tiny trained two SGD steps by ``Stoke`` on the mesh, each process
  fed its data row's whole sequences (the placement cuts its sequence
  shard): the eval logits, each step's loss and each step's gradient
  (``(w_before - w_after) / lr``) within 1e-3 of each tensor's largest
  magnitude of the JAX package's dp on the global batch;
- on a (2, 2) mesh, the shard kept to its own calls beside a mesh-less
  ``Stoke``;
- the global view (no ``shard_seq_dim``) on the (2, 2) mesh: GPT-tiny
  under ring, zigzag (zigzag-ordered rows, ``positions=perm``), Ulysses
  and flash attention, two SGD steps against the JAX facade on the same
  mesh with the same attention (losses and gradients within 1e-3 of each
  tensor's largest magnitude; the eval logits against the JAX dp run's),
  a data row's processes bit-equal; the four calls, windows under oss,
  sddp, ``train_steps`` under fsdp with remat and a save loaded by a dp
  Stoke against ``train_step``; dropout and MoE router noise drawn alike
  across a row; and a (1, 2, 2) ("data", "seq", "model") mesh with the
  Megatron rules against JAX on the same mesh shape;
- under ``shard_seq_dim=1``, rows of 2·S + 1 tokens run whole (the
  global view) with flash attention against the JAX facade, and the ring
  adapter at that length raises the JAX package's ``ValueError``;
- ``Stoke.DataLoader``'s rows by the data coordinate, with and without
  ``shard_seq_dim``, and ``FleetConfig(rebalance=True)`` by data row,
  one process of row 1 reading slowly: the verdict against the JAX
  ``straggler_verdict`` on the row-folded matrix, equal shares, each
  row's rows canonical.

Without a spawn: virtual shards in one process, the adapters' guards, the
zigzag helpers, the ``inner="auto"`` divergence (ROADMAP Queue 3) and,
at world 1 under a (1, 1) mesh, ring, zigzag and Ulysses training bit for
bit against flash attention.
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

import stoke_tpu
from stoke_tpu import configs as jc
from stoke_tpu.models import bert_tensor_parallel_rules as jax_bert_rules
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.gpt import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.ops import attention as jax_attention
from stoke_tpu.ops import make_flash_attention as jax_make_flash_attention
from stoke_tpu.telemetry.fleet import FLEET_INDEX as JAX_FLEET_INDEX
from stoke_tpu.telemetry.fleet import straggler_verdict as jax_verdict
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch.configs import DataParallelConfig, MeshConfig
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.ops import attention as port_attention
from stoke_tpu_torch.ops.flash_attention import dense_reference

sys.path.insert(0, os.path.dirname(__file__))
import _torch_seqpar_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module: its small tensors gain nothing
    from more, and beside the suite's other workers each spare thread
    spins against theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORLD = 4
JOIN_TIMEOUT_S = 120
B, H, L, D = 2, 4, 32, 8
GPT_VOCAB, GPT_LEN, GPT_BATCH = 257, 16, 4
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARITY_TOL = 1e-3


def _attention_inputs():
    r = np.random.default_rng(3)
    q, k, v = (r.normal(size=(B, H, L, D)).astype(np.float32)
               for _ in range(3))
    m = np.ones((B, L), np.int32)
    m[0, 20:] = 0
    m[1, 27:] = 0
    return {"B": B, "q": q, "k": k, "v": v, "mask": m}


def _jax_gpt(attention_fn=None):
    kw = ({} if attention_fn is None else
          dict(attention_fn=attention_fn, attention_is_causal=True))
    return JaxGPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=GPT_LEN,
                  dropout_rate=0.0, **kw)


def _gpt_inputs():
    """GPT-tiny's parameters drawn from a numpy seed at ``jax.eval_shape``
    shapes (LayerNorm scales near 1, small biases and weights), the
    global batches and the port's weights."""
    model = _jax_gpt()
    r = np.random.default_rng(5)
    batches = [r.integers(0, GPT_VOCAB, size=(GPT_BATCH, GPT_LEN)).astype(
        np.int32) for _ in range(worker.GPT_STEPS)]
    shapes = jax.eval_shape(lambda k: model.init(k, batches[0], train=False),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        x = r.normal(size=leaf.shape)
        name = path[-1].key
        x = 1.0 + 0.1 * x if name == "scale" else x * (
            0.02 if name == "bias" else 0.05)
        return x.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    weights = {k: v.numpy() for k, v in
               gpt_state_dict_from_jax(variables["params"]).items()}
    return model, variables, batches, weights


@pytest.fixture(scope="module")
def gpt_inputs():
    return _gpt_inputs()


@pytest.fixture(scope="module")
def inputs(gpt_inputs):
    _, _, batches, weights = gpt_inputs
    return {"attention": _attention_inputs(),
            "gpt": {"vocab": GPT_VOCAB, "len": GPT_LEN,
                    "batches": [b.astype(np.int64) for b in batches],
                    "weights": weights}}


@pytest.fixture(scope="module")
def run(inputs, gpt_inputs, tmp_path_factory):
    """The spawned world's per-rank results (fails, never hangs, when a
    rank raised or outlived the join timeout) and the JAX references,
    computed while the world runs."""
    tmp = tmp_path_factory.mktemp("seqpar")
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
    sent = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, sent)
    procs = [ctx.Process(target=worker.run,
                         args=(r, WORLD, store, str(tmp), sent))
             for r in range(WORLD)]
    started = time.monotonic()
    for p in procs:
        p.start()
    try:
        refs = _jax_references(inputs, gpt_inputs)
    finally:
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
    return out, refs


@pytest.fixture(scope="module")
def world(run):
    return run[0]


@pytest.fixture(scope="module")
def refs(run):
    return run[1]


# ---------------------------------------------------------------------- #
# the JAX references
# ---------------------------------------------------------------------- #


def _jax_mesh(shape, axes=("data", "seq")):
    return Mesh(np.asarray(jax.devices("cpu")[:WORLD]).reshape(shape), axes)


def _jax_attention(impl, shape, a):
    """The JAX function on the global arrays over the mesh: its output
    (natural order) and the gradients of ``sum(out ** 2)``."""
    mesh = _jax_mesh(shape)
    m = jnp.asarray(a["mask"])
    if impl == "zigzag":
        perm = jax_attention.zigzag_permutation(L, shape[1])
        inv = jax_attention.inverse_permutation(perm)

        def f(q, k, v):
            o = jax_attention.zigzag_ring_attention(
                q[:, :, perm], k[:, :, perm], v[:, :, perm], m[:, perm],
                mesh=mesh, axis_name="seq")
            return o[:, :, inv]
    else:
        fn = (jax_attention.ring_attention if impl == "ring"
              else jax_attention.ulysses_attention)

        def f(q, k, v):
            return fn(q, k, v, m, mesh=mesh, axis_name="seq", causal=True,
                      inner="flash")

    def both(q, k, v):
        o, vjp = jax.vjp(f, q, k, v)
        return o, vjp(2 * o)

    o, grads = jax.jit(both)(*(jnp.asarray(a[n]) for n in ("q", "k", "v")))
    return np.asarray(o), [np.asarray(g) for g in grads]


def _port_weights(params):
    return {k: v.numpy() for k, v in gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}


def _jax_stoke(model, variables, axes=None, shape=None, *configs):
    """The JAX package's ``Stoke`` (SGD) on the world's 4 CPU devices: a
    data mesh, or ``axes`` of ``shape``; the global batch."""
    mesh = stoke_tpu.MeshConfig(devices=jax.devices("cpu")[:WORLD],
                                **({} if axes is None else
                                   dict(axes=axes, shape=shape)))
    return stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd,
            optimizer_kwargs=dict(learning_rate=worker.GPT_LR)),
        jax_causal_lm_loss, jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=GPT_BATCH // (WORLD if shape is None
                                            else shape[0]),
        distributed="dp", configs=[mesh, *configs],
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)


def _jax_train(s, batches, eval_logits=True, **kw):
    """The eval logits of the first batch (None without ``eval_logits``),
    then each ``train_step``'s loss and the weights after it (the port's
    names)."""
    logits = None
    if eval_logits:
        s.eval()
        logits = np.asarray(s.model(batches[0], **kw))
        s.train()
    losses, weights = [], []
    for b in batches[:worker.GPT_STEPS]:
        losses.append(float(s.train_step(b, b, model_kwargs=kw or None)))
        weights.append(_port_weights(s.params))
    return logits, losses, weights


def _jax_references(inputs, gpt_inputs) -> dict:
    """Every JAX reference of the module's world:

    - ``attention``: each function on each mesh (:func:`_jax_attention`);
    - ``dp``: the JAX package's dp on the global batch over 4 CPU devices
      (dense attention);
    - ``global``: the JAX facade on a (2, 2) ("data", "seq") mesh without
      ``shard_seq_dim`` under each attention, built on a ``Mesh`` of the
      same devices (zigzag on zigzag-ordered batches with
      ``positions=perm``): each step's loss and weights; the eval logits
      are ``dp``'s (the same model function on the same batch, in
      zigzag order for zigzag), which spares each attention's JAX
      forward a compile of its own;
    - ``odd``: under ``shard_seq_dim=1`` with flash attention, rows of
      ``worker.ODD_LEN`` tokens (placed whole): the eval logits and loss,
      one step; and the ring adapter's message at that length;
    - ``three``: the (1, 2, 2) ("data", "seq", "model") mesh with the
      Megatron rules and ring attention."""
    model, variables, batches, _ = gpt_inputs
    out = {"attention": {(shape, impl): _jax_attention(
        impl, shape, inputs["attention"])
        for shape in worker.MESHES for impl in ("ring", "zigzag", "ulysses")}}
    out["dp"] = _jax_train(_jax_stoke(model, variables), batches)
    mesh = _jax_mesh((2, 2))
    makers = {
        "ring": lambda: jax_attention.make_ring_attention(
            mesh, "seq", "data", causal=True),
        "zigzag": lambda: jax_attention.make_zigzag_ring_attention(
            mesh, "seq", "data"),
        "ulysses": lambda: jax_attention.make_ulysses_attention(
            mesh, "seq", "data", causal=True),
        "flash": lambda: jax_make_flash_attention(causal=True)}
    out["global"] = {}
    for kind in worker.GLOBAL_KINDS:
        s = _jax_stoke(_jax_gpt(makers[kind]()), variables, ("data", "seq"),
                       (2, 2))
        logits = out["dp"][0]
        if kind == "zigzag":
            perm = jax_attention.zigzag_permutation(GPT_LEN, 2)
            _, losses, weights = _jax_train(
                s, [b[:, perm] for b in batches], eval_logits=False,
                positions=jnp.asarray(perm))
            logits = logits[:, perm]
        else:
            _, losses, weights = _jax_train(s, batches, eval_logits=False)
        out["global"][kind] = (logits, losses, weights)
    s = _jax_stoke(_jax_gpt(makers["flash"]()), variables, ("data", "seq"),
                   (2, 2), jc.DataParallelConfig(shard_seq_dim=1))
    x = batches[0][:, :worker.ODD_LEN]
    s.eval()
    logits = s.model(x)
    odd = {"logits": np.asarray(logits), "eval_loss": float(s.loss(logits, x))}
    s.train()
    odd["loss"] = float(s.train_step(x, x))
    odd["weights"] = _port_weights(s.params)
    q = jnp.zeros((GPT_BATCH, 2, worker.ODD_LEN, 64))
    with pytest.raises(ValueError) as e:
        jax_attention.ring_attention(q, q, q, mesh=mesh, axis_name="seq",
                                     causal=True)
    odd["ring_message"] = str(e.value)
    out["odd"] = odd
    three = _jax_mesh(worker.THREE_SHAPE, worker.THREE_AXES)
    s = _jax_stoke(_jax_gpt(jax_attention.make_ring_attention(
        three, "seq", "data", causal=True)), variables, worker.THREE_AXES,
        worker.THREE_SHAPE, stoke_tpu.PartitionRulesConfig(
            rules=jax_bert_rules()))
    out["three"] = _jax_train(s, batches, eval_logits=False)[1:]
    return out


# ---------------------------------------------------------------------- #
# the world of 4
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", ["ring", "zigzag", "ulysses"])
@pytest.mark.parametrize("shape", worker.MESHES, ids=str)
def test_sequence_parallel_attention_matches_jax(world, refs, impl, shape):
    """Every rank's output and q/k/v gradients at its rows and global
    positions equal the JAX function's on the same mesh shape."""
    ref_out, ref_grads = refs["attention"][(shape, impl)]
    for res in world:
        got = res["attention"][(shape, impl)]
        rows, pos = slice(*got["rows"]), got["pos"]
        np.testing.assert_allclose(got["out"], ref_out[rows][:, :, pos],
                                   **OUT_TOL)
        for g, ref in zip(got["grads"], ref_grads):
            np.testing.assert_allclose(g, ref[rows][:, :, pos], **GRAD_TOL)


@pytest.mark.parametrize("impl,shape", worker.GPT_RUNS, ids=str)
def test_gpt_shard_seq_dim_matches_jax_dp(world, refs, gpt_inputs, impl,
                                          shape):
    """GPT-tiny under shard_seq_dim=1: the gathered logits, the losses
    and each step's gradient on every rank within 1e-3 of each tensor's
    largest magnitude of JAX dp on the global batch."""
    for res in world:
        got = res["gpt"][impl]
        assert got["layout"] == ("zigzag" if impl == "zigzag"
                                 else "contiguous")
        _check_training(got, refs["dp"], gpt_inputs[3])


def _check_training(got, ref, start, rows=None):
    """``got``'s logits (at its ``rows`` of the global batch, when it has
    them), losses and each step's gradient (``(w_before - w_after) / lr``)
    within 1e-3 of each tensor's largest magnitude of ``ref``'s."""
    logits, losses, weights = ref
    if logits is not None:
        rows = slice(*got["rows"]) if rows is None else rows
        assert _rel(got["logits"], logits[rows]) <= PARITY_TOL
    np.testing.assert_allclose(got["losses"], losses, rtol=PARITY_TOL)
    for step in range(len(losses)):
        before = start if step == 0 else got["weights"][step - 1]
        ref_before = start if step == 0 else weights[step - 1]
        for k in start:
            g = (before[k] - got["weights"][step][k]) / worker.GPT_LR
            want = (ref_before[k] - weights[step][k]) / worker.GPT_LR
            assert _rel(g, want) <= PARITY_TOL, (step, k, _rel(g, want))


def _data_rows(world, key):
    """The ranks of each data row, by the rows each rank reported."""
    rows = {}
    for r, res in enumerate(world):
        rows.setdefault(tuple(res[key]), []).append(r)
    return list(rows.values())


@pytest.mark.parametrize("kind", worker.GLOBAL_KINDS)
def test_global_view_matches_jax(world, refs, gpt_inputs, kind):
    """No ``shard_seq_dim`` on the (2, 2) mesh: every process runs its
    data row's whole sequences (the global view; zigzag on zigzag-ordered
    rows with ``positions=perm``). The losses and each step's gradient
    within 1e-3 of each tensor's largest magnitude of the JAX facade on
    the same mesh with the same attention, the eval logits of JAX's
    (the dp run's, in zigzag order for zigzag); the two processes of a
    data row hold bit-equal weights after each step."""
    for res in world:
        got = res["global_view"][kind]
        assert got["view"] == (True, 2)
        _check_training(got, refs["global"][kind], gpt_inputs[3])
    rows = _data_rows([res["global_view"][kind] for res in world], "rows")
    assert sorted(len(r) for r in rows) == [2, 2]
    for a, b in rows:
        for wa, wb in zip(world[a]["global_view"][kind]["weights"],
                          world[b]["global_view"][kind]["weights"]):
            for k in wa:
                np.testing.assert_array_equal(wa[k], wb[k])


@pytest.mark.parametrize("path", [*worker.GLOBAL_PATHS, "loaded"])
def test_global_view_paths_give_train_steps_numbers(world, path):
    """Under the global view with ring attention: the four calls, the
    windows under oss, sddp and ``train_steps`` under fsdp with remat give
    ``train_step``'s losses and weights (within 1e-5 of each tensor's
    largest magnitude), the same on every process of a data row; a save
    of the oss run loads into a dp Stoke bit for bit."""
    for res in world:
        ref = res["global_view"]["ring"]
        got = res["global_paths"][path]
        if path == "loaded":
            saved = res["global_paths"]["window_oss"]["weights"][-1]
            assert got["steps"] == worker.GPT_STEPS
            for k, v in saved.items():
                np.testing.assert_array_equal(got["weights"][k], v)
            continue
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        for w, want in zip(got["weights"][::-1], ref["weights"][::-1]):
            for k, v in want.items():
                assert _rel(w[k], v) <= 1e-5, (path, k, _rel(w[k], v))
    for a, b in _data_rows([res["global_view"]["ring"] for res in world],
                           "rows"):
        wa = world[a]["global_paths"][path]["weights"]
        wb = world[b]["global_paths"][path]["weights"]
        for x, y in zip(wa if isinstance(wa, list) else [wa],
                        wb if isinstance(wb, list) else [wb]):
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


def test_global_view_draws_alike_across_a_data_row(world):
    """Under the global view with residual dropout 0.1 and an MoE with
    router noise 0.1: the generator is seeded by the data coordinate and
    the MoE's batch means go over the data sub-group, so the two
    processes of a data row hold bit-equal weights and aux losses after
    each step (seeded by world rank, their masks would differ)."""
    got = [res["global_draws"] for res in world]
    for a, b in _data_rows(got, "rows"):
        assert got[a]["aux"] == got[b]["aux"]
        for wa, wb in zip(got[a]["weights"], got[b]["weights"]):
            for k in wa:
                np.testing.assert_array_equal(wa[k], wb[k])
    assert got[0]["aux"][0], "the MoE blocks reported no aux loss"


INDIVISIBLE = ("eval", "step", "window", "ring_refused")


@pytest.mark.parametrize("case", INDIVISIBLE)
def test_indivisible_length_takes_the_global_view(world, refs, gpt_inputs,
                                                  case):
    """Under ``shard_seq_dim=1`` on the (2, 2) mesh, rows of 2·S + 1
    tokens stay whole and the call runs under the global view, as the JAX
    placement leaves such a leaf whole: the eval logits and loss, one
    ``train_step`` and the same step by ``train_step_window`` within 1e-3
    of each tensor's largest magnitude of the JAX facade (flash
    attention); a length the shards divide takes the sharded view on the
    same Stoke; the ring adapter at 2·S + 1 raises the JAX package's
    ``ValueError``."""
    ref = refs["odd"]
    start = gpt_inputs[3]
    for res in world:
        got = res["indivisible"]
        if case == "eval":
            assert got["eval_view"] and not got["divisible_view"]
            assert _rel(got["logits"],
                        ref["logits"][slice(*got["rows"])]) <= PARITY_TOL
            np.testing.assert_allclose(got["eval_loss"], ref["eval_loss"],
                                       rtol=PARITY_TOL)
        elif case == "ring_refused":
            assert got["ring_message"] == ref["ring_message"]
        else:
            key = "" if case == "step" else "window_"
            np.testing.assert_allclose(got[f"{key}loss"], ref["loss"],
                                       rtol=PARITY_TOL)
            for k in start:
                g = (start[k] - got[f"{key}weights"][k]) / worker.GPT_LR
                want = (start[k] - ref["weights"][k]) / worker.GPT_LR
                assert _rel(g, want) <= PARITY_TOL, (k, _rel(g, want))


def test_three_axes_global_view_matches_jax(world, refs, gpt_inputs):
    """(1, 2, 2) ("data", "seq", "model") with the Megatron rules and ring
    attention, no ``shard_seq_dim``: the losses and each step's gradient
    (whole weights) within 1e-3 of each tensor's largest magnitude of the
    JAX facade on the same mesh shape and rules."""
    losses, weights = refs["three"]
    for res in world:
        got = res["three_axes"]
        assert got["view"] == (True, 2)
        _check_training(got, (None, losses, weights), gpt_inputs[3])


@pytest.mark.parametrize("view", ["global", "sharded"])
def test_loader_rows_go_by_the_data_coordinate(world, view):
    """On the (2, 2) mesh, with and without ``shard_seq_dim``, a sampler
    built with the world's defaults is rebuilt over the data sub-group:
    each data row's two processes get equal row ids from
    ``Stoke.DataLoader`` and the two rows disjoint ones; one built for
    other replicas is refused."""
    ids = [res["loader"][view] for res in world]
    assert ids[0] == ids[1] and ids[2] == ids[3]
    assert not set(np.ravel(ids[0])) & set(np.ravel(ids[2]))
    for res in world:
        msg = res["loader"][f"{view}_refused"]
        assert "num_replicas=2" in msg and "data axis" in msg, msg


def _row_reduced(matrix):
    """The exchanged matrix folded to one entry a data row of the (2, 2)
    mesh (ranks ``2d`` and ``2d + 1``): the maximum of each signal, the
    minimum of the barrier wait."""
    m = np.asarray(matrix).reshape(2, 2, -1)
    out = m.max(1)
    b = JAX_FLEET_INDEX["barrier_wait_s"]
    out[:, b] = m[:, :, b].min(1)
    return out


REBALANCE = ("verdict", "shares", "rows", "jax_verdict")


@pytest.mark.parametrize("case", REBALANCE)
def test_rebalance_by_data_row(world, case):
    """``FleetConfig(rebalance=True)`` on the (2, 2) mesh, one process of
    data row 1 reading slowly: the hosts are the data rows; the verdict
    names host 1 a ``loader`` straggler and the rebalancer moves rows off
    it; the four processes hold the same shares; each row's processes
    yield the same rows, equal to the canonical plan; and every verdict
    equals the JAX ``straggler_verdict`` on the row-reduced matrix."""
    got = [res["rebalance"] for res in world]
    if case == "verdict":
        for g in got:
            assert g["hosts"] == (2, g["data"])
            assert any(e["host"] == 1 and e["skew_class"] == "loader"
                       for e in g["stragglers"]), g["stragglers"]
            assert g["shifts"] >= 1
            assert g["shares"][-1][1] < g["shares"][-1][0]
    elif case == "shares":
        for g in got[1:]:
            assert g["shares"] == got[0]["shares"]
    elif case == "rows":
        for a, b in ((0, 1), (2, 3)):
            assert got[a]["batches"] == got[b]["batches"]
        for g in got:
            assert g["batches"] == g["plan"]
    else:
        seen = 0
        for g in got:
            for m, v in zip(g["matrices"], g["verdicts"]):
                if m is None or v is None:
                    continue
                want = jax_verdict(_row_reduced(m), rel_threshold=0.2,
                                   zscore_threshold=3.0)
                assert v == want
                seen += 1
        assert seen


def test_seq_shard_is_scoped_to_its_stoke(world):
    """The sharded Stoke's gathered logits and its ``loss(model(x), x)``
    (model outputs are not cut again; dp's eval loss is the global batch's)
    equal a mesh-less Stoke's on each data row's whole sequences; building
    and running that Stoke after it leaves its logits bit for bit, and no
    shard is set outside their calls."""
    whole_loss = np.mean([res["scoping"]["whole"]["loss"] for res in world])
    for res in world:
        got = res["scoping"]
        assert got["outside"] is None
        assert _rel(got["sharded"]["logits"],
                    got["whole"]["logits"]) <= PARITY_TOL
        np.testing.assert_allclose(got["sharded"]["loss"], whole_loss,
                                   rtol=PARITY_TOL)
        np.testing.assert_array_equal(got["sharded_after"],
                                      got["sharded"]["logits"])


def _rel(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------- #
# one process
# ---------------------------------------------------------------------- #


def _shards(x, S, dim):
    n = x.shape[dim] // S
    return [x.narrow(dim, r * n, n) for r in range(S)]


@pytest.mark.parametrize("inner,causal", [("flash", True), ("dense", False)])
def test_virtual_ring_matches_jax_ring(inner, causal):
    """S=4 virtual shards in one process (the rotation passed in, as
    chip_smoke drives them on the card) equal the JAX ring on a (1, 4)
    mesh: output and gradients at the stated tolerances."""
    a = _attention_inputs()
    S = 4
    q, k, v = (torch.from_numpy(a[n]).requires_grad_()
               for n in ("q", "k", "v"))
    m = torch.from_numpy(a["mask"])
    ks, vs, ms = _shards(k, S, 2), _shards(v, S, 2), _shards(m, S, 1)
    outs = [port_attention.ring_attention(
        qs, ks[r], vs[r], ms[r], shard=port_attention.SeqShard(None, r, S),
        causal=causal, inner=inner,
        rotate=port_attention.virtual_ring(ks, vs, ms, r))
        for r, qs in enumerate(_shards(q, S, 2))]
    out = torch.cat(outs, dim=2)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    mesh = _jax_mesh((1, S))

    def f(q, k, v):
        return jax_attention.ring_attention(
            q, k, v, jnp.asarray(a["mask"]), mesh=mesh, axis_name="seq",
            causal=causal, inner=inner)

    def both(q, k, v):
        o, vjp = jax.vjp(f, q, k, v)
        return o, vjp(2 * o)

    ref, ref_grads = jax.jit(both)(*(jnp.asarray(a[n])
                                     for n in ("q", "k", "v")))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **OUT_TOL)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL)


def test_fully_masked_hops_are_exact_zeros():
    """A causal hop whose keys all come later gives out == 0 and lse ==
    -1e30, and the merge leaves the accumulator bit for bit."""
    a = _attention_inputs()
    q, k, v = (torch.from_numpy(a[n]) for n in ("q", "k", "v"))
    zero = torch.zeros((B, L), dtype=torch.int32)
    o, lse = port_attention.flash_attention(q, k, v, zero, causal=False,
                                            return_lse=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert bool((lse == -1e30).all())
    acc, acc_lse = port_attention.flash_attention(q, k, v, None, causal=True,
                                                  return_lse=True)
    merged, merged_lse = port_attention._lse_merge(acc.float(), acc_lse, o,
                                                   lse)
    assert torch.equal(merged, acc.float())
    assert torch.equal(merged_lse, acc_lse)


def test_fully_masked_rows_are_zero():
    """All-padding rows give zeros, not NaN (JAX
    ``test_fully_masked_rows_are_zero``), both inners."""
    a = _attention_inputs()
    S = 4
    q, k, v = (torch.from_numpy(a[n]) for n in ("q", "k", "v"))
    km = torch.zeros((B, L), dtype=torch.int32)
    ks, vs, ms = _shards(k, S, 2), _shards(v, S, 2), _shards(km, S, 1)
    for inner in ("flash", "dense"):
        out = torch.cat([port_attention.ring_attention(
            qs, ks[r], vs[r], ms[r],
            shard=port_attention.SeqShard(None, r, S), inner=inner,
            rotate=port_attention.virtual_ring(ks, vs, ms, r))
            for r, qs in enumerate(_shards(q, S, 2))], dim=2)
        assert torch.equal(out, torch.zeros_like(out)), inner


def test_zigzag_permutation_helpers_equal_jax():
    for Lz, S in ((32, 4), (16, 2), (8, 1), (64, 8)):
        np.testing.assert_array_equal(
            port_attention.zigzag_permutation(Lz, S),
            jax_attention.zigzag_permutation(Lz, S))
        perm = port_attention.zigzag_permutation(Lz, S)
        np.testing.assert_array_equal(
            port_attention.inverse_permutation(perm),
            jax_attention.inverse_permutation(perm))
    with pytest.raises(ValueError, match="divisible"):
        port_attention.zigzag_permutation(30, 4)
    shard = port_attention.SeqShard(None, 1, 4, "zigzag")
    np.testing.assert_array_equal(
        shard.global_index(8).numpy(),
        jax_attention.zigzag_permutation(32, 4)[8:16])
    x = torch.arange(32)[None]
    np.testing.assert_array_equal(shard.take(x, 1)[0].numpy(),
                                  jax_attention.zigzag_permutation(32, 4)[8:16])


def test_adapters_refuse_what_jax_refuses():
    """Dropout, a full [.., L, L] bias and indivisible heads raise (the
    JAX adapters' guards and messages)."""
    q = torch.zeros((1, 6, 16, 8))
    fn = port_attention.make_zigzag_ring_attention()
    with pytest.raises(ValueError, match="attention_is_causal"):
        fn(q, q, q, torch.zeros((1, 1, 16, 16)))
    with pytest.raises(NotImplementedError, match="dropout"):
        port_attention.make_ring_attention()(q, q, q, None,
                                             dropout=object())
    with pytest.raises(ValueError, match="not divisible"):
        port_attention.ulysses_attention(
            q, q, q, shard=port_attention.SeqShard(None, 0, 4))
    with pytest.raises(ValueError, match="inner must be"):
        port_attention.ring_attention(q, q, q, inner="bogus")
    # a key-padding bias becomes the key mask, as in the JAX adapter
    r = np.random.default_rng(0)
    qk = torch.from_numpy(r.normal(size=(1, 2, 16, 8)).astype(np.float32))
    bias = torch.zeros((1, 1, 1, 16))
    bias[..., 12:] = -1e9
    mask = (bias[:, 0, 0, :] > -1e8).to(torch.int32)
    np.testing.assert_allclose(
        port_attention.make_ring_attention(causal=True)(qk, qk, qk, bias),
        dense_reference(qk, qk, qk, mask, causal=True), **OUT_TOL)


def test_inner_auto_resolves_by_what_the_port_flash_takes():
    """Documented divergence (ROADMAP Queue 3): the JAX package's
    ``inner="auto"`` follows the TPU kernel's block ladder, so a gathered
    length no block divides (520) takes its dense inner; the port's flash
    takes any length, so auto is flash here. Both compute the same
    attention at the stated tolerance."""
    assert jax_attention._resolve_inner("auto", 520) == "dense"
    q = torch.zeros((1, 1, 520, 8))
    assert port_attention._resolve_inner("auto", q) == "flash"
    assert jax_attention._resolve_inner("auto", 65) == "flash"
    assert port_attention._resolve_inner("auto", q[:, :, :65]) == "flash"
    r = np.random.default_rng(7)
    x = r.normal(size=(1, 8, 520, 8)).astype(np.float32)
    mesh = _jax_mesh((1, 4))
    ref = jax_attention.ulysses_attention(*(jnp.asarray(x),) * 3, mesh=mesh,
                                          axis_name="seq")
    t = torch.from_numpy(x)
    np.testing.assert_allclose(
        port_attention.ulysses_attention(t, t, t), np.asarray(ref),
        **OUT_TOL)


@pytest.mark.parametrize("impl", ["ring", "zigzag", "ulysses"])
def test_world_one_seq_mesh_is_flash_bit_for_bit(impl):
    """Under a (data=1, seq=1) mesh a one-hop ring is one flash call and
    a round trip through fp32, a one-shard zigzag one causal flash call and
    Ulysses one flash call: GPT-tiny's losses and weights equal the flash
    run's bit for bit."""
    makers = {"ring": lambda: port_attention.make_ring_attention(causal=True),
              "zigzag": port_attention.make_zigzag_ring_attention,
              "ulysses": lambda: port_attention.make_ulysses_attention(
                  causal=True)}
    from stoke_tpu_torch.ops import make_flash_attention

    r = np.random.default_rng(0)
    batches = [torch.from_numpy(r.integers(0, 257, size=(2, 32))) for _ in
               range(2)]
    runs = {}
    for name, fn, cfg in (
            ("flash", make_flash_attention(causal=True), {}),
            (impl, makers[impl](), dict(distributed="dp", configs=[
                MeshConfig(axes=("data", "seq"), shape=(1, 1)),
                DataParallelConfig(shard_seq_dim=1)]))):
        m = GPT(vocab_size=257, size_name="tiny", max_len=32,
                dropout_rate=0.0, attention_fn=fn, attention_is_causal=True)
        m.init_weights(0)
        s = Stoke(m, StokeOptimizer(torch.optim.AdamW, lr=3e-3),
                  causal_lm_loss, batch_size_per_device=2, device="cpu",
                  **cfg)
        losses = [float(s.train_step(b, b)) for b in batches]
        runs[name] = (losses, [p.detach().clone()
                               for p in s.model_access.parameters()])
        if name != "flash":
            assert s.seq_shard.size == 1
            assert s.seq_shard.layout == ("zigzag" if impl == "zigzag"
                                          else "contiguous")
    assert runs[impl][0] == runs["flash"][0]
    for a, b in zip(runs[impl][1], runs["flash"][1]):
        assert torch.equal(a, b)
