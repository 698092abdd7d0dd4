"""Port parity: the quantized gradient transports (spec:
``tests/test_collectives.py`` and ``tests/test_zero.py``).

The same numpy inputs go through the JAX package's functions and the
port's:

- ``quantize_chunks`` / ``dequantize_chunks`` (the plain versions of the
  CUDA kernel pair): scales exact; the payload exact but for an element
  whose ``v + u`` lies within an fp32 ulp of an integer, which may round
  one level the other way (counted; at most 1e-5 of the elements);
- ``fold_in`` and the 2-D ``uniform``, ``BucketLayout``,
  ``bytes_per_step``, ``layout_descriptor`` and the transport factory:
  exact;
- the transports at world 1 against the JAX one-device transport: bit
  for bit (fp32, bf16, int8);
- the transports at W=2 and W=4 (a spawned gloo world each,
  ``tests/_torch_comm_worker.py``, each rank with its own gradients)
  against the JAX transports on a W-device mesh fed the mean: int8 every
  element within one level (its chunk's scale) and >= 99.9% equal, bf16
  within one bf16 ulp, fp32 exact; the sharded residual holds 1/W of the
  padded bucket a rank;
- int8 with error feedback trains under every tier on the JAX test's
  criterion (final EMA loss within 10% of the run without a transport),
  and the window path gives the eager losses exactly.
"""

import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from stoke_tpu import configs as jc
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.parallel import collectives as jcol
from stoke_tpu.parallel import zero as jzero
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch import configs as pc
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.models.gpt import GPT
from stoke_tpu_torch.ops.quant import (
    dequantize_chunks_plain,
    quantize_chunks_plain,
)
from stoke_tpu_torch.parallel.collectives import (
    BucketLayout,
    GradTransport,
    JaxLeafOrder,
)
from stoke_tpu_torch.parallel.zero import ShardedGradTransport, make_transport
from stoke_tpu_torch.utils import prng

sys.path.insert(0, os.path.dirname(__file__))
import _torch_comm_worker as worker  # noqa: E402
import _torch_dp_worker as dpw  # noqa: E402

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


WORLDS = (2, 4)
JOIN_TIMEOUT_S = 120
#: the share of payload elements allowed one level off (v + u within an
#: ulp of an integer)
ONE_LEVEL_SHARE = 1e-5
EQUAL_SHARE = 0.999
EMA_RTOL = 0.1


def _key(seed):
    return torch.tensor(np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


def _vector(chunk, case, seed=0):
    r = np.random.default_rng(seed)
    n = chunk * 64
    x = (r.normal(size=n) * np.exp(r.normal(size=n))).astype(np.float32)
    if case == "zero_chunks":
        x[chunk * 3:chunk * 5] = 0.0
    if case == "padded_tail":
        x[-chunk - chunk // 3:] = 0.0
    if case == "tiny":
        x *= np.float32(1e-30)
    return x


@pytest.mark.parametrize("chunk", [128, 512])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("case", ["normal", "zero_chunks", "padded_tail",
                                  "tiny"])
def test_quantize_matches_jax(chunk, stochastic, case):
    x = _vector(chunk, case)
    key = jax.random.PRNGKey(7)
    q, s = jcol.quantize_chunks(jnp.asarray(x), chunk, key, stochastic)
    pq, ps = quantize_chunks_plain(torch.from_numpy(x), chunk, _key(7),
                                   stochastic)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s))
    diff = np.abs(pq.numpy().astype(np.int32) - np.asarray(q).astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).sum() <= ONE_LEVEL_SHARE * x.size
    if case == "zero_chunks":
        assert (ps.numpy()[3:5] == 0).all() and (pq.numpy()[
            chunk * 3:chunk * 5] == 0).all()
    d = jcol.dequantize_chunks(q, s, chunk)
    np.testing.assert_array_equal(
        dequantize_chunks_plain(torch.from_numpy(np.asarray(q)),
                                torch.from_numpy(np.asarray(s)), chunk).numpy(),
        np.asarray(d))


def test_quantize_folds_and_offset_are_the_jax_draws():
    """``folds`` are ``fold_in``'s of the key and ``offset`` the index of
    the first element in a longer draw: a part of a bucket quantizes as
    the JAX package quantizes the whole under the folded key."""
    chunk = 128
    x = _vector(chunk, "normal", seed=3)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(2), 5), 3)
    q, s = jcol.quantize_chunks(jnp.asarray(x), chunk, key, True)
    lo, hi = chunk * 16, chunk * 40
    pq, ps = quantize_chunks_plain(torch.from_numpy(x[lo:hi]), chunk,
                                   _key(2), True, folds=(5, 3), offset=lo)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(q)[lo:hi])
    np.testing.assert_array_equal(ps.numpy(), np.asarray(s)[16:40])


@pytest.mark.parametrize("seed", [0, 1, 123456789])
def test_fold_in_and_uniform_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    for d in (0, 1, 9, 2**31 + 5):
        want = np.asarray(jax.random.fold_in(key, d))
        assert (prng.fold_in(np.asarray(key), d) == want).all()
        assert (prng.fold_in(_key(seed), d).numpy() == want).all()
    u = np.asarray(jax.random.uniform(key, (37, 128), dtype=jnp.float32))
    got = prng.uniform(_key(seed), 37 * 128).numpy().reshape(37, 128)
    np.testing.assert_array_equal(got.view(np.uint32), u.view(np.uint32))
    a, b = jax.random.split(key)
    assert (prng.fold_in(_key(seed), 0).numpy() == np.asarray(a)).all()
    assert (prng.fold_in(_key(seed), 1).numpy() == np.asarray(b)).all()


@pytest.mark.parametrize("seed", range(4))
def test_bucket_layout_matches_jax(seed):
    r = np.random.default_rng(seed)
    sizes = [int(v) for v in r.integers(1, 5000, size=20)]
    for bucket, align in ((4096, 128), (10000, 512), (1, 64)):
        a, b = BucketLayout(sizes, bucket, align), jcol.BucketLayout(
            sizes, bucket, align)
        assert a.buckets == b.buckets
        assert a.total_padded_elems == b.total_padded_elems


def _jax_tree(sizes):
    return {k: jnp.zeros(s, jnp.float32) for k, s in sizes.items()}


def _mesh(world):
    return Mesh(np.array(jax.devices("cpu")[:world]), ("data",))


def _jax_transport(name, world, tier=jc.ShardingOptions.oss):
    cfg = jc.CommConfig(**worker.COMMON, **worker.TRANSPORTS[name])
    rules = types.SimpleNamespace(mesh=None if world == 1 else _mesh(world),
                                  axis_name="data", tier=tier)
    return jzero.make_transport(cfg, rules)


@pytest.mark.parametrize("name", list(worker.TRANSPORTS))
def test_accounting_at_world_one_matches_jax(name):
    sizes = [int(np.prod(s)) for s in worker.SHAPES.values()]
    t = make_transport(pc.CommConfig(**worker.COMMON,
                                     **worker.TRANSPORTS[name]),
                       pc.ShardingOptions.oss)
    j = _jax_transport(name, 1)
    tree = _jax_tree(worker.SHAPES)
    assert t.bytes_per_step(sizes) == j.bytes_per_step(tree)
    assert t.layout_descriptor(sizes) == j.layout_descriptor(tree)
    assert t.layout_kind == j.layout_kind


@pytest.mark.parametrize("tier", list(pc.ShardingOptions))
@pytest.mark.parametrize("shard", [None, True, False])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_make_transport_choice_matches_jax(tier, shard, dtype):
    cfg = pc.CommConfig(dtype=dtype, shard_updates=shard)
    jcfg = jc.CommConfig(dtype=dtype, shard_updates=shard)
    jtier = jc.ShardingOptions(tier.value)
    assert pc.comm_shard_updates(cfg, tier) == jc.comm_shard_updates(
        jcfg, jtier)
    mine = make_transport(cfg, tier)
    theirs = jzero.make_transport(jcfg, types.SimpleNamespace(
        mesh=None, axis_name="data", tier=jtier))
    assert type(mine).__name__ == type(theirs).__name__
    if isinstance(mine, ShardedGradTransport):
        assert mine.params_replicated == theirs.params_replicated


def _grads(step, world):
    """The ranks' mean gradients at ``step`` (exact: see the worker)."""
    parts = [worker.rank_grads(step, r) for r in range(world)]
    return {k: (np.stack([p[k] for p in parts]).sum(0) / np.float32(world)
                ).astype(np.float32) for k in worker.SHAPES}


def _pack(leaves, layout):
    """Leaves as their padded buckets."""
    out = []
    for idx, elems, padded in layout.buckets:
        flat = np.concatenate([np.asarray(leaves[i]).reshape(-1)
                               for i in idx])
        out.append(np.pad(flat, (0, padded - elems)))
    return out


def _run_jax(name, world):
    t = _jax_transport(name, world)
    state = jax.tree_util.tree_map(jnp.asarray, t.init_state(
        _jax_tree(worker.SHAPES)))
    steps = []
    # the one-device transport runs op by op (the JAX function's
    # arithmetic); across a mesh compiled, as the JAX engine runs it
    apply = t.apply if world == 1 else jax.jit(t.apply)
    for step in range(worker.STEPS):
        g = {k: jnp.asarray(v) for k, v in _grads(step, world).items()}
        y, state = apply(g, state)
        res = state.get("residual")
        if res is not None and not isinstance(res, tuple):
            res = [res[k] for k in worker.SHAPES]
        steps.append({"out": [np.asarray(y[k]) for k in worker.SHAPES],
                      "residual": None if res is None
                      else [np.asarray(r) for r in res],
                      "rng": np.asarray(state["rng"]) if state else None})
    return t, steps


@pytest.mark.parametrize("name", list(worker.TRANSPORTS))
def test_world_one_transport_matches_jax(name):
    """At world 1 every transport is the JAX one-device transport, bit
    for bit, over three steps of error feedback (the residual too)."""
    sizes = [int(np.prod(s)) for s in worker.SHAPES.values()]
    t = make_transport(pc.CommConfig(**worker.COMMON,
                                     **worker.TRANSPORTS[name]),
                       pc.ShardingOptions.oss)
    state = t.init_state(sizes, "cpu")
    _, want = _run_jax(name, 1)
    layout = t._layout(sizes) if t.active else None
    for step in range(worker.STEPS):
        g = _grads(step, 1)
        y = t.apply([torch.from_numpy(g[k]) for k in worker.SHAPES], state)
        for a, b in zip(y, want[step]["out"]):
            np.testing.assert_array_equal(a.numpy(), b)
        if want[step]["residual"] is not None:
            jres = want[step]["residual"]
            if t.layout_kind == "replicated":
                jres = _pack(jres, layout)
            for a, b in zip(state["residual"], jres):
                np.testing.assert_array_equal(a.numpy(), b)
        if t.active:
            assert (state["rng"].numpy() == want[step]["rng"]).all()


def test_residual_is_the_exact_loss():
    """The residual is what the wire lost: ``x - y`` of the packed
    bucket, with ``x`` the gradient plus the previous residual."""
    sizes = [int(np.prod(s)) for s in worker.SHAPES.values()]
    t = GradTransport(pc.CommConfig(dtype="int8", **worker.COMMON))
    state = t.init_state(sizes, "cpu")
    layout = t._layout(sizes)
    prev = [r.clone() for r in state["residual"]]
    for step in range(worker.STEPS):
        g = _grads(step, 1)
        leaves = [torch.from_numpy(g[k]) for k in worker.SHAPES]
        y = t.apply(leaves, state)
        xs = [a + b.numpy() for a, b in zip(_pack(leaves, layout), prev)]
        ys = _pack(y, layout)
        for r, x, yy in zip(state["residual"], xs, ys):
            np.testing.assert_array_equal(r.numpy(), x - yy)
            assert (r.numpy() != 0).any()
        prev = [r.clone() for r in state["residual"]]


def test_jax_leaf_order_packs_the_flax_tree():
    """The transport's packing of GPT-tiny is the flax params tree's:
    the leaves in ``jax.tree_util`` flatten order, each in the JAX
    layout (the packing alone, before any transport)."""
    jm = JaxGPT(vocab_size=97, size_name="tiny", max_len=16,
                dropout_rate=0.0)
    variables = jax.tree_util.tree_map(np.asarray, init_module(
        jm, jax.random.PRNGKey(0), np.zeros((2, 16), np.int32), train=False))
    model = GPT(vocab_size=97, size_name="tiny", max_len=16, dropout_rate=0.0)
    model.load_state_dict(gpt_state_dict_from_jax(variables["params"]))
    params = [p for p in model.parameters()]
    order = JaxLeafOrder(model, params)
    got = order.to_jax(params)
    want = jax.tree_util.tree_leaves(variables["params"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.detach().reshape(-1).numpy(),
                                      b.reshape(-1))
    back = [torch.empty_like(p) for p in params]
    order.from_jax([torch.from_numpy(np.asarray(b)) for b in want], back)
    for a, p in zip(back, params):
        assert torch.equal(a, p)


def _mlp_stoke(comm=None):
    configs = [] if comm is None else [comm]
    return port.Stoke(dpw.mlp(*_mlp_weights()),
                      port.StokeOptimizer(torch.optim.Adam, lr=1e-2), dpw.mse,
                      batch_size_per_device=dpw.GLOBAL_BATCH, device="cpu",
                      distributed="dp", configs=configs)


def _mlp_weights():
    r = np.random.default_rng(5)
    return (r.normal(size=(dpw.IN, dpw.HID)).astype(np.float32) * 0.3,
            r.normal(size=(dpw.HID, dpw.OUT)).astype(np.float32) * 0.3)


@pytest.fixture
def one_process():
    yield
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def test_fp32_transport_bit_identical(one_process):
    """``CommConfig(dtype="fp32")`` is an exact pass-through: the same
    losses and weights, bit for bit, as no ``CommConfig``; int8 is not."""
    runs = {}
    for name, comm in (("none", None), ("fp32", pc.CommConfig()),
                       ("int8", pc.CommConfig(dtype="int8", chunk_elems=64))):
        s = _mlp_stoke(comm)
        losses = [float(s.train_step(x, (y,))) for x, y in dpw.mlp_data(4)]
        runs[name] = (losses, dpw.weights(s), s.comm_bytes)
    assert runs["fp32"][0] == runs["none"][0]
    for k, v in runs["none"][1].items():
        np.testing.assert_array_equal(runs["fp32"][1][k], v)
    assert runs["int8"][0] != runs["none"][0]
    assert runs["none"][2] is None
    assert runs["fp32"][2] == {"prequant": 0, "onwire": 0}


# --------------------------------------------------------------------------- #
# across processes
# --------------------------------------------------------------------------- #


def _spawn(world, tmp) -> list:
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
    inputs = {"mlp_w": _mlp_weights()}
    procs = [ctx.Process(target=worker.run,
                         args=(r, world, store, str(tmp), inputs))
             for r in range(world)]
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
        pytest.fail(f"world {world}: ranks {hung} still ran after "
                    f"{JOIN_TIMEOUT_S} s")
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pt")
        if not os.path.exists(path):
            pytest.fail(f"world {world}: rank {r} wrote nothing (exit code "
                        f"{procs[r].exitcode})")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            pytest.fail(f"world {world}: rank {r} raised:\n{res['error']}")
        out.append(res)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: _spawn(w, tmp_path_factory.mktemp(f"comm{w}")) for w in WORLDS}


def _levels(name, want, layout):
    """Per bucket, each element's tolerance: int8 one level of its chunk
    (the chunk's absmax over 127, from the JAX output), bf16 one bf16 ulp
    of the value, fp32 none."""
    dtype = worker.TRANSPORTS[name]["dtype"]
    out = []
    for b in _pack(want, layout):
        if dtype == "bf16":
            out.append(np.abs(b) * 2.0**-7)
        elif dtype == "int8":
            c = worker.COMMON["chunk_elems"]
            level = np.abs(b).reshape(-1, c).max(1, keepdims=True) / 127.0
            out.append(np.broadcast_to(level, (level.shape[0], c)).reshape(-1))
        else:
            out.append(np.zeros_like(b))
    return out


def _check(got, want, tol):
    """Every element within its tolerance, and >= 99.9% of them on the
    same level (int8: the same integer multiple of the chunk's level;
    else equal)."""
    same = total = 0
    for a, b, t in zip(got, want, tol):
        d = np.abs(a - b)
        assert (d <= t * (1 + 1e-6)).all()
        same += int((d <= 1e-3 * t).sum())
        total += a.size
    assert same >= EQUAL_SHARE * total


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(worker.TRANSPORTS))
def test_transport_matches_jax_mesh(worlds, world, name):
    """Each rank's output and residual against the JAX transport (under
    ``jax.jit``, as the JAX engine runs it) on a W-device mesh fed the
    ranks' mean, over three steps; the accounting dicts equal the JAX
    ones. The compiled JAX transport divides by 127 as a multiply by its
    reciprocal, so a chunk's scale may be one ulp off the port's (the JAX
    function's IEEE division): its elements then differ by an ulp, on
    the same level."""
    t, want = _run_jax(name, world)
    sizes = [int(np.prod(s)) for s in worker.SHAPES.values()]
    tree = _jax_tree(worker.SHAPES)
    layout = t._layout(sizes) if t.active else jcol.BucketLayout(sizes, 1, 1)
    for rank, res in enumerate(worlds[world]):
        got = res["transports"][name]
        assert got["bytes"] == t.bytes_per_step(tree)
        assert got["descriptor"] == t.layout_descriptor(tree)
        assert got["kind"] == t.layout_kind
        for step in range(worker.STEPS):
            tol = _levels(name, want[step]["out"], layout)
            _check(_pack(got["steps"][step]["out"], layout),
                   _pack(want[step]["out"], layout), tol)
            jres = want[step]["residual"]
            if jres is None:
                assert got["steps"][step]["residual"] == []
                continue
            # the residual is x - y with the same x: it differs where the
            # output does, by as much
            if t.layout_kind == "replicated":
                jres = _pack(jres, layout)
            else:
                jres = [r.reshape(world, -1)[rank] for r in jres]
                tol = [v.reshape(world, -1)[rank] for v in tol]
            mine = got["steps"][step]["residual"]
            assert [a.size for a in mine] == [b.size for b in jres]
            _check(mine, jres, tol)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_residual_holds_a_slice_a_rank(worlds, world):
    """Under sddp and fsdp (the sharded schedule) a rank's residual is
    1/W of each padded bucket; under dp and oss the whole."""
    for res in worlds[world]:
        for (tier, comm), got in res["training"].items():
            if comm is None:
                continue
            div = world if tier in ("sddp", "fsdp") else 1
            assert got["residual"] == [p // div for p in got["padded"]]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tier", list(dpw.TIERS))
@pytest.mark.parametrize("model", ["mlp", "gpt"])
def test_int8_error_feedback_tracks_fp32(worlds, world, tier, model):
    """int8 + error feedback trains on the JAX test's criterion: both
    runs learn, and the final EMA loss is within 10% of the run without
    a transport."""
    got = worlds[world][0]["training"]
    fp32, int8 = got[(tier, None)], got[(tier, "int8")]
    # each rank's values in the message: a failure names what it saw
    seen = [(res["training"][(tier, None)][model],
             res["training"][(tier, "int8")][model])
            for res in worlds[world]]
    assert fp32[model] < 0.8 * fp32[f"{model}0"], (fp32, seen)
    assert abs(int8[model] - fp32[model]) <= EMA_RTOL * fp32[model], seen
    for res in worlds[world][1:]:
        assert res["training"][(tier, "int8")][model] == int8[model], seen


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tier", list(dpw.TIERS))
def test_windows_give_the_eager_losses(worlds, world, tier):
    for rank, res in enumerate(worlds[world]):
        got = res["windows"][tier]
        assert got["window"] == got["eager"], (rank, got["eager"],
                                               got["window"])
