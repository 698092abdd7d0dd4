"""Port parity: sequence-parallel attention (``stoke_tpu_torch/ops/
attention.py``) and GPT under ``DataParallelConfig(shard_seq_dim=1)``
against ``stoke_tpu/ops/attention.py`` and the JAX package's dp.

A gloo world of 4 (``tests/_torch_seqpar_worker.py``) is spawned once for
the module through a file store and joined with a 120 s timeout. In it:

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
- on a (2, 2) mesh, what ``Stoke`` refuses under a seq axis, and its
  shard kept to its own calls beside a mesh-less ``Stoke``.

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
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.gpt import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.ops import attention as jax_attention
from stoke_tpu.utils import init_module
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch.configs import DataParallelConfig, MeshConfig
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.ops import attention as port_attention
from stoke_tpu_torch.ops.flash_attention import dense_reference

sys.path.insert(0, os.path.dirname(__file__))
import _torch_seqpar_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

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


def _gpt_inputs():
    model = JaxGPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=GPT_LEN,
                   dropout_rate=0.0)
    r = np.random.default_rng(5)
    batches = [r.integers(0, GPT_VOCAB, size=(GPT_BATCH, GPT_LEN)).astype(
        np.int32) for _ in range(worker.GPT_STEPS)]
    variables = jax.tree_util.tree_map(np.asarray, init_module(
        model, jax.random.PRNGKey(0), batches[0][:2], train=False))
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
def world(inputs, tmp_path_factory):
    """The spawned world's per-rank results (fails, never hangs, when a
    rank raised or outlived the join timeout)."""
    tmp = tmp_path_factory.mktemp("seqpar")
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


# ---------------------------------------------------------------------- #
# the JAX references
# ---------------------------------------------------------------------- #


def _jax_mesh(shape):
    return Mesh(np.asarray(jax.devices("cpu")[:WORLD]).reshape(shape),
                ("data", "seq"))


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


@pytest.fixture(scope="module")
def jax_gpt(gpt_inputs):
    """The JAX package's dp on the global batch over 4 CPU devices: the
    eval logits of the first batch, each step's loss and weights."""
    model, variables, batches, _ = gpt_inputs
    logits = np.asarray(model.apply(variables, batches[0], train=False))
    s = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd,
            optimizer_kwargs=dict(learning_rate=worker.GPT_LR)),
        jax_causal_lm_loss, jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=GPT_BATCH // WORLD, distributed="dp",
        configs=[stoke_tpu.MeshConfig(devices=jax.devices("cpu")[:WORLD])],
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)
    losses, weights = [], []
    for b in batches:
        losses.append(float(s.train_step(b, b)))
        weights.append({k: v.numpy() for k, v in gpt_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, s.params)).items()})
    return logits, losses, weights


# ---------------------------------------------------------------------- #
# the world of 4
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("impl", ["ring", "zigzag", "ulysses"])
@pytest.mark.parametrize("shape", worker.MESHES, ids=str)
def test_sequence_parallel_attention_matches_jax(world, inputs, impl, shape):
    """Every rank's output and q/k/v gradients at its rows and global
    positions equal the JAX function's on the same mesh shape."""
    a = inputs["attention"]
    ref_out, ref_grads = _jax_attention(impl, shape, a)
    for res in world:
        got = res["attention"][(shape, impl)]
        rows, pos = slice(*got["rows"]), got["pos"]
        np.testing.assert_allclose(got["out"], ref_out[rows][:, :, pos],
                                   **OUT_TOL)
        for g, ref in zip(got["grads"], ref_grads):
            np.testing.assert_allclose(g, ref[rows][:, :, pos], **GRAD_TOL)


@pytest.mark.parametrize("impl,shape", worker.GPT_RUNS, ids=str)
def test_gpt_shard_seq_dim_matches_jax_dp(world, jax_gpt, gpt_inputs, impl,
                                          shape):
    """GPT-tiny under shard_seq_dim=1: the gathered logits, the losses
    and each step's gradient on every rank within 1e-3 of each tensor's
    largest magnitude of JAX dp on the global batch."""
    logits, losses, weights = jax_gpt
    start = gpt_inputs[3]
    for res in world:
        got = res["gpt"][impl]
        assert got["layout"] == ("zigzag" if impl == "zigzag"
                                 else "contiguous")
        assert _rel(got["logits"], logits[slice(*got["rows"])]) <= PARITY_TOL
        np.testing.assert_allclose(got["losses"], losses, rtol=PARITY_TOL)
        for step in range(worker.GPT_STEPS):
            before = start if step == 0 else got["weights"][step - 1]
            ref_before = start if step == 0 else weights[step - 1]
            for k in start:
                g = (before[k] - got["weights"][step][k]) / worker.GPT_LR
                ref = (ref_before[k] - weights[step][k]) / worker.GPT_LR
                assert _rel(g, ref) <= PARITY_TOL, (step, k, _rel(g, ref))


#: what Stoke refuses on a ("data", "seq") mesh of seq size 2, by a word
#: of its message
REFUSALS = {"no_shard_seq_dim": "shard_seq_dim", "indivisible": "divide",
            "rebalance": "rebalance"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_seq_mesh_refusals(world, case):
    """A seq axis of 2 without ``shard_seq_dim``, an input whose sequence
    the shards do not divide, and rebalancing under the seq axis are
    refused (the JAX package's global view accepts them; ROADMAP Queue 3)."""
    for res in world:
        msg = res["scoping"][case]
        assert REFUSALS[case] in msg and "Queue 3" in msg, msg


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
