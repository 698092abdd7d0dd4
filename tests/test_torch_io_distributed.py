"""Port: checkpoints across processes and the sharded format (the sharded
and FSDP cases of ``tests/test_io.py``, run on ``stoke_tpu_torch`` over
gloo).

Two worlds, W=2 then W=4, each spawned once for the module
(``tests/_torch_io_worker.py`` runs every scenario in every rank); they
share one directory of tags, so W=4 reads what W=2 wrote, and this
process reads both. Before them this process writes a one-process port
tag and a JAX tag (the JAX package's ``Stoke`` on a 2-device dp mesh,
carried over by ``jax_checkpoint_to_port``).

Port against port every comparison is exact: a run that loads a tag and
continues computes the same function on the same tensors as the run that
saved it, at the same world size, in either format, sync or async, from
a boundary or mid-window (each rank's own accumulated gradients and
dropout generator come back). Across world sizes the parameters and the
optimizer state come back exactly. The JAX tag resumes on the JAX loss
trajectory within 1e-3 relative (``test_torch_io_parity.py``'s
tolerance: the packages sum in other orders).
"""

import json
import os
import sys
import time

import jax
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

import stoke_tpu
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.gpt import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.configs import CheckpointConfig, CheckpointFormat
from stoke_tpu_torch.convert import jax_checkpoint_to_port
from stoke_tpu_torch.models.gpt import GPT

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dp_worker as dpw  # noqa: E402
import _torch_io_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

WORLDS = (2, 4)
JOIN_TIMEOUT_S = 120
LOSS_RTOL = 1e-3
JAX_BATCH, JAX_BEFORE, JAX_AFTER = 8, 2, 3


def _mlp_weights():
    r = np.random.default_rng(5)
    return (r.normal(size=(dpw.IN, dpw.HID)).astype(np.float32) * 0.3,
            r.normal(size=(dpw.HID, dpw.OUT)).astype(np.float32) * 0.3)


def _one_process(root, inputs):
    """A one-process run (no ``distributed``) of the workers' MLP, two
    steps, saved consolidated: ``(tag path, its whole state)``."""
    s = port.Stoke(dpw.mlp(*inputs["mlp_w"]),
                   port.StokeOptimizer(torch.optim.Adam, lr=1e-2), dpw.mse,
                   batch_size_per_device=dpw.GLOBAL_BATCH, device="cpu")
    for x, y in dpw.mlp_data(2):
        s.backward(s.loss(s.model(x), y))
        s.step()
    path = os.path.join(root, "one")
    s.save(path)
    return path, worker.whole_state(s)


def _jax_gpt_tag(root):
    """GPT-tiny under the JAX package's dp on a 2-device mesh: saved
    after JAX_BEFORE steps, carried over to a port tag; returns the port
    tag's root, the later batches and the JAX losses on them."""
    model = JaxGPT(vocab_size=worker.GPT_VOCAB, size_name="tiny",
                   max_len=worker.GPT_LEN, dropout_rate=0.0)
    r = np.random.default_rng(6)
    batches = r.integers(0, worker.GPT_VOCAB, size=(
        JAX_BEFORE + JAX_AFTER, JAX_BATCH, worker.GPT_LEN)).astype(np.int32)
    variables = init_module(model, jax.random.PRNGKey(0), batches[0][:2],
                            train=False)
    s = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd,
            optimizer_kwargs=dict(learning_rate=0.1, momentum=0.9)),
        jax_causal_lm_loss, jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=JAX_BATCH // 2, distributed="dp",
        configs=[stoke_tpu.MeshConfig(devices=jax.devices("cpu")[:2])],
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)
    for b in batches[:JAX_BEFORE]:
        s.train_step(b, b)
    tag = s.save(os.path.join(root, "jax_src"))
    after = [float(s.train_step(b, b)) for b in batches[JAX_BEFORE:]]
    out = os.path.join(root, "jax_port")
    jax_checkpoint_to_port(
        tag, out, GPT(vocab_size=worker.GPT_VOCAB, size_name="tiny",
                      max_len=worker.GPT_LEN, dropout_rate=0.0),
        port.StokeOptimizer(torch.optim.SGD, lr=0.1, momentum=0.9))
    return out, list(batches[JAX_BEFORE:]), after


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tags"))
    inputs = {"mlp_w": _mlp_weights(), "root": root}
    inputs["one_tag"], one_state = _one_process(root, inputs)
    inputs["jax_tag_root"], inputs["jax_after"], jax_losses = _jax_gpt_tag(
        root)
    return inputs, one_state, jax_losses


def _spawn(world, inputs, tmp) -> list:
    """Run one world; returns each rank's results. Fails (never hangs)
    when a rank raised or the world outlived the join timeout."""
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
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
def worlds(setup, tmp_path_factory):
    inputs = setup[0]
    # in order: W=4 loads the tags W=2 wrote
    return {w: _spawn(w, inputs, tmp_path_factory.mktemp(f"world{w}"))
            for w in WORLDS}


def _equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


CASES = [(t, f, a) for t in dpw.TIERS for f in worker.FORMATS
         for a in (False, True)]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                              for c in CASES])
def test_resume_continues_bit_for_bit(worlds, world, case):
    """Saved at a boundary and mid-window (``grad_accum=2``), loaded by a
    fresh run of the same world: every rank's losses and weights equal
    the run that saved and trained on, exactly."""
    tier, fmt, _ = case
    for rank, res in enumerate(worlds[world]):
        got = res["resume"][case]
        for i, resumed in got["resumed"].items():
            assert resumed["losses"] == got["losses"][i:], (rank, i)
            _equal(resumed["weights"], got["weights"])
            meta = resumed["meta"]
            assert (meta["format"], meta["world"], meta["writer"]) == (
                fmt, world, 0)
            rank_files = [f for f in resumed["files"] if ".rank" in f]
            if fmt == "consolidated":
                assert rank_files == []
                assert ("grad_local.npz" in resumed["files"]) == (
                    i == worker.BOUNDARY + 1 and tier in ("dp", "oss"))
            else:
                # every rank writes what it holds alone: its slices (oss,
                # sddp, fsdp) and, mid-window, its own gradients (dp and
                # oss); plain dp at a boundary has nothing of its own
                alone = tier != "dp" or i == worker.BOUNDARY + 1
                assert sorted({f.split(".rank")[1] for f in rank_files}) == (
                    [f"{r}.npz" for r in range(world)] if alone else [])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_meta_describes_the_slices(worlds, world):
    """The sharded tag's ``meta.json`` records each sharded leaf's
    dimension, whole shape and per-rank extents (fsdp: the parameters,
    the optimizer state, the mid-window accumulators; dp: the ranks'
    own gradients)."""
    res = worlds[world][0]["resume"]
    mid = worker.BOUNDARY + 1
    meta = res[("fsdp", "sharded", False)]["resumed"][mid]["meta"]
    leaves = meta["leaves"]
    assert sorted(leaves) == ["grad_buf", "opt_state", "variables"]
    w1 = leaves["variables"]["0.weight"]
    assert w1["shape"] == [dpw.HID, dpw.IN] and w1["dim"] == 0
    k = dpw.HID // world
    assert w1["extents"] == [[r * k, (r + 1) * k] for r in range(world)]
    assert sorted(leaves["opt_state"]) == [
        "0.weight/exp_avg", "0.weight/exp_avg_sq", "2.weight/exp_avg",
        "2.weight/exp_avg_sq"]
    assert sorted(leaves["grad_buf"]) == ["0.weight", "2.weight"]
    dp = res[("dp", "sharded", False)]["resumed"][mid]["meta"]
    assert dp["leaves"] == {} and dp["grad_local"] == ["0.weight",
                                                       "2.weight"]


@pytest.mark.parametrize("world", WORLDS)
def test_auto_save_and_maybe_resume(worlds, world):
    """Every rank takes part in the periodic auto-save (every 2 steps of
    5) and in ``maybe_resume``: a fresh run finds the step-4 tag, and its
    loss on the fifth batch equals the saver's (fsdp sharded async, oss
    consolidated sync)."""
    for res in worlds[world]:
        for case, got in res["auto_resume"].items():
            assert got["found"] and got["steps"] == 4, case
            assert got["resumed"] == got["losses"], case


@pytest.mark.parametrize("world", WORLDS)
def test_dropout_streams_resume_per_rank(worlds, world):
    """GPT-tiny with dropout under fsdp, sharded and async, saved
    mid-window: each rank's resumed losses equal its unbroken ones (each
    rank's generator comes back)."""
    for res in worlds[world]:
        got = res["gpt_dropout"]
        assert got["resumed"] == got["losses"][3:]


def test_tags_load_across_world_sizes(setup, worlds):
    """A consolidated tag of one process loads at W=2 and W=4 under each
    tier; W=2's sharded tag loads at W=4 and in one process; W=4's
    consolidated tag loads in one process: the parameters and the
    optimizer state equal the saver's, exactly."""
    inputs, one_state, _ = setup
    for world in WORLDS:
        for res in worlds[world]:
            for tier, state in res["cross_world"]["loaded_one"].items():
                _equal(state, one_state)
    saved2 = worlds[2][0]["cross_world"]["saved"]
    saved4 = worlds[4][0]["cross_world"]["saved"]
    for res in worlds[4]:
        _equal(res["cross_world"]["loaded_w2"], saved2)
    for tag, want in (("xw2/sharded", saved2), ("xw4/consolidated", saved4),
                      ("xw4/sharded", saved4)):
        for fmt in CheckpointFormat:
            s = port.Stoke(dpw.mlp(*inputs["mlp_w"]),
                           port.StokeOptimizer(torch.optim.Adam, lr=1e-2),
                           dpw.mse, batch_size_per_device=dpw.GLOBAL_BATCH,
                           device="cpu",
                           configs=[CheckpointConfig(format=fmt)])
            s.load(os.path.join(inputs["root"], tag))
            _equal(worker.whole_state(s), want)
            assert s.optimizer_steps == 3


@pytest.mark.parametrize("world", WORLDS)
def test_save_rank_writes_from_rank_1(worlds, world):
    assert all(res["save_rank"]["writer"] == 1 for res in worlds[world])


@pytest.mark.parametrize("tier", ["dp", "fsdp"])
def test_jax_tag_resumes_at_two_ranks(setup, worlds, tier):
    """The JAX package's tag from a 2-device dp mesh resumes at W=2 on the
    JAX loss trajectory (1e-3 relative), every rank reporting the global
    batch's loss."""
    jax_losses = setup[2]
    for res in worlds[2]:
        np.testing.assert_allclose(res["jax_resume"][tier], jax_losses,
                                   rtol=LOSS_RTOL)


def test_jax_orbax_tag_refused(tmp_path):
    """A tag of the JAX package's sharded format (orbax) is refused,
    naming the format, before anything is copied."""
    import jax.numpy as jnp

    r = np.random.default_rng(5)
    params = {"w1": jnp.asarray(r.normal(size=(8, 32)).astype(np.float32)),
              "w2": jnp.asarray(r.normal(size=(32, 4)).astype(np.float32))}
    js = stoke_tpu.Stoke(
        model=lambda p, x: jnp.maximum(x @ p["w1"], 0) @ p["w2"],
        optimizer=stoke_tpu.StokeOptimizer(
            optimizer=optax.adam, optimizer_kwargs={"learning_rate": 1e-2}),
        loss=lambda o, y: jnp.mean((o - y) ** 2), params=params,
        batch_size_per_device=32, verbose=False,
        configs=[stoke_tpu.CheckpointConfig(
            format=stoke_tpu.CheckpointFormat.sharded)])
    path = str(tmp_path / "ckpt")
    tag = js.save(path)
    with open(os.path.join(tag, "meta.json")) as f:
        assert json.load(f)["format"] == "sharded"
    s = port.Stoke(dpw.mlp(*_mlp_weights()),
                   port.StokeOptimizer(torch.optim.Adam, lr=1e-2), dpw.mse,
                   batch_size_per_device=32, device="cpu")
    before = {k: v.clone() for k, v in s.model_access.state_dict().items()}
    with pytest.raises(ValueError, match="orbax"):
        s.load(path)
    for k, v in s.model_access.state_dict().items():
        assert torch.equal(v, before[k])


@pytest.mark.parametrize("world", WORLDS)
def test_serve_under_every_tier(worlds, world):
    """``serve()`` under oss and fsdp (the weights gathered) gives the
    greedy streams of ``serve()`` under plain dp, on every rank."""
    for res in worlds[world]:
        got = res["serve_tiers"]
        assert got["oss"] == got["dp"] and got["fsdp"] == got["dp"]
        assert all(len(t) == 5 for t in got["dp"])
