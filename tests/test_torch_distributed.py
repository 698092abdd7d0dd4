"""Port parity: the DP / ZeRO ladder across processes over gloo.

Two worlds, W=2 and W=4, each spawned once for the module
(``tests/_torch_dp_worker.py`` runs every scenario in every rank and
writes what it saw); the parametrised cases below read the results. Each
world rendezvouses through a file store in a temporary directory (no TCP
port, so parallel test workers cannot collide) and is joined with a 120 s
timeout, after which the test fails instead of hanging.

References, on the same numpy inputs:

- the JAX package under ``distributed="dp"`` on a W-device CPU mesh
  (``MeshConfig(devices=jax.devices()[:W])``);
- the port on one device over the whole global batch.

Tolerances: the MLP of ``tests/test_distributed.py`` at that file's own,
losses rel 1e-4 and weights rtol 1e-4, atol 1e-6 (each tier against JAX
dp, against the port on one device, and under a binding clip norm);
GPT-tiny and the two-stage ResNet against JAX dp at 1e-3 of each tensor's
largest magnitude (fp32 sums in other orders over 2-3 steps). The
placements, counts, sampler shards and the fp16 skip are exact.
"""

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
from stoke_tpu.models.resnet import BasicBlock as JaxBasicBlock
from stoke_tpu.models.resnet import ResNet as JaxResNet
from stoke_tpu.utils import init_module
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch.configs import ClipGradNormConfig
from stoke_tpu_torch.convert import (
    cnn_state_dict_from_jax,
    gpt_state_dict_from_jax,
)

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dp_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

WORLDS = (2, 4)
JOIN_TIMEOUT_S = 120
GPT_VOCAB, GPT_LEN, GPT_BATCH, GPT_STEPS = 257, 16, 8, 3
RN_BATCH, RN_SIDE, RN_STEPS = 8, 8, 3
PARITY_TOL = 1e-3


def _jax_mlp_params():
    """``tests/test_distributed.py``'s ``init_params``."""
    r = np.random.default_rng(7)
    return {"w1": r.normal(size=(worker.IN, worker.HID)).astype(
                np.float32) * 0.1,
            "w2": r.normal(size=(worker.HID, worker.OUT)).astype(
                np.float32) * 0.1}


def _mesh(world):
    return stoke_tpu.MeshConfig(devices=jax.devices("cpu")[:world])


def _jax_mlp_dp(world, clip=None):
    def mlp(params, x):
        return jax.nn.relu(x @ params["w1"]) @ params["w2"]

    s = stoke_tpu.Stoke(
        model=mlp, optimizer=stoke_tpu.StokeOptimizer(
            optimizer=optax.adam, optimizer_kwargs={"learning_rate": 1e-2}),
        loss=lambda out, y: ((out - y) ** 2).mean(),
        params=_jax_mlp_params(), distributed="dp",
        batch_size_per_device=worker.GLOBAL_BATCH // world,
        grad_clip=None if clip is None else stoke_tpu.ClipGradNormConfig(
            max_norm=clip),
        configs=[_mesh(world)], verbose=False)
    losses = []
    for x, y in worker.mlp_data():
        loss = s.loss(s.model(x), y)
        s.backward(loss)
        s.step()
        losses.append(float(loss))
    return losses, {"0.weight": np.asarray(s.params["w1"]).T,
                    "2.weight": np.asarray(s.params["w2"]).T}


def _one_device(clip=None, grad_accum=None, n=worker.STEPS):
    """The port on one device over the whole global batches."""
    p = _jax_mlp_params()
    s = Stoke(worker.mlp(p["w1"], p["w2"]),
              StokeOptimizer(torch.optim.Adam, lr=1e-2), worker.mse,
              batch_size_per_device=worker.GLOBAL_BATCH, device="cpu",
              grad_accum=grad_accum,
              grad_clip=None if clip is None else ClipGradNormConfig(
                  max_norm=clip))
    losses = worker.four_calls(s, worker.mlp_data(n), 0, 1)
    return losses, worker.weights(s)


def _gpt_inputs():
    model = JaxGPT(vocab_size=GPT_VOCAB, size_name="tiny", max_len=GPT_LEN,
                   dropout_rate=0.0)
    r = np.random.default_rng(5)
    batches = [r.integers(0, GPT_VOCAB, size=(GPT_BATCH, GPT_LEN)).astype(
        np.int32) for _ in range(GPT_STEPS)]
    variables = jax.tree_util.tree_map(np.asarray, init_module(
        model, jax.random.PRNGKey(0), batches[0][:2], train=False))
    weights = {k: v.numpy() for k, v in
               gpt_state_dict_from_jax(variables["params"]).items()}
    return model, variables, batches, weights


def _jax_gpt_dp(world, model, variables, batches):
    s = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd,
            optimizer_kwargs=dict(learning_rate=0.1, momentum=0.9)),
        jax_causal_lm_loss, jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=GPT_BATCH // world, distributed="dp",
        configs=[_mesh(world)], model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)
    losses = [float(s.train_step(b, b)) for b in batches]
    return losses, {k: v.numpy() for k, v in gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, s.params)).items()}


def _resnet_inputs():
    model = JaxResNet(stage_sizes=(1, 1), block=JaxBasicBlock,
                      num_classes=10, num_filters=4, cifar_stem=True)
    variables = jax.tree_util.tree_map(np.asarray, init_module(
        model, jax.random.PRNGKey(0),
        np.zeros((2, RN_SIDE, RN_SIDE, 3), np.float32), train=False))
    r = np.random.default_rng(0)
    xs = r.normal(size=(RN_STEPS, RN_BATCH, RN_SIDE, RN_SIDE, 3)).astype(
        np.float32)
    ys = r.integers(0, 10, size=(RN_STEPS, RN_BATCH)).astype(np.int32)
    weights = {k: v.numpy()
               for k, v in cnn_state_dict_from_jax(variables).items()}
    return model, variables, xs, ys, weights


def _jax_resnet_dp(world, model, variables, xs, ys):
    s = stoke_tpu.Stoke(
        model, stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd,
            optimizer_kwargs=dict(learning_rate=0.05, momentum=0.9)),
        lambda logits, y: optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(),
        jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=RN_BATCH // world, distributed="dp",
        configs=[_mesh(world)], model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)
    losses = [float(s.train_step(xs[i], (ys[i],))) for i in range(len(xs))]
    return losses, {k: v.numpy() for k, v in cnn_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, s.variables)).items()}


@pytest.fixture(scope="module")
def inputs():
    p = _jax_mlp_params()
    _, _, gpt_batches, gpt_weights = _gpt_inputs()
    _, _, xs, ys, rn_weights = _resnet_inputs()
    return {"mlp_w": (p["w1"], p["w2"]),
            "gpt": {"vocab": GPT_VOCAB, "len": GPT_LEN,
                    "batches": gpt_batches, "weights": gpt_weights},
            "resnet": {"xs": xs, "ys": ys, "weights": rn_weights}}


def _spawn(world, inputs, tmp) -> list:
    """Run one world; returns each rank's results. Fails (never hangs)
    when a rank raised or the world outlived the join timeout."""
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
    sent = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, sent)
    procs = [ctx.Process(target=worker.run,
                         args=(r, world, store, str(tmp), sent))
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
def worlds(inputs, tmp_path_factory):
    return {w: _spawn(w, inputs, tmp_path_factory.mktemp(f"world{w}"))
            for w in WORLDS}


@pytest.fixture(scope="module")
def jax_refs():
    gpt = _gpt_inputs()
    resnet = _resnet_inputs()
    return {w: {"mlp": _jax_mlp_dp(w),
                "gpt": _jax_gpt_dp(w, *gpt[:3]),
                "resnet": _jax_resnet_dp(w, *resnet[:4])}
            for w in WORLDS}


@pytest.fixture(scope="module")
def one_device():
    return {None: _one_device(), worker.CLIP: _one_device(worker.CLIP),
            "accum": _one_device(grad_accum=2, n=4)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tier", ["dp", "fsdp"])
def test_sentinels_are_global(worlds, world, tier, tmp_path):
    """The health sentinels across the ranks equal one process's over the
    whole global batches: the grad norm (the clip's, summed over the
    ranks' slices under fsdp), the parameter norm and the update ratio at
    rel 1e-6, the non-finite count and first leaf exactly; every rank
    holds the same row."""
    from stoke_tpu_torch.configs import (ClipGradNormConfig, HealthConfig,
                                         TelemetryConfig)

    p = _jax_mlp_params()
    ref = Stoke(worker.mlp(p["w1"], p["w2"]),
                StokeOptimizer(torch.optim.Adam, lr=1e-2), worker.mse,
                batch_size_per_device=worker.GLOBAL_BATCH, device="cpu",
                grad_clip=ClipGradNormConfig(max_norm=worker.CLIP),
                configs=[TelemetryConfig(output_dir=str(tmp_path),
                                         jsonl=False, prometheus=False),
                         HealthConfig(dump_signals=False)])
    want = np.asarray(worker.sentinel_rows(ref, worker.mlp_data(3), 0, 1))
    ref.close_telemetry()
    got = [np.asarray(r["sentinels"][tier]) for r in worlds[world]]
    for rank_rows in got[1:]:
        np.testing.assert_array_equal(rank_rows, got[0])
    # grad_norm, param_norm, update_ratio (1-3); nonfinite, skip,
    # residual, first leaf (4-7) exactly
    np.testing.assert_allclose(got[0][:, 1:4], want[:, 1:4], rtol=1e-6)
    np.testing.assert_array_equal(got[0][:, 4:], want[:, 4:])
    np.testing.assert_allclose(got[0][:, 0], want[:, 0], rtol=1e-6)


def _close_weights(got, want, rtol=1e-4, atol=1e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tier", list(worker.TIERS))
def test_tier_matches_jax_dp(worlds, jax_refs, world, tier):
    """Each tier at W ranks equals the JAX package's dp on a W-device
    mesh (the JAX test's tolerances), with every rank's weights equal."""
    losses, w = jax_refs[world]["mlp"]
    runs = [r["tiers"][(tier, None)] for r in worlds[world]]
    np.testing.assert_allclose(runs[0]["losses"], losses, rtol=1e-4)
    _close_weights(runs[0]["weights"], w)
    for other in runs[1:]:
        assert other["losses"] == runs[0]["losses"]
        for k, v in runs[0]["weights"].items():
            np.testing.assert_array_equal(other["weights"][k], v)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("clip", [None, worker.CLIP])
@pytest.mark.parametrize("tier", list(worker.TIERS))
def test_tier_matches_one_device(worlds, one_device, world, clip, tier):
    """Each tier equals the port on one device over the global batch,
    also under a clip norm that binds (the global norm, replicated leaves
    counted once, each slice once)."""
    losses, w = one_device[clip]
    got = worlds[world][0]["tiers"][(tier, clip)]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    _close_weights(got["weights"], w)
    if clip is not None:
        free = one_device[None][1]
        assert max(_rel(w[k], free[k]) for k in w) > 1e-3  # it binds


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(worker.PLACEMENTS))
def test_placements(worlds, world, case):
    """What each rank holds (elements) with the min sizes at 300:
    ``0.weight`` (8x64 = 512) in 1/W under the tiers that shard it,
    ``2.weight`` (64x4 = 256) whole everywhere; oss shards optimizer
    state, sddp also the gradient buffer, fsdp also the parameters. With
    sddp's min size (300) below oss's (600), ``0.weight``'s gradient
    buffer shards and its optimizer state does not, as the JAX rules place
    them. Every case's weights after the step equal dp's."""
    big, small = "0.weight", "2.weight"
    for res in worlds[world]:
        got = res["placements"][case]
        assert got["steps"] == 1
        _close_weights(got["weights"], res["placements"]["dp"]["weights"])
        shard_opt = case in ("oss", "sddp", "fsdp")
        shard_grad = case in ("sddp", "fsdp", "sddp_gap")
        shard_param = case == "fsdp"
        assert got["opt"] == {big: 512 // world if shard_opt else 512,
                              small: 256}
        assert got["grad"] == {big: 512 // world if shard_grad else 512,
                               small: 256}
        assert got["param"] == {big: 512 // world if shard_param else 512,
                                small: 256}


@pytest.mark.parametrize("world", WORLDS)
def test_grad_accumulation(worlds, one_device, world):
    """oss+sddp at grad_accum=2: two optimizer steps, equal to one
    device accumulating the same global micro-batches."""
    losses, w = one_device["accum"]
    got = worlds[world][0]["accumulation"]
    assert got["steps"] == 2
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    _close_weights(got["weights"], w)


@pytest.mark.parametrize("world", WORLDS)
def test_eval_under_fsdp(worlds, world):
    """An eval-mode forward against sharded parameters gives the whole
    model's output on the rank's rows, and the parameters are sharded
    again after it and after a step."""
    p = _jax_mlp_params()
    x, _ = worker.mlp_data(1)[0]
    model = worker.mlp(p["w1"], p["w2"])
    for rank, res in enumerate(worlds[world]):
        got = res["fsdp_eval"]
        with torch.no_grad():
            want = model(worker.rows(x, rank, world)).numpy()
        np.testing.assert_allclose(got["eval_out"], want, rtol=1e-6,
                                   atol=1e-7)
        assert got["held_after_eval"] == [0, 0]
        assert got["held_after_step"] == [0, 0]


@pytest.mark.parametrize("world", WORLDS)
def test_window_equals_four_calls(worlds, world):
    """Under oss+sddp, ``train_steps`` computes what the four calls do
    (on the CPU the window runs eagerly: the same operations)."""
    for res in worlds[world]:
        got = res["window"]
        assert got["steps"] == (2, 2)
        assert got["window"] == got["calls"]
        for k, v in got["calls_w"].items():
            np.testing.assert_array_equal(got["window_w"][k], v)


@pytest.mark.parametrize("world", WORLDS)
def test_fp16_finite_flag_is_global(worlds, world):
    """fp16 under oss+sddp: clean steps skip nothing at scale 2^16; an inf
    in rank 1's loss alone skips the step on every rank, leaves every
    slice as it was, and halves the scale everywhere."""
    for res in worlds[world]:
        got = res["fp16"]
        assert got["skipped"] == 0.0 and got["scale"] == 2.0**16
        assert got["skipped_after_inf"] == 1.0
        assert got["scale_after_inf"] == 2.0**15
        assert got["unchanged"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_detach_and_sync_loss(worlds, world, reduction):
    """The reported loss is the global batch's on every rank;
    ``LossReduction.sum`` scales a mean-reduced loss by the world size (the
    JAX facade's rule), and a sum-reduced one not."""
    x, y = worker.mlp_data(1)[0]
    p = _jax_mlp_params()
    with torch.no_grad():
        want = float(worker.mse(worker.mlp(p["w1"], p["w2"])(
            torch.from_numpy(x)), torch.from_numpy(y)))
    scale = world if reduction == "sum" else 1
    for res in worlds[world]:
        got = res["loss_sync"][reduction]
        assert got["mean"] == pytest.approx(want * scale, rel=1e-6)
        assert got["sum"] == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_world_size_and_effective_batch(worlds, world):
    for rank, res in enumerate(worlds[world]):
        assert res["loss_sync"]["counts"] == {
            "world_size": world, "rank": rank, "n_processes": world,
            "batch_size": worker.GLOBAL_BATCH // world,
            "effective_batch_size": worker.GLOBAL_BATCH * 2}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["plain", "bucketed"])
def test_sampler_shards_are_disjoint_and_cover(worlds, world, kind):
    shards = [res["samplers"][kind] for res in worlds[world]]
    assert len({len(s) for s in shards}) == 1
    seen = [i for s in shards for i in s]
    assert sorted(seen) == list(range(worker.SAMPLES))


@pytest.mark.parametrize("world", WORLDS)
def test_dataloader_refuses_no_sampler(worlds, world):
    for res in worlds[world]:
        assert res["samplers"]["refusal"].startswith(
            "Stoke -- multi-process runs require a distributed sampler")


@pytest.mark.parametrize("world", WORLDS)
def test_dropout_masks_differ_across_ranks(worlds, world):
    """Each rank seeds its dropout generator ``seed + rank``: with one seed
    every rank would draw the same mask over its own rows. (The JAX
    package draws one mask over the global batch, so neither matches it
    bit for bit; ROADMAP Queue 3 logs the divergence.)"""
    masks = [res["dropout_masks"]["mask"] for res in worlds[world]]
    assert all(0 < m.mean() < 1 for m in masks)
    for i in range(world):
        for j in range(i + 1, world):
            assert not np.array_equal(masks[i], masks[j])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tier", ["dp", "fsdp"])
def test_gpt_matches_jax_dp(worlds, jax_refs, world, tier):
    """GPT-tiny (2 layers, plain attention) from the JAX weights, 3 SGD
    steps: losses and parameters within 1e-3 of JAX dp."""
    losses, w = jax_refs[world]["gpt"]
    got = worlds[world][0]["gpt"][tier]
    np.testing.assert_allclose(got["losses"], losses, rtol=PARITY_TOL)
    assert set(got["weights"]) == set(w)
    for k in w:
        assert _rel(got["weights"][k], w[k]) <= PARITY_TOL, k


@pytest.mark.parametrize("world", WORLDS)
def test_resnet_batchnorm_matches_jax_dp(worlds, jax_refs, world):
    """The two-stage ResNet under dp: BatchNorm's moments are the global
    batch's (all-reduced), so parameters and running statistics match JAX
    dp within 1e-3; every rank holds the same statistics."""
    losses, want = jax_refs[world]["resnet"]
    runs = [res["resnet"] for res in worlds[world]]
    np.testing.assert_allclose(runs[0]["losses"], losses, rtol=PARITY_TOL)
    for k, v in want.items():
        assert _rel(runs[0]["state"][k], v) <= PARITY_TOL, k
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for other in runs[1:]:
        for k in stats:
            np.testing.assert_array_equal(other["state"][k],
                                          runs[0]["state"][k])


@pytest.mark.parametrize("world", WORLDS)
def test_multiprocess_checkpoints_refused(worlds, world):
    """Saves, loads and the periodic auto-save across processes were
    refused until ROADMAP item 6b; now each runs on every rank (the tag
    of step 2 written and loaded, ``maybe_resume`` finds the auto-save
    of step 2) and ``barrier`` returns."""
    for res in worlds[world]:
        got = res["multiprocess_checkpoints"]
        assert got["barrier"]
        assert got["save"] == "stoke-stoke-backward-step-2"
        assert got["load"] == 2
        assert got["auto_save"] == (True, 2)
