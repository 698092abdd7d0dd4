"""The port's staging, partial tags, the residual remap and elastic resume
against ``tests/test_elastic.py:121-638`` and the JAX package (its
rebalancer cases are in ``tests/test_torch_fleet.py``).

The remap functions are held exactly to the JAX package's on the same
residuals. A gloo world of 2 (``tests/_torch_elastic_worker.py``) saves an
emergency tag with the int8 sharded transport's residual, and a world of
1 resumes it: the parameters and the optimizer state exactly, the
residual exactly the host remap. Each world is spawned once for the
module; on the CPU every staging copy is synchronous, so the card phase
(``chip_smoke.train_resilience``) is where a torn snapshot would show.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from stoke_tpu.parallel import zero as jzero
from stoke_tpu_torch import (
    CheckpointConfig,
    ResilienceConfig,
    Stoke,
    StokeOptimizer,
    StokeValidationError,
    io_ops,
    offload,
)
from stoke_tpu_torch import supervise as sv
from stoke_tpu_torch.configs import CheckpointFormat
from stoke_tpu_torch.parallel.zero import (
    flat_to_residual,
    remap_residual,
    residual_to_flat,
)
from stoke_tpu_torch.resilience import (
    PreemptedError,
    read_manifest,
    verify_checkpoint,
    write_manifest,
)

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dp_worker as dpw  # noqa: E402
import _torch_elastic_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN, OUT = 8, 4
JOIN_TIMEOUT_S = 120
_STAGED = CheckpointConfig(async_save=True, offload_staging=True)


def _make_stoke(tmp_path, *, tag="run", ckpt=None, model_out=OUT):
    """The JAX tests' two-matrix model under SGD with momentum."""
    cfgs = [ResilienceConfig(save_path=str(tmp_path / tag / "em"),
                             exit_on_preempt=False)]
    if ckpt is not None:
        cfgs.append(ckpt)
    model = torch.nn.Sequential(torch.nn.Linear(IN, IN, bias=False),
                                torch.nn.Linear(IN, model_out, bias=False))
    with torch.no_grad():
        for m in model:
            m.weight.fill_(0.1)
    return Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.05,
                                       momentum=0.9),
                 lambda o, y: ((o - y) ** 2).mean(), batch_size_per_device=4,
                 device="cpu", configs=cfgs)


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(IN, OUT)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(32, IN)).astype(np.float32)
        out.append((torch.from_numpy(x), torch.from_numpy(x @ w)))
    return out


# --------------------------------------------------------------------------- #
# staging
# --------------------------------------------------------------------------- #


def test_staged_snapshot_survives_the_next_step(tmp_path):
    """The snapshot is independent of the live tensors: the next step
    updates them in place, the resolved values are the pre-step state."""
    s = _make_stoke(tmp_path)
    x, y = _batches(1)[0]
    s.train_step(x, y)
    before = {n: p.detach().clone() for n, p in
              s.model_access.named_parameters()}
    snap = offload.stage_tree({"w": dict(s.model_access.named_parameters()),
                               "n": 7})
    s.train_step(x, y)
    spec, leaves = snap.resolve()
    got = torch.utils._pytree.tree_unflatten(leaves, spec)
    assert got["n"] == 7
    for n, ref in before.items():
        np.testing.assert_array_equal(got["w"][n], ref.numpy())
        assert not torch.equal(s.model_access.get_parameter(n), ref)
    snap.release()
    s.close_telemetry()


def test_stage_double_buffer_bound():
    x = torch.ones(32)
    s1 = offload.stage_tree({"x": x})
    s2 = offload.stage_tree({"x": x})
    assert not s1.resolved and not s2.resolved
    s3 = offload.stage_tree({"x": x})
    assert s1.resolved and not s3.resolved
    assert len(offload._INFLIGHT_STAGED) == offload.MAX_STAGED
    offload.drain_staged()
    assert s2.resolved and s3.resolved and not offload._INFLIGHT_STAGED
    assert offload.staged_nbytes() == 0
    # idempotent: the cached host arrays
    spec, leaves = s3.resolve()
    np.testing.assert_array_equal(leaves[0], np.ones(32, np.float32))
    for s in (s1, s2, s3):
        s.release()


def test_pinned_pool_bounded_reused_and_freed(tmp_path, monkeypatch):
    """A Stoke's pool lends at most MAX_STAGED sets a signature for reuse
    (beyond that a set is the snapshot's alone), counts their bytes, and
    frees them at close: the free sets at once, the lent ones when they
    come back. (Unpinned here: the CPU has no pinned memory.)"""
    monkeypatch.setattr(offload, "_alloc_pinned", lambda sig: [
        torch.empty(shape, dtype=dtype) for shape, dtype in sig])
    sig = (((32,), torch.float32), ((4, 4), torch.bfloat16))
    set_bytes = 32 * 4 + 16 * 2
    pool = offload.PinnedPool()
    (a, pa), (b, pb), (c, pc) = (pool.take(sig) for _ in range(3))
    assert (pa, pb, pc) == (True, True, False)
    assert pool.nbytes == offload.MAX_STAGED * set_bytes
    pool.give(sig, a)
    again, pooled = pool.take(sig)
    assert again is a and pooled
    pool.give(sig, a)
    assert pool.close() == set_bytes
    assert pool.nbytes == set_bytes  # b is still lent out
    pool.give(sig, b)
    assert pool.nbytes == 0
    assert pool.take(sig)[1] is False  # closed: nothing is pooled
    s = _make_stoke(tmp_path)
    s.close_telemetry()
    assert s._staging_pool.nbytes == 0 and s._staging_pool.take(sig)[1] is False


def test_staged_save_no_main_thread_gather(tmp_path, monkeypatch):
    """The staged async save never copies the state to the host on the
    calling thread; the tag is manifest-complete and loads back exactly."""
    s = _make_stoke(tmp_path, ckpt=_STAGED)
    for x, y in _batches(2):
        s.train_step(x, y)

    def no_gather(tree):
        raise AssertionError("a staged save must not copy on the main "
                             "thread")

    monkeypatch.setattr(io_ops, "to_numpy_tree", no_gather)
    tag_dir = s.save(str(tmp_path / "ck"))
    s.wait_for_checkpoint()
    monkeypatch.undo()
    ok, reason = verify_checkpoint(tag_dir, require_manifest=True)
    assert ok, reason
    s2 = _make_stoke(tmp_path, tag="load", ckpt=_STAGED)
    s2.load(str(tmp_path / "ck"))
    for (n, p), q in zip(s.model_access.named_parameters(),
                         s2.model_access.parameters()):
        assert torch.equal(p, q), n
    for p, q in zip(s.model_access.parameters(),
                    s2.model_access.parameters()):
        assert torch.equal(s.optimizer.state[p]["momentum_buffer"],
                           s2.optimizer.state[q]["momentum_buffer"])
    assert s2.optimizer_steps == 2
    s.close_telemetry()
    s2.close_telemetry()


def test_staged_partial_tag_detected_and_quarantined(tmp_path):
    s = _make_stoke(tmp_path, ckpt=_STAGED)
    x, y = _batches(1)[0]
    s.train_step(x, y)
    root = str(tmp_path / "ck")
    tag_dir = s.save(root)
    s.wait_for_checkpoint()
    os.remove(os.path.join(tag_dir, "opt_state.npz"))
    ok, reason = verify_checkpoint(tag_dir)
    assert not ok and reason == "missing file opt_state.npz"
    s2 = _make_stoke(tmp_path, tag="resume")
    assert s2.resume(path=root) is False
    qdir = os.path.join(root, "quarantine")
    assert os.path.isdir(qdir) and os.listdir(qdir)
    assert s2.resilience_summary["quarantined_ckpts"] == 1
    s.close_telemetry()
    s2.close_telemetry()


def test_wait_for_saves_drains_staging_before_emergency_gather(
        tmp_path, monkeypatch):
    """An emergency save arriving while a staged periodic save is in
    flight resolves the staging before its own host copy."""
    events = []
    real_resolve = offload.StagedSnapshot.resolve

    def slow_resolve(self):
        time.sleep(0.05)
        out = real_resolve(self)
        events.append("staged-resolved")
        return out

    real_gather = io_ops.to_numpy_tree

    def logged_gather(tree):
        events.append("gather")
        return real_gather(tree)

    monkeypatch.setattr(offload.StagedSnapshot, "resolve", slow_resolve)
    monkeypatch.setattr(io_ops, "to_numpy_tree", logged_gather)
    s = _make_stoke(tmp_path, ckpt=_STAGED)
    batches = _batches(3)
    s.train_step(*batches[0])
    s.save(str(tmp_path / "ck"))
    s.resilience.request_preemption("race")
    with pytest.raises(PreemptedError):
        s.train_step(*batches[1])
    first = events.index("gather")
    assert first >= 1 and set(events[:first]) == {"staged-resolved"}, events
    s.wait_for_checkpoint()
    for root in (tmp_path / "ck", tmp_path / "run" / "em"):
        tags = [t for t in os.listdir(root) if t.startswith("stoke-")]
        assert tags, root
        for t in tags:
            ok, reason = verify_checkpoint(os.path.join(str(root), t))
            assert ok, (t, reason)
    s.close_telemetry()


def test_manifest_skips_inflight_tmp_files(tmp_path):
    tag = tmp_path / "stoke-x-backward-step-1"
    tag.mkdir()
    (tag / "meta.json").write_text('{"format": "consolidated"}')
    (tag / "variables.rank0.npz").write_bytes(b"done")
    (tag / "variables.rank1.npz.tmp").write_bytes(b"inflight")
    write_manifest(str(tag))
    listed = read_manifest(str(tag))["files"]
    assert "variables.rank0.npz" in listed
    assert not any(".tmp" in name for name in listed)
    os.replace(tag / "variables.rank1.npz.tmp", tag / "variables.rank1.npz")
    ok, reason = verify_checkpoint(str(tag))
    assert ok, reason


def test_durable_save_accounting_per_save(tmp_path):
    s = _make_stoke(tmp_path, ckpt=_STAGED)
    x, y = _batches(1)[0]
    s.train_step(x, y)
    assert s._last_save_step == 0
    s.save(str(tmp_path / "ck"))
    s.wait_for_checkpoint()
    assert s._last_save_step == 1
    s.train_step(x, y)
    s._save_with_config(str(tmp_path / "ck"), "sync", CheckpointConfig(),
                        None)
    assert s._last_save_step == 2
    s.close_telemetry()


@pytest.mark.parametrize("case", ["sync", "sharded"])
def test_offload_staging_status_rules(tmp_path, case):
    """offload_staging without async_save, or with the sharded format, is
    the JAX package's status error, letter for letter."""
    from stoke_tpu import CheckpointConfig as JaxCheckpoint
    from stoke_tpu import CheckpointFormat as JaxFormat
    from stoke_tpu import StokeStatus as JaxStatus
    from stoke_tpu import StokeValidationError as JaxError
    from stoke_tpu_torch.status import StokeStatus

    kw = {"sync": {}, "sharded": dict(async_save=True)}[case]
    fmt = {"sync": "consolidated", "sharded": "sharded"}[case]
    with pytest.raises(JaxError) as theirs:
        JaxStatus(batch_size_per_device=4, configs=[JaxCheckpoint(
            offload_staging=True, format=JaxFormat(fmt), **kw)])
    with pytest.raises(StokeValidationError) as ours:
        StokeStatus(batch_size_per_device=4, device="cpu",
                    configs=[CheckpointConfig(
                        offload_staging=True, format=CheckpointFormat(fmt),
                        **kw)])
    assert str(ours.value) == str(theirs.value)
    assert ("async_save" if case == "sync" else "consolidated") in str(
        ours.value)


# --------------------------------------------------------------------------- #
# the residual remap, exact against the JAX functions
# --------------------------------------------------------------------------- #


def _sharded_desc(leaf_sizes, world, chunk=64):
    total = sum(leaf_sizes)
    align = world * chunk
    padded = -(-total // align) * align
    return {"kind": "sharded", "world": world, "error_feedback": True,
            "leaf_sizes": list(leaf_sizes), "buckets": [[total, padded]]}


def test_residual_remap_world_change_roundtrip():
    sizes = [200, 56]
    flat = np.random.default_rng(0).normal(size=(256,)).astype(np.float32)
    d8, d4 = _sharded_desc(sizes, 8), _sharded_desc(sizes, 4)
    res8 = flat_to_residual(flat, d8)
    jres8 = jzero.flat_to_residual(flat, d8, None)
    assert [a.tobytes() for a in res8] == [a.tobytes() for a in jres8]
    res4 = remap_residual(res8, d8, d4)
    jres4 = jzero.remap_residual(jres8, d8, d4, None)
    assert [a.tobytes() for a in res4] == [a.tobytes() for a in jres4]
    assert res4[0].shape == (d4["buckets"][0][1],)
    np.testing.assert_array_equal(residual_to_flat(res4, d4), flat)
    back = remap_residual(res4, d4, d8)
    np.testing.assert_array_equal(residual_to_flat(back, d8), flat)


def test_residual_remap_replicated_sharded_conversion():
    sizes = [20, 5]
    rng = np.random.default_rng(1)
    leaves = {"a": rng.normal(size=(10, 2)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    repl = {"kind": "replicated", "world": 8, "error_feedback": True,
            "leaf_sizes": sizes, "buckets": [[25, 512]]}
    sh = _sharded_desc(sizes, 4, chunk=16)
    # the JAX replicated residual is per leaf; the port's, whole buckets
    jax_sh = jzero.remap_residual(leaves, repl, sh, None)
    ours_from_leaves = remap_residual([leaves["a"], leaves["b"]], repl, sh)
    ours_from_buckets = remap_residual(flat_to_residual(
        np.concatenate([leaves["a"].ravel(), leaves["b"]]), repl), repl, sh)
    for ours in (ours_from_leaves, ours_from_buckets):
        assert [a.tobytes() for a in ours] == [a.tobytes() for a in jax_sh]
    back = remap_residual(ours_from_leaves, sh, repl)
    template = {k: np.zeros_like(v) for k, v in leaves.items()}
    jax_back = jzero.flat_to_residual(residual_to_flat(back, repl), repl,
                                      template)
    for k in leaves:
        np.testing.assert_array_equal(jax_back[k], leaves[k])


def test_residual_remap_model_mismatch_raises():
    d_a, d_b = _sharded_desc([100], 4), _sharded_desc([120], 4)
    res = flat_to_residual(np.zeros(100, np.float32), d_a)
    with pytest.raises(ValueError, match="incompatible") as ours:
        remap_residual(res, d_a, d_b)
    with pytest.raises(ValueError) as theirs:
        jzero.remap_residual(jzero.flat_to_residual(
            np.zeros(100, np.float32), d_a, None), d_a, d_b, None)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="different model"):
        flat_to_residual(np.zeros(7, np.float32), d_a)


# --------------------------------------------------------------------------- #
# the topology descriptor
# --------------------------------------------------------------------------- #


def test_topology_descriptor_matches_jax(tmp_path):
    """Keys and values against the JAX facade's for the same run (one
    device, no tier), and the compatibility predicates."""
    import optax

    from stoke_tpu import Stoke as JaxStoke
    from stoke_tpu import StokeOptimizer as JaxOpt

    js = JaxStoke(model=lambda p, x: x @ p["w1"] @ p["w2"],
                  optimizer=JaxOpt(optimizer=optax.sgd,
                                   optimizer_kwargs={"learning_rate": 0.05}),
                  loss=lambda o, y: ((o - y) ** 2).mean(),
                  params={"w1": np.ones((IN, IN), np.float32),
                          "w2": np.ones((IN, OUT), np.float32)},
                  batch_size_per_device=4, verbose=False)
    s = _make_stoke(tmp_path)
    desc = s.topology_descriptor()
    assert desc == js.topology_descriptor()
    assert desc["param_leaves"] == 2
    assert desc["param_elems"] == IN * IN + IN * OUT
    assert s._descriptor_incompatible(
        {**desc, "mesh_shape": [4], "device_count": 4}) is None
    assert "incompatible" in s._descriptor_incompatible(
        {**desc, "param_elems": 123})
    assert s._topology_changed({**desc, "tier": "oss"}, desc)
    assert not s._topology_changed(desc, desc)
    assert not s._topology_changed(None, desc)
    s.close_telemetry()


def test_incompatible_descriptor_quarantined_with_remedy(tmp_path):
    s = _make_stoke(tmp_path, tag="a")
    s.train_step(*_batches(1)[0])
    root = str(tmp_path / "ck")
    s.save(root)
    other = _make_stoke(tmp_path, tag="b", model_out=OUT + 2)
    assert other.resume(path=root) is False
    qdir = os.path.join(root, "quarantine")
    (qtag,) = os.listdir(qdir)
    with open(os.path.join(qdir, qtag, "QUARANTINED.json")) as f:
        record = json.load(f)
    assert "incompatible checkpoint" in record["reason"]
    assert "resume with the saving architecture" in record["reason"]
    assert other.resilience_summary["quarantined_ckpts"] == 1
    s.close_telemetry()
    other.close_telemetry()


# --------------------------------------------------------------------------- #
# a kill during a save; the supervisor's accounting
# --------------------------------------------------------------------------- #


def test_kill_during_save_leaves_quarantinable_partial(tmp_path):
    """SIGKILL from inside a staged async save's writer (after the
    payload, before meta.json): the tag reads as partial and a resume
    quarantines it."""
    root = str(tmp_path / "work")
    os.makedirs(root)
    env = {**os.environ, "PYTHONPATH": _REPO,
           "STOKE_CHAOS": "kill_during_save=1"}
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, "tests",
                                      "_torch_resilience_worker.py"),
         "--root", root, "--steps", "2", "--save-every", "2", "--staged"],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == -9, proc.stderr
    auto = os.path.join(root, "auto")
    (tag,) = [t for t in os.listdir(auto) if t.startswith("stoke-")]
    ok, reason = verify_checkpoint(os.path.join(auto, tag))
    assert not ok and "meta.json" in reason
    s = _make_stoke(tmp_path, tag="resumer", model_out=OUT)
    assert s.resume(path=auto, name="auto") is False
    qdir = os.path.join(auto, "quarantine")
    assert os.path.isdir(qdir) and os.listdir(qdir)
    s.close_telemetry()


def test_supervisor_records_elapsed_and_lost_goodput(tmp_path):
    bundle = tmp_path / "bundle"
    bundle.mkdir()
    with open(bundle / "manifest.json", "w") as f:
        json.dump({"extra": {"step_ema_s": 0.25,
                             "lost_steps_estimate": 8}}, f)
    calls = []
    clock = iter([0.0, 1.0, 3.5, 4.0, 6.0, 6.5])

    def fake_run(argv, env):
        calls.append(env)
        if len(calls) == 1:  # only the dying attempt writes a bundle
            with open(env[sv.BUNDLE_FILE_ENV], "w") as f:
                f.write(str(bundle) + "\n")
        return 114 if len(calls) == 1 else 0

    out = sv.run_resilient(["worker"], max_restarts=2, seed=0,
                           run=fake_run, sleep=lambda s: None,
                           clock=lambda: next(clock))
    assert out["ok"] and out["attempts"] == 2
    first, second = out["records"]
    assert first["exit_code"] == 114 and first["elapsed_s"] == 2.5
    assert first["lost_steps_estimate"] == 8
    assert first["step_ema_s"] == 0.25
    assert first["lost_goodput_s_est"] == pytest.approx(2.0)
    assert second["elapsed_s"] == 2.0 and "lost_goodput_s_est" not in second
    assert out["elapsed_s"] == 6.5 and out["lost_goodput_s_est"] == 2.0


# --------------------------------------------------------------------------- #
# across processes: world 2 saves, world 1 resumes
# --------------------------------------------------------------------------- #


def _spawn(world, inputs, tmp) -> list:
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
            pytest.fail(f"world {world} rank {r}:\n{res['error']}")
        out.append(res)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    r = np.random.default_rng(5)
    inputs = {"root": str(tmp_path_factory.mktemp("tags")),
              "mlp_w": (r.normal(size=(dpw.IN, dpw.HID)).astype(np.float32)
                        * 0.3,
                        r.normal(size=(dpw.HID, dpw.OUT)).astype(np.float32)
                        * 0.3)}
    return {w: _spawn(w, inputs, tmp_path_factory.mktemp(f"world{w}"))
            for w in (2, 1)}


def test_preemption_flag_is_all_reduced(worlds):
    """The notice reached rank 1 only; both ranks drained at step 4 and
    the emergency tag is one, with its manifest."""
    saves = [r["elastic_save"] for r in worlds[2]]
    assert [s["step"] for s in saves] == [4, 4]
    assert [s["signal"] for s in saves] == ["peer-preemption", "test"]
    assert saves[0]["tag_dir"] == saves[1]["tag_dir"]
    assert verify_checkpoint(saves[0]["tag_dir"], require_manifest=True)[0]
    for s in saves:
        assert s["summary"]["preemptions"] == 1
        assert s["summary"]["emergency_saves"] == 1


def test_rank0_picks_and_broadcasts(worlds):
    picks = [r["pick_broadcast"] for r in worlds[2]]
    assert all(p["resumed"] for p in picks)
    assert [p["step"] for p in picks] == [1, 1]
    # one validator: only rank 0 verified and quarantined
    assert [p["summary"]["quarantined_ckpts"] for p in picks] == [1, 0]
    for k, v in picks[0]["state"].items():
        np.testing.assert_array_equal(v, picks[1]["state"][k], err_msg=k)


def test_elastic_resume_world2_to_world1(worlds):
    """The world-2 emergency tag at world 1: parameters and optimizer
    state exactly, the sharded int8 residual remapped onto world 1's
    padding exactly as ``remap_residual`` (port and JAX) maps the saved
    one, the elastic resume counted, and the run steps on."""
    import pickle

    saved = worlds[2][0]["elastic_save"]
    (res,) = (r["elastic_resume"] for r in worlds[1])
    assert res["resumed"] and res["step"] == 4
    for k, v in saved["state"].items():
        np.testing.assert_array_equal(res["state"][k], v, err_msg=k)
    with open(os.path.join(saved["tag_dir"], "extras.pkl"), "rb") as f:
        extras = pickle.load(f)["resilience"]
    desc2, desc1 = extras["comm_layout"], res["layout"]
    assert desc2 == saved["layout"] and desc2["world"] == 2
    assert desc1["world"] == 1 and desc2["buckets"] != desc1["buckets"]
    whole = extras["comm_state"]["residual"]
    assert [a.shape for a in whole] == [(960,)]
    assert np.any(whole[0] != 0)
    ours = remap_residual(whole, desc2, desc1)
    theirs = jzero.remap_residual(tuple(whole), desc2, desc1, None)
    assert [a.shape for a in ours] == [(800,)]
    for a, b, live in zip(ours, theirs, res["residual"]):
        assert a.tobytes() == b.tobytes() == live.tobytes()
    rz = res["summary"]
    assert rz["elastic_resumes"] == 1
    assert rz["elastic_resume"]["from"]["mesh_shape"] == [2]
    assert rz["elastic_resume"]["to"]["mesh_shape"] == [1]
    assert res["events"]["resilience/elastic_resumes"] == 1.0
    assert len(res["losses"]) == 2 and np.all(np.isfinite(res["losses"]))
