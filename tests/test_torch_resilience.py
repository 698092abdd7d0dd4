"""The port's resilience (``stoke_tpu_torch.resilience``, ``.supervise`` and
the facade's preemption, emergency save and verified resume) against
``tests/test_resilience.py`` and the JAX package.

Host functions are held exactly to the JAX package's on the same inputs:
the exit classes, the backoff schedule and its seeded jitter, the chaos
grammar and its messages, tag discovery, and manifests (each package
verifies the other's). The facade cases run the JAX tests' scenario (a
linear regression under SGD, the same numpy weights and batches) on the
CPU: an interrupted run of the port equals its uninterrupted run bit for
bit and the JAX facade's trajectory at rel 1e-5.
"""

import json
import os
import random
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from stoke_tpu import resilience as jr
from stoke_tpu_torch import (
    CheckpointConfig,
    ResilienceConfig,
    Stoke,
    StokeOptimizer,
    TelemetryConfig,
    io_ops,
)
from stoke_tpu_torch import resilience as pr
from stoke_tpu_torch import supervise as sv
from stoke_tpu_torch.resilience import (
    ChaosError,
    ChaosInjector,
    PreemptedError,
    RestartBackoff,
    corrupt_checkpoint,
    find_latest_valid_checkpoint,
    parse_chaos,
    quarantine_checkpoint,
    verify_checkpoint,
    write_manifest,
)

pytestmark = pytest.mark.torch_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN, OUT = 8, 4
LR = 0.05
JAX_RTOL = 1e-5


def _make_stoke(tmp_path, *, resilience_over=None, telemetry=False,
                with_resilience=True, tag="run", extra=()):
    """The JAX tests' linear regression on the CPU."""
    configs = list(extra)
    if telemetry:
        configs.append(TelemetryConfig(
            output_dir=str(tmp_path / tag / "telemetry"),
            log_every_n_steps=1, sample_device_time=False,
            prometheus=False))
    if with_resilience:
        configs.append(ResilienceConfig(
            save_path=str(tmp_path / tag / "ckpts"), exit_on_preempt=False,
            **(resilience_over or {})))
    model = torch.nn.Linear(IN, OUT, bias=False)
    with torch.no_grad():
        model.weight.fill_(0.1)
    return Stoke(model, StokeOptimizer(torch.optim.SGD, lr=LR),
                 lambda o, y: ((o - y) ** 2).mean(), batch_size_per_device=4,
                 device="cpu", configs=configs)


def _batches(n, seed=7, batch=32):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(IN, OUT)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(batch, IN)).astype(np.float32)
        out.append((x, (x @ W).astype(np.float32)))
    return out


def _step(s, b):
    x, y = b
    return s.train_step(torch.from_numpy(x), torch.from_numpy(y))


def _weight(s):
    return s.model_access.weight.detach().clone()


def _fake_tag(root, step, name="emergency", payload=b"x" * 256):
    tag_dir = os.path.join(root, f"stoke-{name}-backward-step-{step}")
    os.makedirs(tag_dir, exist_ok=True)
    with open(os.path.join(tag_dir, "meta.json"), "w") as f:
        json.dump({"format": "consolidated", "name": name}, f)
    with open(os.path.join(tag_dir, "state.bin"), "wb") as f:
        f.write(payload)
    return tag_dir


# --------------------------------------------------------------------------- #
# host functions, exact against the JAX package
# --------------------------------------------------------------------------- #


def test_constants_match_jax():
    for name in ("PREEMPTION_EXIT_CODE", "_WATCHDOG_EXIT_CODE",
                 "RESUMABLE_EXIT_CODES", "RESTART_ATTEMPT_ENV", "CHAOS_ENV",
                 "MANIFEST_NAME", "QUARANTINE_DIRNAME", "CHAOS_KILL_MODES"):
        assert getattr(pr, name) == getattr(jr, name), name
    from stoke_tpu_torch import status
    from stoke_tpu_torch.telemetry.recorder import BUNDLE_FILE_ENV

    # one source: the status layer and the supervisor read these
    assert status.WATCHDOG_EXIT_CODE == pr._WATCHDOG_EXIT_CODE == 113
    assert status.CHAOS_ENV is pr.CHAOS_ENV
    assert sv.BUNDLE_FILE_ENV == BUNDLE_FILE_ENV


@pytest.mark.parametrize("code", [0, 1, 2, 113, 114, 99, -9, -15, 137,
                                  143, 129, 192, 193, 255])
def test_classify_exit_matches_jax(code):
    assert pr.classify_exit(code) == jr.classify_exit(code)
    assert (pr.classify_exit(code, extra_resumable=(99,))
            == jr.classify_exit(code, extra_resumable=(99,)))


def test_backoff_schedule_and_jitter_match_jax():
    for kw in (dict(base_s=1.0, factor=2.0, max_s=10.0, jitter_frac=0.0,
                    max_restarts=6),
               dict(base_s=0.5, factor=3.0, max_s=60.0, jitter_frac=0.5,
                    max_restarts=6)):
        a = RestartBackoff(**kw, rng=random.Random(0))
        b = jr.RestartBackoff(**kw, rng=random.Random(0))
        got = [a.next_delay() for _ in range(8)]
        assert got == [b.next_delay() for _ in range(8)]
        assert got[-2:] == [None, None] and a.exhausted
    for bad in (dict(base_s=-1), dict(factor=0.5), dict(jitter_frac=-0.1)):
        with pytest.raises(ValueError, match="RestartBackoff needs"):
            RestartBackoff(**bad)


CHAOS_SPECS = [
    None, "", "kill_at_step=5", "kill_at_step=5,kill_mode=sigkill",
    "kill_at_step=2,kill_mode=exception", "corrupt_save=2",
    "wedge_at_step=3,wedge_s=0", " kill_during_save=1 , ",
    "kill_at_step", "kill_at=3", "kill_mode=nope", "corrupt_save=x",
    "corrupt_save=0", "wedge_s=-1", "kill_during_save=0",
]


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_parse_chaos_matches_jax(spec):
    def parse(fn):
        try:
            out = fn(spec)
        except ValueError as e:
            return ("error", str(e))
        return ("ok", None if out is None else vars(out))

    assert parse(parse_chaos) == parse(jr.parse_chaos)


def test_tag_regex_matches_io_ops():
    assert pr._TAG_RE.pattern == io_ops._TAG_RE.pattern
    assert pr._TAG_RE.match(io_ops.checkpoint_tag("emergency", 12))


def test_discovery_matches_jax(tmp_path):
    root = str(tmp_path)
    for step, name in ((2, "emergency"), (10, "emergency"), (4, "auto"),
                       (7, "emergency")):
        _fake_tag(root, step, name=name)
    os.makedirs(os.path.join(root, "not-a-tag"))
    for name in (None, "emergency", "auto", "missing"):
        assert (pr.list_checkpoints(root, name)
                == jr.list_checkpoints(root, name))
    assert pr.list_checkpoints(str(tmp_path / "nowhere"), None) == []
    pick = find_latest_valid_checkpoint([(root, "emergency")])
    assert pick == jr.find_latest_valid_checkpoint([(root, "emergency")])
    assert pick["step"] == 10


def test_manifest_cross_verify_and_corruption(tmp_path):
    """A manifest the port writes verifies under the JAX package and the
    reverse; both catch corruption, truncation and a lost file."""
    for writer, checker in ((pr, jr), (jr, pr)):
        tag = _fake_tag(str(tmp_path / writer.__name__), 3)
        with open(os.path.join(tag, "half.tmp"), "w") as f:
            f.write("in flight")
        writer.write_manifest(tag, extra={"backward_step": 3})
        assert checker.verify_checkpoint(tag, require_manifest=True) == (
            True, "ok")
        manifest = checker.read_manifest(tag)
        assert "half.tmp" not in manifest["files"]
        assert manifest["backward_step"] == 3
        assert checker.corrupt_checkpoint(tag) is not None
        assert pr.verify_checkpoint(tag) == jr.verify_checkpoint(tag)
        assert not pr.verify_checkpoint(tag)[0]
    tag = _fake_tag(str(tmp_path / "t"), 1)
    write_manifest(tag)
    with open(os.path.join(tag, "state.bin"), "r+b") as f:
        f.truncate(10)
    assert verify_checkpoint(tag) == (False, "size mismatch in state.bin")
    os.remove(os.path.join(tag, "state.bin"))
    assert verify_checkpoint(tag) == (False, "missing file state.bin")
    os.remove(os.path.join(tag, "meta.json"))
    assert verify_checkpoint(tag) == (False,
                                      "missing meta.json (partial write)")


def test_quarantine_moves_never_deletes(tmp_path):
    tag = _fake_tag(str(tmp_path), 5)
    dest = quarantine_checkpoint(tag, "bad digest")
    assert not os.path.exists(tag) and os.path.isdir(dest)
    with open(os.path.join(dest, "QUARANTINED.json")) as f:
        assert json.load(f)["reason"] == "bad digest"
    assert os.path.exists(os.path.join(dest, "state.bin"))


def test_discovery_falls_back_past_corrupt_latest(tmp_path):
    root = str(tmp_path)
    for step in (2, 4):
        write_manifest(_fake_tag(root, step))
    corrupt_checkpoint(os.path.join(root, "stoke-emergency-backward-step-4"))
    seen = []
    pick = find_latest_valid_checkpoint(
        [(root, "emergency")], on_quarantine=lambda *a: seen.append(a))
    assert pick["step"] == 2 and len(seen) == 1
    assert "digest mismatch" in seen[0][2]


def test_injector_windows_match_jax(tmp_path, monkeypatch):
    """kill_at_step fires only inside a window this process ran, never
    after a resume past it; a wedge never re-fires after a resume; the
    N-th save is the corrupted one."""
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    inj = ChaosInjector(parse_chaos("kill_at_step=3,kill_mode=sigkill"))
    inj.on_step(2)
    inj.on_step(4, window=2)
    assert kills == [signal.SIGKILL]
    resumed = ChaosInjector(parse_chaos("kill_at_step=3"))
    resumed.note_resumed(3)
    resumed.on_step(4)
    assert kills == [signal.SIGKILL]
    with pytest.raises(ChaosError):
        ChaosInjector(parse_chaos(
            "kill_at_step=1,kill_mode=exception")).on_step(1)
    wedge = ChaosInjector(parse_chaos("wedge_at_step=2,wedge_s=0"))
    wedge.note_resumed(2)
    wedge.on_dispatch("fused")
    assert not wedge._wedged
    fresh = ChaosInjector(parse_chaos("wedge_at_step=2,wedge_s=0"))
    fresh.on_step(2)
    fresh.on_dispatch("fused")
    assert fresh._wedged
    cor = ChaosInjector(parse_chaos("corrupt_save=2"))
    tags = [_fake_tag(str(tmp_path), s) for s in (1, 2)]
    for t in tags:
        write_manifest(t)
        cor.note_saved(t)
    assert verify_checkpoint(tags[0])[0] and not verify_checkpoint(tags[1])[0]
    assert cor.corrupted and cor.corrupted[0].startswith(tags[1])


# --------------------------------------------------------------------------- #
# the supervisor's schedule (no subprocesses, no sleeps)
# --------------------------------------------------------------------------- #


def test_supervisor_restarts_then_succeeds(tmp_path):
    codes = iter([114, 113, 0])
    slept = []
    rec_path = str(tmp_path / "restarts.jsonl")
    seen_env = []

    def run(argv, env):
        seen_env.append(env[pr.RESTART_ATTEMPT_ENV])
        return next(codes)

    out = sv.run_resilient(["worker"], max_restarts=5, base_s=1.0,
                           jitter_frac=0.0, seed=0, run=run,
                           sleep=slept.append, record_path=rec_path)
    assert out["ok"] and out["attempts"] == 3 and out["restarts"] == 2
    assert slept == [1.0, 2.0] and seen_env == ["0", "1", "2"]
    with open(rec_path) as f:
        records = [json.loads(ln) for ln in f]
    assert [r["class"] for r in records] == ["resumable", "resumable", "ok"]
    assert [r["backoff_s"] for r in records[:2]] == [1.0, 2.0]


def test_supervisor_fatal_and_budget():
    calls = []
    out = sv.run_resilient(["w"], max_restarts=5,
                           run=lambda a, e: calls.append(1) or 1,
                           sleep=lambda s: None)
    assert out["fatal"] and out["exit_code"] == 1 and len(calls) == 1
    out = sv.run_resilient(["w"], max_restarts=2, base_s=0.0,
                           jitter_frac=0.0, run=lambda a, e: -9,
                           sleep=lambda s: None)
    assert out["exhausted"] and out["attempts"] == 3


def test_supervise_watchdogs(capfd):
    """A worker silent past ``idle_s`` is killed (a signal death, so
    resumable); under the watchdogs a worker's output is relayed and its
    own code kept; the preemption drain's 114 is named."""
    env = dict(os.environ)
    code = sv.supervise([sys.executable, "-c",
                         "import time; print('up', flush=True); "
                         "time.sleep(60)"], env, idle_s=1.0)
    assert code == -signal.SIGKILL
    assert pr.classify_exit(code) == "resumable"
    code = sv.supervise([sys.executable, "-c",
                         "print('draining'); raise SystemExit(114)"], env,
                        watchdog_s=60.0)
    assert code == pr.PREEMPTION_EXIT_CODE
    out, err = capfd.readouterr()
    assert "up" in out and "draining" in out
    assert "idle watchdog" in err and "preempted and drained" in err


def test_main_maps_signal_deaths_to_shell_codes(monkeypatch):
    monkeypatch.setattr(sv, "supervise", lambda *a, **k: -9)
    assert sv.main(["--max-restarts", "0", "--", "w"]) == 137
    monkeypatch.setattr(sv, "supervise", lambda *a, **k: 3)
    assert sv.main(["--", "w"]) == 3
    with pytest.raises(SystemExit):
        sv.main([])


# --------------------------------------------------------------------------- #
# the facade
# --------------------------------------------------------------------------- #


def test_resilience_off_is_bit_identical_and_on_adds_no_dispatches(tmp_path):
    s_off = _make_stoke(tmp_path, with_resilience=False, tag="off")
    s_on = _make_stoke(tmp_path, tag="on")
    for b in _batches(4):
        assert torch.equal(_step(s_off, b), _step(s_on, b))
    assert s_on.dispatch_count == s_off.dispatch_count == 4
    assert torch.equal(_weight(s_on), _weight(s_off))
    assert s_off.resilience is None and s_off.resilience_summary is None
    s_on.close_telemetry()
    s_off.close_telemetry()


def test_signal_handlers_installed_and_restored(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    s = _make_stoke(tmp_path)
    assert signal.getsignal(signal.SIGTERM) == s.resilience._on_signal
    s.close_telemetry()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_signal_handlers_overlapping_monitors(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    a = _make_stoke(tmp_path, tag="ovl-a")
    b = _make_stoke(tmp_path, tag="ovl-b")
    assert signal.getsignal(signal.SIGTERM) == b.resilience._on_signal
    a.close_telemetry()
    assert signal.getsignal(signal.SIGTERM) == b.resilience._on_signal
    b.close_telemetry()
    assert signal.getsignal(signal.SIGTERM) is prev
    c = _make_stoke(tmp_path, tag="ovl-c")
    d = _make_stoke(tmp_path, tag="ovl-d")
    d.close_telemetry()
    assert signal.getsignal(signal.SIGTERM) == c.resilience._on_signal
    c.close_telemetry()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_resilience_supersedes_the_recorder_and_closes_first(tmp_path):
    """With a HealthConfig the recorder claims SIGTERM first; the monitor,
    built after it, supersedes it, and close_telemetry hands the signal
    back in reverse order."""
    from stoke_tpu_torch import HealthConfig

    prev = signal.getsignal(signal.SIGTERM)
    s = _make_stoke(tmp_path, tag="h", telemetry=True, extra=[HealthConfig(
        bundle_dir=str(tmp_path / "bundles"), watchdog=False)])
    assert signal.getsignal(signal.SIGTERM) == s.resilience._on_signal
    s.close_telemetry()
    assert signal.getsignal(signal.SIGTERM) is prev


def _interrupted(tmp_path, tag, batches, preempt_at, window=False):
    """Run ``batches`` with a preemption requested before step
    ``preempt_at``; returns the per-step losses and the preempted run's
    error. With ``window`` the steps after ``preempt_at - 1`` run as one
    ``train_steps`` segment, so the notice lands inside it."""
    run = _make_stoke(tmp_path, tag=tag)
    losses = [float(_step(run, b)) for b in batches[:preempt_at - 1]]
    run.resilience.request_preemption("test")
    with pytest.raises(PreemptedError) as ei:
        if window:
            rest = batches[preempt_at - 1:preempt_at + 1]
            xs = torch.from_numpy(np.stack([b[0] for b in rest]))
            ys = torch.from_numpy(np.stack([b[1] for b in rest]))
            out = run.train_steps(xs, ys)
            losses += [float(v) for v in out.reshape(-1)]
        else:
            losses.append(float(_step(run, batches[preempt_at - 1])))
    run.close_telemetry()
    return run, losses, ei.value


@pytest.mark.parametrize("window", [False, True], ids=["eager", "window"])
def test_preemption_cycle_bit_identical_trajectory(tmp_path, window):
    n = 6
    batches = _batches(n)
    ref = _make_stoke(tmp_path, tag="ref")
    ref_losses = [float(_step(ref, b)) for b in batches]
    ref.close_telemetry()

    run, _, err = _interrupted(tmp_path, "pre", batches, 4, window=window)
    done = 5 if window else 4
    # the in-flight step(s) finished before the drain
    assert err.step == done == run.optimizer_steps
    assert os.path.exists(os.path.join(err.tag_dir, pr.MANIFEST_NAME))
    assert verify_checkpoint(err.tag_dir, require_manifest=True)[0]
    summary = run.resilience_summary
    assert summary["preemptions"] == 1 and summary["emergency_saves"] == 1
    assert summary["emergency_tag"] == err.tag_dir

    resumed = _make_stoke(tmp_path, tag="pre")
    assert resumed.resume()
    assert resumed.optimizer_steps == done
    rz = resumed.resilience_summary
    assert rz["resumed_step"] == done and rz["lost_steps"] == 0
    assert resumed.ema_loss == run.ema_loss
    losses = [float(_step(resumed, b)) for b in batches[done:]]
    assert losses == ref_losses[done:]
    assert torch.equal(_weight(resumed), _weight(ref))
    resumed.close_telemetry()


def test_interrupted_trajectory_matches_jax(tmp_path):
    """The preempted-and-resumed port run against the JAX facade's
    uninterrupted run on the same numpy weights and batches."""
    import optax

    from stoke_tpu import Stoke as JaxStoke, StokeOptimizer as JaxOpt

    n = 6
    batches = _batches(n)
    js = JaxStoke(
        model=lambda p, x: x @ p["w"],
        optimizer=JaxOpt(optimizer=optax.sgd,
                         optimizer_kwargs={"learning_rate": LR}),
        loss=lambda o, y: ((o - y) ** 2).mean(),
        params={"w": np.ones((IN, OUT), np.float32) * 0.1},
        batch_size_per_device=4, verbose=False)
    jax_losses = [float(np.asarray(js.train_step(x, (y,))))
                  for x, y in batches]

    _, losses, err = _interrupted(tmp_path, "jx", batches, 3)
    resumed = _make_stoke(tmp_path, tag="jx")
    assert resumed.resume() and resumed.optimizer_steps == err.step == 3
    losses += [float(_step(resumed, b)) for b in batches[3:]]
    # the preempted step's report is lost with the raise (its update was
    # applied and saved)
    np.testing.assert_allclose(losses, jax_losses[:2] + jax_losses[3:],
                               rtol=JAX_RTOL)
    np.testing.assert_allclose(
        _weight(resumed).numpy().T, np.asarray(js.params["w"]),
        rtol=JAX_RTOL)
    resumed.close_telemetry()


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    s = _make_stoke(tmp_path, tag="fresh")
    assert not s.resume()
    assert s.optimizer_steps == 0
    s.close_telemetry()


def test_corrupt_latest_quarantined_resume_falls_back(tmp_path):
    run = _make_stoke(tmp_path, tag="qr")
    batches = _batches(4)
    root = run.resilience.cfg.save_path
    for b in batches[:2]:
        _step(run, b)
    run.save(root, name="emergency")
    for b in batches[2:]:
        _step(run, b)
    newest = run.save(root, name="emergency")
    run.close_telemetry()
    assert corrupt_checkpoint(newest) is not None

    resumed = _make_stoke(tmp_path, tag="qr")
    assert resumed.resume()
    assert resumed.optimizer_steps == 2
    rz = resumed.resilience_summary
    assert rz["quarantined_ckpts"] == 1
    assert rz["resumed_step"] == 2 and rz["lost_steps"] == 2
    assert not os.path.exists(newest)
    qdir = os.path.join(root, pr.QUARANTINE_DIRNAME)
    assert len(os.listdir(qdir)) == 1
    resumed.close_telemetry()


def test_emergency_prune_skips_inflight_tags(tmp_path):
    run = _make_stoke(tmp_path, resilience_over={"max_to_keep": 1},
                      tag="race")
    root = run.resilience.cfg.save_path
    os.makedirs(root, exist_ok=True)
    inflight = os.path.join(root, "stoke-emergency-backward-step-99")
    os.makedirs(inflight)
    io_ops._INFLIGHT_TAGS.add(inflight)
    leftover = os.path.join(root, "stoke-emergency-backward-step-98")
    os.makedirs(leftover)
    try:
        b = _batches(1)[0]
        _step(run, b)
        run.resilience.request_preemption("test")
        with pytest.raises(PreemptedError):
            _step(run, b)
        assert os.path.exists(inflight)
        assert not os.path.exists(leftover)
        assert run.resilience_summary["emergency_saves"] == 1
    finally:
        io_ops._INFLIGHT_TAGS.discard(inflight)
        run.close_telemetry()


def test_chaos_exception_mode_via_facade(tmp_path):
    run = _make_stoke(tmp_path, tag="chaos", resilience_over={
        "chaos": "kill_at_step=2,kill_mode=exception"})
    batches = _batches(3)
    _step(run, batches[0])
    with pytest.raises(ChaosError):
        _step(run, batches[1])
    run.close_telemetry()


def test_chaos_corrupt_save_via_facade(tmp_path):
    run = _make_stoke(tmp_path, tag="cor",
                      resilience_over={"chaos": "corrupt_save=1"})
    _step(run, _batches(1)[0])
    tag = run.save(run.resilience.cfg.save_path, name="emergency")
    assert not verify_checkpoint(tag)[0]
    run.close_telemetry()


def test_resilience_jsonl_fields(tmp_path):
    """The ``resilience/*`` step-event fields are the JAX package's names
    (its reader parses the port's file)."""
    from stoke_tpu.telemetry import read_step_events
    from stoke_tpu.telemetry.events import RESILIENCE_STEP_FIELDS

    s = _make_stoke(tmp_path, telemetry=True, tag="tel")
    for b in _batches(2):
        _step(s, b)
    s.close_telemetry()
    rec = read_step_events(
        str(tmp_path / "tel" / "telemetry" / "steps.jsonl"))[-1]
    assert sorted(k for k in rec if k.startswith("resilience/")) == sorted(
        RESILIENCE_STEP_FIELDS)
    assert sorted(s.resilience.event_fields()) == sorted(
        RESILIENCE_STEP_FIELDS)
    assert rec["resilience/preemptions"] == 0.0
    assert rec["resilience/emergency_saves"] == 0.0
    assert rec["resilience/quarantined"] == 0.0
    assert rec["resilience/restarts"] == 0.0
    assert rec["resilience/resumed_step"] is None
    assert rec["resilience/lost_steps"] is None
    s_off = _make_stoke(tmp_path, telemetry=True, with_resilience=False,
                        tag="tel_off")
    for b in _batches(2):
        _step(s_off, b)
    s_off.close_telemetry()
    rec_off = read_step_events(
        str(tmp_path / "tel_off" / "telemetry" / "steps.jsonl"))[-1]
    assert "resilience/preemptions" not in rec_off


def test_restart_attempt_env_surfaces(tmp_path, monkeypatch):
    monkeypatch.setenv(pr.RESTART_ATTEMPT_ENV, "3")
    s = _make_stoke(tmp_path, tag="att")
    assert s.resilience.restarts == 3 == s.restart_attempt
    assert s.resilience_summary["restarts"] == 3
    s.close_telemetry()
    assert _make_stoke(tmp_path, tag="att2",
                       with_resilience=False).restart_attempt == 0


# --------------------------------------------------------------------------- #
# a supervised SIGKILL restart as real processes
# --------------------------------------------------------------------------- #


def _run_worker(root, steps, chaos=None, supervised=False, save_every=3):
    env = {k: v for k, v in os.environ.items() if k != pr.CHAOS_ENV}
    env["PYTHONPATH"] = _REPO
    if chaos:
        env[pr.CHAOS_ENV] = chaos
    cmd = [sys.executable,
           os.path.join(_REPO, "tests", "_torch_resilience_worker.py"),
           "--root", root, "--steps", str(steps),
           "--save-every", str(save_every)]
    if supervised:
        cmd = [sys.executable, "-m", "stoke_tpu_torch.supervise",
               "--max-restarts", "3", "--base-s", "0.01",
               "--jitter-frac", "0",
               "--record", os.path.join(root, "restarts.jsonl"),
               "--"] + cmd
    return subprocess.run(cmd, env=env, cwd=_REPO, timeout=240,
                          capture_output=True, text=True)


def test_chaos_sigkill_supervised_restart_bit_identical(tmp_path):
    """The kill, restart and resume loop as processes: SIGKILLed by the
    injector at step 3 (no emergency save can run), the worker is
    restarted by the supervisor, resumes from the periodic tag the boundary
    saved just before the kill (step 3: a resumed process never re-fires a
    kill it restored past) and ends bit for bit where the uninterrupted
    run does."""
    steps = 6
    ref_root, chaos_root = str(tmp_path / "ref"), str(tmp_path / "chaos")
    os.makedirs(ref_root)
    os.makedirs(chaos_root)
    ref = _run_worker(ref_root, steps)
    assert ref.returncode == 0, ref.stderr
    out = _run_worker(chaos_root, steps,
                      chaos="kill_at_step=3,kill_mode=sigkill",
                      supervised=True)
    assert out.returncode == 0, out.stderr
    with open(os.path.join(chaos_root, "restarts.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    assert [r["exit_code"] for r in records] == [-signal.SIGKILL, 0]
    assert records[0]["class"] == "resumable"
    assert all(r["elapsed_s"] > 0 for r in records)
    summary = json.loads([ln for ln in out.stdout.splitlines()
                          if '"supervise"' in ln][-1])["supervise"]
    assert summary["ok"] and summary["restarts"] == 1
    assert summary["elapsed_s"] >= sum(r["elapsed_s"] for r in records)
    np.testing.assert_array_equal(
        np.load(os.path.join(chaos_root, "final_w.npy")),
        np.load(os.path.join(ref_root, "final_w.npy")))

    def traj(root):
        with open(os.path.join(root, "trajectory.jsonl")) as f:
            return [json.loads(ln) for ln in f]

    t_ref = {r["step"]: r["loss"] for r in traj(ref_root)}
    by_attempt = {}
    for r in traj(chaos_root):
        assert r["loss"] == t_ref[r["step"]], r
        by_attempt.setdefault(r["attempt"], []).append(r["step"])
    # step 3 ran and was saved in the killed life; its line died with it
    assert by_attempt == {0: [1, 2], 1: [4, 5, 6]}
