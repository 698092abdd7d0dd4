"""Port parity: the health monitor, flight recorder and watchdog (ROADMAP
item 10b).

The sentinel row ``StepEngine.apply`` computes against the JAX
``compute_sentinels`` fed the same step (rel 1e-6 in fp32; the non-finite
count and first bad leaf exact, in the JAX leaf order; a clip, fp16 with
and without a skip, the int8 error-feedback residual), every row of the
same MLP through both facades (4-call, clip, accumulation, window, fp16),
the detectors fed one sentinel sequence
firing at the same steps as the JAX detectors (exact), a NaN batch at step
k detected at step k through both facades with bundles of the same file
names, the leaf path table of GPT-tiny against the JAX params tree's, the
sentinel grad norm against a host recompute, ``HealthHaltError``, the
watchdog (unit, compile grace, and a killing watchdog in a subprocess
exiting 113), the exception dump and its cap, and the JAX status messages
of the health rules.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch import nn

import stoke_tpu_torch as port
from stoke_tpu_torch.telemetry import collectors
from stoke_tpu_torch.telemetry.health import (
    SENTINEL_FIELDS,
    HangWatchdog,
    HealthHaltError,
    HealthMonitor,
    leaf_path_names,
)
from stoke_tpu_torch.telemetry.recorder import FlightRecorder
from stoke_tpu_torch.telemetry.registry import MetricsRegistry

from test_torch_telemetry import MLP, _batches, four_calls, jax_stoke, port_stoke

pytestmark = pytest.mark.torch_port

#: the sentinels' tolerance against the JAX package (fp32)
RTOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trees(r, bad=None):
    """Gradients and parameters before the step as dicts (sorted keys =
    the JAX flatten order); ``bad`` poisons leaves."""
    shapes = {"a": (3, 5), "b": (7,), "c": (4, 2), "d": (6,)}
    grads = {k: r.normal(size=s).astype(np.float32) for k, s in
             shapes.items()}
    for k, v in (bad or {}).items():
        grads[k].flat[1] = v
    old = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    return grads, old


class _Leaves(nn.Module):
    """The leaves of ``_trees`` as parameters, registered in the JAX
    flatten order (the order the engine keeps for a module the converter
    does not know)."""

    def __init__(self, old):
        super().__init__()
        for k in sorted(old):
            self.register_parameter(
                k, nn.Parameter(torch.from_numpy(old[k].copy())))


#: the apply's settings and poisoned leaves of each sentinel case
SENTINEL_CASES = {
    "finite": {},
    "nan": dict(bad={"c": np.nan}),
    "inf_and_nan": dict(bad={"b": np.inf, "d": np.nan}),
    "neg_inf": dict(bad={"a": -np.inf}),
    "huge_finite": dict(bad={"a": 3e38}),
    "fp16": dict(fp16=True),
    "skipped_fp16": dict(fp16=True, bad={"b": np.inf}),
    "clip": dict(clip=True),
    "residual": dict(comm=dict(dtype="int8", bucket_mb=0.004,
                               chunk_elems=16)),
}


@pytest.mark.parametrize("case", list(SENTINEL_CASES))
def test_compute_sentinels_matches_jax(case):
    """The row ``StepEngine.apply`` computes (the port's
    ``compute_sentinels``) against the JAX ``compute_sentinels`` fed the
    same step: the gradients after the transport and before the clip, the
    parameters before and after the engine's SGD step, the fp16 finite
    flag and the transport's state. The norms and the update ratio at rel
    1e-6, the non-finite count, first bad leaf, skip flag and loss exact.
    A finite leaf whose squares overflow fp32 (``huge_finite``) is not
    counted, as ``any(~isfinite)`` counts it; ``-inf`` is."""
    import types

    import jax.numpy as jnp

    from stoke_tpu import configs as jc
    from stoke_tpu.parallel import zero as jzero
    from stoke_tpu.telemetry.health import compute_sentinels as jax_compute
    from stoke_tpu_torch import configs as pc
    from stoke_tpu_torch.engine import PrecisionPolicy, StepEngine
    from stoke_tpu_torch.parallel.zero import make_transport

    spec = SENTINEL_CASES[case]
    grads, old = _trees(np.random.default_rng(0), spec.get("bad"))
    module = _Leaves(old)
    fp16 = spec.get("fp16", False)
    policy = PrecisionPolicy.make(
        pc.PrecisionOptions.fp16 if fp16 else pc.PrecisionOptions.full,
        pc.PrecisionConfig())
    comm = spec.get("comm")
    transport = (None if comm is None else make_transport(
        pc.CommConfig(**comm), pc.ShardingOptions.oss))
    engine = StepEngine(
        module, None, torch.optim.SGD(module.parameters(), lr=0.01), policy,
        grad_clip=(port.ClipGradNormConfig(max_norm=0.5)
                   if spec.get("clip") else None),
        transport=transport, sentinels=True)
    # the accumulated gradients as the backward leaves them (scaled under
    # fp16, by a power of two: exact)
    scale = float(engine.scaler["scale"]) if fp16 else 1.0
    for k, p in module.named_parameters():
        p.grad = torch.from_numpy(grads[k] * np.float32(scale))
    engine.apply(torch.tensor(2.5))
    ours = engine.sentinel_row.numpy()
    new = {k: p.detach().numpy() for k, p in module.named_parameters()}

    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    state = {}
    if comm is not None:
        jt = jzero.make_transport(jc.CommConfig(**comm), types.SimpleNamespace(
            mesh=None, axis_name="data", tier=jc.ShardingOptions.oss))
        jg, state = jt.apply(jg, jt.init_state(jg))
    finite = all(np.isfinite(v).all() for v in grads.values())
    theirs = np.asarray(jax_compute(
        jnp.float32(2.5), jg, {k: jnp.asarray(v) for k, v in new.items()},
        {k: jnp.asarray(v) for k, v in old.items()},
        jnp.asarray(finite or not fp16), state))
    assert ours.shape == theirs.shape == (len(SENTINEL_FIELDS),)
    exact = [SENTINEL_FIELDS.index(f) for f in
             ("nonfinite_leaves", "scaler_skip", "first_nonfinite_leaf",
              "step_loss")]
    np.testing.assert_array_equal(ours[exact], theirs[exact])
    close = [i for i in range(len(SENTINEL_FIELDS)) if i not in exact]
    np.testing.assert_allclose(ours[close], theirs[close], rtol=RTOL)
    want_bad = {"nan": (1, 2), "inf_and_nan": (2, 1), "neg_inf": (1, 0),
                "skipped_fp16": (1, 1)}.get(case, (0, -1))
    assert (ours[4], ours[7]) == want_bad
    assert ours[5] == (case == "skipped_fp16")
    if comm is not None:
        assert ours[SENTINEL_FIELDS.index("comm_residual_norm")] > 0


#: the fp16 cases' tolerance through the facades: both run the MLP in
#: float16 and round at other places, so the gradients themselves differ
#: at this level (the step losses too); the row over equal gradients is
#: held at RTOL above
FP16_RTOL = 5e-4
#: each facade case: Stoke flags and how the steps are driven
FACADE_CASES = {
    "four_call": dict(drive="four_call"),
    "clip": dict(drive="train_step", clip=0.3),
    "accum": dict(drive="train_step", grad_accum=2),
    "window": dict(drive="train_steps"),
    "fp16": dict(drive="train_step", precision="fp16", nan_batch=1),
}


def _facade_rows(make, mod, tmp, case):
    """Every step's sentinel row (from the flight recorder's ring) of the
    MLP driven through ``make``'s facade as ``case`` says."""
    spec = FACADE_CASES[case]
    kw = {k: spec[k] for k in ("grad_accum", "precision") if k in spec}
    if "clip" in spec:
        kw["grad_clip"] = mod.ClipGradNormConfig(max_norm=spec["clip"])
    s = make([mod.TelemetryConfig(output_dir=tmp, jsonl=False,
                                  prometheus=False),
              mod.HealthConfig(dump_signals=False,
                               nonfinite_action="record")], **kw)
    batches = _batches(4)
    if "nan_batch" in spec:
        x = batches[spec["nan_batch"]][0].copy()
        x[0, 0] = np.nan
        batches[spec["nan_batch"]] = (x, batches[spec["nan_batch"]][1])
    if spec["drive"] == "four_call":
        four_calls(s, batches)
    elif spec["drive"] == "train_steps":
        s.train_steps(np.stack([x for x, _ in batches]),
                      np.stack([y for _, y in batches]))
    else:
        for x, y in batches:
            s.train_step(x, y)
    rows = [(e["step"], [e["values"][f] for f in SENTINEL_FIELDS])
            for e in s.health.recorder.ring if e["kind"] == "sentinels"]
    s.close_telemetry()
    return [r for r, _ in rows], np.asarray([v for _, v in rows],
                                            np.float64)


@pytest.mark.parametrize("case", list(FACADE_CASES))
def test_facade_sentinel_rows_match_jax(case, tmp_path):
    """The same MLP, weights and batches through both facades with a
    ``HealthConfig``: a sentinel row for the same steps, every field of
    every row within rel RTOL of the JAX facade's (FP16_RTOL under fp16),
    the non-finite count, skip flag and first bad leaf exact. The fp16
    case's NaN batch is a skipped step in both. (The error-feedback
    residual is held to the JAX transport's in
    ``test_compute_sentinels_matches_jax[residual]``: a ``CommConfig``
    needs a data-parallel facade.)"""
    import stoke_tpu.configs as jc

    steps, ours = _facade_rows(port_stoke, port, str(tmp_path / "p"), case)
    want_steps, theirs = _facade_rows(jax_stoke, jc, str(tmp_path / "j"),
                                      case)
    assert steps == want_steps == list(
        range(1, 1 + 4 // FACADE_CASES[case].get("grad_accum", 1)))
    exact = [SENTINEL_FIELDS.index(f) for f in
             ("nonfinite_leaves", "scaler_skip", "first_nonfinite_leaf")]
    np.testing.assert_array_equal(ours[:, exact], theirs[:, exact])
    close = [i for i in range(len(SENTINEL_FIELDS)) if i not in exact]
    rtol = FP16_RTOL if "precision" in FACADE_CASES[case] else RTOL
    np.testing.assert_allclose(ours[:, close], theirs[:, close], rtol=rtol)
    if case == "fp16":
        skip = SENTINEL_FIELDS.index("scaler_skip")
        assert ours[:, skip].tolist() == [0.0, 1.0, 0.0, 0.0]


def _sentinel_sequence():
    """24 steps of rows that trip every sentinel detector: a loss spike
    at 14, a grad-norm spike at 16, a NaN at 18, a 3-step scaler-skip
    streak at 19-21, a residual runaway at 23."""
    rows = []
    r = np.random.default_rng(4)
    for step in range(1, 25):
        loss = 2.0 + 0.01 * r.normal()
        grad = 1.0 + 0.01 * r.normal()
        res = 0.5 + 0.01 * r.normal()
        row = [loss, grad, 10.0, 1e-3, 0.0, 0.0, res, -1.0]
        if step == 14:
            row[0] = 9.0
        if step == 16:
            row[1] = 50.0
        if step == 18:
            row[0], row[4], row[7] = float("nan"), 2.0, 1.0
        if step in (19, 20, 21):
            row[5] = 1.0
        if step == 23:
            row[6] = 20.0
        rows.append(np.asarray(row, np.float32))
    return rows


def test_detectors_fire_at_the_same_steps(tmp_path):
    """The port's monitor and the JAX monitor, fed the same sentinel rows
    and the same registry-driven signals (loader starvation growing on
    consecutive steps, a burst of recompiles), fire the same detectors at
    the same steps with the same values and provenance."""
    import stoke_tpu.configs as jc
    from stoke_tpu.telemetry.health import HealthMonitor as JaxMonitor
    from stoke_tpu.telemetry.recorder import FlightRecorder as JaxRecorder
    from stoke_tpu.telemetry.registry import MetricsRegistry as JaxRegistry

    class Tracker:
        recompiles = 0

    kw = dict(detector_warmup_steps=5, loss_spike_action="record",
              grad_spike_action="record", nonfinite_action="record",
              scaler_skip_streak=3, scaler_skip_action="record",
              recompile_storm_threshold=3, recompile_storm_window=4,
              recompile_storm_action="record", starvation_streak=3,
              starvation_action="record", comm_residual_factor=5.0,
              comm_residual_action="record", dump_signals=False)
    fired = {}
    for name, cfg, reg, rec, mon in (
            ("port", port.HealthConfig(**kw), MetricsRegistry(),
             FlightRecorder(str(tmp_path / "p")), HealthMonitor),
            ("jax", jc.HealthConfig(**kw), JaxRegistry(),
             JaxRecorder(str(tmp_path / "j")), JaxMonitor)):
        tracker = Tracker()
        m = mon(cfg, reg, rec, compile_tracker=tracker)
        m.leaf_paths = ["Dense_0/bias", "Dense_0/kernel", "Dense_1/bias"]
        out = []
        for step, row in enumerate(_sentinel_sequence(), start=1):
            if step in (6, 7, 8):
                reg.counter("data/starvation_s").inc(0.5)
            if step in (10, 11):
                tracker.recompiles += 2
            out += [(a.detector, a.step, a.value, a.context, a.message)
                    for a in m.observe(step, row)]
        m.close()
        fired[name] = out
    assert fired["port"] == fired["jax"]
    assert {d for d, *_ in fired["port"]} == {
        "loss_spike", "grad_norm_spike", "nonfinite_grads",
        "scaler_skip_streak", "recompile_storm", "loader_starvation",
        "comm_residual_runaway"}


def test_nan_at_step_k_in_both_facades(tmp_path):
    """A NaN batch at step 3 fires the non-finite detector at step 3 in
    both packages, naming the same first leaf (its JAX path), and each
    writes a bundle of the same file names."""
    import stoke_tpu.configs as jc

    batches = _batches(4)
    batches[2] = (batches[2][0].copy(), batches[2][1])
    batches[2][0][0, 0] = np.nan
    got = {}
    for name, make, mod in (("port", port_stoke, port), ("jax", jax_stoke,
                                                          jc)):
        s = make([mod.TelemetryConfig(output_dir=str(tmp_path / name),
                                      prometheus=False),
                  mod.HealthConfig(dump_signals=False, max_dumps=1)])
        for x, y in batches:
            s.train_step(x, y)
        a = next(a for a in s.health.anomalies
                 if a.detector == "nonfinite_grads")
        bundle = s.health.recorder.dumps[0]
        ring = [json.loads(l) for l in open(os.path.join(bundle,
                                                         "ring.jsonl"))]
        got[name] = (a.step, a.context, sorted(os.listdir(bundle)),
                     [e["step"] for e in ring if e["kind"] == "sentinels"])
        s.close_telemetry()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 3
    assert got["port"][1]["first_leaf_path"] == "Dense_0/bias"
    assert "manifest.json" in got["port"][2] and "stacks.txt" in got[
        "port"][2]


def test_first_bad_leaf_is_named_by_its_jax_path(tmp_path):
    """A gradient hook makes one parameter's gradient NaN at step 2: the
    detector fires at step 2 naming that parameter's JAX path, inside a
    replayed-window path too (``train_steps``)."""
    s = port_stoke([port.TelemetryConfig(output_dir=str(tmp_path),
                                         prometheus=False, jsonl=False),
                    port.HealthConfig(dump_signals=False,
                                      nonfinite_action="record")])
    calls = []

    def poison(g):
        calls.append(1)
        return g * float("nan") if len(calls) == 2 else g

    s.model_access.Dense_1.weight.register_hook(poison)
    b = _batches(3)
    xs, ys = np.stack([x for x, _ in b]), np.stack([y for _, y in b])
    s.train_steps(xs, ys)
    fired = [a for a in s.health.anomalies if a.detector == "nonfinite_grads"]
    assert fired[0].step == 2 and fired[0].value == 1.0
    assert fired[0].context == {"first_leaf_index": 3,
                                "first_leaf_path": "Dense_1/kernel"}
    s.close_telemetry()


def test_gpt_leaf_paths_in_the_jax_order():
    """GPT-tiny's leaf path table is the JAX params tree's flatten order
    and names (the tied embedding, the fused qkv), from
    ``jax.eval_shape`` (no compile)."""
    import jax

    from stoke_tpu.models.gpt import GPT as JaxGPT
    from stoke_tpu.telemetry.numerics import leaf_path_names as jax_paths
    from stoke_tpu_torch.models.gpt import GPT

    jmodel = JaxGPT(vocab_size=257, size_name="tiny", max_len=64)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32), train=False))
    model = GPT(size_name="tiny", vocab_size=257, max_len=64, device="cpu")
    assert leaf_path_names(model) == jax_paths(shapes["params"])


def test_sentinel_grad_norm_against_a_host_recompute(tmp_path):
    """The first step's sentinel grad norm is the norm of that step's
    gradient recomputed on the host from the same weights and batch (rel
    1e-6), with and without a clip (whose norm it reuses)."""
    x, y = _batches(1)[0]
    m = MLP()
    loss = ((m(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    want = torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in m.parameters()])).item()
    for clip in (None, port.ClipGradNormConfig(max_norm=0.1)):
        s = port_stoke([port.TelemetryConfig(output_dir=str(tmp_path),
                                             jsonl=False, prometheus=False),
                        port.HealthConfig(dump_signals=False)],
                       grad_clip=clip)
        s.train_step(x, y)
        row = s._last_sentinels
        assert row[1] == pytest.approx(want, rel=RTOL)
        assert row[0] == pytest.approx(loss.item(), rel=RTOL)
        s.close_telemetry()


def test_health_halt_error_propagates(tmp_path):
    s = port_stoke([port.TelemetryConfig(output_dir=str(tmp_path),
                                         jsonl=False, prometheus=False),
                    port.HealthConfig(dump_signals=False,
                                      nonfinite_action="halt")])
    b = _batches(2)
    s.train_step(*b[0])
    x = b[1][0].copy()
    x[0, 0] = np.nan
    with pytest.raises(HealthHaltError) as e:
        s.train_step(x, b[1][1])
    assert e.value.anomalies[0].detector == "nonfinite_grads"
    assert os.path.isdir(e.value.bundle) and "health halt" in str(e.value)
    assert s.health.halted == "nonfinite_grads"
    s.close_telemetry()


def test_watchdog_unit_and_compile_grace():
    """Fires once per arm, never after a disarm; a compile starting while
    armed pushes the deadline out by the monitor's grace."""
    trips = []
    wd = HangWatchdog(0.15, lambda: trips.append(1))
    try:
        wd.arm()
        deadline = time.monotonic() + 3.0
        while not trips and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(trips) == 1
        time.sleep(0.3)
        assert len(trips) == 1
        wd.arm()
        wd.disarm()
        time.sleep(0.3)
        assert len(trips) == 1
    finally:
        wd.stop()
    assert not wd._thread.is_alive()
    cfg = port.HealthConfig(watchdog=True, watchdog_timeout_s=0.2,
                            watchdog_compile_grace_s=0.6, dump_signals=False)
    reg = MetricsRegistry()
    m = HealthMonitor(cfg, reg, FlightRecorder("unused"))
    m._steps_completed = True
    m.watchdog.on_trip = lambda: trips.append(2)
    m.arm_watchdog()
    with collectors.compiling():
        time.sleep(0.4)  # past the timeout, inside the grace
    assert trips == [1]
    m.disarm_watchdog()
    m.close()
    assert not m.watchdog._thread.is_alive()


_KILL = """
import sys, time, numpy as np, torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import stoke_tpu_torch as port
from test_torch_telemetry import port_stoke, _batches
s = port_stoke([port.TelemetryConfig(output_dir={out!r}, prometheus=False),
                port.HealthConfig(dump_signals=False, watchdog=True,
                                  watchdog_timeout_s=0.5,
                                  watchdog_compile_grace_s=0.0,
                                  watchdog_kill=True)])
fused = s._engine.fused
def wedged(*a, **k):
    time.sleep(30)
    return fused(*a, **k)
s._engine.fused = wedged
s.train_step(*_batches(1)[0])
print("survived")
"""


def test_watchdog_kill_exits_113(tmp_path):
    """A wedged step under ``watchdog_kill`` (timeout 0.5 s): the process
    leaves a watchdog bundle and exits with ``WATCHDOG_EXIT_CODE``."""
    from stoke_tpu_torch.status import WATCHDOG_EXIT_CODE

    code = _KILL.format(root=ROOT, tests=os.path.join(ROOT, "tests"),
                        out=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path))
    assert p.returncode == WATCHDOG_EXIT_CODE == 113, p.stderr[-2000:]
    assert "survived" not in p.stdout
    bundles = os.listdir(tmp_path / "postmortem")
    assert len(bundles) == 1 and bundles[0].endswith("-watchdog")
    assert "stacks.txt" in os.listdir(tmp_path / "postmortem" / bundles[0])


def test_exception_dump_once_per_exception_and_capped(tmp_path):
    """Nested guarded calls (``train_steps`` by segments) write one bundle
    for an exception, and repeated failing calls stop at ``max_dumps``."""
    s = port_stoke([port.TelemetryConfig(output_dir=str(tmp_path),
                                         jsonl=False, prometheus=False),
                    port.HealthConfig(dump_signals=False, max_dumps=2)])

    def boom(*a, **k):
        raise RuntimeError("window failure")

    s._engine.window = boom
    b = _batches(4)
    xs, ys = np.stack([x for x, _ in b]), np.stack([y for _, y in b])
    with pytest.raises(RuntimeError, match="window failure"):
        s.train_steps(xs, ys, segment_size=2)
    assert len(s.health.recorder.dumps) == 1
    for _ in range(4):
        with pytest.raises(RuntimeError):
            s.train_steps(xs, ys, segment_size=2)
    assert len(s.health.recorder.dumps) == 2
    manifest = json.load(open(os.path.join(s.health.recorder.dumps[0],
                                           "manifest.json")))
    assert manifest["reason"] == "exception"
    assert "window failure" in manifest["extra"]["error"]
    s.close_telemetry()


def test_signal_handlers_and_watchdog_gone_after_close(tmp_path):
    """The recorder's SIGTERM/SIGUSR1 handlers and the watchdog thread
    leave with ``close_telemetry``."""
    import signal

    before = signal.getsignal(signal.SIGUSR1)
    s = port_stoke([port.TelemetryConfig(output_dir=str(tmp_path),
                                         jsonl=False, prometheus=False),
                    port.HealthConfig(watchdog=True)])
    assert signal.getsignal(signal.SIGUSR1) != before
    s.close_telemetry()
    assert signal.getsignal(signal.SIGUSR1) == before
    assert not s.health.watchdog._thread.is_alive()
    assert s.health not in list(collectors._watchers)


HEALTH_RULES = {
    "sentinels_need_telemetry": dict(health=dict()),
    "unknown_action": dict(health=dict(sentinels=False,
                                       loss_spike_action="explode")),
    "halt_under_fp16": dict(health=dict(sentinels=False,
                                        nonfinite_action="halt"),
                            precision="fp16"),
    "watchdog_timeout": dict(health=dict(sentinels=False, watchdog=True,
                                         watchdog_timeout_s=0.0)),
    "ring_size": dict(health=dict(sentinels=False, ring_size=0)),
}


@pytest.mark.parametrize("case", sorted(HEALTH_RULES))
def test_health_rule_messages_match_jax(case):
    import stoke_tpu.configs as jc
    from stoke_tpu.status import StokeStatus as JaxStatus
    from stoke_tpu.status import StokeValidationError as JaxError
    from stoke_tpu_torch.status import StokeStatus, StokeValidationError

    rule = dict(HEALTH_RULES[case])
    h = rule.pop("health")
    with pytest.raises(JaxError) as theirs:
        JaxStatus(batch_size_per_device=4,
                  configs=[jc.HealthConfig(**h)], **rule)
    with pytest.raises(StokeValidationError) as ours:
        StokeStatus(batch_size_per_device=4, device="cpu",
                    configs=[port.HealthConfig(**h)], **rule)
    assert str(ours.value) == str(theirs.value)
