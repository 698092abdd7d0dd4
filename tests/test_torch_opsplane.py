"""Port parity: the live ops plane (``stoke_tpu_torch/telemetry/
opsplane.py``) and the attribution monitor's manual capture against
``stoke_tpu/telemetry/opsplane.py`` and ``tests/test_opsplane.py``.

Exact against the JAX package: the ``/statusz`` key set
(``STATUSZ_FIELDS``), the status rules' messages. Through the port: no
thread and no socket without an ``OpsPlaneConfig`` and the same step
events and dispatches with one; ``/metrics`` byte for byte the
``PrometheusSink``'s file; the ``/requests`` table; ``/healthz`` 200 then
503 after an injected-NaN halt; ``/trace``; the profile budget's 429 and
409; read-only (405); a ``/profile`` scraped from another thread during
training captures on that thread while the steps go on. All requests go
to an ephemeral port on the loopback address.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from stoke_tpu import StokeStatus as JaxStatus
from stoke_tpu import OpsPlaneConfig as JaxOpsPlaneConfig
from stoke_tpu import TelemetryConfig as JaxTelemetryConfig
from stoke_tpu.telemetry.opsplane import STATUSZ_FIELDS as JAX_STATUSZ
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch.configs import (
    AttributionConfig,
    HealthConfig,
    OpsPlaneConfig,
    ProfilerConfig,
    TelemetryConfig,
    TraceConfig,
)
from stoke_tpu_torch.serving.kv_cache import BlockAllocator
from stoke_tpu_torch.serving.scheduler import Scheduler
from stoke_tpu_torch.serving.slo import RequestSLO
from stoke_tpu_torch.status import StokeStatus, StokeValidationError
from stoke_tpu_torch.telemetry import HealthHaltError
from stoke_tpu_torch.telemetry.attribution import AttributionMonitor
from stoke_tpu_torch.telemetry.events import read_step_events
from stoke_tpu_torch.telemetry.opsplane import STATUSZ_FIELDS, OpsPlane
from stoke_tpu_torch.telemetry.registry import MetricsRegistry
from stoke_tpu_torch.telemetry.sinks import PrometheusSink

pytestmark = pytest.mark.torch_port

IN, OUT = 8, 4
HOSTILE = 'run "A"\\prod\nline2'


def _get(url, timeout=10.0, method="GET"):
    req = urllib.request.Request(url, method=method,
                                 data=b"{}" if method != "GET" else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get_json(url, timeout=10.0):
    status, body = _get(url, timeout=timeout)
    return status, json.loads(body)


def _threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("stoke-opsplane") and t.is_alive()]


def _make(tmp_path, tag, *, opsplane=True, health=False, trace=False,
          attribution=False):
    tdir = str(tmp_path / tag)
    cfgs = [TelemetryConfig(output_dir=tdir, log_every_n_steps=1,
                            prometheus=False, tensorboard=False,
                            sample_device_time=False, track_hbm=False)]
    if opsplane:
        cfgs.append(OpsPlaneConfig(port=0))
    if health:
        cfgs.append(HealthConfig(nonfinite_action="halt", dump_signals=False))
    if trace:
        cfgs.append(TraceConfig(output_dir=tdir, export_on_close=False))
    if attribution:
        cfgs += [AttributionConfig(peak_tflops=1.0, max_captures=1),
                 ProfilerConfig(trace_dir=os.path.join(tdir, "prof"))]
    model = nn.Linear(IN, OUT, bias=False)
    with torch.no_grad():
        model.weight.fill_(0.1)
    s = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.05),
              lambda o, y: ((o - y) ** 2).mean(), batch_size_per_device=4,
              device="cpu", configs=cfgs)
    return s, tdir


def _batch(seed=0):
    r = np.random.default_rng(seed)
    return (torch.from_numpy(r.normal(size=(32, IN)).astype(np.float32)),
            torch.zeros((32, OUT)))


INVALID = [
    [OpsPlaneConfig()],
    [TelemetryConfig(), OpsPlaneConfig(port=-1)],
    [TelemetryConfig(), OpsPlaneConfig(port=70000)],
    [TelemetryConfig(), OpsPlaneConfig(host="")],
    [TelemetryConfig(), OpsPlaneConfig(profile_max_seconds=0.0)],
    [TelemetryConfig(), OpsPlaneConfig(profile_default_seconds=0.0)],
    [TelemetryConfig(), OpsPlaneConfig(profile_default_seconds=5.0,
                                       profile_max_seconds=1.0)],
    [TelemetryConfig(), OpsPlaneConfig(requests_limit=0)],
]


def _to_jax(cfg):
    cls = (JaxOpsPlaneConfig if isinstance(cfg, OpsPlaneConfig)
           else JaxTelemetryConfig)
    return cls(**{k: v for k, v in vars(cfg).items()})


@pytest.mark.parametrize("i", range(len(INVALID)))
def test_status_rejects_invalid_with_the_jax_message(i):
    with pytest.raises(StokeValidationError) as port:
        StokeStatus(batch_size_per_device=4, device="cpu", configs=INVALID[i])
    with pytest.raises(Exception) as ref:
        JaxStatus(batch_size_per_device=4,
                  configs=[_to_jax(c) for c in INVALID[i]])
    assert str(port.value) == str(ref.value)


def test_status_accepts_valid():
    st = StokeStatus(batch_size_per_device=4, device="cpu",
                     configs=[TelemetryConfig(), OpsPlaneConfig()])
    assert st.opsplane_config.port == 9200


def test_statusz_keys_are_the_jax_packages():
    assert STATUSZ_FIELDS == JAX_STATUSZ
    plane = OpsPlane(OpsPlaneConfig(port=0), registry=MetricsRegistry())
    plane.start()
    try:
        status, st = _get_json(f"http://127.0.0.1:{plane.port}/statusz")
    finally:
        plane.close()
    assert status == 200 and tuple(st) == JAX_STATUSZ
    assert st["training"] is None and st["serving"] is None
    assert st["healthy"] is True and st["halted"] is None


def test_default_off_no_thread_and_on_the_same_steps(tmp_path):
    x, y = _batch()
    runs = {}
    for on in (False, True):
        s, tdir = _make(tmp_path, f"p{on}", opsplane=on)
        assert (s.opsplane is not None) is on
        assert len(_threads()) == int(on)
        losses = [float(s.train_step(x, y)) for _ in range(2)]
        port = s.opsplane.port if on else None
        s.close_telemetry()
        runs[on] = (losses, s.dispatch_count,
                    read_step_events(os.path.join(tdir, "steps.jsonl")))
    assert _threads() == []
    assert runs[True][:2] == runs[False][:2]
    for a, b in zip(runs[True][2], runs[False][2]):
        assert set(a) == set(b)
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2)


def test_metrics_byte_matches_the_sink(tmp_path):
    reg = MetricsRegistry()
    reg.counter("serve/tokens_out", help="tokens").inc(17)
    reg.gauge("serve/kv_occupancy").set(0.5)
    reg.histogram("serve/ttft_s", help="ttft").observe(0.01)
    labels = {"rank": "0", "run": HOSTILE, "host": "h", "process_index": "0"}
    path = str(tmp_path / "metrics.prom")
    PrometheusSink(path, labels)._emit({}, reg.snapshot())
    plane = OpsPlane(OpsPlaneConfig(port=0), registry=reg, labels=labels)
    plane.start()
    try:
        status, body = _get(f"http://127.0.0.1:{plane.port}/metrics")
    finally:
        plane.close()
    assert status == 200
    with open(path, "rb") as f:
        assert body == f.read()


def test_metrics_of_a_run_match_its_scrape_file(tmp_path):
    """A Stoke's /metrics and its PrometheusSink's file, one renderer and
    one label set (equal on the same snapshot)."""
    s = Stoke(nn.Linear(IN, OUT), StokeOptimizer(torch.optim.SGD, lr=0.05),
              lambda o, y: ((o - y) ** 2).mean(), batch_size_per_device=4,
              device="cpu",
              configs=[TelemetryConfig(output_dir=str(tmp_path),
                                       tensorboard=False,
                                       sample_device_time=False),
                       OpsPlaneConfig(port=0)])
    s.train_step(*_batch())
    try:
        sink = next(k for k in s.telemetry.sinks
                    if isinstance(k, PrometheusSink))
        assert s.opsplane.scrape_labels() == sink.labels
        reg = s.telemetry.registry
        sink._emit({}, reg.snapshot())
        with open(sink.path, "rb") as f:
            want = f.read()
        assert s.opsplane.render_metrics().encode() == want
        status, body = _get(f"http://127.0.0.1:{s.opsplane.port}/metrics")
        assert status == 200 and b"stoke_" in body
    finally:
        s.close_telemetry()


def _scheduler(queue_n):
    sched = Scheduler(2, BlockAllocator(16, 8), 4, max_seq_len=64,
                      default_max_new_tokens=8)
    for _ in range(queue_n):
        sched.submit(np.arange(4) + 1,
                     slo=RequestSLO(priority="interactive",
                                    ttft_target_s=30.0))
    return sched


def test_requests_table_states_and_truncation():
    sched = _scheduler(2)
    req = sched.queue.popleft()
    req.tokens.extend([5, 6, 7])
    sched.slots[0].request = req
    sched.slots[0].blocks = [1, 2]
    sched.slots[0].prefill_pos = None
    engine = SimpleNamespace(scheduler=sched,
                             metrics=SimpleNamespace(registry=MetricsRegistry()),
                             summary=lambda: {"requests": 2})
    plane = OpsPlane(OpsPlaneConfig(port=0), registry=MetricsRegistry())
    plane.attach_engine(engine)
    plane.start()
    try:
        status, table = _get_json(f"http://127.0.0.1:{plane.port}/requests")
        _, st = _get_json(f"http://127.0.0.1:{plane.port}/statusz")
    finally:
        plane.close()
    assert status == 200 and table["truncated"] is False
    states = sorted(r["state"] for r in table["requests"])
    assert states == ["decoding", "queued"]
    for r in table["requests"]:
        assert r["priority"] == "interactive"
        assert 0 < r["slo_headroom_s"] <= 30.0
        assert r["tokens_out"] == (3 if r["state"] == "decoding" else 0)
        assert r["kv_blocks"] == (2 if r["state"] == "decoding" else 0)
    assert st["serving"] == {"requests": 2}
    plane = OpsPlane(OpsPlaneConfig(port=0, requests_limit=3),
                     registry=MetricsRegistry())
    plane.attach_engine(SimpleNamespace(scheduler=_scheduler(5),
                                        summary=lambda: {}))
    plane.start()
    try:
        _, table = _get_json(f"http://127.0.0.1:{plane.port}/requests")
    finally:
        plane.close()
    assert table["truncated"] is True and len(table["requests"]) == 3


def test_rank_offsets_the_port():
    cfg = OpsPlaneConfig(port=9321)
    assert OpsPlane(cfg, rank=0).port == 9321
    assert OpsPlane(cfg, rank=3).port == 9324
    assert OpsPlane(OpsPlaneConfig(port=0), rank=3).port == 0


def test_profile_budget_409_429_and_clamp(tmp_path):
    """A standalone monitor captures on the caller's thread: the first
    capture runs (clamped to the ceiling), a second while it is in flight
    gets 409, one past the budget 429, a bad duration 400; without an
    attribution monitor /profile is 404."""
    mon = AttributionMonitor(AttributionConfig(peak_tflops=1.0,
                                               max_captures=1),
                             MetricsRegistry(),
                             trace_dir=str(tmp_path / "prof"))
    plane = OpsPlane(OpsPlaneConfig(port=0, profile_max_seconds=0.5),
                     registry=MetricsRegistry())
    plane.attach_attribution(mon)
    plane.start()
    base = f"http://127.0.0.1:{plane.port}"
    try:
        first = {}
        t = threading.Thread(target=lambda: first.update(
            zip(("status", "body"), _get_json(f"{base}/profile?seconds=60"))))
        t.start()
        while not mon._capturing and t.is_alive():
            pass
        status, body = _get_json(f"{base}/profile?seconds=0.05")
        t.join(30)
        assert status == 409 and "in flight" in body["error"]
        assert first["status"] == 200 and first["body"]["ok"] is True
        assert first["body"]["seconds"] == pytest.approx(0.5)
        assert os.path.isdir(first["body"]["trace_dir"])
        status, body = _get_json(f"{base}/profile?seconds=0.05")
        assert status == 429 and "budget" in body["error"]
        assert mon.captures == 1
        assert _get_json(f"{base}/profile?seconds=banana")[0] == 400
        assert _get_json(f"{base}/profile?seconds=-1")[0] == 400
    finally:
        plane.close()
        mon.close()
    bare = OpsPlane(OpsPlaneConfig(port=0), registry=MetricsRegistry())
    bare.start()
    try:
        status, body = _get_json(f"http://127.0.0.1:{bare.port}/profile")
    finally:
        bare.close()
    assert status == 404 and body["ok"] is False


def test_plane_is_read_only():
    plane = OpsPlane(OpsPlaneConfig(port=0), registry=MetricsRegistry())
    plane.start()
    try:
        codes = {m: _get(f"http://127.0.0.1:{plane.port}/statusz",
                         method=m)[0]
                 for m in ("POST", "PUT", "DELETE", "PATCH")}
    finally:
        plane.close()
    assert set(codes.values()) == {405}


def test_facade_healthz_flip_and_trace(tmp_path):
    s, _ = _make(tmp_path, "flip", health=True, trace=True)
    base = f"http://127.0.0.1:{s.opsplane.port}"
    x, y = _batch()
    s.train_step(x, y)
    status, body = _get_json(f"{base}/healthz")
    assert status == 200 and body["ok"] is True
    status, events = _get_json(f"{base}/trace")
    assert status == 200 and {e["ph"] for e in events} >= {"M", "X"}
    xn = x.clone()
    xn[:, 3] = float("nan")
    with pytest.raises(HealthHaltError):
        s.train_step(xn, y)
    status, body = _get_json(f"{base}/healthz")
    assert status == 503
    assert body["halted"] == "nonfinite_grads" and body["anomalies"] >= 1
    status, st = _get_json(f"{base}/statusz")
    assert st["healthy"] is False and st["halted"] == "nonfinite_grads"
    assert st["training"]["trace"]["spans"] >= 1
    port = s.opsplane.port
    s.close_telemetry()
    assert not s.opsplane.running
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2)


def test_profile_during_training_runs_on_the_request_thread(tmp_path):
    """Under a training Stoke a /profile scraped from another thread runs
    its capture there, as the JAX plane does: the training loop goes on
    stepping while it runs, the answer comes after the requested seconds,
    and the trace is written (on the card it holds the training thread's
    kernels: ``chip_smoke.py``'s fleet_ops; on the CPU only the request
    thread's operators)."""
    s, _ = _make(tmp_path, "prof", attribution=True)
    base = f"http://127.0.0.1:{s.opsplane.port}"
    got = {}
    t = threading.Thread(target=lambda: got.update(
        zip(("status", "body"), _get_json(f"{base}/profile?seconds=0.2",
                                          timeout=60))))
    t.start()
    while not s.attribution._capturing and t.is_alive():
        pass
    x, y = _batch()
    steps, t0 = 0, time.monotonic()
    while t.is_alive() and steps < 2000:
        s.train_step(x, y)
        steps += 1
    t.join(30)
    waited = time.monotonic() - t0
    s.close_telemetry()
    assert got["status"] == 200 and got["body"]["ok"] is True
    assert steps >= 1 and waited < 30
    assert s.attribution.captures == 1 and not s.attribution._capturing
    path = os.path.join(got["body"]["trace_dir"], "stoke.rank0.pt.trace.json")
    with open(path) as f:
        assert "traceEvents" in json.load(f)
