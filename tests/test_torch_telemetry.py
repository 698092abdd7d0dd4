"""Port parity: the telemetry pipeline (ROADMAP item 10a).

The port's step events, Prometheus text and TensorBoard stream against the
JAX package's readers and renderers, and one two-layer MLP trained through
both facades with ``TelemetryConfig(log_every_n_steps=2)`` on the same
seeded numpy weights and batches: the same record steps and key sets, and
``step_loss``, ``ema_loss`` and ``grad_norm`` within rel 1e-5 (fp32). Then
the port's own contracts: rank gating, the loader's wait and starvation
counters, and default off (no config, or telemetry and tracing without
health) changing no device work: equal ``LAUNCHES`` and
``dispatch_count``, bit-equal losses and parameters.
"""

import math
import os

import numpy as np
import pytest
import torch
from torch import nn

import stoke_tpu_torch as port
from stoke_tpu_torch.ops.flash_attention import LAUNCHES
from stoke_tpu_torch.telemetry import (
    MetricsRegistry,
    Telemetry,
    TensorBoardSink,
    render_prometheus,
    validate_step_event,
)
from stoke_tpu_torch.telemetry.events import build_step_event

pytestmark = pytest.mark.torch_port

#: the tolerance of the losses and norms between the packages (fp32)
RTOL = 1e-5
IN, HID, OUT, BATCH = 8, 16, 4, 8


def _weights():
    r = np.random.default_rng(0)
    return {"Dense_0": {"kernel": r.normal(size=(IN, HID)).astype(np.float32)
                        * 0.3,
                        "bias": r.normal(size=HID).astype(np.float32) * 0.1},
            "Dense_1": {"kernel": r.normal(size=(HID, OUT)).astype(np.float32)
                        * 0.3,
                        "bias": r.normal(size=OUT).astype(np.float32) * 0.1}}


def _batches(n):
    r = np.random.default_rng(1)
    return [(r.normal(size=(BATCH, IN)).astype(np.float32),
             r.normal(size=(BATCH, OUT)).astype(np.float32))
            for _ in range(n)]


class MLP(nn.Module):
    """The JAX function ``relu(x @ Dense_0) @ Dense_1``, layers named as
    flax names them (so the JAX leaf paths are ``Dense_0/kernel`` ...)."""

    def __init__(self, w=None):
        super().__init__()
        self.Dense_0 = nn.Linear(IN, HID)
        self.Dense_1 = nn.Linear(HID, OUT)
        w = w or _weights()
        with torch.no_grad():
            for name in ("Dense_0", "Dense_1"):
                layer = getattr(self, name)
                layer.weight.copy_(torch.from_numpy(w[name]["kernel"].T))
                layer.bias.copy_(torch.from_numpy(w[name]["bias"]))

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


def _mse(o, y):
    return ((o - y) ** 2).mean()


def port_stoke(configs=(), **kw):
    return port.Stoke(MLP(), port.StokeOptimizer(torch.optim.SGD, lr=0.1),
                      _mse, batch_size_per_device=BATCH, device="cpu",
                      configs=list(configs), **kw)


def jax_stoke(configs, **kw):
    import jax.numpy as jnp
    import optax

    import stoke_tpu

    def model(p, x):
        h = jnp.maximum(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"], 0)
        return h @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]

    return stoke_tpu.Stoke(
        model=model,
        optimizer=stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd, optimizer_kwargs={"learning_rate": 0.1}),
        loss=lambda o, y: jnp.mean((o - y) ** 2), params=_weights(),
        batch_size_per_device=BATCH, configs=list(configs), verbose=False,
        **kw)


def four_calls(s, batches):
    for x, y in batches:
        s.backward(s.loss(s.model(x), y))
        s.step()


# --------------------------------------------------------------------------- #
# the wire formats against the JAX package
# --------------------------------------------------------------------------- #


def _event_kwargs(**over):
    kw = dict(ts=123.0, step=5, rank=0, window_steps=1, host_dispatch_s=0.5,
              loader_wait_s=0.1, samples_total=640.0, compiles_total=3,
              recompiles=0, compile_time_s=1.5, ema_loss=2.5,
              grad_norm=0.75, loss_scale=[1024.0, 512.0], param_norm=3.0,
              nonfinite_leaves=0.0, health_anomalies=1.0)
    kw.update(over)
    return kw


def test_step_events_cross_validate(tmp_path):
    """The port's validator accepts a JAX-built record (and refuses what
    the JAX one refuses), and the JAX ``read_step_events`` reads a
    ``steps.jsonl`` the port's hub wrote."""
    from stoke_tpu.telemetry import build_step_event as jax_build
    from stoke_tpu.telemetry import read_step_events as jax_read
    from stoke_tpu.telemetry import validate_step_event as jax_validate

    rec = jax_build(**_event_kwargs())
    validate_step_event(rec)
    assert build_step_event(**_event_kwargs()) == rec
    for bad in ({**rec, "extra": 1}, {**rec, "step": 1.5},
                {**rec, "schema": "other/v9"}):
        with pytest.raises(ValueError):
            jax_validate(bad)
        with pytest.raises(ValueError):
            validate_step_event(bad)
    t = Telemetry(port.TelemetryConfig(output_dir=str(tmp_path)), rank=0)
    t.add_samples(16)
    with t.phase("step"):
        pass
    t.record_step(1, ema_loss=1.5, step_loss=1.25, loss_scale=2.0 ** 15)
    t.record_step(2, window_steps=2, grad_norm=0.5)
    t.close()
    recs = jax_read(str(tmp_path / "steps.jsonl"))
    assert [r["step"] for r in recs] == [1, 2]
    assert recs[0]["samples_total"] == 16.0 and recs[0]["ema_loss"] == 1.5
    assert recs[1]["window_steps"] == 2 and recs[1]["grad_norm"] == 0.5
    assert (tmp_path / "metrics.prom").exists()


def _fill(reg):
    reg.counter("data/samples_total", help="samples").inc(640)
    reg.counter("trace/spans_total").inc(3)
    reg.gauge("hbm/bytes_in_use", help='a "quoted"\nhelp').set(1.5e9)
    reg.gauge("user/nan").set(float("nan"))
    reg.gauge("user/inf").set(float("-inf"))
    h = reg.histogram("device/step_s", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)


def test_prometheus_text_identical():
    """``render_prometheus`` of the same snapshot is the same text in
    both packages, with and without labels (escaping included); and the
    two registries snapshot the same instruments alike."""
    from stoke_tpu.telemetry import MetricsRegistry as JaxRegistry
    from stoke_tpu.telemetry import render_prometheus as jax_render

    ours, theirs = MetricsRegistry(), JaxRegistry()
    _fill(ours)
    _fill(theirs)
    snap = ours.snapshot()
    labels = {"rank": "0", "run": 'a"b\\c\nd', "host": "h"}
    for lab in (None, labels):
        assert render_prometheus(snap, lab) == jax_render(snap, lab)
        # (NaN gauges make the snapshots compare unequal as dicts)
        assert render_prometheus(snap, lab) == jax_render(
            theirs.snapshot(), lab)
    assert "stoke_data_samples_total" in render_prometheus(snap)


def test_tensorboard_sink_read_by_the_jax_frame_parser(tmp_path):
    from stoke_tpu.utils.tb_writer import read_scalar_events

    sink = TensorBoardSink(str(tmp_path))
    rec = build_step_event(**_event_kwargs(step=7, device_step_s=0.5,
                                           loss_scale=4096.0))
    sink.emit(rec, {})
    sink.close()
    events = read_scalar_events(sink.writer.path)
    assert ("telemetry/ema_loss", 2.5, 7) in events
    assert ("telemetry/device_step_s", 0.5, 7) in events
    assert ("telemetry/loss_scale", 4096.0, 7) in events
    assert "telemetry/step_loss" not in {t for t, _, _ in events}


# --------------------------------------------------------------------------- #
# one MLP through both facades
# --------------------------------------------------------------------------- #


def test_mlp_step_events_match_the_jax_facade(tmp_path):
    """Six four-call steps with ``TelemetryConfig(log_every_n_steps=2,
    grad_norm=True)``: records at steps 2, 4, 6 in both packages, the same
    keys, and ``step_loss``, ``ema_loss``, ``grad_norm`` within rel 1e-5;
    a ``train_steps`` segment then emits one record of window 2."""
    import stoke_tpu.configs as jc
    from stoke_tpu.telemetry import read_step_events as jax_read

    batches = _batches(8)
    runs = {}
    for name, make, cfg_mod in (("port", port_stoke, port),
                                ("jax", jax_stoke, jc)):
        out = str(tmp_path / name)
        s = make([cfg_mod.TelemetryConfig(output_dir=out,
                                          log_every_n_steps=2,
                                          grad_norm=True)])
        four_calls(s, batches[:6])
        xs = np.stack([b[0] for b in batches[6:]])
        ys = np.stack([b[1] for b in batches[6:]])
        s.train_steps(xs, ys)
        s.close_telemetry()
        runs[name] = jax_read(os.path.join(out, "steps.jsonl"))
    ours, theirs = runs["port"], runs["jax"]
    assert [r["step"] for r in ours] == [r["step"] for r in theirs] == [
        2, 4, 6, 8]
    assert [r["window_steps"] for r in ours] == [1, 1, 1, 2]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        assert a["samples_total"] == b["samples_total"]
        for key in ("step_loss", "ema_loss"):
            assert a[key] == pytest.approx(b[key], rel=RTOL), key
    for a, b in zip(ours[:3], theirs[:3]):
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=RTOL)
    # a window path samples no extra grad norm in either package
    assert ours[3]["grad_norm"] is None and theirs[3]["grad_norm"] is None


def test_rank_gating(tmp_path):
    """Ranks other than 0 attach no sinks by default, as in the JAX hub;
    ``jsonl_all_ranks`` / ``prometheus_all_ranks`` give each rank its own
    files."""
    from stoke_tpu.telemetry import Telemetry as JaxTelemetry
    import stoke_tpu.configs as jc

    for i, (kw, names) in enumerate((
            ({}, []),
            ({"jsonl_all_ranks": True}, ["steps.rank3.jsonl"]),
            ({"prometheus_all_ranks": True}, ["metrics.rank3.prom"]))):
        out = tmp_path / f"case{i}"
        t = Telemetry(port.TelemetryConfig(output_dir=str(out), **kw),
                      rank=3)
        j = JaxTelemetry(jc.TelemetryConfig(output_dir=str(out / "j"), **kw),
                         rank=3)
        assert len(t.sinks) == len(j.sinks) == len(names)
        t.record_step(1)
        t.close()
        j.close()
        made = os.listdir(out) if out.exists() else []
        assert sorted(p for p in made if p != "j") == names
    t = Telemetry(port.TelemetryConfig(output_dir=str(tmp_path / "r0"),
                                       tensorboard=True), rank=0)
    assert [type(k).__name__ for k in t.sinks] == [
        "JsonlSink", "PrometheusSink", "TensorBoardSink"]
    t.close()


def test_loader_wait_and_starvation(tmp_path):
    """``Stoke.DataLoader`` under a ``TelemetryConfig`` times every fetch
    into ``data/loader_wait_s``; the waits after the first ``prefetch``
    fetches also land in ``data/starvation_s`` (the JAX loader's rule), and
    ``data/tokens_total`` counts a ragged batch's real tokens."""
    s = port_stoke([port.TelemetryConfig(output_dir=str(tmp_path))])
    ds = port.ArrayDataset(np.ones((32, IN), np.float32),
                           np.zeros((32, OUT), np.float32))
    loader = s.DataLoader(ds, drop_last=True)
    assert len(list(loader)) == len(loader) == 4
    reg = s.telemetry.registry
    wait, starve = (reg.counter("data/loader_wait_s").value,
                    reg.counter("data/starvation_s").value)
    assert wait > 0 and 0 < starve <= wait
    # a slow loader: each of the two fetches after the warm-up sleeps
    slow = port.StokeDataLoader(_Slow(4, 0.05), batch_size=1, device="cpu",
                                prefetch=2, telemetry=s.telemetry)
    before = reg.counter("data/starvation_s").value
    assert len(list(slow)) == 4
    assert reg.counter("data/starvation_s").value - before >= 0.1
    seqs = port.RaggedSequenceDataset(
        [np.arange(1, n + 1, dtype=np.int32) for n in (3, 5, 2, 7)],
        np.zeros(4, np.int32))
    list(s.DataLoader(seqs))
    assert reg.counter("data/tokens_total").value == 17
    s.close_telemetry()
    # without telemetry the loader keeps no counters
    quiet = port_stoke()
    list(quiet.DataLoader(ds))
    assert quiet.telemetry.registry.get("data/loader_wait_s") is None


class _Slow(torch.utils.data.Dataset):
    """``n`` items; the item fetched third and later sleeps ``dt``."""

    def __init__(self, n, dt):
        self.n, self.dt = n, dt

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import time

        if i >= 2:
            time.sleep(self.dt)
        return torch.zeros(1)


# --------------------------------------------------------------------------- #
# default off changes nothing
# --------------------------------------------------------------------------- #


def _drive(s):
    """The four calls, ``train_step``, ``train_step_window`` and a
    ``train_steps`` segment of 2 at ``grad_accum=2``."""
    b = _batches(12)
    losses = []
    for x, y in b[:2]:
        losses.append(s.loss(s.model(x), y))
        s.backward()
        s.step()
    for x, y in b[2:4]:
        losses.append(s.train_step(x, y))
    xs, ys = (np.stack([x for x, _ in b[4:6]]),
              np.stack([y for _, y in b[4:6]]))
    losses.append(s.train_step_window(xs, ys))
    xs, ys = (np.stack([x for x, _ in b[6:10]]),
              np.stack([y for _, y in b[6:10]]))
    losses.append(s.train_steps(xs, ys))
    return [l.detach().clone() for l in losses]


@pytest.mark.parametrize("configs", ["telemetry_trace", "health"])
def test_default_off_is_inert(tmp_path, configs):
    """No config against ``TelemetryConfig`` + ``TraceConfig`` (the device
    work unchanged: equal launches and dispatches, bit-equal losses and
    parameters), and against ``HealthConfig`` sentinels (read-only: the
    parameters bit-equal, the dispatches equal). Without configs no sink,
    recorder, tracer or health monitor exists, and without sentinels no
    parameter snapshot."""
    cfgs = [port.TelemetryConfig(output_dir=str(tmp_path / "t"),
                                 log_every_n_steps=1, grad_norm=True)]
    if configs == "telemetry_trace":
        cfgs.append(port.TraceConfig(output_dir=str(tmp_path / "tr")))
    else:
        cfgs.append(port.HealthConfig(dump_signals=False, watchdog=True))
    clip = port.ClipGradNormConfig(max_norm=0.5)
    runs = []
    for c in ([], cfgs):
        LAUNCHES.clear()
        s = port_stoke(c, grad_accum=2, grad_clip=clip)
        losses = _drive(s)
        runs.append((s, losses, dict(LAUNCHES)))
    (off, l_off, n_off), (on, l_on, n_on) = runs
    assert off.telemetry.sinks == [] and off.tracer is None
    assert off.health is None and off._engine.sentinel_row is None
    assert not off._engine._snapshot
    assert n_off == n_on
    # 2 backward + 1 apply, 2 fused, 1 window, 2 replayed windows
    assert off.dispatch_count == on.dispatch_count == 8
    for a, b in zip(l_off, l_on):
        assert torch.equal(a, b)
    for (n, a), b in zip(off.model_access.named_parameters(),
                         on.model_access.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(off.optimizer.state.values(), on.optimizer.state.values()):
        for k in a:
            assert torch.equal(a[k], b[k])
    on.close_telemetry()
    assert os.path.getsize(tmp_path / "t" / "steps.jsonl") > 0
    if configs == "health":
        assert on.health.anomaly_count == 0
        assert math.isfinite(float(on._last_sentinels[1]))
    else:
        # the grad-norm probe reads the gradients and keeps no copy of
        # the parameters
        assert not on._engine._snapshot
