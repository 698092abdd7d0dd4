"""Port parity: structured tracing (ROADMAP item 10a).

The port's ``TraceRecorder`` against the JAX package's: ring bounds,
nesting and self time, ``summary()`` equal to the JAX summary for the same
intervals given to ``add()`` at fixed timestamps (exact), the Chrome /
Perfetto trace-event JSON, ``scripts/merge_rank_traces.py`` over two port
traces, the facade's spans and ``profile_trace``, and the request-id
correlation of a GPT-tiny ``ServingEngine`` on the CPU.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import stoke_tpu_torch as port
from stoke_tpu_torch.telemetry import MetricsRegistry
from stoke_tpu_torch.telemetry.tracing import (
    TRACE_EVENT_KEYS,
    TraceRecorder,
    dropped_total,
    register_recorder,
    request_spans,
    trace_span,
    tracing_active,
    unregister_recorder,
)

pytestmark = pytest.mark.torch_port

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")


@pytest.fixture
def recorder():
    rec = TraceRecorder(ring_size=4096)
    register_recorder(rec)
    yield rec
    unregister_recorder(rec)


def test_ring_bounds_nesting_and_self_time():
    registry = MetricsRegistry()
    rec = TraceRecorder(ring_size=16, registry=registry)
    for i in range(160):
        with rec.span(f"churn/{i % 4}"):
            pass
    assert len(rec) == 16 and rec.dropped == 144
    assert registry.get("trace/spans_total").value == 160
    assert registry.get("trace/dropped_total").value == 144
    rec = TraceRecorder(ring_size=64)
    with rec.span("outer"):
        with rec.span("mid"):
            with rec.span("inner"):
                pass
        with rec.span("mid2"):
            pass
    by = {s.name: s for s in rec.spans()}
    assert by["outer"].parent_id is None
    assert by["mid"].parent_id == by["outer"].span_id
    assert by["inner"].parent_id == by["mid"].span_id
    assert by["mid2"].parent_id == by["outer"].span_id
    assert [s.name for s in rec.spans()] == ["inner", "mid", "mid2", "outer"]
    for s in rec.spans():
        assert 0.0 <= s.self_s <= s.dur_s + 1e-12
    assert by["outer"].self_s <= by["outer"].dur_s - (
        by["mid"].dur_s + by["mid2"].dur_s) + 1e-9


def _intervals(rec):
    """The same fixed intervals into either package's recorder."""
    rec.set_step(3)
    rec.add("stoke/step", 0.0, 1.0, track="facade")
    rec.add("stoke/step", 0.25, 0.75, track="step")
    rec.add("stoke/dispatch", 1.0, 1.5, track="step")
    rec.add("stoke/io", 1.5, 1.625, track="data")
    rec.add("serve/decode_step", 2.0, 3.0, track="serve")
    for rid in range(4):
        rec.add("serve/decode", 2.0, 3.0, track="serve", request_id=rid,
                count_self=False)
    rec.add("serve/prefill", 3.0, 3.5, track="serve", request_id=1,
            step=9, attrs={"padded_len": 16})


def test_summary_equals_the_jax_summary():
    """``summary()`` over the same intervals is the JAX recorder's, key
    for key and value for value (exact: the intervals are dyadic)."""
    from stoke_tpu.telemetry import MetricsRegistry as JaxRegistry
    from stoke_tpu.telemetry.tracing import TraceRecorder as JaxRecorder

    ours = TraceRecorder(ring_size=8, registry=MetricsRegistry())
    theirs = JaxRecorder(ring_size=8, registry=JaxRegistry())
    _intervals(ours)
    _intervals(theirs)
    for top in (10, 2):
        assert ours.summary(top) == theirs.summary(top)
    assert ours.dropped == theirs.dropped == 2
    assert ours._registry.snapshot() == theirs._registry.snapshot()
    ev_ours, ev_theirs = ours.to_trace_events(), theirs.to_trace_events()
    strip = [{k: v for k, v in e.items() if k != "args"}
             for e in ev_ours]
    assert strip == [{k: v for k, v in e.items() if k != "args"}
                     for e in ev_theirs]


def test_trace_event_json_schema(tmp_path):
    rec = TraceRecorder(ring_size=64, rank=3, output_dir=str(tmp_path))
    rec.set_step(5)
    with rec.span("outer", track="step"):
        with rec.span("inner", track="step"):
            pass
    rec.add("req/decode", 1.0, 2.0, track="serve", request_id=11)
    path = rec.export()
    assert os.path.basename(path) == "trace.rank3.json"
    doc = json.load(open(path))
    assert doc["stoke"]["rank"] == 3 and doc["displayTimeUnit"] == "ms"
    durations = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert len(durations) == 3
    for e in durations:
        assert all(k in e for k in TRACE_EVENT_KEYS)
        assert e["pid"] == 3 and e["dur"] >= 0
    names = {e["tid"]: e["args"]["name"] for e in meta
             if e["name"] == "thread_name"}
    req = next(e for e in durations if e["args"].get("request_id") == 11)
    assert names[req["tid"]] == "serve/req11"
    inner = next(e for e in durations if e["name"] == "inner")
    outer = next(e for e in durations if e["name"] == "outer")
    assert inner["args"]["parent_id"] == outer["args"]["span_id"]
    assert outer["args"]["step"] == 5


def test_merge_rank_traces_merges_two_port_traces(tmp_path):
    """Two ranks' exported port traces (different clocks) merge into one
    timeline aligned on the first common optimizer step."""
    sys.path.insert(0, SCRIPTS)
    import merge_rank_traces as mrt

    for rank, offset in ((0, 0.0), (1, 5.0)):
        rec = TraceRecorder(ring_size=64, rank=rank,
                            output_dir=str(tmp_path))
        for step in (1, 2):
            rec.set_step(step)
            t = offset + step
            rec.add("stoke/step", t, t + 0.25 * (rank + 1), track="facade")
        rec.export()
    out = tmp_path / "merged.json"
    assert mrt.main([str(tmp_path), "--out", str(out)]) == 0
    at = {(e["pid"], e["args"]["step"]): e["ts"]
          for e in json.load(open(out))["traceEvents"] if e["ph"] == "X"}
    assert at[(0, 1)] == pytest.approx(at[(1, 1)])
    assert at[(0, 2)] == pytest.approx(at[(1, 2)])


def test_module_helpers_need_a_registered_recorder(recorder):
    assert tracing_active()
    with trace_span("a/b", track="t", request_id=4):
        pass
    assert [s.name for s in request_spans(4)] == ["a/b"]
    assert dropped_total() == 0
    unregister_recorder(recorder)
    assert not tracing_active() and request_spans(4) == []


def _mlp_stoke(tmp_path, configs):
    from torch import nn

    torch.manual_seed(0)
    return port.Stoke(nn.Linear(8, 4),
                      port.StokeOptimizer(torch.optim.SGD, lr=0.1),
                      lambda o, y: ((o - y) ** 2).mean(),
                      batch_size_per_device=4, device="cpu", grad_accum=2,
                      configs=configs)


def test_facade_spans_export_and_profile_trace(tmp_path):
    """Under a ``TraceConfig`` every step call leaves its facade phase and
    engine spans (``stoke/accum`` a four-call micro-step, ``stoke/step``
    its apply, ``stoke/dispatch`` each fused step or window), the loader
    and checkpoint ``stoke/io`` spans; ``close_telemetry`` exports them
    and unregisters the recorder. ``profile_trace`` writes a
    ``torch.profiler`` trace naming the facade's sections."""
    s = _mlp_stoke(tmp_path, [
        port.TraceConfig(output_dir=str(tmp_path / "trace")),
        port.ProfilerConfig(trace_dir=str(tmp_path / "prof"))])
    r = np.random.default_rng(0)
    x, y = (r.normal(size=(8, 4, 8)).astype(np.float32),
            r.normal(size=(8, 4, 4)).astype(np.float32))
    with s.profile_trace("mlp") as prof:
        for i in range(2):
            s.backward(s.loss(s.model(x[i]), y[i]))
            s.step()
        s.train_step(x[2], y[2])
        s.train_step(x[3], y[3])
    assert prof is not None
    s.train_steps(x[4:8], y[4:8])
    for _ in s.DataLoader(port.ArrayDataset(x[0], y[0])):
        pass
    s.save(str(tmp_path / "ckpt"))
    summary = s.trace_summary
    counts = {k: v["count"] for k, v in summary["by_name"].items()}
    assert counts["stoke/accum"] == 2
    assert counts["stoke/step [step]"] == 1
    assert counts["stoke/dispatch"] == 2 + 2
    assert counts["stoke/train_steps"] == 1 and counts["stoke/model"] == 2
    # one batch, then the fetch that ends the loader
    assert counts["stoke/io [data]"] == 2 and counts["stoke/io [io]"] == 1
    assert counts["stoke/ckpt_save"] == 1 and counts["stoke/save"] == 1
    assert s.wall_clock_breakdown["train_steps"] > 0
    s.close_telemetry()
    assert not tracing_active()
    doc = json.load(open(tmp_path / "trace" / "trace.rank0.json"))
    steps = {e["args"]["step"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {0, 1, 2, 4} <= steps
    prof_doc = open(tmp_path / "prof" / "mlp.rank0.pt.trace.json").read()
    assert "stoke/train_step" in prof_doc and "stoke/accum" in prof_doc
    # no TraceConfig: no tracer, a null profile_trace without a trace_dir
    plain = _mlp_stoke(tmp_path, [])
    assert plain.tracer is None and plain.trace_summary is None
    assert plain.export_trace() is None
    with plain.profile_trace() as nothing:
        assert nothing is None


def test_serve_request_id_correlation(recorder):
    """A GPT-tiny engine, three requests through two slots (one queues):
    every request's timeline has one admission, one prefill, a decode
    slice per decode step it rode and the eviction marker, in order; the
    batch decode spans carry no request id."""
    from stoke_tpu_torch.configs import ServeConfig
    from stoke_tpu_torch.models.gpt import GPT
    from stoke_tpu_torch.serving import ServingEngine

    model = GPT(size_name="tiny", vocab_size=211, max_len=128,
                dropout_rate=0.0, device="cpu")
    model.init_weights(0)
    eng = ServingEngine(model, model.state_dict(), ServeConfig(
        max_seqs=2, kv_block_size=8, max_seq_len=64, max_new_tokens=3,
        prefill_pad_multiple=16), device="cpu")
    r = np.random.default_rng(0)
    rids = [eng.submit(r.integers(1, 211, size=5).astype(np.int32))
            for _ in range(3)]
    eng.run()
    by_rid = {}
    for sp in recorder.spans():
        if sp.request_id is not None:
            by_rid.setdefault(sp.request_id, []).append(sp)
    assert set(by_rid) == set(rids)
    for rid in rids:
        names = [sp.name for sp in by_rid[rid]]
        assert names.count("serve/admission") == 1
        assert names.count("serve/prefill") == 1
        assert names.count("serve/decode") == 2
        assert names.count("serve/evict") == 1
        seq = [sp.name for sp in sorted(by_rid[rid],
                                        key=lambda sp: sp.t_start)]
        assert seq[0] == "serve/admission" and seq[1] == "serve/prefill"
    assert any(sp.name == "serve/decode_step" and sp.request_id is None
               for sp in recorder.spans())
