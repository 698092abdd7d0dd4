"""Port parity: the serve SLO and cost observatories (specs:
``tests/test_serving_slo.py``, ``tests/test_serve_cost.py``).

- ``RequestSLO`` validation and resolution, and the status rules on the
  ``ServeConfig.slo_*`` defaults, raise the JAX package's messages
  (exact).
- ``SLOTracker``: the same fabricated request lifecycles give the JAX
  tracker's summary, attributions and headroom (exact; the goodput rates,
  which read the host clock, at a fixed ``now``).
- The engine: an invalid SLO is refused before enqueue; an engine with
  SLO-tagged requests counts the trace's requests; each finished
  request's latency buckets sum to its end-to-end time (rel 1e-9) and,
  with a trace recorder, are attributed with full span coverage; an
  SLO-free engine adds no ``serve/slo_*`` field.
- Cost cards: the ``serve/cost/*`` counters recombine exactly from the
  cards and the dispatch counts; decode classifies memory-bound at the
  H100 peaks; MFU and bandwidth utilization lie in (0, 1]; the SLO
  tracker gains its TFLOP-goodput column; the cost fields are the JAX
  engine's; without cost cards no ``serve/cost`` series exists; cost
  cards without an ``AttributionConfig`` raise the JAX engine's message.
- The observatories move nothing: greedy and speculative streams equal
  the plain engine's token for token.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from stoke_tpu.serving import roofline as jr
from stoke_tpu.serving import slo as js
from stoke_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
import stoke_tpu
import stoke_tpu_torch as port
from stoke_tpu_torch.configs import AttributionConfig, ServeConfig
from stoke_tpu_torch.models.gpt import GPT
from stoke_tpu_torch.serving import ServingEngine
from stoke_tpu_torch.serving import roofline as pr
from stoke_tpu_torch.serving import slo as ps
from stoke_tpu_torch.telemetry.registry import MetricsRegistry
from stoke_tpu_torch.telemetry.tracing import (
    TraceRecorder,
    register_recorder,
    unregister_recorder,
)

pytestmark = pytest.mark.torch_port

VOCAB = 97
SERVE = dict(max_seqs=3, kv_block_size=8, max_seq_len=64, max_new_tokens=5,
             prefill_pad_multiple=16)
PEAKS = AttributionConfig(peak_tflops=989.0, peak_hbm_gbps=3350.0)


@pytest.fixture(scope="module")
def model():
    m = GPT(vocab_size=VOCAB, size_name="tiny", max_len=64,
            dropout_rate=0.0)
    m.init_weights(0)
    return m


def _prompts(n=6, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=int(k)).astype(np.int32)
            for k in rng.integers(3, 30, size=n)]


def _engine(model, **kw):
    obs = {k: kw.pop(k) for k in ("attribution",) if k in kw}
    return ServingEngine(model, model.state_dict(),
                         ServeConfig(**{**SERVE, **kw}), device="cpu", **obs)


# --------------------------------------------------------------------------- #
# validation, resolution and the tracker against the JAX package's
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("bad", [dict(priority=""), dict(priority=3),
                                 dict(ttft_target_s=0.0),
                                 dict(ttft_target_s=-1.0),
                                 dict(tpot_target_s=0.0)])
def test_request_slo_validation_is_the_jax_one(bad):
    errs = []
    for mod in (js, ps):
        with pytest.raises((ValueError, TypeError)) as e:
            mod.validate_request_slo(mod.RequestSLO(**bad))
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


def test_resolution_is_the_jax_one():
    for mod in (js, ps):
        r = mod.resolve_request_slo(mod.RequestSLO(priority="p"), 0.5, 0.25)
        assert (r.ttft_target_s, r.tpot_target_s) == (0.5, 0.25)
        r = mod.resolve_request_slo(mod.RequestSLO(ttft_target_s=2.0), 0.5,
                                    0.25)
        assert (r.ttft_target_s, r.tpot_target_s) == (2.0, 0.25)
    msgs = []
    for mod in (js, ps):
        with pytest.raises(ValueError, match="no deadline") as e:
            mod.resolve_request_slo(mod.RequestSLO(), None, None)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("bad", [{"slo_ttft_target_s": 0.0},
                                 {"slo_tpot_target_s": -0.5}])
def test_status_rules_keep_the_jax_messages(bad):
    msgs = []
    for pkg in (stoke_tpu, port):
        cfg = pkg.configs.ServeConfig(max_seqs=2, kv_block_size=8,
                                      max_seq_len=64,
                                      prefill_pad_multiple=16, **bad)
        with pytest.raises(Exception) as e:
            pkg.status.StokeStatus(batch_size_per_device=1, device="cpu",
                                   configs=[cfg])
        assert type(e.value).__name__ == "StokeValidationError"
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _fake(mod, rid, priority, ttft, tpot, tokens=(1, 2, 3, 4), **ts):
    times = dict(arrival_ts=0.0, admit_ts=0.1, first_token_ts=0.3,
                 finish_ts=0.9)
    times.update(ts)
    req = SimpleNamespace(rid=rid, slo=mod.RequestSLO(
        priority=priority, ttft_target_s=ttft, tpot_target_s=tpot),
        tokens=list(tokens), **times)
    live = req.first_token_ts is None
    req.ttft_s = None if live else req.first_token_ts - req.arrival_ts
    req.tpot_s = (None if live or len(tokens) < 2 else
                  (req.finish_ts - req.first_token_ts) / (len(tokens) - 1))
    return req


def test_tracker_is_the_jax_one():
    out = []
    for mod, reg in ((js, JaxRegistry), (ps, MetricsRegistry)):
        t = mod.SLOTracker(reg())
        attrs = []
        for req in (_fake(mod, 0, "interactive", 0.5, 1.0),
                    _fake(mod, 1, "interactive", 0.1, 1.0),
                    _fake(mod, 2, "batch", 10.0, 10.0),
                    _fake(mod, 3, "batch", 1.0, 1e-9, tokens=(7,))):
            t.on_submit(req)
            t.on_admit(req)
            attrs.append(t.on_finish(req, spans=[], dropped=0))
        live = _fake(mod, 4, "batch", 1.0, None, arrival_ts=100.0,
                     first_token_ts=None)
        t.on_submit(live)
        t.set_flops_per_token(2e9)
        summary = t.summary()
        for key in ("goodput_tokens_per_s", "goodput_tflops_per_s",
                    "headroom_min_s"):
            summary.pop(key)
        out.append((summary, attrs, t.headroom_min_s(now=100.4),
                    t.goodput_tokens_per_s(now=t._t0 + 2.0),
                    t.goodput_tflops_per_s(now=t._t0 + 2.0)))
    assert out[0] == out[1]
    assert out[1][0]["by_class"]["interactive"]["violated"] == 1


# --------------------------------------------------------------------------- #
# the engine's SLO tracking
# --------------------------------------------------------------------------- #


def test_engine_tracks_the_trace(model):
    eng = _engine(model, slo_ttft_target_s=30.0, slo_tpot_target_s=10.0)
    with pytest.raises(ValueError):
        eng.submit(np.array([1, 2, 3], np.int32), 2,
                   slo=ps.RequestSLO(ttft_target_s=-1.0))
    assert not eng.scheduler.queue and eng.slo.active is False
    rec = TraceRecorder(ring_size=4096, output_dir="unused")
    register_recorder(rec)
    try:
        prompts = _prompts()
        rids = [eng.submit(p, slo=ps.RequestSLO(
            priority="interactive" if i % 2 else "batch"))
            for i, p in enumerate(prompts)]
        eng.run()
    finally:
        unregister_recorder(rec)
    s = eng.summary()["slo"]
    assert s["requests"] == s["finished"] == len(prompts)
    assert s["attained"] + s["violated"] == len(prompts)
    assert set(s["by_class"]) == {"interactive", "batch"}
    for rid in rids:
        a = eng.slo.attributions[rid]
        parts = a["queue_wait_s"] + a["prefill_blocked_s"] + a[
            "decode_contention_s"]
        req = eng.result(rid)
        assert parts == pytest.approx(req.finish_ts - req.arrival_ts,
                                      rel=1e-9)
        assert a["span_coverage"] == "full" and a["prefill_active_s"] > 0
    fields = eng.event_fields()
    assert fields["serve/slo_requests"] == len(prompts)
    plain = _engine(model)
    plain.generate(_prompts(2))
    assert not any(k.startswith("serve/slo") for k in plain.event_fields())


# --------------------------------------------------------------------------- #
# cost cards
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module", params=["decode", "verify"])
def cost_run(model, request):
    kw = {}
    if request.param == "verify":
        kw = dict(sampling=True, speculative_k=3, prefill_chunk_tokens=16)
    prompts = _prompts()
    plain = _engine(model, **kw).generate(prompts)
    eng = _engine(model, cost_cards=True, attribution=PEAKS,
                  slo_ttft_target_s=30.0, **kw)
    rids = [eng.submit(p, slo=ps.RequestSLO()) for p in prompts]
    eng.run()
    return request.param, eng, plain, [eng.result(r).tokens for r in rids]


def test_cost_counters_recombine_and_bound(cost_run):
    which, eng, plain, streams = cost_run
    assert streams == plain
    cost = eng._cost
    for counter, attr in (("serve/cost/flops_total", "flops"),
                          ("serve/cost/bytes_total", "bytes_accessed")):
        want = sum(getattr(cost.cache.cards[k], attr) * n
                   for k, n in cost.dispatch_counts.items())
        assert eng.metrics.registry.get(counter).value == want > 0
    assert cost.cards_total() == len(cost.cache.cards)
    program = "serve_verify" if which == "verify" else "serve_decode"
    assert program in cost.program_cards
    assert cost.decode_bound() == "memory"
    s = eng.summary()["cost"]
    assert 0 < s["mfu"] <= 1 and 0 < s["hbm_bw_util"] <= 1
    assert s["attainable_tpot_s"] > 0 and s["achieved_tpot_s"] > 0
    assert s["flops_per_token"] == pytest.approx(
        cost.flops_total() / eng.metrics.tokens_out.value)
    if which == "verify":
        assert s["verify_intensity"] > 0
        assert s["verify_intensity_uplift"] is None  # no lowered decode
    fields = eng.event_fields()
    assert set(jr.COST_FIELDS) == set(pr.COST_FIELDS) <= set(fields)
    assert fields["serve/slo_goodput_tflops_per_s"] is not None


def test_cost_cards_off_and_without_peaks(model):
    plain = _engine(model)
    plain.generate(_prompts(2))
    assert not any(n.startswith("serve/cost")
                   for n in plain.metrics.registry.names())
    assert plain.summary()["cost"] == {"active": False}
    with pytest.raises(ValueError, match="needs the hardware peaks") as e:
        _engine(model, cost_cards=True)
    assert "attribution=" in str(e.value)
