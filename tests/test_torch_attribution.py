"""Port parity: step-time attribution and goodput (spec:
``tests/test_attribution.py``).

- The pure functions (``roofline_time_s``, ``roofline_summary``,
  ``classify_bound``, ``CostCard.from_cost``) equal the JAX package's on
  the same inputs (exact); so do the status messages.
- One card a (program, signature): counted at its first run, every later
  dispatch books it (the counters recombine exactly from the cards); the
  cards cover the four step paths; the FLOPs of a fused step's card equal
  ``estimate_step_flops`` and ``estimate_step_cost``'s (exact), and the
  estimate leaves the run bit for bit as it was.
- The FLOP and byte counts against the JAX package's on GPT-tiny (a
  documented divergence, ROADMAP Queue 3): the port counts the products
  only (``FlopCounterMode``), XLA every op, so the port's FLOPs are
  within [0.9, 1] of the JAX package's; the port's bytes are the
  dispatched ops' operands (views move nothing), the JAX package's on the
  CPU the lowered program's HLO, op by op, so the port's are lower.
- The JSONL records carry the attribution fields and every goodput
  bucket (none negative, productive time positive); without the config
  the fields ride null; on, nothing moves (bit for bit, the same
  dispatches).
- The auto-capture: bounded by ``max_captures``, a ``torch.profiler``
  trace in each directory, an ``attribution_capture`` anomaly with a
  ``HealthConfig``; the z-score trigger on synthetic windows as the JAX
  monitor's; bundles carry ``goodput.json`` and ``cost_cards.json``.
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax

import stoke_tpu
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.gpt import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.telemetry import attribution as ja
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.convert import gpt_state_dict_from_jax
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.telemetry import attribution as pa
from stoke_tpu_torch.telemetry.registry import MetricsRegistry

pytestmark = pytest.mark.torch_port

VOCAB, L, B = 97, 16, 4


def _gpt():
    m = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L, dropout_rate=0.0)
    m.init_weights(0)
    return m


def _stoke(tmp_path, attr=True, extra=(), model=None, **over):
    cfgs = [port.TelemetryConfig(output_dir=str(tmp_path),
                                 log_every_n_steps=1, prometheus=False,
                                 tensorboard=False)]
    if attr:
        cfgs.append(port.AttributionConfig(
            **{"peak_tflops": 989.0, "peak_hbm_gbps": 3350.0, **over}))
    return port.Stoke(model or _gpt(),
                      port.StokeOptimizer(torch.optim.AdamW, lr=1e-3),
                      causal_lm_loss, batch_size_per_device=B, device="cpu",
                      configs=cfgs + list(extra), verbose=False)


def _ids(seed=0, n=B):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, VOCAB, (n, L)).astype(np.int64))


def test_pure_functions_are_the_jax_ones():
    for args in ((2e12, None, 1.0), (1e9, 1e9, 1.0, 100.0),
                 (1e9, None, 0.0), (5e9, 2e9, 989.0, 3350.0)):
        assert pa.roofline_time_s(*args) == ja.roofline_time_s(*args)
    for args in ((1e12, 2.0, 1.0), (None, 1.0, 1.0), (1e12, 0.0, 1.0)):
        assert pa.roofline_summary(*args) == ja.roofline_summary(*args)
    for kw in (dict(compute_optimal_s=0.8, memory_optimal_s=0.2, comm_s=0.1,
                    host_s=0.05),
               dict(compute_optimal_s=0.2, memory_optimal_s=0.9, comm_s=0.1,
                    host_s=0.0),
               dict(compute_optimal_s=0.1, memory_optimal_s=0.1, comm_s=0.7,
                    host_s=0.0),
               dict(compute_optimal_s=0.9, memory_optimal_s=0.9, comm_s=0.9,
                    host_s=0.6),
               dict(compute_optimal_s=0.05, memory_optimal_s=0.02,
                    comm_s=0.0, host_s=0.1)):
        assert pa.classify_bound(wall_s=1.0, **kw) == ja.classify_bound(
            wall_s=1.0, **kw)
    assert pa.classify_bound(wall_s=0.0, compute_optimal_s=1.0,
                             memory_optimal_s=None, comm_s=None,
                             host_s=0.0) is None
    cost = {"flops": 3e9, "bytes accessed": 1e9}
    assert (pa.CostCard.from_cost(cost, "fused", 1, 989.0, 3350.0).to_dict()
            == ja.CostCard.from_cost(cost, "fused", 1, 989.0,
                                     3350.0).to_dict())
    assert pa.GOODPUT_BUCKETS == ja.GOODPUT_BUCKETS
    assert pa.BOUND_CLASSES == ja.BOUND_CLASSES


@pytest.mark.parametrize("over,extra", [
    (dict(peak_tflops=0.0), ()),
    (dict(auto_capture=True), ()),
    (dict(capture_action="explode"), ()),
    (dict(ema_alpha=0.0), ()),
])
def test_status_rules_keep_the_jax_messages(over, extra):
    msgs = []
    for pkg in (stoke_tpu, port):
        with pytest.raises(Exception) as e:
            pkg.status.StokeStatus(
                batch_size_per_device=8, device="cpu",
                configs=[pkg.AttributionConfig(**{"peak_tflops": 1.0,
                                                  **over}),
                         pkg.TelemetryConfig(jsonl=False, prometheus=False)])
        assert type(e.value).__name__ == "StokeValidationError"
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_cards_once_per_signature_and_recombine(tmp_path):
    s = _stoke(tmp_path)
    cards = s.attribution.cost_cards
    x = _ids()
    for _ in range(3):
        s.train_step(x, x)
    assert cards.cost_analysis_runs == 1
    s.train_step(_ids(1, 2 * B), _ids(1, 2 * B))  # another signature
    assert cards.cost_analysis_runs == 2
    s.backward(s.loss(s.model(x), x))
    s.step()
    xs = _ids(2, 2 * B).reshape(2, B, L)
    s.train_steps(xs, xs)
    s.train_steps(xs, xs)
    progs = sorted({c.program for c in cards.cards.values()})
    assert progs == ["accum", "apply", "fused", "window"]
    assert cards.cost_analysis_runs == 5
    reg = s.telemetry.registry
    by = dict(cards.cards)
    small = ("fused", (((B, L), "torch.int64"), ((B, L), "torch.int64")))
    n = {"accum": 1, "apply": 1, "window": 4}
    want = sum(c.flops * (3 if k == small else n.get(c.program, 1))
               for k, c in by.items())
    assert reg.get("attr/flops_total").value == want
    fused = by[small]
    accum = next(c for c in by.values() if c.program == "accum")
    assert fused.flops == accum.flops == s.estimate_step_flops(x, x) > 0
    assert fused.steps == 1 and accum.steps == 0
    s.close_telemetry()


def test_estimate_step_cost_is_the_cards_and_moves_nothing(tmp_path):
    s = _stoke(tmp_path)
    x = _ids()
    s.train_step(x, x)
    before = [p.detach().clone() for p in s.model_access.parameters()]
    state = {k: v.clone() for st in s.optimizer.state.values()
             for k, v in st.items()}
    card = s.estimate_step_cost(x, x)
    assert card.program == "fused" and card.steps == 1
    live = s.attribution.cost_cards.cards
    (fused,) = [c for c in live.values() if c.program == "fused"]
    assert card.flops == fused.flops
    assert card.optimal_time_s == pytest.approx(max(
        card.flops / 989e12, card.bytes_accessed / 3350e9))
    assert all(torch.equal(a, b) for a, b in zip(
        before, s.model_access.parameters()))
    assert {k: v for st in s.optimizer.state.values()
            for k, v in st.items()}.keys() == state.keys()
    # a fresh run without the estimate takes the same next step
    ref = _stoke(tmp_path / "ref", attr=False)
    ref.train_step(x, x)
    s.train_step(_ids(3), _ids(3))
    ref.train_step(_ids(3), _ids(3))
    assert all(torch.equal(a, b) for a, b in zip(
        ref.model_access.parameters(), s.model_access.parameters()))
    s.close_telemetry()
    ref.close_telemetry()


def test_counts_against_the_jax_cost_analysis():
    jmodel = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                    dropout_rate=0.0)
    ids = np.random.default_rng(0).integers(0, VOCAB, (B, L)).astype(
        np.int32)
    v = init_module(jmodel, jax.random.PRNGKey(0), ids[:1], train=False)
    js = stoke_tpu.Stoke(
        jmodel, stoke_tpu.StokeOptimizer(
            optimizer=optax.adamw,
            optimizer_kwargs=dict(learning_rate=1e-3)),
        jax_causal_lm_loss, jax.tree_util.tree_map(np.array, v),
        batch_size_per_device=B, device="cpu", verbose=False,
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False})
    jc = js.estimate_step_cost(ids, ids)
    m = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L, dropout_rate=0.0)
    m.load_state_dict(gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, v["params"])))
    ps = port.Stoke(m, port.StokeOptimizer(torch.optim.AdamW, lr=1e-3),
                    causal_lm_loss, batch_size_per_device=B, device="cpu",
                    verbose=False)
    t = torch.from_numpy(ids).long()
    pc = ps.estimate_step_cost(t, t)
    assert 0.9 * jc.flops <= pc.flops <= jc.flops
    assert 0 < pc.bytes_accessed < jc.bytes_accessed


def test_jsonl_fields_and_goodput_partition(tmp_path):
    s = _stoke(tmp_path)
    for i in range(4):
        s.train_step(_ids(i), _ids(i))
    s.close_telemetry()
    recs = [json.loads(l) for l in open(tmp_path / "steps.jsonl")]
    for r in recs[1:]:
        assert r["mfu"] > 0 and r["hbm_bw_util"] > 0
        assert r["achieved_tflops"] > 0 and r["bound"] in pa.BOUND_CLASSES
        assert all(r[f"goodput_{b}_s"] >= 0 for b in pa.GOODPUT_BUCKETS)
        assert r["goodput_productive_s"] > 0
    g = s.goodput
    assert g["windows"] == 4 and 0 < g["goodput_fraction"] <= 1
    assert set(s.wall_clock_breakdown) >= {
        f"goodput/{b}" for b in pa.GOODPUT_BUCKETS}
    plain = _stoke(tmp_path / "off", attr=False)
    plain.train_step(_ids(), _ids())
    plain.close_telemetry()
    rec = json.loads(open(tmp_path / "off" / "steps.jsonl").readline())
    assert rec["mfu"] is None and rec["goodput_productive_s"] is None
    assert plain.attribution is None and plain.goodput is None


def test_attribution_moves_nothing(tmp_path):
    runs = []
    for on in (False, True):
        s = _stoke(tmp_path / str(on), attr=on)
        for i in range(2):
            s.train_step(_ids(i), _ids(i))
        s.backward(s.loss(s.model(_ids(4)), _ids(4)))
        s.step()
        xs = _ids(5, 2 * B).reshape(2, B, L)
        s.train_steps(xs, xs)
        runs.append(([p.detach().clone() for p in
                      s.model_access.parameters()], s.dispatch_count))
        s.close_telemetry()
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert runs[0][1] == runs[1][1]


def test_auto_capture_bounded_and_a_health_anomaly(tmp_path):
    trace_dir = tmp_path / "traces"
    s = _stoke(tmp_path, auto_capture=True, capture_mfu_below=0.999,
               capture_step_zscore=0.0, capture_warmup_windows=1,
               capture_steps=1, max_captures=2,
               extra=(port.ProfilerConfig(trace_dir=str(trace_dir)),
                      port.HealthConfig(dump_signals=False,
                                        bundle_dir=str(tmp_path / "pm"))))
    assert any(isinstance(d, pa.AutoCaptureDetector)
               for d in s.health.detectors)
    for i in range(6):
        s.train_step(_ids(i), _ids(i))
    mon = s.attribution
    assert mon.captures == 2 and len(mon._capture_dirs) == 2
    for d in mon._capture_dirs:
        assert str(d).startswith(str(trace_dir))
        assert os.path.isfile(os.path.join(d, "stoke.rank0.pt.trace.json"))
    assert s.telemetry.registry.get("attr/captures_total").value == 2
    assert s.health.anomaly_counts_by_detector().get(
        "attribution_capture") == 2
    bundle = s.health.recorder.dump("probe")
    with open(os.path.join(bundle, "goodput.json")) as f:
        assert json.load(f)["captures"] == 2
    with open(os.path.join(bundle, "cost_cards.json")) as f:
        assert json.load(f)[0]["program"] == "fused"
    s.close_telemetry()


def test_step_time_zscore_trigger_is_the_jax_monitors(tmp_path):
    mons = []
    for pkg, mod, reg in ((stoke_tpu, ja, stoke_tpu.telemetry.MetricsRegistry),
                          (port, pa, MetricsRegistry)):
        cfg = pkg.AttributionConfig(
            peak_tflops=1.0, auto_capture=True, capture_mfu_below=0.0,
            capture_step_zscore=3.0, capture_warmup_windows=3,
            capture_steps=1, max_captures=1, ema_alpha=0.2)
        mon = mod.AttributionMonitor(cfg, reg(),
                                     trace_dir=str(tmp_path / pkg.__name__))
        fired = []
        for step in range(1, 12):
            wall = 1.0 if step == 11 else 0.1 + 0.001 * (step % 2)
            mon.window_stats(step=step, wall_s=wall, host_dispatch_s=0.0,
                             loader_wait_s=0.0, ckpt_io_s=0.0,
                             comm_bytes_onwire=None)
            fired.append(mon.captures)
        trig = mon.consume_trigger()
        mons.append((fired, trig["reason"], trig["step"]))
        mon.close()
    assert mons[0] == mons[1] and mons[0][0][-1] == 1
