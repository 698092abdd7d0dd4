"""Port parity: the device-memory observatory (spec:
``tests/test_memory.py``).

On the CPU the port's ledger counts the run's tensors on the CPU, and
holds them to what the JAX package's analytic ledger gives for the same
model (exact):

- ``params``: the JAX ``tree_resident_bytes`` of the params tree;
- ``opt_state``: the JAX count of optax AdamW's state less its one int32
  step count, plus the port's step counts (``torch.optim.AdamW`` keeps a
  float32 one per parameter);
- ``snapshot``: the copy of the parameters the port's engine keeps
  between steps for the sentinels' update norm (the JAX package's step
  program holds it as an XLA temporary: its ``snapshot`` reads 0 there).

What the JAX package reports on the CPU and the port cannot:
``temp_peak_bytes`` (XLA's ``memory_analysis`` of each compiled program;
the port measures a program's first run with the CUDA allocator, so None
off the card), and so the pre-flight's temp term. Capacity and the
unattributed bytes are None on the CPU in both.

The components always sum to ``resident`` exactly, through all four step
paths; the pre-flight fires at a small ``capacity_bytes`` naming the
largest components; a serving engine ledgers its weights and KV pool and
forecasts the headroom as the JAX engine does; without a ``MemoryConfig``
no ``mem/`` key exists.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax

from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.telemetry import memory as jm
import stoke_tpu_torch as port
from stoke_tpu_torch.configs import MemoryConfig, ServeConfig
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.serving import ServingEngine
from stoke_tpu_torch.telemetry import memory as pm
from stoke_tpu_torch.telemetry.registry import MetricsRegistry

pytestmark = pytest.mark.torch_port

VOCAB, L, B = 97, 16, 4


def _gpt():
    m = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L, dropout_rate=0.0)
    m.init_weights(0)
    return m


def _stoke(tmp_path, memory=MemoryConfig(), health=True, accum=1):
    cfgs = [port.TelemetryConfig(output_dir=str(tmp_path),
                                 log_every_n_steps=1, prometheus=False,
                                 tensorboard=False)]
    if health:
        cfgs.append(port.HealthConfig(dump_signals=False))
    if memory is not None:
        cfgs.append(memory)
    return port.Stoke(_gpt(), port.StokeOptimizer(torch.optim.AdamW, lr=1e-3),
                      causal_lm_loss, batch_size_per_device=B,
                      grad_accum=accum, device="cpu", configs=cfgs,
                      verbose=False)


def _ids(seed=0, n=B):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, VOCAB, (n, L)).astype(np.int64))


def _jax_shapes():
    model = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=L)
    v = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), np.zeros((1, 8), np.int32), train=False))
    opt = jax.eval_shape(optax.adamw(1e-3).init, v["params"])
    return v, opt


def test_ledger_is_the_jax_count_and_recombines(tmp_path):
    variables, opt = _jax_shapes()
    s = _stoke(tmp_path, accum=2)
    n_params = len(list(s.model_access.parameters()))
    led = s.memory.ledger()
    assert led["params"] == jm.tree_resident_bytes(variables)
    assert led["opt_state"] == 0 and led["snapshot"] == 0
    assert led["kv_cache"] is None  # a train run has no KV pool
    assert s.memory.preflights["build"]["fired"] is False
    x = _ids()
    # the four calls: mid-window the accumulated gradients join params
    s.backward(s.loss(s.model(x), x))
    mid = s.memory.ledger()
    assert mid["params"] == 2 * led["params"]
    s.backward(s.loss(s.model(x), x))
    s.step()
    for call in ("four", "train_step", "window", "steps"):
        if call == "train_step":
            s.train_step(x, x)
            s.train_step(x, x)
        elif call == "window":
            s.train_step_window(x.reshape(2, B // 2, L),
                                x.reshape(2, B // 2, L))
        elif call == "steps":
            xs = _ids(1, 4 * B).reshape(4, B, L)
            s.train_steps(xs, xs)
        led = s.memory.ledger()
        assert led["resident"] == sum(
            v for k, v in led.items() if k != "resident" and v is not None)
        assert led["params"] == jm.tree_resident_bytes(variables)
        assert led["opt_state"] == (jm.tree_resident_bytes(opt) - 4
                                    + 4 * n_params)
        assert led["snapshot"] == led["params"]
        assert led["transport"] == 0
    summary = s.memory_summary
    # the JAX package has XLA's temp bytes here; the port measures a
    # program's first run on the card only
    assert summary["temp_peak_bytes"] is None and summary["programs"] == {}
    assert summary["capacity_bytes"] is None
    assert summary["unattributed_bytes"] is None
    assert list(summary["components"])[0] == "opt_state"
    s.close_telemetry()
    rec = [json.loads(l) for l in open(tmp_path / "steps.jsonl")][-1]
    assert [k for k in rec if k.startswith("mem/")] == sorted(pm.MEM_FIELDS)
    assert rec["mem/resident_bytes"] == led["resident"]


def test_fields_and_messages_are_the_jax_ones():
    assert pm.MEM_FIELDS == jm.MEM_FIELDS
    assert pm.LEDGER_COMPONENTS == jm.LEDGER_COMPONENTS
    with pytest.raises(ValueError) as pe:
        pm.MemoryObservatory(MemoryConfig(), MetricsRegistry()).set_component(
            "weights", lambda: 0)
    from stoke_tpu.configs import MemoryConfig as JaxMemoryConfig
    from stoke_tpu.telemetry.registry import MetricsRegistry as JaxRegistry

    with pytest.raises(ValueError) as je:
        jm.MemoryObservatory(JaxMemoryConfig(program_peaks=False),
                             JaxRegistry()).set_component(
            "weights", lambda: 0)
    assert str(pe.value) == str(je.value)


def test_preflight_fires_at_a_small_capacity(tmp_path):
    with pytest.warns(UserWarning, match="OOM pre-flight at build") as w:
        s = _stoke(tmp_path, memory=MemoryConfig(capacity_bytes=1000))
    msg = str(w[0].message)
    assert "params=" in msg and "remedy" in msg
    v = s.memory.preflights["build"]
    assert v["fired"] and v["capacity_bytes"] == 1000
    assert v["contributors"][0][0] == "params"
    s.close_telemetry()
    s = _stoke(tmp_path, memory=MemoryConfig(capacity_bytes=1000,
                                             preflight=False))
    assert s.memory.preflights["build"]["fired"] is False
    s.close_telemetry()


def test_serve_ledger_and_headroom():
    m = _gpt()
    cfg = ServeConfig(max_seqs=2, kv_block_size=8, max_seq_len=16,
                      max_new_tokens=4, prefill_pad_multiple=8)
    e = ServingEngine(m, m.state_dict(), cfg, device="cpu",
                      memory=MemoryConfig())
    led = e.summary()["memory"]["components"]
    assert led == {"params": sum(p.numel() * 4 for p in m.parameters()),
                   "kv_cache": e.cache.nbytes}
    assert e.summary()["memory"]["preflights"]["serve"]["fired"] is False
    rng = np.random.default_rng(0)
    for _ in range(5):
        e.submit(rng.integers(1, VOCAB, 6))
    e.step()
    alloc = e.allocator
    queued = sum(alloc.blocks_for(r.prompt.size + r.max_new_tokens)
                 for r in e.scheduler.queue)
    want = (alloc.free_blocks - queued) * (e.cache.nbytes / alloc.num_blocks)
    assert e.event_fields()["serve/mem_headroom_bytes"] == want < 0
    e.run()
    assert e.event_fields()["serve/mem_headroom_bytes"] > 0
    plain = ServingEngine(m, m.state_dict(), cfg, device="cpu")
    assert plain.summary()["memory"] == {"active": False}
    assert "serve/mem_headroom_bytes" not in plain.event_fields()


def test_default_off_has_no_memory_fields(tmp_path):
    s = _stoke(tmp_path, memory=None)
    s.train_step(_ids(), _ids())
    assert s.memory is None and s.memory_summary is None
    s.close_telemetry()
    rec = [json.loads(l) for l in open(tmp_path / "steps.jsonl")][-1]
    assert not any(k.startswith("mem/") for k in rec)
