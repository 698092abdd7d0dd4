"""Port parity: the per-layer numerics observatory (spec:
``tests/test_numerics.py``).

- The grouping is the JAX package's: GPT-tiny's, BERT-tiny's and a
  ResNet-18's groups (names, order, element counts) equal
  ``module_groups`` of the JAX params tree (exact).
- The matrix the engine computes in the apply equals the JAX
  ``compute_group_stats`` fed the same step (the pre-clip gradients, the
  parameters before and after, moved to the JAX layout): rtol 1e-5 on the
  sums, exact on the counts; its gradient sums recombine to the sentinel
  grad norm (rtol 1e-5); each window step yields its own row.
- The host functions (``unpack_group_stats``, ``provenance_of``,
  ``quant_error_by_group``, ``max_quant_error``, the event fields' keys
  and the status messages) equal the JAX package's on the same inputs
  (exact).
- A NaN planted in one parameter's gradient is named by group and step,
  through the health detector and into ``numerics.json``.
- The int8 serving weights' error by group is the JAX fold of the same
  per-leaf errors (exact); the transport's residual by group is the host
  sum of its leaves' slices (rtol 1e-5).
- Off, nothing moves: the same parameters bit for bit and the same
  dispatches with and without a ``NumericsConfig``; no ``numerics/`` key.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import stoke_tpu
from stoke_tpu.models.bert import BertForSequenceClassification as JaxBert
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.resnet import ResNet18 as JaxResNet18
from stoke_tpu.telemetry import numerics as jn
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.convert import gpt_state_dict_from_jax, jax_param_layout
from stoke_tpu_torch.models import BertForSequenceClassification
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.models.resnet import ResNet18
from stoke_tpu_torch.telemetry import numerics as pn
from stoke_tpu_torch.telemetry.health import SENTINEL_INDEX

pytestmark = pytest.mark.torch_port

VOCAB, L, B = 97, 16, 4
RTOL = 1e-5


def _gpt(seed=0):
    m = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L, dropout_rate=0.0)
    m.init_weights(seed)
    return m


def _stoke(tmp_path, model=None, numerics=True, health=True, lr=1e-2,
           clip=0.5, **kw):
    d = str(tmp_path)
    cfgs = [port.TelemetryConfig(output_dir=d, log_every_n_steps=1,
                                 prometheus=False, tensorboard=False)]
    if health:
        cfgs.append(port.HealthConfig(dump_signals=False,
                                      bundle_dir=os.path.join(d, "pm")))
    if numerics:
        cfgs.append(port.NumericsConfig())
    return port.Stoke(model if model is not None else _gpt(),
                      port.StokeOptimizer(torch.optim.SGD, lr=lr),
                      causal_lm_loss, batch_size_per_device=B, device="cpu",
                      configs=cfgs + kw.pop("extra_configs", []),
                      grad_clip=(port.ClipGradNormConfig(max_norm=clip)
                                 if clip else None),
                      verbose=False, **kw)


def _ids(seed=0, n=B):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, VOCAB, (n, L)).astype(np.int64))


def _jax_tree(model, tensors):
    """Port tensors by name as the JAX params tree (the JAX layout)."""
    tree = {}
    for name, (path, perm, shape) in jax_param_layout(model).items():
        t = tensors[name].detach()
        a = (t.permute(perm) if perm else t).reshape(shape).numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.astype(np.float32)
    return tree


# --------------------------------------------------------------------------- #
# the grouping
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("which", ["gpt", "bert", "resnet"])
def test_module_groups_are_the_jax_trees(which):
    if which == "gpt":
        jm = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                    tie_embeddings=False)
        shape = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), np.zeros((1, 8), np.int32),
            train=False))
        pm = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                 tie_embeddings=False)
    elif which == "bert":
        jm = JaxBert(vocab_size=VOCAB, size_name="tiny")
        shape = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), np.zeros((1, 8), np.int32),
            train=False))
        pm = BertForSequenceClassification(vocab_size=VOCAB,
                                           size_name="tiny")
    else:
        jm = JaxResNet18(num_classes=10, num_filters=8)
        shape = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3), np.float32),
            train=False))
        pm = ResNet18(num_classes=10, num_filters=8)
    want = jn.module_groups(shape["params"])
    got = pn.module_groups(pm)
    assert [(g.name, g.leaf_indices, g.leaf_elems) for g in got] == [
        (g.name, g.leaf_indices, g.leaf_elems) for g in want]
    params = [p for p in pm.parameters() if p.requires_grad]
    assert sorted(i for g in got for i in g.param_indices) == list(
        range(len(params)))


# --------------------------------------------------------------------------- #
# the matrix of the apply
# --------------------------------------------------------------------------- #


def test_group_stats_match_jax_and_recombine(tmp_path):
    m = _gpt()
    s = _stoke(tmp_path, m)
    x = _ids()
    for _ in range(2):
        s.train_step(x, x)
    old = {n: p.detach().clone() for n, p in m.named_parameters()}
    s.backward(s.loss(s.model(_ids(1)), _ids(1)))
    grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
    s.step()
    new = dict(m.named_parameters())
    want = np.asarray(jn.compute_group_stats(
        _jax_tree(m, grads), _jax_tree(m, new), _jax_tree(m, old)))
    got = s._engine.numerics_row.numpy()
    assert got.shape == want.shape == (len(s.numerics.groups), 5)
    np.testing.assert_allclose(got[:, [0, 1, 3, 4]], want[:, [0, 1, 3, 4]],
                               rtol=RTOL)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    # the rows recombine to the sentinel grad norm
    sent = float(s._last_sentinels[SENTINEL_INDEX["grad_norm"]])
    np.testing.assert_allclose(np.sqrt(got[:, 0].astype(np.float64).sum()),
                               sent, rtol=RTOL)
    assert sum(g.n_elems for g in s.numerics.groups) == sum(
        p.numel() for p in m.parameters())
    # a window of two steps yields two rows, the last the monitor's
    xs = _ids(2, 2 * B).reshape(2, B, L)
    s.train_steps(xs, xs)
    assert s.numerics.windows == 5 and s.numerics.last_step == 5
    s.close_telemetry()
    recs = [json.loads(l) for l in open(tmp_path / "steps.jsonl")]
    assert recs[-1]["numerics/groups"] == len(s.numerics.groups)
    assert set(recs[-1]["numerics/per_group"]) == {
        g.name for g in s.numerics.groups}


def test_host_functions_match_jax():
    rng = np.random.default_rng(3)
    tree = {"a": np.zeros((3,), np.float32), "b": np.zeros((2, 2),
                                                            np.float32)}
    jg = jn.module_groups(tree)
    pg = [pn.ModuleGroup(g.name, g.leaf_indices, g.leaf_elems) for g in jg]
    m = rng.uniform(0.5, 2.0, size=(2, 5)).astype(np.float32)
    m[:, 2] = 0
    assert pn.unpack_group_stats(m, pg) == jn.unpack_group_stats(m, jg)
    assert pn.provenance_of(m, pg) is None is jn.provenance_of(m, jg)
    for where in ((1, 2, 3.0), (0, 3, np.nan), (1, 4, np.inf)):
        bad = m.copy()
        bad[where[0], where[1]] = where[2]
        assert pn.provenance_of(bad, pg) == jn.provenance_of(bad, jg)
    errs = {"a/x": {"rel_rms": 0.1, "abs_err_max": 0.5},
            "b/y": {"rel_rms": 0.3, "abs_err_max": 0.2},
            "c": {"rel_rms": 0.2, "abs_err_max": 0.1}}
    paths = ["a/x", "b/y"]
    assert pn.quant_error_by_group(errs, pg, paths) == \
        jn.quant_error_by_group(errs, jg, paths)
    folded = pn.quant_error_by_group(errs, pg, paths)
    assert pn.max_quant_error(folded) == jn.max_quant_error(folded)
    assert pn.NUMERICS_STATS == jn.NUMERICS_STATS
    jmon = jn.NumericsMonitor(stoke_tpu.NumericsConfig(),
                              stoke_tpu.telemetry.MetricsRegistry(), jg)
    pmon = pn.NumericsMonitor(port.NumericsConfig(),
                              port.telemetry.MetricsRegistry(), pg)
    for mon in (jmon, pmon):
        mon.observe_window(7, m)
    assert pmon.event_fields() == jmon.event_fields()
    assert pmon.summary()["top_grad_noise"] == jmon.summary()[
        "top_grad_noise"]


@pytest.mark.parametrize("bad", [
    dict(provenance_action="explode"), dict(top_k=0),
    dict(grad_stats=False, wire_error=False),
])
def test_status_rules_keep_the_jax_messages(bad):
    msgs = []
    for pkg in (stoke_tpu, port):
        with pytest.raises(Exception) as e:
            pkg.status.StokeStatus(
                batch_size_per_device=8, device="cpu",
                configs=[pkg.NumericsConfig(**bad),
                         pkg.TelemetryConfig(jsonl=False, prometheus=False)])
        assert type(e.value).__name__ == "StokeValidationError"
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --------------------------------------------------------------------------- #
# provenance
# --------------------------------------------------------------------------- #


def test_nan_provenance_names_the_group_and_step(tmp_path):
    m = _gpt()
    s = _stoke(tmp_path, m, lr=0.0, clip=None)
    s.train_step(_ids(), _ids())
    poison = {"on": False}

    def hook(g):
        return g * float("nan") if poison["on"] else g

    m.layers[1].ff_out.weight.register_hook(hook)
    poison["on"] = True
    s.train_step(_ids(), _ids())
    prov = s.numerics.last_provenance
    names = [g.name for g in s.numerics.groups]
    assert prov["name"] == "layer_1" and prov["step"] == 2
    assert prov["group"] == names.index("layer_1") and prov["field"] == "grad"
    assert prov["nonfinite_elems"] == m.layers[1].ff_out.weight.numel()
    fired = [a for a in s.health.anomalies
             if a.detector == "numerics_provenance"]
    assert fired and fired[0].step == 2 and "layer_1" in fired[0].message
    bundle = s.health.recorder.dump("probe")
    with open(os.path.join(bundle, "numerics.json")) as f:
        assert json.load(f)["provenance"]["name"] == "layer_1"
    s.close_telemetry()


# --------------------------------------------------------------------------- #
# quantization error: serving weights and the wire
# --------------------------------------------------------------------------- #


def test_serving_quant_errors_by_group_are_the_jax_fold():
    from stoke_tpu_torch.configs import ServeConfig
    from stoke_tpu_torch.serving import ServingEngine

    jm = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=32,
                dropout_rate=0.0)
    v = init_module(jm, jax.random.PRNGKey(0), np.zeros((1, 8), np.int32),
                    train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    engine = ServingEngine(
        GPT(vocab_size=VOCAB, size_name="tiny", max_len=32),
        gpt_state_dict_from_jax(params),
        ServeConfig(max_seqs=2, kv_block_size=8, max_seq_len=32,
                    prefill_pad_multiple=16, quant="int8",
                    quant_min_size=64), device="cpu")
    want = jn.quant_error_by_group(engine.quant_errors,
                                   jn.module_groups(params),
                                   jn.leaf_path_names(params))
    assert engine.quant_errors_by_group == want and want
    assert (engine.quant_err_layer, engine.quant_err_max) == \
        jn.max_quant_error(want)


def test_wire_residual_by_group_is_the_leaves_slices(tmp_path):
    m = _gpt()
    s = _stoke(tmp_path, m, health=False, lr=1e-2, distributed="dp",
               extra_configs=[port.configs.CommConfig(dtype="int8",
                                              error_feedback=True,
                                              chunk_elems=64)])
    try:
        for i in range(2):
            s.train_step(_ids(i), _ids(i))
        eng = s._engine
        sizes = eng.comm_order.sizes(eng.params)
        got = pn.wire_residual_group_norms(eng.transport, eng.comm_state,
                                           s.numerics.groups, sizes)
        layout = eng.transport._layout(sizes)
        leaf_sq = {}
        for b, (idx, _, _) in enumerate(layout.buckets):
            off = 0
            for j in idx:
                r = eng.comm_state["residual"][b][off:off + sizes[j]]
                leaf_sq[j] = float(r.double().pow(2).sum())
                off += sizes[j]
        for g in s.numerics.groups:
            want = np.sqrt(sum(leaf_sq[j] for j in g.leaf_indices))
            np.testing.assert_allclose(got[g.name], want, rtol=RTOL)
        assert any(v > 0 for v in got.values())
        assert s.numerics.wire_err is not None  # sampled at the cadence
    finally:
        s.close_telemetry()


# --------------------------------------------------------------------------- #
# default off
# --------------------------------------------------------------------------- #


def test_numerics_moves_nothing(tmp_path):
    runs = []
    for on in (False, True):
        m = _gpt()
        s = _stoke(tmp_path / str(on), m, numerics=on)
        for i in range(2):
            s.train_step(_ids(i), _ids(i))
        xs = _ids(5, 2 * B).reshape(2, B, L)
        s.train_steps(xs, xs)
        s.close_telemetry()
        recs = [json.loads(l) for l in
                open(tmp_path / str(on) / "steps.jsonl")]
        runs.append(([p.detach().clone() for p in m.parameters()],
                     s.dispatch_count, recs))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert runs[0][1] == runs[1][1]
    assert not any(k.startswith("numerics/") for k in runs[0][2][-1])
    assert runs[1][2][-1]["numerics/groups"] == 5
