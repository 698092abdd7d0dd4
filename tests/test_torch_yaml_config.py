"""Port parity: a YAML document or dict -> ``Stoke``.

The documents of ``tests/test_yaml_config.py`` (loaded by path) give both
packages equal flag dicts and equal ``asdict_config``s; the ``optimizer``
section's optax constructor becomes the ``torch.optim`` optimizer that
follows optax's trajectory (losses within 1e-6 relative over 3 steps,
parameters within 1e-6 of the largest; optax's defaults included:
``adamw`` decays weights by 1e-4, not torch's 1e-2); the errors carry
the JAX messages; a class of a later slice raises ``NotImplementedError``
naming its ROADMAP item.
"""

import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import stoke_tpu.configs as jc
from stoke_tpu.utils import stoke_kwargs_from_config as jax_kwargs
from stoke_tpu_torch import configs as pc
from stoke_tpu_torch.convert import OPTAX_OPTIMIZERS
from stoke_tpu_torch.utils import stoke_from_config, stoke_kwargs_from_config

pytestmark = pytest.mark.torch_port

_SPEC = importlib.util.spec_from_file_location(
    "jax_yaml_spec", Path(__file__).with_name("test_yaml_config.py"))
JAX_SPEC = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(JAX_SPEC)

ROUND4_CFG = {
    "batch_size_per_device": 4,
    "device": "cpu",
    "precision": "fp16",
    "optimizer": {"name": "sgd", "learning_rate": 0.1},
    "configs": {
        "PrecisionConfig": {"num_losses": 2, "init_scale": 256.0},
        "CheckpointConfig": {"save_rank": 1},
    },
}
MIXED_CFG = {
    "batch_size_per_device": 8, "grad_accum": 3, "seed": 5,
    "ema_weight": 0.2, "verbose": False,
    "model_train_kwargs": {"train": True},
    "model_rng_keys": ["dropout", "layer_drop"],
    "grad_clip": {"type": "value", "clip_value": 0.5},
    "configs": {
        "MeshConfig": {"axes": ["data", "model"], "shape": [-1, 2]},
        "PartitionRulesConfig": {"rules": [["kernel", [None, "model"]]]},
        "DataParallelConfig": {"loss_reduction": "sum"},
        "TensorboardConfig": {"output_path": "runs", "log_every_n_steps": 5},
        "ResilienceConfig": {"preempt_signals": ["SIGTERM", "SIGUSR1"]},
    },
}
DOCUMENTS = {"full": JAX_SPEC.FULL_CFG, "round4": ROUND4_CFG,
             "mixed": MIXED_CFG}


def plain(v):
    """Enums by value; config objects by class name and fields."""
    if isinstance(v, (jc.ClipGradConfig, jc.ClipGradNormConfig,
                      pc.ClipGradConfig, pc.ClipGradNormConfig)):
        return (type(v).__name__, pc.asdict_config(v))
    if isinstance(v, list) and v and hasattr(v[0], "__dataclass_fields__"):
        return [(type(c).__name__, pc.asdict_config(c)) for c in v]
    return v


@pytest.mark.parametrize("doc", sorted(DOCUMENTS))
def test_documents_give_equal_kwargs(doc):
    cfg = DOCUMENTS[doc]
    theirs = jax_kwargs(copy.deepcopy(cfg))
    ours = stoke_kwargs_from_config(copy.deepcopy(cfg))
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        if key == "optimizer":
            continue
        assert plain(ours[key]) == plain(theirs[key]), key
    if "optimizer" in theirs:
        name = cfg["optimizer"]["name"]
        assert theirs["optimizer"]["optimizer"] is getattr(optax, name)
        assert ours["optimizer"]["optimizer"] in (
            torch.optim.AdamW, torch.optim.Adam, torch.optim.SGD)


def test_yaml_lists_become_tuples_and_enums():
    kw = stoke_kwargs_from_config(copy.deepcopy(MIXED_CFG))
    by_name = {type(c).__name__: c for c in kw["configs"]}
    assert by_name["MeshConfig"].axes == ("data", "model")
    assert by_name["MeshConfig"].shape == (-1, 2)
    assert by_name["PartitionRulesConfig"].rules == (
        ("kernel", [None, "model"]),)
    assert by_name["DataParallelConfig"].loss_reduction is \
        pc.LossReduction.sum
    kw = stoke_kwargs_from_config(copy.deepcopy(JAX_SPEC.FULL_CFG))
    ckpt = next(c for c in kw["configs"]
                if isinstance(c, pc.CheckpointConfig))
    assert ckpt.format is pc.CheckpointFormat.sharded


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 5)).astype(np.float32)
    y = rng.normal(size=(8, 3)).astype(np.float32)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    return x, y, w


def _optax_run(opt, steps=3):
    x, y, w = _data()
    params = {"w": jnp.asarray(w)}
    state = opt.init(params)
    loss = lambda p: jnp.mean((x @ p["w"] - y) ** 2)
    losses = []
    for _ in range(steps):
        l, g = jax.value_and_grad(loss)(params)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(l))
    return np.asarray(losses), np.asarray(params["w"])


def _port_run(spec, steps=3):
    x, y, w = _data()
    model = torch.nn.Linear(5, 3, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w.T))
    s = stoke_from_config(model, lambda o, t: ((o - t) ** 2).mean(), None,
                          {"batch_size_per_device": 8, "device": "cpu",
                           "optimizer": spec})
    losses = [float(s.train_step(x, y)) for _ in range(steps)]
    return np.asarray(losses), model.weight.detach().numpy().T


@pytest.mark.parametrize("spec", [
    {"name": "adamw", "learning_rate": 1e-3},
    {"name": "adamw", "learning_rate": 1e-2, "b1": 0.8, "weight_decay": 0.3},
    {"name": "adam", "learning_rate": 1e-3, "eps": 1e-6},
    {"name": "sgd", "learning_rate": 0.1, "momentum": 0.9},
    {"name": "sgd", "learning_rate": 0.1, "momentum": 0.9, "nesterov": True},
    {"name": "sgd", "learning_rate": 0.1},
], ids=lambda s: "-".join(f"{k}={v}" for k, v in s.items()))
def test_optimizer_follows_the_optax_trajectory(spec):
    kw = {k: v for k, v in spec.items() if k != "name"}
    want_losses, want_w = _optax_run(getattr(optax, spec["name"])(**kw))
    got_losses, got_w = _port_run(dict(spec))
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-6)
    # 1e-6 of the largest parameter (fp32 sums the update in another order)
    np.testing.assert_allclose(got_w, want_w, rtol=0,
                               atol=1e-6 * np.abs(want_w).max())


def test_torch_default_weight_decay_would_be_caught():
    """The same run with torch's AdamW default (1e-2) leaves the optax
    trajectory: the parameter check above would fail."""
    want_losses, want_w = _optax_run(optax.adamw(1e-3))
    _, got_w = _port_run({"name": "adamw", "learning_rate": 1e-3,
                          "weight_decay": 1e-2})
    assert np.abs(got_w - want_w).max() > 10 * 1e-6 * np.abs(want_w).max()


def test_yaml_file_round_trip(tmp_path):
    p = tmp_path / "run.yaml"
    p.write_text(yaml.safe_dump(JAX_SPEC.FULL_CFG))
    ours = stoke_kwargs_from_config(str(p))
    theirs = jax_kwargs(str(p))
    assert ours["batch_size_per_device"] == 4
    assert plain(ours["configs"]) == plain(theirs["configs"])
    p.write_text(yaml.safe_dump({**ROUND4_CFG, "precision": "bf16",
                                 "configs": {}}))
    s = stoke_from_config(torch.nn.Linear(4, 2), lambda o, y: o.sum(), None,
                          str(p))
    assert s.precision is pc.PrecisionOptions.bf16
    assert isinstance(s.optimizer, torch.optim.SGD)


@pytest.mark.parametrize("cfg,match", [
    ({"batch_size_per_device": 4, "batchsize": 8}, "unknown config keys"),
    ({"batch_size_per_device": 4, "configs": {"FooConfig": {}}},
     "unknown config class"),
    ({"batch_size_per_device": 4, "optimizer": {"name": "sgdd"}},
     "no optimizer named"),
    ({"batch_size_per_device": 4, "grad_clip": {"type": "l1"}},
     "unknown grad_clip type"),
])
def test_errors_carry_the_jax_messages(cfg, match):
    with pytest.raises(ValueError, match=match) as theirs:
        jax_kwargs(copy.deepcopy(cfg))
    with pytest.raises(ValueError, match=match) as ours:
        stoke_kwargs_from_config(copy.deepcopy(cfg))
    assert str(ours.value) == str(theirs.value)


def test_missing_optimizer_and_explicit_one():
    with pytest.raises(ValueError, match="no optimizer"):
        stoke_from_config(torch.nn.Linear(2, 2), lambda o, y: o.sum(), None,
                          {"batch_size_per_device": 4, "device": "cpu"})
    s = stoke_from_config(
        torch.nn.Linear(2, 2), lambda o, y: o.sum(), None,
        {"batch_size_per_device": 4, "device": "cpu",
         "optimizer": {"name": "sgd", "learning_rate": 1.0}},
        optimizer=pc.StokeOptimizer(torch.optim.Adam, lr=1e-3))
    assert isinstance(s.optimizer, torch.optim.Adam)


@pytest.mark.parametrize("name", ["lion", "rmsprop", "adafactor"])
def test_an_optax_optimizer_the_port_does_not_build(name):
    assert hasattr(optax, name) and name in OPTAX_OPTIMIZERS
    with pytest.raises(ValueError, match=r"supported: \['adam', 'adamw', "
                                         r"'sgd'\]"):
        stoke_kwargs_from_config({"batch_size_per_device": 4,
                                  "optimizer": {"name": name,
                                                "learning_rate": 1.0}})


def test_optax_names_are_optax_optimizers():
    for name in OPTAX_OPTIMIZERS:
        assert callable(getattr(optax, name)), name


@pytest.mark.parametrize("spec,match", [
    ({"name": "adamw"}, "needs learning_rate"),
    ({"name": "adamw", "learning_rate": 1.0, "momentum": 0.9},
     "takes no argument"),
    ({"name": "adam", "learning_rate": 1.0, "nesterov": True},
     "nesterov=True"),
    ({"name": "adamw", "learning_rate": 1.0, "eps_root": 1e-8},
     "eps_root"),
])
def test_optimizer_arguments_without_a_counterpart(spec, match):
    with pytest.raises(ValueError, match=match):
        stoke_kwargs_from_config({"batch_size_per_device": 4,
                                  "optimizer": spec})


@pytest.mark.parametrize("name,fields,item", [
    ("NumericsConfig", {}, "item 10c"),
    ("CompileConfig", {}, "item 11"),
    ("ActivationCheckpointingConfig", {}, "item 13"),
    ("OffloadOptimizerConfig", {}, "item 9"),
])
def test_a_refused_class_names_its_item(name, fields, item, tmp_path,
                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    configs = {name: fields}
    if item in ("item 10c", "item 11", "item 13"):
        # landed: the document builds the run and its status holds it
        if name == "NumericsConfig":
            configs["TelemetryConfig"] = {"jsonl": False,
                                          "prometheus": False}
        s = stoke_from_config(
            torch.nn.Linear(2, 2), lambda o, y: o.sum(), None,
            {"batch_size_per_device": 4, "device": "cpu",
             "optimizer": {"name": "sgd", "learning_rate": 1},
             "configs": configs})
        prop = {"NumericsConfig": "numerics_config",
                "CompileConfig": "compile_config",
                "ActivationCheckpointingConfig":
                    "activation_checkpointing_config"}[name]
        assert type(getattr(s.status, prop)).__name__ == name
        return
    if item == "item 9":
        # landed: the document builds the run (on the CPU the host tier
        # warns and keeps the state where it is)
        with pytest.warns(UserWarning, match="host offload unsupported"):
            s = stoke_from_config(
                torch.nn.Linear(2, 2), lambda o, y: o.sum(), None,
                {"batch_size_per_device": 4, "device": "cpu",
                 "optimizer": {"name": "sgd", "learning_rate": 1},
                 "configs": configs})
        assert type(s.status.offload_optimizer_config).__name__ == name
        return
    if name == "NumericsConfig":  # the observatories need a pipeline
        configs["TelemetryConfig"] = {"jsonl": False, "prometheus": False}
    with pytest.raises(NotImplementedError, match=f"{name} is not ported "
                                                  f"yet: ROADMAP Queue 1 "
                                                  f"{item} "):
        stoke_from_config(torch.nn.Linear(2, 2), lambda o, y: o.sum(), None,
                          {"batch_size_per_device": 4, "device": "cpu",
                           "optimizer": {"name": "sgd", "learning_rate": 1},
                           "configs": configs})


def test_a_health_document_builds(tmp_path, monkeypatch):
    """A document's ``TelemetryConfig``, ``TraceConfig``, ``HealthConfig``
    and ``ProfilerConfig`` sections build the run's pipeline, recorder
    and monitor (items 10a and 10b)."""
    monkeypatch.chdir(tmp_path)
    s = stoke_from_config(
        torch.nn.Linear(2, 2), lambda o, y: o.sum(), None,
        {"batch_size_per_device": 4, "device": "cpu",
         "optimizer": {"name": "sgd", "learning_rate": 1},
         "configs": {"TelemetryConfig": {"output_dir": "tel",
                                         "log_every_n_steps": 1},
                     "TraceConfig": {"output_dir": "trace"},
                     "HealthConfig": {"watchdog": True,
                                      "dump_signals": False},
                     "ProfilerConfig": {"trace_dir": "prof"}}})
    try:
        assert s.telemetry.enabled and s.tracer is not None
        assert s.health is not None and s.health.watchdog is not None
        assert s.profiler_config.trace_dir == "prof"
        s.train_step(torch.ones(4, 2), torch.ones(4, 2))
        assert s.optimizer_steps == 1
    finally:
        s.close_telemetry()
    assert (tmp_path / "tel" / "steps.jsonl").read_text().count("\n") == 1
    assert (tmp_path / "trace" / "trace.rank0.json").exists()


def test_model_rng_keys_are_recorded():
    s = stoke_from_config(torch.nn.Linear(2, 2), lambda o, y: o.sum(), None,
                          {"batch_size_per_device": 4, "device": "cpu",
                           "model_rng_keys": ["dropout", "layer_drop"],
                           "optimizer": {"name": "sgd", "learning_rate": 1}})
    assert s.model_rng_keys == ("dropout", "layer_drop")
    with pytest.raises(TypeError, match="model_rng_keys"):
        stoke_from_config(torch.nn.Linear(2, 2), lambda o, y: o.sum(), None,
                          {"batch_size_per_device": 4, "device": "cpu",
                           "model_rng_keys": "dropout",
                           "optimizer": {"name": "sgd", "learning_rate": 1}})
