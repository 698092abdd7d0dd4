"""The port's static analysis (``stoke_tpu_torch/analysis/``) against the
JAX package's (``stoke_tpu/analysis/``): the invariant linter over the
port's tree and over the synthetic trees of ``tests/test_analysis.py``
(the same rule ids as the JAX rules), the wire manifest, the program
auditor's rules on synthetic programs, ``Stoke.audit()`` on GPT-tiny after
every step API and ``serve()``, and the CLI.

The rules that need a model or expert group larger than 1
(``audit-replicated-bytes``, ``audit-comm-bytes`` on real traces) run in
the gloo world of ``tests/test_torch_second_axis.py``."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import stoke_tpu.analysis.invariants as jinv
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch.analysis import invariants as pinv
from stoke_tpu_torch.analysis.program import (
    AUDIT_RULES,
    ProgramFacts,
    ProgramSpec,
    StateEntry,
    TraceRecorder,
    audit_program_specs,
    cost_signature,
)
from stoke_tpu_torch.configs import ServeConfig
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.ops.flash_attention import LAUNCHES, make_flash_attention

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# the linter over the port's tree
# --------------------------------------------------------------------------- #


def test_port_tree_lints_clean():
    fs = pinv.run_invariant_lints(REPO)
    assert fs == [], "\n".join(f.format() for f in fs)


@pytest.mark.parametrize("rule", ["wire", "config", "jsonl", "banned"])
def test_each_rule_family_is_clean_on_the_port(rule):
    check = {"wire": pinv.check_wire_formats,
             "config": pinv.check_config_coverage,
             "jsonl": pinv.check_jsonl_schema,
             "banned": pinv.check_banned_apis}[rule]
    assert check(REPO) == []


def test_wire_manifest_is_the_jax_manifests():
    """Every packed layout the port pins is the JAX package's list, in its
    order (the sentinel row, the fleet signals, the numerics statistics
    among them)."""
    ours = {e["name"]: e for e in pinv.load_wire_manifest(REPO)}
    theirs = {e["name"]: e for e in jinv.load_wire_manifest(REPO)}
    for name in ("SENTINEL_FIELDS", "FLEET_SIGNALS", "NUMERICS_STATS"):
        assert ours[name]["fields"] == theirs[name]["fields"], name
    assert set(ours) == set(theirs)
    for name, e in ours.items():
        assert e["fields"] == theirs[name]["fields"], name
        assert e["file"] == theirs[name]["file"].replace(
            "stoke_tpu/", "stoke_tpu_torch/", 1)


def test_waivers_name_only_port_fields():
    waivers = pinv.load_config_waivers(REPO)
    assert waivers and all(r.strip() for r in waivers.values())
    assert "CompileConfig.serialize_executables" in waivers


def test_host_fetch_waivers_are_the_stated_readbacks():
    """The serving engine's token readbacks are the stated exception; the
    training engine has none in its step paths."""
    w = pinv.load_host_fetch_waivers(REPO)
    serve = "stoke_tpu_torch/serving/engine.py::"
    for fn in ("_decode", "_decode_sampling", "_packed_chunk", "_verify"):
        assert serve + fn in w
    assert [k for k in w if k.startswith("stoke_tpu_torch/engine.py")] == \
        ["stoke_tpu_torch/engine.py::resident_state"]


# --------------------------------------------------------------------------- #
# the synthetic trees of tests/test_analysis.py: the same rule ids
# --------------------------------------------------------------------------- #

_CONFIGS = textwrap.dedent("""
    from dataclasses import dataclass

    @dataclass
    class FooConfig:
        guarded_knob: int = 1
        unguarded_knob: int = 2
        waived_knob: bool = True
""")
_STATUS = textwrap.dedent("""
    def _foo_invalid(cfg):
        if cfg.guarded_knob < 1:
            return "FooConfig.guarded_knob must be >= 1"
        return False
""")
_EVENTS = textwrap.dedent("""
    STEP_EVENT_FIELDS = {
        "step": (True, "int"),
        "serve/known": (False, "nullable_number"),
        "serve/required_oops": (True, "number"),
    }
""")


def _wire(tmp, body):
    (tmp / "mod.py").write_text(body)
    return lambda m: m.check_wire_formats(
        str(tmp), [{"file": "mod.py", "name": "FMT",
                    "fields": ["a", "b", "c"]}])


def _coverage(tmp, waivers, configs=_CONFIGS, status=_STATUS):
    (tmp / "configs.py").write_text(configs)
    (tmp / "status.py").write_text(status)
    return lambda m: m.check_config_coverage(
        str(tmp), configs_path=str(tmp / "configs.py"),
        status_path=str(tmp / "status.py"), waivers=waivers)


def _jsonl(tmp, body):
    (tmp / "events.py").write_text(_EVENTS)
    (tmp / "emit.py").write_text(body)
    return lambda m: m.check_jsonl_schema(
        str(tmp), emitters=["emit.py"], schema_path=str(tmp / "events.py"))


def _banned(tmp, name, body, **lists):
    (tmp / name).write_text(body)
    return lambda m: m.check_banned_apis(str(tmp), **lists)


TREES = {
    "wire_reorder": lambda t: _wire(t, 'FMT = ("a", "c", "b")\n'),
    "wire_removal": lambda t: _wire(t, 'FMT = ("a", "b")\n'),
    "wire_append_unpinned": lambda t: _wire(t, 'FMT = ("a", "b", "c", "d")\n'),
    "wire_append_pinned": lambda t: _wire(t, 'FMT = ("a", "b", "c")\n'),
    "wire_missing": lambda t: _wire(t, "OTHER = 1\n"),
    "config_unguarded": lambda t: _coverage(
        t, {"FooConfig.waived_knob": "boolean"}),
    "config_waived": lambda t: _coverage(
        t, {"FooConfig.waived_knob": "boolean",
            "FooConfig.unguarded_knob": "any int is legal"}),
    "config_unknown_waiver": lambda t: _coverage(
        t, {"FooConfig.waived_knob": "boolean",
            "FooConfig.unguarded_knob": "x", "FooConfig.bogus": "stale"}),
    "config_common_method": lambda t: _coverage(
        t, {}, textwrap.dedent("""
            from dataclasses import dataclass

            @dataclass
            class BarConfig:
                join: str = ""
                get: int = 0
        """), "import os\nx = os.path.join('a', 'b')\ny = {}.get('k')\n"),
    "config_no_reason": lambda t: _coverage(
        t, {"FooConfig.waived_knob": "",
            "FooConfig.unguarded_knob": "any int is legal"}),
    "jsonl_unknown": lambda t: _jsonl(
        t, "class M:\n    def event_fields(self):\n"
           '        return {"serve/known": 1, "serve/bogus": 2}\n'),
    "jsonl_required": lambda t: _jsonl(
        t, "class M:\n    def event_fields(self):\n        out = {}\n"
           '        out["serve/required_oops"] = 1\n        return out\n'),
    "jsonl_non_emitter": lambda t: _jsonl(
        t, 'def helper():\n    return {"serve/bogus": 1}\n'),
    "banned_jax_import": lambda t: _banned(
        t, "driver.py", "import os\ntry:\n    import jax\n"
                        "except ImportError:\n    jax = None\n",
        jax_free=["driver.py"], no_device_get=[]),
    "banned_function_local_ok": lambda t: _banned(
        t, "driver.py", "def go():\n    import jax\n"
                        "    from jax import numpy\n    return jax, numpy\n",
        jax_free=["driver.py"], no_device_get=[]),
    "banned_device_get": lambda t: _banned(
        t, "engine.py", "import jax\ndef fetch(x):\n"
                        "    return jax.device_get(x)\n",
        jax_free=[], no_device_get=["engine.py"]),
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_synthetic_tree_gives_the_jax_rule_ids(tree, tmp_path):
    check = TREES[tree](tmp_path)
    # a manifest's path names its package; its file name is the same
    ours = sorted((f.rule, os.path.basename(f.file), f.line)
                  for f in check(pinv))
    theirs = sorted((f.rule, os.path.basename(f.file), f.line)
                    for f in check(jinv))
    assert ours == theirs


def test_port_only_rules_fire(tmp_path):
    """The port's own banned-API rules: the JAX stack in any scope of a
    port module, torch at module scope in a torch-free module, and a host
    fetch (``.item()``) in a step path unless its function is waived."""
    (tmp_path / "mod.py").write_text(
        "def go():\n    import optax\n    from stoke_tpu import Stoke\n")
    (tmp_path / "free.py").write_text("import torch\n")
    (tmp_path / "engine.py").write_text(
        "def step(x):\n    return x.item()\n"
        "def readback(x):\n    return x.cpu().numpy()\n")
    fs = pinv.check_banned_apis(
        str(tmp_path), jax_anywhere=["mod.py"], torch_free=["free.py"],
        no_device_get=["engine.py"],
        fetch_waivers={"engine.py::readback": "the stated readback"})
    assert sorted((f.rule, f.file, f.line) for f in fs) == [
        ("banned-device-get", "engine.py", 2),
        ("banned-jax-import", "mod.py", 2),
        ("banned-jax-import", "mod.py", 3),
        ("banned-torch-import", "free.py", 1)]


# --------------------------------------------------------------------------- #
# the auditor on synthetic programs: one fires each rule
# --------------------------------------------------------------------------- #

def _spec(program="apply", **kw):
    return ProgramSpec(program=program, **kw)


def _rules(report):
    return sorted({f.rule for f in report.findings})


def test_recorder_notes_what_the_program_writes():
    """An in-place op through a view writes the declared state it views,
    an ``out=`` op writes its output, every op is counted, and on the CPU
    nothing is a round trip to the host."""
    a, b = torch.zeros(4), torch.ones(4)
    rec = TraceRecorder("p")
    rec.declare("param:a", a)
    rec.declare("param:b", b)
    with rec:
        a.view(2, 2).add_(b.view(2, 2))
        float((a * 2).sum())
        torch.add(b, 1, out=torch.empty(4))
    facts = rec.facts
    assert facts.written == {"param:a"} and facts.ops == 8
    assert facts.transfers == () and facts.collectives == 0


_ROUND_TRIPS = {
    "item": (lambda x: x.sum().item(), "aten::_local_scalar_dense", "d2h"),
    "to_host": (lambda x: x.to("meta"), "aten::_to_copy", "d2h"),
    "nonzero": (lambda x: x.nonzero(), "aten::nonzero", "sync"),
    "masked_select": (lambda x: x.masked_select(x > 3),
                      "aten::masked_select", "sync"),
    "mask_index": (lambda x: x[x > 3], "aten::index", "sync"),
}


@pytest.mark.parametrize("case", sorted(_ROUND_TRIPS))
def test_recorder_finds_each_round_trip(case):
    """Each host round trip of a program, with the CPU standing for the
    card (the recorder told the host is another device)."""
    fn, op, kind = _ROUND_TRIPS[case]
    rec = TraceRecorder("p", host=("meta",))
    with rec:
        fn(torch.arange(8.0))
    assert [t[1:] for t in rec.facts.transfers] == [(op, kind)]


def test_audit_donation_fires():
    state = (StateEntry("param:w", 64), StateEntry("opt:w/exp_avg", 64),
             StateEntry("grad:w", 64, after="released"))
    written = ProgramFacts(ops=1, written=frozenset({"param:w"}))
    # the optimizer state written by no op
    assert _rules(audit_program_specs(
        [_spec(facts=written, state=state)])) == ["audit-donation"]
    # replaced with a new tensor (a released gradient is fine)
    replaced = (StateEntry("param:w", 64, after="replaced"),)
    assert _rules(audit_program_specs(
        [_spec(facts=written, state=replaced)])) == ["audit-donation"]
    ok = (state[0], state[2])
    assert audit_program_specs([_spec(facts=written, state=ok)]).findings \
        == []


@pytest.mark.parametrize("trip", [
    (0, "aten::_local_scalar_dense", "d2h"), (0, "aten::_to_copy", "d2h"),
    (0, "aten::copy_", "h2d"), (0, "aten::nonzero", "sync"),
    (0, "aten::index", "sync"),
])
def test_audit_hidden_transfer_fires(trip):
    rep = audit_program_specs([_spec(facts=ProgramFacts(
        ops=1, transfers=(trip,)))])
    assert _rules(rep) == ["audit-hidden-transfer"]
    assert trip[1] in rep.findings[0].message
    assert audit_program_specs([_spec(facts=ProgramFacts(ops=1))]
                               ).findings == []


def test_serve_upload_and_readback_are_the_programs_own():
    up = (0, "aten::_to_copy", "h2d")
    item = (1, "aten::_local_scalar_dense", "d2h")
    down = (2, "aten::_to_copy", "d2h")
    serve = dict(source="serve", program="serve_decode")
    assert audit_program_specs([_spec(facts=ProgramFacts(
        ops=3, transfers=(up, down)), **serve)]).findings == []
    assert _rules(audit_program_specs([_spec(facts=ProgramFacts(
        ops=3, transfers=(up, item, down)), **serve)])) == \
        ["audit-hidden-transfer"]


def test_audit_weak_type_fires():
    rep = audit_program_specs([_spec(weak_leaves=(
        "leaf 2: raw Python float argument",))])
    assert _rules(rep) == ["audit-weak-type"]


def test_audit_recompile_churn_fires():
    rep = audit_program_specs([], shape_sig_counts={"fused": 40,
                                                    "accum": 3})
    assert _rules(rep) == ["audit-recompile-churn"]
    assert "40 distinct" in rep.findings[0].message
    capped = audit_program_specs([], shape_sig_counts={"fused": 1024})
    assert "memo cap" in capped.findings[0].message
    assert any("not checked" in n for n in audit_program_specs([]).notes)


def test_audit_replicated_bytes_fires_on_a_group():
    state = (StateEntry("param:emb", 100 << 20),
             StateEntry("param:qkv", 100 << 20, cut=True))
    written = ProgramFacts(ops=1, written=frozenset({"param:emb",
                                                     "param:qkv"}))
    rep = audit_program_specs([_spec(facts=written, state=state,
                                     group_sizes={"model": 2})])
    assert _rules(rep) == ["audit-replicated-bytes"]
    assert "param:emb" in rep.findings[0].message
    alone = audit_program_specs([_spec(facts=written, state=state,
                                       group_sizes={"model": 1})])
    assert alone.findings == []


def test_audit_comm_bytes_fires_both_ways():
    rep = audit_program_specs([_spec()], transport_active=True,
                              comm_bytes={"onwire": 1024})
    assert _rules(rep) == ["audit-comm-bytes"]
    assert "no c10d collective" in rep.findings[0].message
    collective = ProgramFacts(ops=1, collectives=1)
    rep = audit_program_specs([_spec(facts=collective, exchange=False)])
    assert _rules(rep) == ["audit-comm-bytes"]
    assert audit_program_specs(
        [_spec(facts=collective, exchange=True)]).findings == []


def test_audit_cost_and_memory_drift_fire():
    args = (((4, 16), "int32", "host"),)
    spec = ProgramSpec("serve_decode", abstract_args=args, source="serve",
                       cost={"flops": 110.0, "bytes accessed": 50.0},
                       memory={"temp_bytes": 10.0, "peak_bytes": 100.0})
    sig = cost_signature(args)
    pin = {"programs": {"serve_decode": {"sig": sig, "flops": 100.0,
                                         "bytes_accessed": 50.0}}}
    rep = audit_program_specs([spec], cost_manifest=pin)
    assert [f.rule for f in rep.findings] == ["audit-cost-drift"]
    assert "grew 10.0%" in rep.findings[0].message
    mem = {"programs": {"serve_decode": {"sig": sig, "temp_bytes": 10.0,
                                         "peak_bytes": 50.0}}}
    rep = audit_program_specs([spec], mem_manifest=mem)
    assert [f.rule for f in rep.findings] == ["audit-memory-drift"]
    # a changed geometry is a note, an unpinned program a finding
    moved = {"programs": {"serve_decode": dict(pin["programs"][
        "serve_decode"], sig="other")}}
    rep = audit_program_specs([spec], cost_manifest=moved)
    assert rep.findings == [] and any("geometry" in n for n in rep.notes)
    rep = audit_program_specs([spec], cost_manifest={"programs": {}})
    assert [f.rule for f in rep.findings] == ["audit-cost-drift"]


def test_audit_deserialized_is_kept_and_never_fires():
    """Nothing is dispatched through a loaded executable in the port, so
    the id is kept (the JAX catalog's) and no program can fire it."""
    assert "audit-deserialized" in AUDIT_RULES
    import stoke_tpu_torch.analysis.program as prog

    assert "loaded executable" in prog.__doc__


# --------------------------------------------------------------------------- #
# Stoke.audit() on GPT-tiny
# --------------------------------------------------------------------------- #


def _gpt():
    m = GPT(vocab_size=257, size_name="tiny", max_len=64, dropout_rate=0.0,
            attention_fn=make_flash_attention(causal=True),
            attention_is_causal=True)
    m.init_weights(0)
    return m


def _stoke(loss=causal_lm_loss, **kw):
    return Stoke(_gpt(), StokeOptimizer(torch.optim.AdamW, lr=3e-3), loss,
                 batch_size_per_device=2, device="cpu", verbose=False, **kw)


def _batch():
    return torch.randint(0, 257, (2, 16),
                         generator=torch.Generator().manual_seed(0))


def _jax_audited_programs():
    """The programs the JAX audit names after the same calls: the four
    calls, train_step, train_steps and a serving engine (a linear model;
    the program names do not depend on it)."""
    import jax.numpy as jnp
    import optax

    from stoke_tpu import Stoke as JaxStoke

    def mk(**kw):
        return JaxStoke(model=lambda p, x: x @ p["w"],
                        optimizer=optax.sgd(0.1),
                        loss=lambda o, y: jnp.mean((o - y) ** 2),
                        params={"w": np.zeros((8, 4), np.float32)},
                        batch_size_per_device=2, verbose=False, **kw)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8)).astype(np.float32)
    y = rng.normal(size=(2, 4)).astype(np.float32)
    s = mk()
    s.train_step(x, y)
    out = s.model(x)
    s.backward(s.loss(out, y))
    s.step()
    s.train_steps(np.stack([x, x]), np.stack([y, y]))
    return set(s.audit().programs)


def test_stoke_audit_on_gpt_tiny_after_every_api():
    """After the four calls, train_step, train_steps and serve(): no
    findings, no dispatch and no kernel launch by the audit, and every
    step program the JAX audit names that the port has."""
    x = _batch()
    s = _stoke(grad_accum=2, configs=[ServeConfig(
        max_seqs=2, kv_block_size=16, max_seq_len=64, max_new_tokens=3,
        prefill_pad_multiple=16, attention="flash",
        decode_kernel="pallas")])
    s.train_step(x, x)
    s.train_step(x, x)
    for _ in range(2):
        out = s.model(x)
        s.backward(s.loss(out, x))
    s.step()
    s.train_steps(torch.stack([x] * 4), torch.stack([x] * 4))
    engine = s.serve()
    engine.submit([5, 6, 7])
    engine.run()
    before = (s.dispatch_count, dict(LAUNCHES))
    rep = s.audit(serve=engine)
    assert rep.findings == [], rep.format()
    assert (s.dispatch_count, dict(LAUNCHES)) == before
    assert {"fused_nb", "fused", "accum", "apply", "window",
            "serve_prefill", "serve_decode"} <= set(rep.programs)
    port_programs = set(s._engine.DECLARED_STATE) | {"serve_prefill",
                                                     "serve_decode"}
    assert (_jax_audited_programs() & port_programs) <= set(rep.programs)
    reg = s._telemetry.registry
    assert reg.get("analysis/programs_audited_total").value == \
        len(rep.programs)
    assert reg.get("analysis/audit_findings_total").value == 0
    # each spec holds no live tensor: its arguments are abstract
    for spec in s._engine.audit_specs():
        assert not any(isinstance(a, torch.Tensor)
                       for a in spec.abstract_args)


def test_audit_spec_cap_is_noted(monkeypatch):
    monkeypatch.setattr(type(_stoke()._engine), "_MAX_AUDIT_SPECS", 1)
    s = _stoke()
    x = _batch()
    s.train_step(x, x)
    out = s.model(x)
    s.backward(s.loss(out, x))
    s.step()
    rep = s.audit()
    assert len(rep.programs) == 1
    assert any("truncated" in n for n in rep.notes)


def test_audit_warns_on_findings():
    """A Python-number loss argument is a weak-typed program argument:
    the audit finds it and warns."""
    s = _stoke(loss=lambda out, y, w: causal_lm_loss(out, y) * w)
    x = _batch()
    s.train_step(x, (x, 0.5))
    with pytest.warns(UserWarning, match="program audit found 1 issue"):
        rep = s.audit()
    assert [f.rule for f in rep.findings] == ["audit-weak-type"]
    assert "raw Python float" in rep.findings[0].message


def test_serve_specs_cost_and_kv_state():
    """A serve program's spec carries its first run's cost and the KV pool
    it writes in place, and matches the committed cost manifest."""
    model = _gpt()
    from stoke_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, model.state_dict(), ServeConfig(
        max_seqs=2, kv_block_size=8, max_seq_len=64, max_new_tokens=4,
        prefill_pad_multiple=16, attention="flash", decode_kernel="pallas"),
        device="cpu")
    eng.submit([5, 6, 7])
    eng.run()
    specs = {s.program: s for s in eng.audit_specs()}
    assert set(specs) == {"serve_prefill", "serve_decode"}
    for spec in specs.values():
        assert spec.cost["flops"] > 0
        assert [e.name for e in spec.state] == ["kv:k_pages", "kv:v_pages"]
    with open(os.path.join(REPO, "stoke_tpu_torch", "analysis", "manifests",
                           "program_costs.json")) as f:
        manifest = json.load(f)
    rep = audit_program_specs(list(specs.values()), cost_manifest=manifest)
    assert rep.findings == [], rep.format()


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #

_CLI = os.path.join(REPO, "scripts", "stoke_lint_torch.py")


def test_cli_exit0_and_json():
    out = subprocess.run([sys.executable, _CLI, "--json"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["findings"] == []
    assert payload["version"] == pinv.LINT_VERSION


def test_cli_loads_neither_torch_nor_jax(tmp_path):
    for name in ("torch", "jax"):
        poison = tmp_path / name
        poison.mkdir()
        (poison / "__init__.py").write_text(
            f"raise ImportError('{name} must not be imported by the lint "
            f"CLI')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tmp_path) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, _CLI], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout


def test_cli_findings_exit1(tmp_path):
    pkg = tmp_path / "stoke_tpu_torch"
    (pkg / "analysis" / "manifests").mkdir(parents=True)
    (pkg / "telemetry").mkdir()
    (pkg / "autotune.py").write_text("import torch\n")
    man = pkg / "analysis" / "manifests"
    (man / "wire_formats.json").write_text('{"wire_formats": []}')
    (man / "config_waivers.json").write_text('{"waivers": {}}')
    (pkg / "configs.py").write_text("")
    (pkg / "status.py").write_text("")
    (pkg / "telemetry" / "events.py").write_text(
        'STEP_EVENT_FIELDS = {"step": (True, "int")}\n')
    out = subprocess.run([sys.executable, _CLI, "--json", "--repo-root",
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1, out.stdout + out.stderr
    rules = {f["rule"] for f in json.loads(out.stdout)["findings"]}
    assert rules == {"banned-torch-import"}


def test_cli_usage_errors_exit2():
    out = subprocess.run([sys.executable, _CLI, "--update-costs"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "requires --programs" in out.stderr
