"""The port's autotuner (``stoke_tpu_torch/autotune.py``) against the JAX
package's (``stoke_tpu/autotune.py``): the JAX module's cases run against
the port's module; on the knobs both have, the config keys, the pruning
and the whole greedy-search trajectory and winner are the JAX module's;
a port ledger is read by the JAX ``read_winner``; and the driver
(``scripts/autotune_torch.py --smoke``) runs end to end on the CPU.

Both modules are torch- and jax-free, so each is loaded by file."""

import importlib.util
import json
import math
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


at = _load(os.path.join(REPO, "stoke_tpu_torch", "autotune.py"),
           "_port_autotune_under_test")
jat = _load(os.path.join(REPO, "stoke_tpu", "autotune.py"),
            "_jax_autotune_reference")
TrialSpec, TrialResult = at.TrialSpec, at.TrialResult

#: the knobs both modules have
SHARED = ("batch", "steps_per_dispatch", "comm_dtype")


# --------------------------------------------------------------------------- #
# the JAX module's cases
# --------------------------------------------------------------------------- #


def test_config_key_identity_and_determinism():
    assert TrialSpec().config_key() == "baseline"
    a = TrialSpec(batch=256, steps_per_dispatch=25)
    assert a.config_key() == TrialSpec(batch=256,
                                       steps_per_dispatch=25).config_key()
    assert "batch=256" in a.config_key()
    assert a.config_key() != TrialSpec(batch=512).config_key()
    assert TrialSpec(comm_dtype="int8").config_key() != "baseline"


def test_spec_roundtrip_and_with_knob():
    spec = TrialSpec(batch=128, comm_dtype="int8")
    assert TrialSpec.from_dict(spec.to_dict()) == spec
    # unknown keys (a JAX record's xla_flags and block knobs) are dropped
    assert TrialSpec.from_dict({"batch": 64, "xla_flags": "--x",
                                "decode_block_h": 2}).batch == 64
    bumped = spec.with_knob("steps_per_dispatch", 50)
    assert bumped.steps_per_dispatch == 50 and spec.steps_per_dispatch is None


def test_closed_knobs_are_not_offered():
    """xla_flags, the flash tiles, the head blocks and the paged tile
    close without a port (the module docstring gives the reasons)."""
    names = {f for f in TrialSpec().to_dict()}
    assert names == set(SHARED)
    for closed in ("xla_flags", "flash_block_q", "flash_block_k",
                   "decode_block_h", "verify_block_h",
                   "decode_pages_per_block", "verify_pages_per_block"):
        assert closed not in at.KNOB_KIND and closed in at.__doc__


FULL_SPACE = {"batch": [128, 256], "steps_per_dispatch": [10, 25],
              "comm_dtype": ["bf16"]}


def test_memory_bound_prunes_the_wire_format():
    knobs = at.knobs_for_bound("memory", FULL_SPACE)
    assert "comm_dtype" not in knobs
    assert {"batch", "steps_per_dispatch"} <= set(knobs)


def test_host_bound_prioritizes_dispatch_amortization():
    knobs = at.knobs_for_bound("host", FULL_SPACE)
    assert knobs[0] == "steps_per_dispatch"
    assert set(knobs) == set(FULL_SPACE)


def test_comm_bound_keeps_wire_format_first():
    knobs = at.knobs_for_bound("comm", FULL_SPACE)
    assert knobs[0] == "comm_dtype"
    assert "batch" not in knobs


def test_unknown_or_missing_bound_never_empties_the_sweep():
    assert set(at.knobs_for_bound(None, FULL_SPACE)) == set(FULL_SPACE)
    assert set(at.knobs_for_bound("weird", FULL_SPACE)) == set(FULL_SPACE)
    assert set(at.KNOB_KIND.values()) <= set(at.BOUND_KNOB_KINDS[None])


def _mfu_measure(module, optimum_batch=512, bound="compute"):
    calls = []

    def measure(spec):
        calls.append(spec.config_key())
        batch = spec.batch or 128
        seg = spec.steps_per_dispatch or 10
        wire = spec.comm_dtype
        mfu = (0.5 - abs(batch - optimum_batch) / 2048 + seg / 1000.0
               + (0.01 if wire == "bf16" else 0.0))
        return module.TrialResult(spec, value=batch * 10.0, mfu=mfu,
                                  goodput_fraction=0.9, bound=bound)

    measure.calls = calls
    return measure


def test_search_converges_on_synthetic_optimum():
    space = {"batch": [128, 256, 512, 1024],
             "steps_per_dispatch": [10, 25, 50]}
    out = at.greedy_search(_mfu_measure(at), TrialSpec(), space,
                           max_trials=16)
    assert out.best.spec.batch == 512
    assert out.best.spec.steps_per_dispatch == 50
    assert out.trials == len(out.history) <= 16
    assert out.best.score() == max(r.score() for r in out.history)


def test_search_never_remeasures_a_config():
    measure = _mfu_measure(at)
    at.greedy_search(measure, TrialSpec(),
                     {"batch": [128, 128, 256], "steps_per_dispatch": [10]},
                     max_trials=16)
    assert len(measure.calls) == len(set(measure.calls))


def test_search_respects_trial_budget():
    measure = _mfu_measure(at)
    out = at.greedy_search(measure, TrialSpec(),
                           {"batch": list(range(100, 2000, 100))},
                           max_trials=4)
    assert out.trials == 4 and len(measure.calls) == 4


def test_search_prunes_by_baseline_bound():
    """A memory-bound baseline does not spend trials on the wire format."""
    measure = _mfu_measure(at, bound="memory")
    out = at.greedy_search(measure, TrialSpec(),
                           {"comm_dtype": ["bf16", "int8"],
                            "batch": [128, 256]}, max_trials=16)
    assert "comm_dtype" in out.pruned_knobs
    assert all("comm_dtype=" not in k for k in measure.calls)


def test_failed_trials_recorded_but_never_win():
    def measure(spec):
        if spec.batch == 256:
            return TrialResult(spec, ok=False, error="OOM")
        return TrialResult(spec, value=float(spec.batch or 1), bound=None)

    out = at.greedy_search(measure, TrialSpec(), {"batch": [64, 256, 128]},
                           max_trials=16)
    assert out.best.spec.batch == 128
    failed = [r for r in out.history if not r.ok]
    assert len(failed) == 1 and failed[0].error == "OOM"
    assert failed[0].score() == -math.inf


def test_score_prefers_mfu_times_goodput_over_raw_value():
    high_tp = TrialResult(TrialSpec(), value=9999.0, mfu=0.2,
                          goodput_fraction=0.5)
    high_mfu = TrialResult(TrialSpec(batch=1), value=1.0, mfu=0.4,
                           goodput_fraction=0.9)
    assert high_mfu.score() > high_tp.score()
    assert TrialResult(TrialSpec(), value=10.0).score() == 10.0


def test_persist_and_read_winner_provenance(tmp_path):
    ledger = str(tmp_path / "autotune.json")
    best = TrialResult(TrialSpec(batch=256, steps_per_dispatch=25,
                                 comm_dtype="bf16"),
                       value=9500.0, mfu=0.41, goodput_fraction=0.93,
                       bound="compute")
    outcome = at.SearchOutcome(best, history=[best],
                               pruned_knobs=["comm_dtype"], trials=7)
    rec = at.persist_winner(ledger, "gpt_base_bf16_train_tokens_per_s",
                            outcome, backend="cuda")
    back = at.read_winner(ledger, "gpt_base_bf16_train_tokens_per_s")
    assert back == rec
    assert back["config_key"] == (
        "batch=256|steps_per_dispatch=25|comm_dtype=bf16")
    assert back["mfu"] == pytest.approx(0.41)
    assert back["trials"] == 7 and back["pruned_knobs"] == ["comm_dtype"]
    assert back["backend"] == "cuda" and back["date"]
    assert TrialSpec.from_dict(back["spec"]).config_key() == \
        back["config_key"]


def test_persist_winner_merges_with_existing_ledger(tmp_path):
    ledger = str(tmp_path / "autotune.json")
    with open(ledger, "w") as f:
        json.dump({"other_metric": {"value": 1.0}}, f)
    at.persist_winner(ledger, "m", at.SearchOutcome(
        TrialResult(TrialSpec(), value=5.0), trials=1))
    data = at.load_ledger(ledger)
    assert data["other_metric"] == {"value": 1.0}
    assert at.winner_metric("m") in data


def test_read_winner_absent_is_none(tmp_path):
    assert at.read_winner(str(tmp_path / "nope.json"), "m") is None


# --------------------------------------------------------------------------- #
# the JAX module's answers on the shared knobs
# --------------------------------------------------------------------------- #


_SPECS = [dict(), dict(batch=64), dict(comm_dtype="int8", batch=8),
          dict(comm_dtype="bf16", steps_per_dispatch=25),
          dict(comm_dtype="bf16", batch=512, steps_per_dispatch=10)]


@pytest.mark.parametrize("fields", _SPECS)
def test_config_key_is_the_jax_modules(fields):
    ours = TrialSpec(**fields)
    assert ours.config_key() == jat.TrialSpec(**fields).config_key()
    assert jat.TrialSpec.from_dict(ours.to_dict()).config_key() == \
        ours.config_key()


@pytest.mark.parametrize("bound", ["memory", "compute", "comm", "host",
                                   None, "weird"])
def test_knobs_for_bound_is_the_jax_modules(bound):
    space = {k: [1, 2] for k in reversed(SHARED)}
    assert at.knobs_for_bound(bound, space) == \
        jat.knobs_for_bound(bound, space)


@pytest.mark.parametrize("bound", ["memory", "compute", "host", None])
def test_greedy_search_trajectory_is_the_jax_modules(bound):
    """The same synthetic measure through both searches: every trial in
    the same order with the same score, the same pruning and winner."""
    space = {"comm_dtype": ["bf16", "int8"], "batch": [128, 256, 512, 1024],
             "steps_per_dispatch": [10, 25, 50]}
    runs = []
    for module in (at, jat):
        log = []
        out = module.greedy_search(
            _mfu_measure(module, bound=bound), module.TrialSpec(batch=128),
            space, max_trials=9, log=log.append)
        runs.append(([(r.spec.config_key(), r.score()) for r in out.history],
                     out.pruned_knobs, out.best.spec.config_key(), log))
    assert runs[0] == runs[1]


def test_port_ledger_is_read_by_the_jax_read_winner(tmp_path):
    ledger = str(tmp_path / "autotune.json")
    best = TrialResult(TrialSpec(batch=16), value=123.0, bound="memory")
    rec = at.persist_winner(ledger, "serve_paged_decode_tokens_per_s",
                            at.SearchOutcome(best, [best], [], 3))
    theirs = jat.read_winner(ledger, "serve_paged_decode_tokens_per_s")
    assert theirs == rec
    assert jat.TrialSpec.from_dict(theirs["spec"]).config_key() == \
        "batch=16"


# --------------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("workload", ["gpt", "serve_decode"])
def test_autotune_smoke_end_to_end(tmp_path, workload):
    """``--smoke`` on the CPU: subprocess trials, a winner persisted under
    the smoke metric in the given ledger, and the parent never imports
    torch (its module is loaded by file)."""
    ledger = tmp_path / "autotune.json"
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "autotune_torch.py"),
         "--smoke", "--workload", workload, "--trials", "3",
         "--ledger", str(ledger)],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:] + proc.stdout[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["autotune"] == "ok" and summary["trials"] == 3
    assert summary["metric"].endswith("_smoke")
    data = json.loads(ledger.read_text())
    assert f"autotune/{summary['metric']}" in data
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "BENCH_RESULTS.json"))
