"""Port parity: the fleet monitor (``stoke_tpu_torch/telemetry/fleet.py``)
and input rebalancing (``stoke_tpu_torch/data.py``) against
``stoke_tpu/telemetry/fleet.py`` and ``stoke_tpu/data.py:204-450``.

Exact against the JAX package on the same inputs: the wire format
(``FLEET_SIGNALS``, pack and unpack), ``fleet_aggregates`` and
``straggler_verdict`` on the same matrices, the monitor's fields, streaks
and summary on a synthetic 4-host exchange, the rebalancer's share
protocol, and the rebalanced batches. Through the port's ``Stoke`` on one
process: the ``fleet/*`` fields at window boundaries, the same losses,
weights and dispatches with and without a ``FleetConfig``, the straggler
anomaly and its bundle's ``fleet.json``.

A gloo world of 2 (``tests/_torch_fleet_worker.py``), spawned once for the
module through a file store and joined with a 120 s timeout, runs the real
exchange: every step's matrix is the same on both ranks, rank 1's planted
read delay is flagged as a loader straggler, the rebalancer shifts read
rows off it, and every batch either rank trained on equals its canonical
batch row for row.
"""

import json
import os
import sys
import time
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch import nn

from stoke_tpu import data as jax_data
from stoke_tpu.configs import FleetConfig as JaxFleetConfig
from stoke_tpu.telemetry import fleet as jax_fleet
from stoke_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch import data as port_data
from stoke_tpu_torch.configs import (
    FleetConfig,
    HealthConfig,
    TelemetryConfig,
)
from stoke_tpu_torch.telemetry import fleet as port_fleet
from stoke_tpu_torch.telemetry.events import read_step_events
from stoke_tpu_torch.telemetry.registry import MetricsRegistry

sys.path.insert(0, os.path.dirname(__file__))
import _torch_fleet_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

WORLD = 2
JOIN_TIMEOUT_S = 120


def _rows_matrix(mod, rows):
    return np.stack([mod.pack_fleet_vector(r) for r in rows])


#: the JAX tests' synthetic fleets, and random ones
MATRICES = {
    "compute_straggler": [{"step": 1, "wall_s": w}
                          for w in (1.0, 1.0, 3.0, 1.0)],
    "small_fleet_z": [{"step": 1, "wall_s": w}
                      for w in (1.0, 1.01, 0.99, 1.2)],
    "loader": [{"step": 1, "wall_s": 1.0, "loader_wait_s": lw}
               for lw in (0.05, 0.9, 0.05, 0.05)],
    "two_hosts": [{"step": 1, "wall_s": 1.0, "loader_wait_s": 0.0},
                  {"step": 1, "wall_s": 1.0, "loader_wait_s": 0.8}],
    "barrier": [{"step": 1, "wall_s": 1.0, "barrier_wait_s": b}
                for b in (0.5, 0.0, 0.45)],
    "equal_barrier": [{"step": 1, "wall_s": 1.0, "barrier_wait_s": 0.4}
                      for _ in range(3)],
    "uniform": [{"step": 1, "wall_s": 1.0, "loader_wait_s": 0.1}] * 4,
    "one_host": [{"step": 1, "wall_s": 1.0}],
}


def _random_matrix(seed, hosts):
    r = np.random.default_rng(seed)
    m = r.uniform(0.0, 2.0, size=(hosts, len(jax_fleet.FLEET_SIGNALS)))
    return m.astype(np.float32)


def _matrix(name):
    if name.startswith("random"):
        _, seed, hosts = name.split("-")
        return _random_matrix(int(seed), int(hosts))
    return _rows_matrix(jax_fleet, MATRICES[name])


CASES = list(MATRICES) + [f"random-{s}-{h}" for s, h in
                          ((0, 2), (1, 3), (2, 5), (3, 8))]


def test_wire_format_is_the_jax_packages():
    assert port_fleet.FLEET_SIGNALS == jax_fleet.FLEET_SIGNALS
    assert port_fleet.FLEET_INDEX == jax_fleet.FLEET_INDEX
    assert port_fleet.FLEET_EVENT_FIELDS == jax_fleet.FLEET_EVENT_FIELDS
    assert port_fleet.FLEET_BASE_FIELDS == jax_fleet.FLEET_BASE_FIELDS
    assert port_fleet._GOODPUT_BUCKETS == jax_fleet._GOODPUT_BUCKETS
    from stoke_tpu_torch.telemetry.attribution import GOODPUT_BUCKETS

    assert tuple(f"goodput_{b}_s" for b in GOODPUT_BUCKETS) == tuple(
        s for s in port_fleet.FLEET_SIGNALS if s.startswith("goodput_"))


@pytest.mark.parametrize("seed", range(3))
def test_pack_unpack_equal_jax(seed):
    r = np.random.default_rng(seed)
    names = list(jax_fleet.FLEET_SIGNALS)
    signals = {n: float(r.uniform(0, 1e6)) for n in
               r.choice(names, size=1 + seed * 5, replace=False)}
    a, b = port_fleet.pack_fleet_vector(signals), \
        jax_fleet.pack_fleet_vector(signals)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert port_fleet.unpack_fleet_vector(a) == jax_fleet.unpack_fleet_vector(b)
    with pytest.raises(ValueError, match="unknown fleet signals"):
        port_fleet.pack_fleet_vector({"walls_s": 1.0})
    with pytest.raises(ValueError, match="mixed code versions"):
        port_fleet.unpack_fleet_vector(np.zeros(len(names) + 1, np.float32))


@pytest.mark.parametrize("case", CASES)
def test_aggregates_and_verdict_equal_jax(case):
    m = _matrix(case)
    assert port_fleet.fleet_aggregates(m) == jax_fleet.fleet_aggregates(m)
    for rel, z in ((0.2, 3.0), (0.5, 1.1), (0.3, 3.0), (0.01, 0.1)):
        assert port_fleet.straggler_verdict(
            m, rel_threshold=rel, zscore_threshold=z) == \
            jax_fleet.straggler_verdict(m, rel_threshold=rel,
                                        zscore_threshold=z)


def _driven(mod, cfg_cls, registry_cls, walls_by_window, straggler_windows,
            rebalancer=None):
    """A monitor of ``mod`` whose exchange returns a synthetic 4-host
    matrix a window (host walls from ``walls_by_window``)."""
    reg = registry_cls()
    cfg = cfg_cls(window_steps=1, straggler_rel_frac=0.5,
                  straggler_windows=straggler_windows,
                  straggler_action="record", rebalance=rebalancer is not None,
                  rebalance_rows=3, rebalance_max_frac=0.5)
    mon = mod.FleetMonitor(cfg, reg, rank=0, n_processes=4)
    if rebalancer is not None:
        mon.attach_rebalancer(rebalancer)
    windows = iter(walls_by_window)

    def exchange(vec):
        walls, loaders = next(windows)
        rows = []
        for w, lw in zip(walls, loaders):
            row = dict(mod.unpack_fleet_vector(vec))
            row.update(wall_s=w, loader_wait_s=lw)
            rows.append(row)
        return _rows_matrix(mod, rows).astype(np.float32)

    mon._exchange = exchange
    return mon, reg


def _exchange_script(n):
    """A 4-host fleet: host 2 slow in compute for 3 windows, then host 1
    slow in its loader for 4, then a quiet fleet."""
    out = []
    for w in range(n):
        if w < 3:
            out.append(((1.0, 1.0, 3.0, 1.0), (0.0,) * 4))
        elif w < 7:
            out.append(((1.0, 1.0, 1.0, 1.0), (0.0, 2.0, 0.1, 0.2)))
        else:
            out.append(((1.0,) * 4, (0.1,) * 4))
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
def test_streak_detector_on_a_4_host_exchange_equals_jax(k):
    """The monitor's step-event fields, fired straggler events, counters
    and summary over a scripted 4-host exchange, exact."""
    script = _exchange_script(10)
    rb_port = port_data.InputRebalancer(n_hosts=4, rank=0, batch_size=16,
                                        max_frac=0.5)
    rb_jax = jax_data.InputRebalancer(n_hosts=4, rank=0, batch_size=16,
                                      max_frac=0.5)
    port, preg = _driven(port_fleet, FleetConfig, MetricsRegistry, script, k,
                         rb_port)
    ref, jreg = _driven(jax_fleet, JaxFleetConfig, JaxRegistry, script, k,
                        rb_jax)
    for step in range(1, 12):
        a = port.window_stats(step=step, wall_s=0.5)
        b = ref.window_stats(step=step, wall_s=0.5)
        assert a == b, step
        assert port.consume_straggler() == ref.consume_straggler(), step
    for name in ("fleet/windows_total", "fleet/straggler_windows_total",
                 "fleet/anomalies_total", "fleet/rebalance_shifts_total",
                 "fleet/rebalance_rows_moved_total"):
        assert preg.counter(name).value == jreg.counter(name).value, name
    assert port.summary() == ref.summary()
    assert rb_port.shares == rb_jax.shares
    assert rb_port.share_of(1) == rb_jax.share_of(1)


def test_straggler_detector_adapts_to_health_registry():
    script = _exchange_script(4)
    mon, _ = _driven(port_fleet, FleetConfig, MetricsRegistry, script, 1)
    det = port_fleet.FleetStragglerDetector(mon, "warn")
    assert det.name == "fleet_straggler"
    assert det.check(1, None, None) is None
    mon.window_stats(step=1, wall_s=1.0)
    mon.window_stats(step=2, wall_s=1.0)
    anomaly = det.check(2, None, None)
    assert anomaly.detector == "fleet_straggler" and anomaly.action == "warn"
    assert "host 2" in anomaly.message
    assert det.check(3, None, None) is None


def test_warn_fallback_without_health():
    script = _exchange_script(3)
    mon, _ = _driven(port_fleet, FleetConfig, MetricsRegistry, script, 1)
    mon.cfg.straggler_action = "warn"
    mon.window_stats(step=1, wall_s=1.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mon.window_stats(step=2, wall_s=1.0)
    assert any("straggled" in str(w.message) and "host 2" in str(w.message)
               for w in caught)


# ---------------------------------------------------------------------- #
# the rebalancer
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(4))
def test_rebalancer_protocol_equals_jax(seed):
    """The same proposals, yields and fetches give the same shares, moves
    and apply points, step for step."""
    r = np.random.default_rng(seed)
    hosts = int(r.integers(2, 5))
    kw = dict(n_hosts=hosts, rank=int(r.integers(0, hosts)), batch_size=16,
              max_frac=float(r.choice([0.25, 0.5])),
              apply_slack=int(r.integers(1, 5)))
    a, b = port_data.InputRebalancer(**kw), jax_data.InputRebalancer(**kw)
    for _ in range(40):
        op = r.integers(0, 3)
        if op == 0:
            f, t = (int(x) for x in r.integers(0, hosts, 2))
            n = int(r.integers(0, 8))
            assert a.propose_shift(f, t, n) == b.propose_shift(f, t, n)
        elif op == 1:
            a.note_yield()
            b.note_yield()
        else:
            assert a.shares_for_fetch() == b.shares_for_fetch()
        assert a.shares == b.shares and a.shifted == b.shifted
        assert [a.share_of(h) for h in range(hosts)] == \
            [b.share_of(h) for h in range(hosts)]
    assert (a.shifts, a.rows_moved) == (b.shifts, b.rows_moved)
    with pytest.raises(ValueError, match="zero-row share"):
        port_data.InputRebalancer(n_hosts=2, rank=0, batch_size=2,
                                  max_frac=0.25)
    with pytest.raises(ValueError, match="out of range"):
        port_data.InputRebalancer(n_hosts=2, rank=2, batch_size=16)


def test_reassemble_math_equals_jax():
    r = np.random.default_rng(0)
    gathered = r.normal(size=(3, 10, 2)).astype(np.float32)
    for shares in ([6, 2, 4], [4, 4, 4], [10, 1, 1]):
        for rank in range(3):
            np.testing.assert_array_equal(
                port_data.reassemble_from_gathered(gathered, shares, rank, 4),
                jax_data.reassemble_from_gathered(gathered, shares, rank, 4))


def test_rebalanced_batches_are_canonical():
    """A simulated fleet of two with any legal share split: every host's
    assembled batch is its canonical batch, equal to the JAX function's;
    a balanced split runs no exchange."""
    n_rows, batch = 128, 8

    def row(i):
        return np.full((4,), i, np.float32), np.float32(i)

    class IdRows:
        def __len__(self):
            return n_rows

        def __getitem__(self, i):
            return row(i)

    data = IdRows()
    samplers = [port_data.BucketedDistributedSampler(
        data, buckets=1, batch_size=batch, sorted_idx=list(range(n_rows)),
        num_replicas=2, rank=r, seed=5) for r in range(2)]
    ref = jax_data.BucketedDistributedSampler(
        data, buckets=1, batch_size=batch, sorted_idx=list(range(n_rows)),
        num_replicas=2, rank=0, seed=5)
    plans = [s.global_batches() for s in samplers]
    assert plans[0] == plans[1] == ref.global_batches()

    def assemble(idx):
        return (np.stack([row(int(i))[0] for i in idx]),
                np.stack([row(int(i))[1] for i in idx]))

    for shares in ([8, 8], [10, 6], [4, 12], [15, 1]):
        for per_replica in plans[0][:4]:
            canonical = [i for sub in per_replica for i in sub]
            cuts = np.concatenate([[0], np.cumsum(shares)])
            payloads = [port_data._pad_rows(
                assemble(canonical[cuts[r]:cuts[r + 1]]), max(shares))
                for r in range(2)]

            def gather(_payload):
                return (np.stack([p[0] for p in payloads]),
                        np.stack([p[1] for p in payloads]))

            def no_gather(_payload):
                raise AssertionError("a balanced split exchanged")

            for r in range(2):
                fn = gather if max(shares) != min(shares) else no_gather
                got = port_data.assemble_rebalanced_batch(
                    per_replica, shares, r, batch, assemble, allgather=fn)
                want = jax_data.assemble_rebalanced_batch(
                    per_replica, shares, r, batch, assemble, allgather=fn)
                for g, w, c in zip(got, want, assemble(per_replica[r])):
                    np.testing.assert_array_equal(g, w)
                    np.testing.assert_array_equal(g, c)
    with pytest.raises(ValueError, match="do not cover"):
        port_data.assemble_rebalanced_batch(plans[0][0], [8, 7], 0, batch,
                                            assemble)


def test_rebalanced_loader_needs_a_global_plan():
    with pytest.raises(ValueError, match="global_batches"):
        port_data.StokeDataLoader(
            port_data.ArrayDataset(np.zeros((4, 2))), 2, device="cpu",
            rebalancer=port_data.InputRebalancer(2, 0, 16))
    s = port_data.BucketedDistributedSampler(
        np.zeros(128), buckets=1, batch_size=8, sorted_idx=range(128),
        num_replicas=2, rank=0)
    with pytest.raises(ValueError, match="silently ignored"):
        port_data.StokeDataLoader(
            port_data.ArrayDataset(np.zeros((128, 2))), 8, device="cpu",
            rebalancer=port_data.InputRebalancer(2, 0, 16), sampler=s,
            drop_last=True)


# ---------------------------------------------------------------------- #
# one process through Stoke
# ---------------------------------------------------------------------- #


IN, OUT = 8, 4


def _stoke(tmp_path, tag, *, fleet=True, fleet_over=None, extra=()):
    configs = [TelemetryConfig(output_dir=str(tmp_path / tag),
                               log_every_n_steps=1, prometheus=False,
                               tensorboard=False, sample_device_time=False)]
    if fleet:
        configs.append(FleetConfig(**{"window_steps": 1,
                                      **(fleet_over or {})}))
    model = nn.Linear(IN, OUT, bias=False)
    with torch.no_grad():
        model.weight.fill_(0.1)
    return Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.05),
                 lambda o, y: ((o - y) ** 2).mean(), batch_size_per_device=4,
                 device="cpu", configs=configs + list(extra))


def _batches(n, seed=0):
    r = np.random.default_rng(seed)
    w = r.normal(size=(IN, OUT)).astype(np.float32)
    out = []
    for _ in range(n):
        x = r.normal(size=(32, IN)).astype(np.float32)
        out.append((torch.from_numpy(x), torch.from_numpy(x @ w)))
    return out


def test_fleet_off_and_on_run_the_same(tmp_path):
    """With and without a FleetConfig: the same losses, weights and
    dispatches (the exchange is host bookkeeping)."""
    runs = {}
    for fleet in (False, True):
        s = _stoke(tmp_path, f"f{fleet}", fleet=fleet)
        losses = []
        for i, (x, y) in enumerate(_batches(4)):
            if i < 2:
                losses.append(float(s.train_step(x, y)))
            else:
                loss = s.loss(s.model(x), y)
                s.backward(loss)
                s.step()
                losses.append(float(loss))
        s.close_telemetry()
        runs[fleet] = (losses, s.model_access.weight.detach().clone(),
                       s.dispatch_count)
    assert runs[True][0] == runs[False][0]
    assert torch.equal(runs[True][1], runs[False][1])
    assert runs[True][2] == runs[False][2]


def test_single_process_fleet_fields_and_cadence(tmp_path):
    s = _stoke(tmp_path, "solo", fleet_over={"window_steps": 2})
    for x, y in _batches(5):
        s.train_step(x, y)
    s.close_telemetry()
    records = read_step_events(str(tmp_path / "solo" / "steps.jsonl"))
    assert [r["step"] for r in records if r["fleet/hosts"] is not None] \
        == [2, 4]
    assert all("fleet/hosts" in r for r in records)
    assert not any(k.startswith("fleet/rebalance") for k in records[0])
    for rec in records:
        if rec["fleet/hosts"] is not None:
            assert rec["fleet/hosts"] == 1
            assert rec["fleet/skew_class"] == "none"
            assert rec["fleet/straggler_host"] is None
    reg = s.telemetry.registry
    assert reg.counter("fleet/windows_total").value == 2
    assert reg.get("fleet/wall_s_median") is not None
    summary = s.fleet_summary
    assert summary["windows"] == 2 and summary["n_processes"] == 1
    assert set(summary["last_matrix"]) == {"0"}
    s2 = _stoke(tmp_path, "none", fleet=False)
    s2.train_step(*_batches(1)[0])
    s2.close_telemetry()
    assert s2.fleet is None and s2.fleet_summary is None
    assert all("fleet/hosts" not in r for r in read_step_events(
        str(tmp_path / "none" / "steps.jsonl")))


def test_fleet_straggler_lands_in_health_pipeline(tmp_path):
    """A synthetic straggler exchange surfaces as one fleet_straggler
    anomaly a completed streak; a bundle carries fleet.json; the streak
    completed on the last window is drained at close."""
    s = _stoke(tmp_path, "health",
               fleet_over={"straggler_windows": 2, "straggler_rel_frac": 0.5,
                           "straggler_action": "warn"},
               extra=(HealthConfig(dump_signals=False,
                                   detector_warmup_steps=100),))
    real = s.fleet._exchange

    def fake_exchange(vec):
        rows = [dict(port_fleet.unpack_fleet_vector(real(vec)[0]))
                for _ in range(2)]
        rows[1]["wall_s"] = rows[0]["wall_s"] + 10.0
        return _rows_matrix(port_fleet, rows).astype(np.float32)

    s.fleet._exchange = fake_exchange
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for x, y in _batches(5):
            s.train_step(x, y)
    assert s.health.anomaly_counts_by_detector() == {"fleet_straggler": 1}
    bundle = s.health.dump("test")
    with open(os.path.join(bundle, "fleet.json")) as f:
        payload = json.load(f)
    assert payload["last_verdict"]["flagged"]
    assert payload["last_verdict"]["host"] == 1
    assert len(payload["straggler_events"]) == 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s.close_telemetry()
    assert s.health.anomaly_counts_by_detector() == {"fleet_straggler": 2}


# ---------------------------------------------------------------------- #
# the world of 2
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    ctx = mp.get_context("spawn")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=worker.run,
                         args=(r, WORLD, store, str(tmp), {}))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        pytest.fail(f"ranks {hung} still ran after {JOIN_TIMEOUT_S} s")
    out = []
    for r in range(WORLD):
        path = os.path.join(tmp, f"rank{r}.pt")
        if not os.path.exists(path):
            pytest.fail(f"rank {r} wrote nothing (exit code "
                        f"{procs[r].exitcode})")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            pytest.fail(f"rank {r} raised:\n{res['error']}")
        out.append(res["fleet"])
    return out


def test_exchange_gives_every_rank_the_same_matrix(world):
    a, b = world
    assert a["matrices"][0] is None and b["matrices"][0] is None
    for ma, mb in zip(a["matrices"][1:], b["matrices"][1:]):
        assert ma.shape == (WORLD, len(port_fleet.FLEET_SIGNALS))
        np.testing.assert_array_equal(ma, mb)
    for res in world:
        closed = [r for r in res["records"] if r["fleet/hosts"] is not None]
        assert closed and all(r["fleet/hosts"] == WORLD for r in closed)
        assert "fleet/rebalance_shifts" in closed[0]


def test_loader_straggler_is_rebalanced(world):
    """Rank 1's read delay is flagged as a loader straggler and read rows
    move off it; both ranks hold the same shares."""
    a, b = world
    assert a["summary"]["straggler_anomalies"] >= 1
    events = a["summary"]["straggler_events"]
    assert events[0]["host"] == 1 and events[0]["skew_class"] == "loader"
    assert a["shifts"] == b["shifts"] >= 1
    assert a["final_shares"] == b["final_shares"]
    assert a["final_shares"][1] < worker.BATCH < a["final_shares"][0]
    assert a["summary"]["rebalance"]["shares"] == b["summary"]["rebalance"][
        "shares"]


def test_rebalanced_batches_equal_canonical_row_for_row(world):
    for res in world:
        assert len(res["batches"]) == worker.STEPS
        for got, want in zip(res["batches"], res["plan"]):
            assert got == [int(i) for i in want]
    # the shares moved while these batches were read
    assert any(s != [worker.BATCH] * WORLD for s in world[0]["shares"])


FLEET_INVALID = [dict(window_steps=0), dict(straggler_zscore=0.0),
                 dict(straggler_rel_frac=-0.5), dict(straggler_windows=0),
                 dict(straggler_action="explode"),
                 dict(straggler_action="halt"),
                 dict(rebalance=True, rebalance_rows=0),
                 dict(rebalance=True, rebalance_max_frac=1.5)]


@pytest.mark.parametrize("kw", FLEET_INVALID, ids=str)
def test_status_rules_have_the_jax_messages(kw):
    from stoke_tpu import StokeStatus as JaxStatus
    from stoke_tpu import TelemetryConfig as JaxTelemetryConfig
    from stoke_tpu_torch.status import StokeStatus, StokeValidationError

    with pytest.raises(StokeValidationError) as port:
        StokeStatus(batch_size_per_device=4, device="cpu",
                    configs=[TelemetryConfig(prometheus=False),
                             FleetConfig(**kw)])
    with pytest.raises(Exception) as ref:
        JaxStatus(batch_size_per_device=4,
                  configs=[JaxTelemetryConfig(prometheus=False),
                           JaxFleetConfig(**kw)])
    assert str(port.value) == str(ref.value)


def test_yaml_builds_the_fleet_and_plane_as_jax_does(tmp_path):
    from stoke_tpu.utils import stoke_kwargs_from_config as jax_kwargs
    from stoke_tpu_torch.status import StokeStatus
    from stoke_tpu_torch.utils import stoke_kwargs_from_config

    doc = {"batch_size_per_device": 4, "configs": {
        "TelemetryConfig": {"output_dir": str(tmp_path), "prometheus": False},
        "FleetConfig": {"window_steps": 5, "straggler_zscore": 2.5,
                        "straggler_action": "dump", "rebalance": True},
        "OpsPlaneConfig": {"port": 0, "requests_limit": 8}}}
    port = {type(c).__name__: c
            for c in stoke_kwargs_from_config(doc)["configs"]}
    ref = {type(c).__name__: c for c in jax_kwargs(doc)["configs"]}
    for name in ("FleetConfig", "OpsPlaneConfig"):
        assert vars(port[name]) == vars(ref[name])
    st = StokeStatus(batch_size_per_device=4, device="cpu",
                     configs=list(port.values()))
    assert st.fleet_config.window_steps == 5
    assert st.opsplane_config.requests_limit == 8
