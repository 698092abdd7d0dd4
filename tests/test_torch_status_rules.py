"""Port parity: every config class and every status rule.

The spec is the JAX package's ``StokeStatus``: each row of
``tests/test_status.py``'s ``MATRIX`` (loaded by path, not copied) goes
through both packages. A row the JAX package rejects is rejected by the
port with ``StokeValidationError`` and the same message; a row it accepts
gives the port a status, or a ``NotImplementedError`` naming the ROADMAP
item of a later slice, raised only after the legality rules. Then each of
the 29 config classes has the JAX fields and defaults, ``to_dict`` the JAX
keys, and each rule function an illegal config whose message is the JAX
package's, letter for letter.
"""

import dataclasses
import enum
import importlib.util
from pathlib import Path

import pytest

import stoke_tpu.configs as jc
from stoke_tpu import StokeValidationError as JaxValidationError
from stoke_tpu.status import StokeStatus as JaxStatus
from stoke_tpu_torch import configs as pc
from stoke_tpu_torch.status import (
    LATER_CONFIGS,
    StokeStatus,
    StokeValidationError,
)

pytestmark = pytest.mark.torch_port

LATER = "not ported yet: ROADMAP Queue 1 item"
_SPEC = importlib.util.spec_from_file_location(
    "jax_status_spec", Path(__file__).with_name("test_status.py"))
JAX_SPEC = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(JAX_SPEC)


def port_value(v):
    """A JAX config object (or enum, or container of them) as the port's."""
    if isinstance(v, enum.Enum):
        return getattr(pc, type(v).__name__)(v.value)
    if dataclasses.is_dataclass(v):
        cls = getattr(pc, type(v).__name__)
        return cls(**{f.name: port_value(getattr(v, f.name))
                      for f in dataclasses.fields(v)})
    if isinstance(v, (list, tuple)):
        return type(v)(port_value(x) for x in v)
    return v


def port_kwargs(kwargs):
    """The row's flags for the port: its own config classes, and the JAX
    package's default device ``cpu`` stated (the port's default is the
    card); the JAX accelerator ``tpu`` is the port's ``cuda``."""
    out = {k: port_value(v) for k, v in kwargs.items()}
    out["device"] = {"tpu": "cuda"}.get(out.get("device", "cpu"),
                                        out.get("device", "cpu"))
    return out


def outcome(make):
    """("ok", status) / ("invalid", message) / ("later", message)."""
    try:
        return "ok", make()
    except (JaxValidationError, StokeValidationError) as e:
        return "invalid", str(e)
    except NotImplementedError as e:
        return "later", str(e)


def assert_same_verdict(jax_kwargs, kwargs):
    jax = outcome(lambda: JaxStatus(**jax_kwargs))
    ours = outcome(lambda: StokeStatus(**kwargs))
    assert jax[0] in ("ok", "invalid")
    if jax[0] == "invalid":
        assert ours == jax, (jax, ours)
    else:
        assert ours[0] in ("ok", "later"), ours
        if ours[0] == "later":
            assert LATER in ours[1]
    return ours


@pytest.mark.parametrize("kwargs,should_raise", JAX_SPEC.MATRIX)
def test_jax_matrix_row(kwargs, should_raise):
    ours = assert_same_verdict(kwargs, port_kwargs(kwargs))
    assert (ours[0] == "invalid") == should_raise


@pytest.mark.parametrize("cls", jc.ALL_CONFIG_CLASSES,
                         ids=lambda c: c.__name__)
def test_config_class_fields_and_defaults(cls):
    ours = getattr(pc, cls.__name__)
    assert ours in pc.ALL_CONFIG_CLASSES
    fields = lambda c: [(f.name, f.type, f.default) for f in
                        dataclasses.fields(c)]
    theirs = [(n, t, d.value if isinstance(d, enum.Enum) else d)
              for n, t, d in fields(cls)]
    mine = [(n, t, d.value if isinstance(d, enum.Enum) else d)
            for n, t, d in fields(ours)]
    assert mine == theirs
    assert pc.asdict_config(ours()) == jc.asdict_config(cls())


def test_config_tuple_enums_and_helpers():
    assert ([c.__name__ for c in pc.ALL_CONFIG_CLASSES]
            == [c.__name__ for c in jc.ALL_CONFIG_CLASSES])
    for name in ("ShardingOptions", "LossReduction", "CheckpointFormat",
                 "PrecisionOptions", "ParamNormalize"):
        assert ([(e.name, e.value) for e in getattr(pc, name)]
                == [(e.name, e.value) for e in getattr(jc, name)])
    for name in ("COMM_DTYPES", "COMM_STRATEGIES", "HEALTH_ACTIONS",
                 "FLEET_ACTIONS", "SERVE_ATTENTION_KERNELS",
                 "SERVE_DECODE_KERNELS", "SERVE_QUANT_MODES",
                 "SERVE_KV_DTYPES"):
        assert getattr(pc, name) == getattr(jc, name)
    for dtype in ("fp32", "bf16", "int8"):
        for shard in (None, True, False):
            for tier in jc.ShardingOptions:
                assert pc.comm_shard_updates(
                    pc.CommConfig(dtype=dtype, shard_updates=shard),
                    pc.ShardingOptions(tier.value)) == jc.comm_shard_updates(
                    jc.CommConfig(dtype=dtype, shard_updates=shard), tier)
    assert pc.comm_shard_updates(None, pc.ShardingOptions.fsdp) is False
    # every class the port does not honour names its item
    honoured = {"PrecisionConfig", "ClipGradConfig", "ClipGradNormConfig",
                "CheckpointConfig", "ServeConfig", "TensorboardConfig",
                "DataParallelConfig", "MeshConfig", "DistributedInitConfig",
                "OSSConfig", "SDDPConfig", "FSDPConfig", "CommConfig",
                "TelemetryConfig", "TraceConfig", "HealthConfig",
                "ProfilerConfig", "ResilienceConfig",
                "OffloadOptimizerConfig", "OffloadDiskConfig",
                "OffloadParamsConfig", "AttributionConfig", "MemoryConfig",
                "NumericsConfig", "ActivationCheckpointingConfig",
                "FleetConfig", "OpsPlaneConfig", "PartitionRulesConfig",
                "CompileConfig"}
    assert set(LATER_CONFIGS) == {c.__name__ for c in
                                  pc.ALL_CONFIG_CLASSES} - honoured


#: classes refused here until their item landed, each now a case that
#: shows the status layer takes it (by the status property that holds it)
NOW_HONOURED = {"CommConfig": "comm_config",
                "HealthConfig": "health_config",
                "ProfilerConfig": "profiler_config",
                "TelemetryConfig": "telemetry_config",
                "TraceConfig": "trace_config",
                "OffloadDiskConfig": "offload_disk_config",
                "OffloadOptimizerConfig": "offload_optimizer_config",
                "OffloadParamsConfig": "offload_params_config",
                "ResilienceConfig": "resilience_config",
                "AttributionConfig": "attribution_config",
                "MemoryConfig": "memory_config",
                "NumericsConfig": "numerics_config",
                "ActivationCheckpointingConfig":
                    "activation_checkpointing_config",
                "FleetConfig": "fleet_config",
                "OpsPlaneConfig": "opsplane_config",
                "PartitionRulesConfig": "partition_rules_config",
                "CompileConfig": "compile_config"}
#: the item each refused class names (none is refused now: the compile
#: cache of item 11 runs)
LATER_ITEMS: dict = {}


@pytest.mark.parametrize("name", sorted(LATER_CONFIGS) + list(NOW_HONOURED))
def test_each_later_class_is_refused_naming_its_item(name, tmp_path):
    """Every class the port does not run raises naming its ROADMAP item;
    those of items 7, 8b, 9, 10a, 10b, 10c, 10d, 11 and 13 run now and the
    status holds them."""
    kw = dict(batch_size_per_device=8, device="cpu")
    needs_dp = {"CommConfig", "MeshConfig", "PartitionRulesConfig"}
    needs_tel = {"AttributionConfig", "FleetConfig", "NumericsConfig",
                 "MemoryConfig", "OpsPlaneConfig", "HealthConfig"}
    cfgs = {"AttributionConfig": dict(peak_tflops=989.0),
            "ProfilerConfig": dict(trace_dir=None),
            "TelemetryConfig": dict(jsonl=False, prometheus=False),
            "TraceConfig": dict(export_on_close=False),
            "CompileConfig": dict(cache_dir=str(tmp_path / "cache")),
            "ResilienceConfig": dict(save_path=str(tmp_path / "res"))}
    configs = [getattr(pc, name)(**cfgs.get(name, {}))]
    if name in needs_dp:
        kw["distributed"] = "dp"
    if name in needs_tel:
        configs.append(pc.TelemetryConfig(jsonl=False, prometheus=False))
    if name == "OffloadParamsConfig":
        kw.update(distributed="dp", fsdp=True)
    if name in NOW_HONOURED:
        st = StokeStatus(configs=configs, **kw)
        assert type(getattr(st, NOW_HONOURED[name])).__name__ == name
        assert name not in LATER_CONFIGS
        return
    with pytest.raises(NotImplementedError) as e:
        StokeStatus(configs=configs, **kw)
    msg = str(e.value)
    assert LATER in msg and msg.startswith("Stoke -- ")
    assert name in msg
    assert LATER_CONFIGS[name] in msg
    if name in LATER_ITEMS:
        assert f"{LATER} {LATER_ITEMS[name]} " in msg


def test_legality_comes_before_the_refusal():
    """An illegal later-slice config raises the JAX package's
    StokeValidationError, never NotImplementedError."""
    for cfgs, flags in (([pc.HealthConfig(ring_size=0)], {}),
                        ([pc.MeshConfig(axes=("data", "data"))],
                         {"distributed": "dp"}),
                        ([pc.ActivationCheckpointingConfig(policy="x")], {}),
                        ([pc.FSDPConfig(shard_axis_preference="big")], {})):
        with pytest.raises(StokeValidationError):
            StokeStatus(batch_size_per_device=4, device="cpu",
                        configs=cfgs, **flags)


def test_tpu_is_refused_with_the_valid_devices():
    with pytest.raises(StokeValidationError,
                       match=r"Unknown device option 'tpu'; valid: "
                             r"\['cpu', 'cuda'\]"):
        StokeStatus(batch_size_per_device=4, device="tpu")


def _blocked(tmp_path):
    """A path under a regular file: no directory can be made there."""
    f = tmp_path / "blocker"
    f.write_text("x")
    return str(f / "sub")


# one illegal config per rule function of the JAX table (and a few rules
# with several arms), as a function of a tmp dir -> kwargs of JAX objects
RULE_CASES = {
    "mesh_duplicate_axes": lambda t: dict(
        distributed="dp", configs=[jc.MeshConfig(axes=("data", "data"))]),
    "mesh_shape_len": lambda t: dict(
        distributed="dp", configs=[jc.MeshConfig(axes=("data",),
                                                 shape=(2, 2))]),
    "mesh_without_dp": lambda t: dict(configs=[jc.MeshConfig()]),
    "rules_without_dp": lambda t: dict(
        configs=[jc.PartitionRulesConfig()]),
    "partition_axis": lambda t: dict(
        distributed="dp",
        configs=[jc.PartitionRulesConfig(rules=(("k", ("model",)),))]),
    "seq_axis_no_dp": lambda t: dict(
        configs=[jc.DataParallelConfig(shard_seq_dim=1)]),
    "seq_axis_missing": lambda t: dict(
        distributed="dp", configs=[jc.DataParallelConfig(shard_seq_dim=1)]),
    "tier_axis": lambda t: dict(
        distributed="dp", oss=True,
        configs=[jc.MeshConfig(axes=("model",))]),
    "sddp_without_oss": lambda t: dict(distributed="dp", sddp=True),
    "fsdp_with_oss": lambda t: dict(distributed="dp", fsdp=True, oss=True),
    "tier_without_dp": lambda t: dict(oss=True),
    "num_losses": lambda t: dict(configs=[jc.PrecisionConfig(num_losses=2)]),
    "clip_value": lambda t: dict(grad_clip=jc.ClipGradConfig(0.0)),
    "clip_norm": lambda t: dict(grad_clip=jc.ClipGradNormConfig(
        max_norm=1.0, norm_type=0.5)),
    "tensorboard": lambda t: dict(configs=[jc.TensorboardConfig(
        output_path=_blocked(t))]),
    "telemetry_cadence": lambda t: dict(configs=[jc.TelemetryConfig(
        log_every_n_steps=0)]),
    "telemetry_path": lambda t: dict(configs=[jc.TelemetryConfig(
        output_dir=_blocked(t), jsonl_all_ranks=True)]),
    "profiler": lambda t: dict(configs=[jc.ProfilerConfig(
        trace_dir=_blocked(t))]),
    "comm_no_dp": lambda t: dict(configs=[jc.CommConfig()]),
    "comm_dtype": lambda t: dict(distributed="dp",
                                 configs=[jc.CommConfig(dtype="fp8")]),
    "comm_bucket": lambda t: dict(distributed="dp",
                                  configs=[jc.CommConfig(bucket_mb=0)]),
    "comm_fp16": lambda t: dict(distributed="dp", precision="fp16",
                                configs=[jc.CommConfig(dtype="int8")]),
    "comm_axis": lambda t: dict(
        distributed="dp",
        configs=[jc.CommConfig(dtype="int8"),
                 jc.MeshConfig(axes=("model",))]),
    "health_sentinels": lambda t: dict(configs=[jc.HealthConfig()]),
    "health_action": lambda t: dict(configs=[
        jc.HealthConfig(sentinels=False, grad_spike_action="panic")]),
    "health_halt_fp16": lambda t: dict(precision="fp16", configs=[
        jc.HealthConfig(sentinels=False, nonfinite_action="halt")]),
    "health_watchdog": lambda t: dict(configs=[
        jc.HealthConfig(sentinels=False, watchdog=True,
                        watchdog_timeout_s=0)]),
    "health_streak": lambda t: dict(configs=[
        jc.HealthConfig(sentinels=False, starvation_streak=0)]),
    "attribution_no_telemetry": lambda t: dict(configs=[
        jc.AttributionConfig(peak_tflops=1.0)]),
    "attribution_peak": lambda t: dict(configs=[
        jc.AttributionConfig(),
        jc.TelemetryConfig(output_dir=str(t / "tel"))]),
    "attribution_capture": lambda t: dict(configs=[
        jc.AttributionConfig(peak_tflops=1.0, auto_capture=True),
        jc.TelemetryConfig(output_dir=str(t / "tel"))]),
    "attribution_action": lambda t: dict(configs=[
        jc.AttributionConfig(peak_tflops=1.0, capture_action="halt"),
        jc.TelemetryConfig(output_dir=str(t / "tel"))]),
    "fleet": lambda t: dict(configs=[
        jc.FleetConfig(straggler_action="halt"),
        jc.TelemetryConfig(output_dir=str(t / "tel"))]),
    "fleet_rebalance": lambda t: dict(configs=[
        jc.FleetConfig(rebalance=True, rebalance_max_frac=1.0),
        jc.TelemetryConfig(output_dir=str(t / "tel"))]),
    "numerics": lambda t: dict(configs=[
        jc.NumericsConfig(grad_stats=False, provenance_action="dump"),
        jc.TelemetryConfig(output_dir=str(t / "tel"))]),
    "numerics_no_telemetry": lambda t: dict(configs=[jc.NumericsConfig()]),
    "memory": lambda t: dict(configs=[
        jc.MemoryConfig(oom_margin_frac=0.0),
        jc.TelemetryConfig(output_dir=str(t / "tel"))]),
    "opsplane": lambda t: dict(configs=[
        jc.OpsPlaneConfig(profile_default_seconds=60.0),
        jc.TelemetryConfig(output_dir=str(t / "tel"))]),
    "checkpoint_cadence": lambda t: dict(configs=[
        jc.CheckpointConfig(save_every_n_steps=5)]),
    "checkpoint_staging": lambda t: dict(configs=[
        jc.CheckpointConfig(offload_staging=True)]),
    "resilience_exit": lambda t: dict(configs=[
        jc.ResilienceConfig(exit_code=113, save_path=str(t / "r"))]),
    "resilience_signal": lambda t: dict(configs=[
        jc.ResilienceConfig(preempt_signals=("SIGNOPE",),
                            save_path=str(t / "r"))]),
    "resilience_chaos": lambda t: dict(configs=[
        jc.ResilienceConfig(chaos="corrupt_save=0,kill_at_step=0",
                            save_path=str(t / "r"))]),
    "resilience_chaos_key": lambda t: dict(configs=[
        jc.ResilienceConfig(chaos="kill_at=3", save_path=str(t / "r"))]),
    "resilience_collision": lambda t: dict(configs=[
        jc.ResilienceConfig(save_path=str(t / "a"), save_name="auto"),
        jc.CheckpointConfig(auto_path=str(t / "a"))]),
    "resilience_path": lambda t: dict(configs=[
        jc.ResilienceConfig(save_path=_blocked(t))]),
    "compile_layers": lambda t: dict(configs=[
        jc.CompileConfig(aot=False, xla_cache=False,
                         cache_dir=str(t / "c"))]),
    "compile_path": lambda t: dict(configs=[
        jc.CompileConfig(cache_dir=_blocked(t))]),
    "serve_sizes": lambda t: dict(configs=[jc.ServeConfig(max_seqs=0)]),
    "serve_cost_cards": lambda t: dict(device="tpu", configs=[
        jc.ServeConfig(cost_cards=True)]),
    "serve_cost_cards_hbm": lambda t: dict(device="tpu", configs=[
        jc.ServeConfig(cost_cards=True),
        jc.AttributionConfig(peak_tflops=1.0),
        jc.TelemetryConfig(output_dir=str(t / "tel"))]),
    "trace": lambda t: dict(configs=[jc.TraceConfig(ring_size=0)]),
    "trace_path": lambda t: dict(configs=[
        jc.TraceConfig(output_dir=_blocked(t))]),
    "remat": lambda t: dict(configs=[
        jc.ActivationCheckpointingConfig(policy="save_everything")]),
    "precision_scaler": lambda t: dict(configs=[
        jc.PrecisionConfig(backoff_factor=2.0)]),
    "precision_growth": lambda t: dict(configs=[
        jc.PrecisionConfig(growth_interval=0)]),
    "fsdp_preference": lambda t: dict(configs=[
        jc.FSDPConfig(shard_axis_preference="smallest")]),
    "offload_cpu": lambda t: dict(configs=[
        jc.OffloadParamsConfig(fallback_to_device=False)]),
    "offload_params_fsdp": lambda t: dict(configs=[
        jc.OffloadParamsConfig()]),
    "offload_tiers": lambda t: dict(configs=[
        jc.OffloadDiskConfig(), jc.OffloadOptimizerConfig()]),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_messages_match_jax(case, tmp_path):
    kwargs = dict(batch_size_per_device=8, **RULE_CASES[case](tmp_path))
    with pytest.raises(JaxValidationError) as jax_err:
        JaxStatus(**kwargs)
    with pytest.raises(StokeValidationError) as ours:
        StokeStatus(**port_kwargs(kwargs))
    assert str(ours.value) == str(jax_err.value)


@pytest.mark.parametrize("extra", [
    [], [pc.TensorboardConfig], [pc.CheckpointConfig, pc.ServeConfig]])
def test_to_dict_keys_equal_the_jax_dict(extra, tmp_path):
    def build(mod, status_cls):
        cfgs = [getattr(mod, c.__name__)() for c in extra]
        for c in cfgs:
            if hasattr(c, "output_path"):
                c.output_path = str(tmp_path / "tb")
        device = "cpu"
        st = status_cls(batch_size_per_device=4, grad_accum=2,
                        precision="bf16", device=device, configs=cfgs,
                        grad_clip=mod.ClipGradNormConfig(max_norm=1.0))
        st.set_post_init_values(world_size=1)
        for prop in ("precision_config", "dp_config", "mesh_config",
                     "dist_init_config", "oss_config", "sddp_config",
                     "fsdp_config", "checkpoint_config", "profiler_config"):
            getattr(st, prop)
        return st.to_dict()

    ours, theirs = build(pc, StokeStatus), build(jc, JaxStatus)
    assert list(ours) == list(theirs)
    assert list(ours["configs"]) == list(theirs["configs"])
    for name, fields in theirs["configs"].items():
        assert ours["configs"][name] == fields
    assert {k: v for k, v in ours.items() if k != "configs"} == {
        k: v for k, v in theirs.items() if k != "configs"}


def test_properties_match_the_jax_status():
    kw = dict(batch_size_per_device=4, device="cpu")
    ours, theirs = StokeStatus(**kw), JaxStatus(**kw)
    for prop in ("dp_config", "mesh_config", "dist_init_config",
                 "oss_config", "sddp_config", "fsdp_config",
                 "profiler_config", "checkpoint_config"):
        assert pc.asdict_config(getattr(ours, prop)) == jc.asdict_config(
            getattr(theirs, prop)), prop
    for prop in ("comm_config", "partition_rules_config",
                 "offload_optimizer_config", "offload_params_config",
                 "offload_disk_config", "activation_checkpointing_config",
                 "tensorboard_config", "health_config",
                 "attribution_config", "fleet_config", "numerics_config",
                 "memory_config", "opsplane_config", "resilience_config",
                 "compile_config", "serve_config", "telemetry_config",
                 "trace_config"):
        assert getattr(ours, prop) is None and getattr(theirs, prop) is None
    assert ours.sharding_tier is pc.ShardingOptions.none
