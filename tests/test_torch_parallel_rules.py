"""Port parity: the data-parallel rules, without spawning.

- the port's leaf rule (``stoke_tpu_torch.parallel.sharding
  .leaf_partition_spec``, a dimension or None) against the JAX package's
  (a ``PartitionSpec``) over shapes x W x preferences x min sizes;
- the tier ladder against the JAX package's rules on a W-device mesh, and
  the port's one-shard split at W=1;
- the mesh's shape rule and its errors against ``build_mesh``'s;
- the status layer: ``distributed`` and its aliases, the tiers and the
  data-parallel config classes accepted; the options of later items
  refused naming them;
- a one-process group (world 1, gloo): every tier trains bit for bit as
  one device does, saves and loads, and the CIFAR-10 example's documents
  build and step.

The one-process group is made once for the module and destroyed after.
"""

import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import stoke_tpu.configs as jc
from stoke_tpu.parallel.mesh import build_mesh as jax_build_mesh
from stoke_tpu.parallel.sharding import leaf_partition_spec as jax_leaf_spec
from stoke_tpu.parallel.sharding import make_sharding_rules as jax_rules
from stoke_tpu_torch import Stoke, StokeOptimizer
from stoke_tpu_torch import configs as pc
from stoke_tpu_torch.models.resnet import BasicBlock, ResNet
from stoke_tpu_torch.parallel import (
    leaf_partition_spec,
    make_sharding_rules,
    mesh_shape,
)
from stoke_tpu_torch.status import StokeStatus
from stoke_tpu_torch.utils import stoke_from_example

pytestmark = pytest.mark.torch_port

SHAPES = [(64, 16), (16, 64), (7, 5), (8,), (), (3, 2), (8, 2), (8, 64),
          (7, 64), (12, 8, 4), (4, 4, 4, 4), (1024,), (6, 10), (2, 3, 4)]
LATER = "not ported yet: ROADMAP Queue 1 item"
EXAMPLE_DIR = Path(__file__).resolve().parent.parent / "examples/cifar10/config"


def _dim(spec) -> object:
    """The JAX ``PartitionSpec``'s sharded dimension, or None."""
    dims = [i for i, a in enumerate(spec) if a == "data"]
    return dims[0] if dims else None


@pytest.mark.parametrize("min_size", [0, 16, 1000])
@pytest.mark.parametrize("preference", ["largest", "first"])
@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_leaf_rule_matches_jax(shape, world, preference, min_size):
    want = _dim(jax_leaf_spec(shape, "data", world, min_size, preference))
    assert leaf_partition_spec(shape, world, min_size, preference) == want


TIER_FLAGS = {"none": (False, False, False), "oss": (False, False, True),
              "sddp": (False, True, True), "fsdp": (True, True, True)}


def _rules(tier, world, port=True):
    cfgs = (dict(min_shard_size=64), dict(min_shard_size=128),
            dict(min_weight_size=256, shard_axis_preference="first"))
    if port:
        return make_sharding_rules(
            pc.ShardingOptions(tier), world, pc.OSSConfig(**cfgs[0]),
            pc.SDDPConfig(**cfgs[1]), pc.FSDPConfig(**cfgs[2]))
    mesh = jax_build_mesh(jc.MeshConfig(devices=jax.devices("cpu")[:world]),
                          jc.DeviceOptions.cpu, True)
    return jax_rules(jc.ShardingOptions(tier), mesh, "data",
                     jc.OSSConfig(**cfgs[0]), jc.SDDPConfig(**cfgs[1]),
                     jc.FSDPConfig(**cfgs[2]))


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("tier", list(TIER_FLAGS))
def test_tier_ladder_matches_jax(tier, world):
    """Which of params, grads and optimizer state each tier shards, and
    along which dimension, at the three configs' own thresholds."""
    mine, theirs = _rules(tier, world), _rules(tier, world, port=False)
    assert mine.tier.value == tier and mine.axis_size == world
    for shape in SHAPES:
        assert mine.param_dim(shape) == _dim(theirs.param_spec(shape))
        assert mine.grad_dim(shape) == _dim(theirs.grad_spec(shape))
        assert mine.opt_dim(shape) == _dim(theirs.opt_spec(shape))
    big = (16, 64)
    assert tuple(f(big) is not None for f in (
        mine.param_dim, mine.grad_dim, mine.opt_dim)) == TIER_FLAGS[tier]


@pytest.mark.parametrize("tier", list(TIER_FLAGS))
def test_one_device_axis_splits_into_one_shard(tier):
    """At W=1 the JAX rule replicates every leaf; the port's rules split a
    leaf into one shard (the same placement), along the dimension the rule
    picks when every dimension divides, so a one-process run takes the
    sharded path."""
    mine = _rules(tier, 1)
    for shape in SHAPES:
        assert jax_leaf_spec(shape, "data", 1) == P()
        for fn, sharded in zip((mine.param_dim, mine.grad_dim,
                                mine.opt_dim), TIER_FLAGS[tier]):
            if not sharded:
                assert fn(shape) is None
    assert mine.opt_dim((8, 64)) == (None if tier == "none" else
                                     0 if tier == "fsdp" else 1)
    assert mine.opt_dim((3, 2)) is None  # under every min size


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [None, (-1,), (1,), (2,), (3,), (8,)],
                         ids=str)
def test_mesh_shape_matches_jax(shape, n):
    cfg = jc.MeshConfig(shape=shape, devices=jax.devices("cpu")[:n])
    try:
        want = tuple(jax_build_mesh(cfg, jc.DeviceOptions.cpu,
                                    True).devices.shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            mesh_shape(shape, n)
        return
    assert mesh_shape(shape, n) == want


@pytest.mark.parametrize("alias", ["dp", "ddp", "horovod", "deepspeed",
                                   "xla"])
@pytest.mark.parametrize("tier", [{}, dict(oss=True),
                                  dict(oss=True, sddp=True),
                                  dict(fsdp=True)], ids=str)
def test_status_accepts_the_ladder(alias, tier):
    st = StokeStatus(batch_size_per_device=4, device="cpu",
                     distributed=alias, configs=[
                         pc.DataParallelConfig(), pc.MeshConfig(),
                         pc.DistributedInitConfig(), pc.OSSConfig(),
                         pc.SDDPConfig(), pc.FSDPConfig()], **tier)
    assert st.distributed is pc.DistributedOptions.dp
    assert st.sharding_tier.value == (
        "fsdp" if tier.get("fsdp") else "sddp" if tier.get("sddp")
        else "oss" if tier.get("oss") else "none")
    st.set_post_init_values(world_size=4, n_processes=4)
    assert st.effective_batch_size == 16 and st.world_size == 4


REFUSED = {
    "shard_seq_dim": ([pc.DataParallelConfig(shard_seq_dim=1),
                       pc.MeshConfig(axes=("data", "seq"))], "8a"),
    "two_axes": ([pc.MeshConfig(axes=("data", "model"))], "8b"),
    "dcn_axes": ([pc.MeshConfig(dcn_axes=("data",))], "8e"),
    "comm": ([pc.CommConfig()], "7"),
    "partition_rules": ([pc.PartitionRulesConfig(rules=(("w", ("data",)),))],
                        "8b"),
    "seq_axis_tiers": ([pc.DataParallelConfig(shard_seq_dim=1),
                        pc.MeshConfig(axes=("data", "seq"))], "8d"),
    "tp_tiers": ([pc.MeshConfig(axes=("data", "model"), shape=(1, 2)),
                  pc.PartitionRulesConfig(rules=(
                      ("ff_in/kernel", (None, "model")),))], "8d"),
    "offload": ([pc.OffloadOptimizerConfig()], "9"),
    "sharded_format": ([pc.CheckpointConfig(
        format=pc.CheckpointFormat.sharded)], "6b"),
}


#: options refused here until their item landed (the transports, item 7,
#: the sharded checkpoint format, item 6b, optimizer offload, item 9, the
#: (data, seq) mesh with shard_seq_dim, item 8a, a (data, model) mesh
#: and partition rules, item 8b, a tier under a seq axis or a model
#: axis of two, item 8d, and dcn_axes, item 8e): each case now shows the
#: status layer takes them
LANDED = ("comm", "sharded_format", "offload", "shard_seq_dim", "two_axes",
          "partition_rules", "seq_axis_tiers", "tp_tiers", "dcn_axes")
#: the flags of a case (a tier under a seq axis, or under a model axis of
#: two, item 8d)
REFUSED_FLAGS = {"seq_axis_tiers": dict(oss=True), "tp_tiers": dict(oss=True)}


@pytest.mark.parametrize("case", list(REFUSED))
def test_later_options_name_their_item(case):
    configs, item = REFUSED[case]
    if case in LANDED:
        st = StokeStatus(batch_size_per_device=4, device="cpu",
                         distributed="dp", configs=configs,
                         **REFUSED_FLAGS.get(case, {}))
        if case in REFUSED_FLAGS:
            assert st.sharding_tier.value == "oss"
        assert (st.comm_config is not None
                or st.offload_optimizer_config is not None
                or st.checkpoint_config.format is pc.CheckpointFormat.sharded
                or (st.dp_config.shard_seq_dim == 1
                    and st.mesh_config.axes == ("data", "seq"))
                or st.mesh_config.axes == ("data", "model")
                or st.partition_rules_config is not None
                or st.mesh_config.dcn_axes == ("data",))
        return
    with pytest.raises(NotImplementedError, match=f"{LATER} {item}\\b"):
        StokeStatus(batch_size_per_device=4, device="cpu", distributed="dp",
                    configs=configs, **REFUSED_FLAGS.get(case, {}))


@pytest.mark.parametrize("env,present", [
    ({}, False),
    ({"RANK": "0", "WORLD_SIZE": "2"}, False),
    ({"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "h"}, True),
    ({"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "h"}, False),
    ({"RANK": "0", "WORLD_SIZE": "x", "MASTER_ADDR": "h"}, False)], ids=str)
def test_launcher_environment(monkeypatch, env, present):
    """torchrun's variables mean a rank of several; a world of one is
    no launch."""
    from stoke_tpu_torch.parallel.mesh import _multihost_env_present

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _multihost_env_present() is present


@pytest.mark.parametrize("ids,env,want", [
    (None, None, 0), (None, "3", 3), ((2,), "3", 2), ((0, 1), None, None)])
def test_local_rank_is_one_device(monkeypatch, ids, env, want):
    from stoke_tpu_torch.parallel.mesh import local_rank

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if env is not None:
        monkeypatch.setenv("LOCAL_RANK", env)
    cfg = pc.DistributedInitConfig(local_device_ids=ids)
    if want is None:
        with pytest.raises(ValueError, match="drives one device"):
            local_rank(cfg)
    else:
        assert local_rank(cfg) == want


def test_explicit_rendezvous_needs_every_field():
    from stoke_tpu_torch.parallel import initialize_distributed

    with pytest.raises(ValueError, match="coordinator_address, "
                                         "num_processes and process_id"):
        initialize_distributed(pc.DistributedInitConfig(num_processes=2),
                               torch.device("cpu"))


# ---------------------------------------------------------------------- #
# a one-process group
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def one_process():
    """The process group the first ``distributed="dp"`` Stoke makes, torn
    down after the module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(8, 64), torch.nn.ReLU(),
                               torch.nn.Linear(64, 4))


def _stoke(**kw):
    kw.setdefault("configs", [pc.OSSConfig(min_shard_size=1),
                              pc.SDDPConfig(min_shard_size=1),
                              pc.FSDPConfig(min_weight_size=1)])
    return Stoke(_mlp(), StokeOptimizer(torch.optim.AdamW, lr=1e-2),
                 lambda o, y: ((o - y) ** 2).mean(), batch_size_per_device=16,
                 device="cpu", **kw)


def _train(s, n=4):
    r = np.random.default_rng(0)
    losses = []
    for _ in range(n):
        x = torch.from_numpy(r.normal(size=(16, 8)).astype(np.float32))
        y = torch.from_numpy(r.normal(size=(16, 4)).astype(np.float32))
        losses.append(s.train_step(x, y))
    with s._whole_params():
        return torch.stack(losses), [p.detach().clone()
                                     for p in s.model_access.parameters()]


TIERS = {"dp": {}, "oss": dict(oss=True), "sddp": dict(oss=True, sddp=True),
         "fsdp": dict(fsdp=True)}
SETUPS = {"fp32": {}, "bf16": dict(precision="bf16"),
          "fp16": dict(precision="fp16"), "accum": dict(grad_accum=2),
          "clip": dict(grad_clip=pc.ClipGradNormConfig(max_norm=0.1))}


@pytest.mark.parametrize("setup", list(SETUPS))
@pytest.mark.parametrize("tier", list(TIERS))
def test_one_process_group_trains_as_one_device(one_process, tier, setup):
    """World 1: the sharded path's collectives run (one shard a leaf) and
    the numbers are one device's, bit for bit."""
    want_l, want_p = _train(_stoke(**SETUPS[setup]))
    s = _stoke(distributed="dp", **TIERS[tier], **SETUPS[setup])
    assert dist.get_backend() == "gloo"
    assert (s.world_size, s.rank, s.n_processes) == (1, 0, 1)
    assert s.is_distributed and s.effective_batch_size == 16 * s.grad_accum
    got_l, got_p = _train(s)
    assert torch.equal(got_l, want_l)
    assert all(torch.equal(a, b) for a, b in zip(got_p, want_p))
    if tier == "fsdp":
        assert all(p.untyped_storage().nbytes() == 0
                   for p in s.model_access.parameters())


@pytest.mark.parametrize("tier", list(TIERS))
def test_one_process_group_saves_and_loads(one_process, tier, tmp_path):
    """A world of one saves as one device does, mid-window too, and a
    fresh run that loads the tag continues bit for bit."""
    a = _stoke(distributed="dp", grad_accum=2, **TIERS[tier])
    _train(a, 3)
    tag = a.save(str(tmp_path))
    want_l, want_p = _train(a, 3)
    b = _stoke(distributed="dp", grad_accum=2, **TIERS[tier])
    b.load(str(tmp_path), tag=tag.rsplit("/", 1)[-1])
    assert b.grad_accum_counter == 1
    got_l, got_p = _train(b, 3)
    assert torch.equal(got_l, want_l)
    assert all(torch.equal(x, y) for x, y in zip(got_p, want_p))


def test_serve_under_dp_serves_the_replicated_model(one_process):
    """Under plain dp every rank holds the whole model: ``serve()`` builds
    the engine and emits the tokens a one-device run's engine emits."""
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss

    serve = pc.ServeConfig(max_seqs=2, kv_block_size=8, max_seq_len=32,
                           max_new_tokens=4, prefill_pad_multiple=16)
    prompt = np.random.default_rng(7).integers(1, 97, size=6).astype(
        np.int32)
    tokens = []
    for flags in ({}, dict(distributed="dp")):
        model = GPT(vocab_size=97, size_name="tiny", max_len=32,
                    dropout_rate=0.0)
        model.init_weights(0)
        s = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.1),
                  causal_lm_loss, batch_size_per_device=2, device="cpu",
                  configs=[serve], **flags)
        engine = s.serve()
        rid = engine.submit(prompt)
        engine.run()
        tokens.append(list(engine.result(rid).tokens))
    assert tokens[0] == tokens[1] and len(tokens[0]) == 4


def test_serve_refused_under_a_sharding_tier(one_process):
    """Refused until item 6b; now ``serve()`` under oss and fsdp builds
    its engine from the gathered weights and emits plain dp's tokens."""
    from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss

    serve = pc.ServeConfig(max_seqs=2, kv_block_size=8, max_seq_len=32,
                           max_new_tokens=4, prefill_pad_multiple=16)
    prompt = np.random.default_rng(7).integers(1, 97, size=6).astype(
        np.int32)
    tokens = []
    for flags in ({}, dict(oss=True), dict(fsdp=True)):
        model = GPT(vocab_size=97, size_name="tiny", max_len=32,
                    dropout_rate=0.0)
        model.init_weights(0)
        s = Stoke(model, StokeOptimizer(torch.optim.SGD, lr=0.1),
                  causal_lm_loss, batch_size_per_device=2, device="cpu",
                  distributed="dp", configs=[
                      serve, pc.FSDPConfig(min_weight_size=1),
                      pc.OSSConfig(min_shard_size=1)], **flags)
        engine = s.serve()
        rid = engine.submit(prompt)
        engine.run()
        tokens.append(list(engine.result(rid).tokens))
        if flags.get("fsdp"):
            # the run's own parameters are freed again after the copy
            assert all(p.untyped_storage().nbytes() == 0
                       for p in s.model_access.parameters())
    assert tokens[0] == tokens[1] == tokens[2] and len(tokens[0]) == 4


def test_mesh_devices_refused(one_process):
    with pytest.raises(ValueError, match="each process drives one device"):
        _stoke(distributed="dp", configs=[pc.MeshConfig(devices=["cpu"])])


EXAMPLES = {"dp": ("none", "full", 1, None),
            "dp_bf16": ("none", "bf16", 2, 5.0),
            "dp_oss_sddp": ("sddp", "bf16", 1, None),
            "dp_fsdp_bf16": ("fsdp", "bf16", 1, None)}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_cifar10_documents_build_and_step(one_process, name):
    """The CIFAR-10 example's data-parallel documents build a runnable
    run (``device: tpu`` is the card; here ``device="cpu"`` overrides it,
    and a two-stage ResNet stands in for ResNet-50)."""
    tier, precision, accum, clip = EXAMPLES[name]
    model = ResNet(stage_sizes=(1, 1), block=BasicBlock, num_classes=10,
                   num_filters=4, cifar_stem=True)
    s = stoke_from_example(str(EXAMPLE_DIR / f"{name}.yaml"),
                           model=model, device="cpu")
    assert s.status.sharding_tier.value == tier
    assert s.precision.value == precision and s.grad_accum == accum
    assert getattr(s.grad_clip, "max_norm", None) == clip
    assert s.batch_size == 64 and s.is_distributed
    x = torch.randn(2, 3, 32, 32)
    for _ in range(accum):
        loss = s.train_step(x, torch.tensor([1, 2]))
    assert s.optimizer_steps == 1 and torch.isfinite(loss)


@pytest.mark.parametrize("doc,want", [({}, "cuda"), ({"device": "tpu"}, "cuda"),
                                      ({"device": "cpu"}, "cpu")],
                         ids=["no_device", "tpu", "cpu"])
def test_example_document_device(doc, want):
    """A document without ``device`` runs on the card, as ``Stoke`` does by
    default; ``tpu`` is the card and ``cpu`` the CPU. Asking for the card
    where there is none raises."""
    doc = dict(doc, model="basic")
    if want == "cuda" and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="runs on a CUDA device"):
            stoke_from_example(doc)
        return
    assert stoke_from_example(doc).device.type == want


@pytest.mark.parametrize("name,item", [("dp_int8_comm", "7"),
                                       ("dp_health", "10")])
def test_cifar10_documents_of_later_items_refused(one_process, name, item,
                                                  tmp_path, monkeypatch):
    """The two documents once refused for a later item build now: item 7's
    int8 transport with item 10a's ``telemetry:`` section
    (``dp_int8_comm``), and item 10b's ``health:`` section with the
    sentinels and a killing watchdog (``dp_health``). Each takes a step
    and writes its step events under the document's relative
    ``output_dir``."""
    monkeypatch.chdir(tmp_path)
    model = ResNet(stage_sizes=(1, 1), block=BasicBlock, num_classes=10,
                   num_filters=4, cifar_stem=True)
    s = stoke_from_example(str(EXAMPLE_DIR / f"{name}.yaml"), model=model,
                           device="cpu")
    try:
        tel = s.status.telemetry_config
        assert tel is not None and tel.log_every_n_steps == 10
        if item == "7":
            assert s.status.comm_config.dtype == "int8"
            assert s.comm_bytes == {"prequant": 0, "onwire": 0}
            assert s.health is None
        else:
            h = s.status.health_config
            assert h.sentinels and h.watchdog and h.watchdog_kill
            assert s.health is not None and s.health.watchdog is not None
        x = torch.randn(2, 3, 32, 32)
        loss = s.train_step(x, torch.tensor([1, 2]))
        assert s.optimizer_steps == 1 and torch.isfinite(loss)
        assert s.dispatch_count == 1
    finally:
        s.close_telemetry()
    assert os.path.exists(os.path.join(tel.output_dir, "steps.jsonl"))
    if item == "10":
        assert not s.health.watchdog._thread.is_alive()


