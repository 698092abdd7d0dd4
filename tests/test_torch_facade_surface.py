"""Port parity: the facade's one-device surface.

The spec is ``tests/test_facade.py`` (loss helpers, properties, the
reference's accessors, ``barrier``), ``tests/test_serving.py`` (``serve``)
and ``tests/test_utils.py`` (``unrolled_print``, ``make_folder``), run on
the port; where both packages are compared they get the same numpy
inputs. Parameter counts, the status dict and the served tokens must
equal the JAX facade's; the FLOP count with the flash kernels' plain
versions must equal the count with dense attention (the flash ops are
counted by their formula, not by what runs inside them).
"""

import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import stoke_tpu
from stoke_tpu.configs import ParamNormalize as JaxParamNormalize
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.gpt import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.models.resnet import BasicBlock as JaxBasicBlock
from stoke_tpu.models.resnet import ResNet as JaxResNet
from stoke_tpu.models.vit import ViT as JaxViT
from stoke_tpu.status import StokeStatus as JaxStatus
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.configs import (
    CheckpointConfig,
    ParamNormalize,
    PrecisionConfig,
    ServeConfig,
)
from stoke_tpu_torch.convert import (
    cnn_state_dict_from_jax,
    gpt_state_dict_from_jax,
    vit_state_dict_from_jax,
)
from stoke_tpu_torch.models.bert import dense_attention
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.models.resnet import BasicBlock, ResNet
from stoke_tpu_torch.models.vit import ViT
from stoke_tpu_torch.ops import make_flash_attention
from stoke_tpu_torch.status import StokeStatus, StokeValidationError
from stoke_tpu_torch.utils import make_folder, unrolled_print

pytestmark = pytest.mark.torch_port


def mse(out, y):
    return ((out - y) ** 2).mean()


def make_stoke(**kw):
    """``tests/test_facade.py``'s ``make_stoke``: a 4 -> 2 linear model
    (weight and bias) with SGD."""
    kw.setdefault("batch_size_per_device", 8)
    return port.Stoke(nn.Linear(4, 2), port.StokeOptimizer(
        torch.optim.SGD, lr=0.2), mse, device="cpu", **kw)


def batch(n=8):
    x = np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32)
    return x, x @ np.ones((4, 2), np.float32)


def test_loss_tracking_helpers(capsys):
    s = make_stoke(grad_accum=2)
    x, y = batch()
    loss = s.loss(s.model(x), y)
    s.backward(loss)
    assert s.ema_loss > 0
    assert s.mean_accumulated_loss is not None and s.step_loss is not None
    s.print_ema_loss()
    s.print_mean_accumulated_synced_loss()
    s.print_synced_loss(loss)
    out = capsys.readouterr().out
    assert "EMA Loss" in out and "Stoke --" in out
    # print_synced_loss scales the divided loss back by grad_accum
    assert f"Step loss: {s.step_loss:.6f}" in out


def test_properties_and_introspection(capsys):
    s = make_stoke(grad_accum=3)
    assert s.batch_size == 8
    assert s.effective_batch_size == 8 * 1 * 3
    assert s.grad_accum_steps == 3
    assert s.world_size == 1 and s.n_processes == 1
    assert s.rank == 0 and s.is_rank_0
    assert not s.is_distributed
    assert s.num_model_parameters() == 4 * 2 + 2
    assert s.num_model_parameters(ParamNormalize.THOUSAND) == \
        pytest.approx(0.01)
    s.print_num_model_parameters()
    s.dump_model_parameter_info()
    s.print_status()
    s.info("hello")
    s.warn("careful")
    s.print_on_devices("everywhere", rank=None)
    s.block_until_ready()
    out = capsys.readouterr().out
    assert "Model parameters" in out and "param weight" in out
    assert "Stoke -- Status:" in out and "INFO: hello" in out
    assert "WARN: careful" in out and "(rank 0) everywhere" in out
    assert callable(s.loss_access)
    assert s.optimizer is not None


def test_reference_parity_accessors():
    s = make_stoke(grad_accum=2, precision="bf16")
    assert s.grad_accum == 2
    assert s.sharded is False and s.fully_sharded is False
    assert s.tpu is False
    assert s.is_bf16 and not s.is_fp16
    assert isinstance(s.precision_config, PrecisionConfig)
    assert s.dp_config.axis_name == "data"
    assert s.mesh_config.axes == ("data",)
    assert s.oss_config and s.sddp_config and s.fsdp_config
    assert s.checkpoint_config and s.profiler_config
    assert isinstance(s.checkpoint_config, CheckpointConfig)
    assert s.mesh is None
    assert s.sharding_rules.tier.value == "none"
    assert s.sharding_rules.axis_size == 1
    x, y = batch()
    s.backward(s.loss(s.model(x), y))
    assert s.ema_loss > 0
    s.reset_ema()
    assert s.ema_loss == 0.0
    s.reset_tracking()
    assert s.step_loss is None and s.mean_accumulated_loss is None
    assert (s.grad_accum_counter, s.backward_steps, s.optimizer_steps) == (
        0, 0, 0)


def test_barrier_noop_single_process():
    make_stoke().barrier()


def test_detach_and_sync_loss_matches_jax():
    """The host float of a loss (a structured one sums), as the JAX
    facade's; a reduction other than mean or sum is refused by both."""
    js = stoke_tpu.Stoke(
        model=lambda p, x: x @ p["w"],
        optimizer=stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd, optimizer_kwargs={"learning_rate": 0.1}),
        loss=mse, params={"w": np.zeros((4, 2), np.float32)},
        batch_size_per_device=8, verbose=False)
    s = make_stoke()
    vals = np.random.default_rng(1).normal(size=3).astype(np.float32)
    for loss, jloss in ((torch.tensor(vals[0]), jnp.asarray(vals[0])),
                        ({"a": torch.tensor(vals[1]),
                          "b": torch.tensor(vals[2])},
                         {"a": jnp.asarray(vals[1]),
                          "b": jnp.asarray(vals[2])})):
        for red in ("mean", "sum"):
            assert s.detach_and_sync_loss(loss, red) == pytest.approx(
                js.detach_and_sync_loss(jloss, red), rel=1e-7)
    for stoke, loss in ((s, torch.tensor(1.0)), (js, jnp.asarray(1.0))):
        with pytest.raises(ValueError, match="user_reduction"):
            stoke.detach_and_sync_loss(loss, user_reduction="max")


# --------------------------------------------------------------------------- #
# parameter counts against the JAX facade
# --------------------------------------------------------------------------- #


VOCAB, L = 257, 32


def _gpt_pair():
    jm = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                dropout_rate=0.0)
    return jm, np.zeros((1, 8), np.int32), GPT(vocab_size=VOCAB,
                                                size_name="tiny", max_len=L)


def _resnet_pair():
    kw = dict(stage_sizes=(1, 1), num_classes=10, num_filters=4,
              cifar_stem=True)
    return (JaxResNet(block=JaxBasicBlock, **kw),
            np.zeros((1, 8, 8, 3), np.float32), ResNet(block=BasicBlock,
                                                       **kw))


def _vit_pair():
    kw = dict(num_classes=10, patch_size=8, size_name="tiny")
    return (JaxViT(**kw), np.zeros((1, 16, 16, 3), np.float32),
            ViT(image_size=16, **kw))


PAIRS = {"gpt": (_gpt_pair, lambda v: gpt_state_dict_from_jax(v["params"])),
         "resnet": (_resnet_pair, cnn_state_dict_from_jax),
         "vit": (_vit_pair, lambda v: vit_state_dict_from_jax(v["params"]))}


@pytest.fixture(scope="module")
def facades():
    """Each model pair's JAX and port facades over the same seeded
    weights (the JAX shapes by ``jax.eval_shape``, values from numpy)."""
    out = {}
    for name, (pair, convert) in PAIRS.items():
        jm, x, pm = pair()
        shapes = jax.eval_shape(
            lambda: init_module(jm, jax.random.PRNGKey(0), x, train=False))
        rng = np.random.default_rng(0)
        variables = jax.tree_util.tree_map(
            lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
        js = stoke_tpu.Stoke(
            jm, stoke_tpu.StokeOptimizer(
                optimizer=optax.sgd, optimizer_kwargs={"learning_rate": 0.1}),
            lambda o, y: 0.0, variables, batch_size_per_device=1,
            verbose=False)
        ps = port.Stoke(pm, port.StokeOptimizer(torch.optim.SGD, lr=0.1),
                        lambda o, y: o.sum(), convert(variables),
                        batch_size_per_device=1, device="cpu")
        out[name] = (js, ps, variables, convert)
    return out


@pytest.mark.parametrize("normalize", [None, "MILLION", "KILO"])
@pytest.mark.parametrize("model", ["gpt", "resnet", "vit"])
def test_num_model_parameters_match_jax(facades, model, normalize):
    js, ps = facades[model][:2]
    ours = ps.num_model_parameters(
        normalize and getattr(ParamNormalize, normalize))
    theirs = js.num_model_parameters(
        normalize and getattr(JaxParamNormalize, normalize))
    assert ours == theirs
    # parameters only: BatchNorm's running statistics do not count
    assert ps.num_model_parameters() == sum(
        p.numel() for p in ps.model_access.parameters())


@pytest.mark.parametrize("model", ["gpt", "resnet", "vit"])
def test_dump_model_parameter_info_matches_jax(facades, model, capsys):
    """One line a parameter in both; the port's shapes are the converted
    JAX leaves' shapes, and the element counts are the same multiset."""
    js, ps, variables, convert = facades[model]
    capsys.readouterr()
    js.dump_model_parameter_info()
    theirs = [ln for ln in capsys.readouterr().out.splitlines()
              if "param " in ln]
    ps.dump_model_parameter_info()
    ours = [ln for ln in capsys.readouterr().out.splitlines()
            if "param " in ln]

    def shapes(lines):
        return [tuple(int(d) for d in ln.split("shape=(")[1].split(")")[0]
                      .split(",") if d.strip()) for ln in lines]

    assert len(ours) == len(theirs)
    assert Counter(int(np.prod(s)) for s in shapes(ours)) == Counter(
        int(np.prod(s)) for s in shapes(theirs))
    converted = convert(variables)
    names = [ln.split("param ")[1].split(":")[0] for ln in ours]
    assert shapes(ours) == [tuple(converted[n].shape) for n in names]


# --------------------------------------------------------------------------- #
# the status dict
# --------------------------------------------------------------------------- #


FLAGS = [
    dict(batch_size_per_device=8),
    dict(batch_size_per_device=4, grad_accum=4, precision="bf16",
         grad_clip="norm"),
    dict(batch_size_per_device=2, precision="fp16", grad_clip="value",
         configs=[PrecisionConfig(init_scale=2.0**10, num_losses=2),
                  CheckpointConfig(max_to_keep=2, async_save=True,
                                   save_every_n_steps=5, auto_path="ck")]),
    dict(batch_size_per_device=1, configs=[ServeConfig(max_seqs=2)]),
]


def _both(kw):
    """The port's and the JAX package's status kwargs for ``kw``."""
    from stoke_tpu import configs as jc

    ours, theirs = dict(kw), dict(kw)
    clip = kw.get("grad_clip")
    if clip is not None:
        ours["grad_clip"] = (port.ClipGradNormConfig(max_norm=0.5)
                             if clip == "norm"
                             else port.ClipGradConfig(clip_value=2.0))
        theirs["grad_clip"] = getattr(jc, type(ours["grad_clip"]).__name__)(
            **vars(ours["grad_clip"]))
    theirs["configs"] = [getattr(jc, type(c).__name__)(**{
        k: (getattr(jc, type(v).__name__)(v.value) if hasattr(v, "value")
            else v) for k, v in vars(c).items()})
        for c in kw.get("configs", ())]
    return ours, theirs


@pytest.mark.parametrize("i", range(len(FLAGS)))
def test_status_to_dict_matches_jax(i, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ours_kw, theirs_kw = _both(FLAGS[i])
    ours = StokeStatus(device="cpu", **ours_kw)
    theirs = JaxStatus(device="cpu", **theirs_kw)
    for st in (ours, theirs):
        st.set_post_init_values(world_size=1)
        st.precision_config, st.checkpoint_config  # defaults materialise
    a, b = ours.to_dict(), theirs.to_dict()
    shared = set(a) & set(b)
    assert shared == set(a)  # every key the port has is a JAX key
    for k in shared - {"configs"}:
        assert a[k] == b[k], k
    for name, cfg in a["configs"].items():
        assert cfg == b["configs"][name], name
    ours_lines = {ln.split(":")[0] for ln in repr(ours).splitlines()}
    assert ours_lines <= {ln.split(":")[0] for ln in repr(theirs)
                          .splitlines()}


# --------------------------------------------------------------------------- #
# the step's FLOPs
# --------------------------------------------------------------------------- #


def _gpt_stoke(attention, grad_accum=1):
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                dropout_rate=0.1,
                attention_fn=(make_flash_attention(causal=True)
                              if attention == "flash" else dense_attention),
                attention_is_causal=attention == "flash")
    for block in model.layers:
        block.attention.prob_dropout.rate = 0.0
    model.init_weights(0)
    return port.Stoke(model, port.StokeOptimizer(torch.optim.AdamW, lr=1e-3),
                      causal_lm_loss, batch_size_per_device=2,
                      grad_accum=grad_accum, device="cpu", seed=3)


def test_estimate_step_flops_flash_equals_dense():
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, VOCAB, size=(2, L)))
    flash, dense = _gpt_stoke("flash"), _gpt_stoke("dense")
    counts = {name: s.estimate_step_flops(ids, ids)
              for name, s in (("flash", flash), ("dense", dense))}
    assert counts["flash"] == counts["dense"] > 0
    # the attention products are in it: 12 B H L^2 D a layer
    assert counts["flash"] > 12 * 2 * 2 * L * L * 64


def test_estimate_step_flops_leaves_the_run_as_it_was():
    """Mid-window, with dropout: the gradients, counters, generator and
    the next step's loss are those of a run that never counted."""
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, VOCAB, size=(3, 2, L)))
    a, b = _gpt_stoke("flash", grad_accum=2), _gpt_stoke("flash",
                                                        grad_accum=2)
    for s in (a, b):
        s.train_step(ids[0], ids[0])
    grads = [p.grad.clone() for p in a.model_access.parameters()]
    a.estimate_step_flops(ids[2], ids[2])
    assert all(torch.equal(g, p.grad) for g, p in
               zip(grads, a.model_access.parameters()))
    assert (a.grad_accum_counter, a.backward_steps) == (1, 1)
    assert float(a.train_step(ids[1], ids[1])) == float(
        b.train_step(ids[1], ids[1]))
    for p, q in zip(a.model_access.parameters(),
                    b.model_access.parameters()):
        assert torch.equal(p, q)


# --------------------------------------------------------------------------- #
# serve()
# --------------------------------------------------------------------------- #


SERVE = dict(max_seqs=3, kv_block_size=8, max_seq_len=32, max_new_tokens=5,
             prefill_pad_multiple=16, attention="flash")


def test_serve_without_config_raises():
    with pytest.raises(StokeValidationError, match="ServeConfig"):
        make_stoke().serve()


def test_serve_requires_gpt_model():
    with pytest.raises(TypeError, match="GPT"):
        make_stoke(configs=[ServeConfig(**SERVE)]).serve()


def test_serve_overrides_revalidate():
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L)
    s = port.Stoke(model, port.StokeOptimizer(torch.optim.SGD, lr=0.1),
                   causal_lm_loss, batch_size_per_device=1, device="cpu",
                   configs=[ServeConfig(**SERVE)])
    assert s.serve(max_seqs=2).cfg.max_seqs == 2
    assert s.status.serve_config.max_seqs == 3
    with pytest.raises(StokeValidationError):
        s.serve(quant="int4")


def test_serve_tokens_match_jax_serve():
    """``serve()`` on converted weights emits the JAX ``Stoke.serve()``'s
    greedy tokens (the JAX facade refuses its TPU decode kernel on the
    CPU, so it decodes with its reference; the port with its decode
    kernel's plain version). Training on afterwards does not change the
    engine already built."""
    jm = JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                dropout_rate=0.0)
    variables = jax.tree_util.tree_map(np.asarray, init_module(
        jm, jax.random.PRNGKey(0), np.zeros((1, 8), np.int32), train=False))
    js = stoke_tpu.Stoke(
        jm, stoke_tpu.StokeOptimizer(optimizer=optax.sgd,
                                     optimizer_kwargs={"learning_rate": 0.1}),
        jax_causal_lm_loss, jax.tree_util.tree_map(np.array, variables),
        batch_size_per_device=2, model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False,
        configs=[stoke_tpu.ServeConfig(**SERVE,
                                       decode_kernel="reference")])
    model = GPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                dropout_rate=0.0,
                attention_fn=make_flash_attention(causal=True),
                attention_is_causal=True)
    s = port.Stoke(model, port.StokeOptimizer(torch.optim.SGD, lr=0.1),
                   causal_lm_loss, gpt_state_dict_from_jax(
                       variables["params"]),
                   batch_size_per_device=2, device="cpu",
                   configs=[ServeConfig(**SERVE, decode_kernel="pallas")])
    prompts = [np.random.default_rng(7).integers(1, VOCAB, size=n)
               .astype(np.int32) for n in (5, 11, 17, 3)]

    def tokens(engine):
        rids = [engine.submit(p) for p in prompts]
        engine.run()
        return [list(engine.result(r).tokens) for r in rids]

    engine = s.serve()
    assert tokens(engine) == tokens(js.serve())
    served = {n: t.clone() for n, t in engine.model.state_dict().items()}
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, VOCAB, size=(2, L)))
    s.train_step(ids, ids)
    assert not torch.equal(model.tok_emb.weight, served["tok_emb.weight"])
    for n, t in engine.model.state_dict().items():
        assert torch.equal(t, served[n]), n


# --------------------------------------------------------------------------- #
# utils
# --------------------------------------------------------------------------- #


def test_unrolled_print(capsys):
    unrolled_print("hello")
    unrolled_print(["a", "b"])
    unrolled_print(["a", "b"], single_line=True)
    out = capsys.readouterr().out
    assert out.count("Stoke --") == 4
    assert "a, b" in out


def test_make_folder(tmp_path):
    p = make_folder(str(tmp_path / "x" / "y"))
    assert os.path.isdir(p)
    assert make_folder(p) == p
