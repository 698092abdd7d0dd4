"""Port parity: a checkpoint the JAX package wrote, resumed in the port.

The JAX ``Stoke`` trains, saves one tag at an accumulation boundary and
one mid-window (``grad_accum=2``), and trains on; each tag goes through
``stoke_tpu_torch.convert.jax_checkpoint_to_port`` into a port tag that
the port's ``Stoke.load`` restores. Two runs:

- GPT-tiny (vocab 257, L=32, B=4, flash attention: the JAX kernels in
  Pallas interpret mode, the port's plain versions) with ``optax.adamw``
  and norm clipping against ``torch.optim.AdamW``, as
  ``test_torch_train.py::test_adamw_clip_trajectory_matches_jax`` runs
  them;
- the two-stage ResNet of ``test_torch_vision_train.py`` (basic blocks,
  4 filters, CIFAR stem, 8x8 images) with ``optax.sgd`` momentum against
  ``torch.optim.SGD``, in fp32, bf16 and fp16.

After ``load``, in every precision, the master parameters, BatchNorm's
running statistics, AdamW's ``mu``/``nu``/``count`` (``exp_avg``,
``exp_avg_sq``, ``step``) or SGD's ``trace`` (``momentum_buffer``), the
scaler state, the accumulated gradients and the counters equal the JAX
state at the save exactly (the converter moves fp32 values without
arithmetic). Then both packages continue from the tag in fp32 over the
same batches; their losses agree within 1e-3 relative (the AdamW
trajectory test's tolerance: the packages sum in different orders). A
last case pins the converter's leaf order against
``jax.tree_util.tree_flatten`` of the trees the JAX facade saves.
"""

import jax
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import stoke_tpu
from stoke_tpu.models.gpt import GPT as JaxGPT
from stoke_tpu.models.gpt import causal_lm_loss as jax_causal_lm_loss
from stoke_tpu.models.resnet import BasicBlock as JaxBasicBlock
from stoke_tpu.models.resnet import ResNet as JaxResNet
from stoke_tpu.ops import make_flash_attention as jax_make_flash
from stoke_tpu.utils import init_module
import stoke_tpu_torch as port
from stoke_tpu_torch.convert import (
    cnn_state_dict_from_jax,
    gpt_state_dict_from_jax,
    jax_checkpoint_to_port,
    jax_flatten_order,
)
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.models.resnet import BasicBlock, ResNet
from stoke_tpu_torch.ops import make_flash_attention

pytestmark = pytest.mark.torch_port

ACCUM = 2
#: micro-batches before the boundary tag; the mid-window tag follows one
#: more; both packages then run to CONTINUE_TO micro-batches (3 more
#: optimizer steps after the boundary tag)
BOUNDARY, CONTINUE_TO = 4, 10
LOSS_RTOL = 1e-3

VOCAB, L, BATCH = 257, 32, 4
SIDE, CLASSES = 8, 10


def _host(tree):
    """A host copy (the JAX steps donate their buffers)."""
    return jax.tree_util.tree_map(np.array, tree)


# --------------------------------------------------------------------------- #
# the two workloads, in each package
# --------------------------------------------------------------------------- #


def _gpt_batches():
    ids = np.random.default_rng(0).integers(
        0, VOCAB, size=(CONTINUE_TO, BATCH, L)).astype(np.int32)
    return [(b, (b,)) for b in ids]


def _cnn_batches():
    r = np.random.default_rng(0)
    xs = r.normal(size=(CONTINUE_TO, BATCH, SIDE, SIDE, 3)).astype(np.float32)
    ys = r.integers(0, CLASSES, size=(CONTINUE_TO, BATCH)).astype(np.int32)
    return list(zip(xs, [(y,) for y in ys]))


def _jax_gpt():
    return JaxGPT(vocab_size=VOCAB, size_name="tiny", max_len=L,
                  dropout_rate=0.0, attention_fn=jax_make_flash(causal=True),
                  attention_is_causal=True)


def _jax_cnn():
    return JaxResNet(stage_sizes=(1, 1), block=JaxBasicBlock,
                     num_classes=CLASSES, num_filters=4, cifar_stem=True)


WORKLOADS = {
    "gpt": dict(
        jax_model=_jax_gpt,
        init=lambda m: init_module(m, jax.random.PRNGKey(0),
                                   np.zeros((2, L), np.int32), train=False),
        jax_opt=lambda: stoke_tpu.StokeOptimizer(
            optimizer=optax.adamw,
            optimizer_kwargs=dict(learning_rate=1e-2, b1=0.9, b2=0.999,
                                  eps=1e-8, weight_decay=1e-4)),
        jax_loss=jax_causal_lm_loss,
        jax_clip=lambda: stoke_tpu.ClipGradNormConfig(max_norm=0.5),
        batches=_gpt_batches,
        port_model=lambda: GPT(vocab_size=VOCAB, size_name="tiny",
                               max_len=L, dropout_rate=0.0,
                               attention_fn=make_flash_attention(causal=True),
                               attention_is_causal=True),
        port_opt=lambda: port.StokeOptimizer(
            torch.optim.AdamW, lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4),
        port_loss=causal_lm_loss,
        port_clip=lambda: port.ClipGradNormConfig(max_norm=0.5),
        port_batch=lambda b: (torch.from_numpy(b[0]).long(),
                              (torch.from_numpy(b[0]).long(),)),
        weights=lambda v: gpt_state_dict_from_jax(v["params"]),
        moments=lambda tree, v: gpt_state_dict_from_jax(tree),
        fields=(("mu", "exp_avg"), ("nu", "exp_avg_sq")),
    ),
    "resnet": dict(
        jax_model=_jax_cnn,
        init=lambda m: init_module(m, jax.random.PRNGKey(0),
                                   np.zeros((2, SIDE, SIDE, 3), np.float32),
                                   train=False),
        jax_opt=lambda: stoke_tpu.StokeOptimizer(
            optimizer=optax.sgd,
            optimizer_kwargs=dict(learning_rate=0.05, momentum=0.9)),
        jax_loss=lambda logits, y: optax.
        softmax_cross_entropy_with_integer_labels(logits, y).mean(),
        jax_clip=lambda: None,
        batches=_cnn_batches,
        port_model=lambda: ResNet(stage_sizes=(1, 1), block=BasicBlock,
                                  num_classes=CLASSES, num_filters=4,
                                  cifar_stem=True),
        port_opt=lambda: port.StokeOptimizer(torch.optim.SGD, lr=0.05,
                                             momentum=0.9, dampening=0.0),
        port_loss=lambda logits, y: F.cross_entropy(logits.float(),
                                                    y.long()),
        port_clip=lambda: None,
        port_batch=lambda b: (torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(b[0], -1, -3))), (torch.from_numpy(b[1][0]),)),
        weights=cnn_state_dict_from_jax,
        moments=lambda tree, v: cnn_state_dict_from_jax(
            {"params": tree, "batch_stats": v["batch_stats"]}),
        fields=(("trace", "momentum_buffer"),),
    ),
}


def _jax_stoke(w, variables, precision=None):
    return stoke_tpu.Stoke(
        w["jax_model"](), w["jax_opt"](), w["jax_loss"], _host(variables),
        batch_size_per_device=BATCH, grad_accum=ACCUM, device="cpu",
        precision=precision, grad_clip=w["jax_clip"](),
        model_train_kwargs={"train": True},
        model_eval_kwargs={"train": False}, verbose=False)


def _jax_micro(s, batch):
    x, y = batch
    loss = s.loss(s.model(x), *y)
    s.backward(loss)
    s.step()
    return float(loss)


def _snapshot(s):
    """The JAX facade's state as a tag holds it, on the host."""
    return {"variables": _host({k: v for k, v in s.variables.items()
                                if k != "losses"}),
            "opt_state": _host(s.opt_state),
            "scaler": _host(s._scaler_state),
            "grad_buf": _host(s._grad_buf),
            "counters": (s.backward_steps, s.optimizer_steps,
                         s.grad_accum_counter)}


def _train_and_save(w, tmp, precision=None, continue_from=()):
    """JAX: BOUNDARY micro-batches, save (``boundary``), one more, save
    (``mid``), then on to CONTINUE_TO micro-batches. For each tag in
    ``continue_from`` a fresh JAX Stoke loads it and runs to CONTINUE_TO
    as well. Returns the tags, the snapshots at each save and the
    continued losses."""
    variables = w["init"](w["jax_model"]())
    batches = w["batches"]()
    s = _jax_stoke(w, variables, precision)
    for b in batches[:BOUNDARY]:
        _jax_micro(s, b)
    out = {"variables0": _host(variables), "tags": {}, "snap": {},
           "losses": {}}
    out["tags"]["boundary"] = s.save(str(tmp), name="run")
    out["snap"]["boundary"] = _snapshot(s)
    mid_losses = [_jax_micro(s, batches[BOUNDARY])]
    out["tags"]["mid"] = s.save(str(tmp), name="run")
    out["snap"]["mid"] = _snapshot(s)
    out["losses"]["mid"] = [_jax_micro(s, b)
                            for b in batches[BOUNDARY + 1:]]
    for which in continue_from:
        r = _jax_stoke(w, variables, precision)
        r.load(str(tmp), tag=out["tags"][which].rsplit("/", 1)[1])
        start = BOUNDARY if which == "boundary" else BOUNDARY + 1
        out["losses"][which] = [_jax_micro(r, b) for b in batches[start:]]
    del mid_losses
    return out


@pytest.fixture(scope="module")
def gpt_run(tmp_path_factory):
    return _train_and_save(WORKLOADS["gpt"],
                           tmp_path_factory.mktemp("jax_gpt"),
                           continue_from=("boundary",))


@pytest.fixture(scope="module")
def resnet_run(tmp_path_factory):
    return _train_and_save(WORKLOADS["resnet"],
                           tmp_path_factory.mktemp("jax_resnet"),
                           continue_from=("boundary",))


def _port_stoke(w, run, precision=None):
    model = w["port_model"]()
    return model, port.Stoke(
        model, w["port_opt"](), w["port_loss"], w["weights"](
            run["variables0"]),
        batch_size_per_device=BATCH, grad_accum=ACCUM, device="cpu",
        precision=precision, grad_clip=w["port_clip"]())


def _load_converted(w, run, which, tmp, precision=None):
    """A fresh port Stoke (its own weights: the JAX init) that loads the
    converted tag ``which``."""
    model, s = _port_stoke(w, run, precision)
    tag = jax_checkpoint_to_port(run["tags"][which], str(tmp), model,
                                 s.optimizer)
    s.load(str(tmp), tag=tag.rsplit("/", 1)[1])
    return model, s


def _assert_state_equals_jax(w, model, s, snap):
    """Parameters, statistics, optimizer state, scaler, gradients and
    counters after ``load``: equal to the JAX state at the save."""
    v = snap["variables"]
    for name, t in w["weights"](v).items():
        assert torch.equal(model.state_dict()[name], t), name
    opt = snap["opt_state"][0]
    named = dict(model.named_parameters())
    for field, key in w["fields"]:
        ref = w["moments"](getattr(opt, field), v)
        for name, p in named.items():
            assert torch.equal(s.optimizer.state[p][key], ref[name]), (
                field, name)
    if "count" in opt._fields:  # (a tuple method is named count too)
        for p in named.values():
            assert float(s.optimizer.state[p]["step"]) == float(opt.count)
    for key, val in snap["scaler"].items():
        np.testing.assert_array_equal(s.scaler[key].numpy(), val, key)
    counters = snap["counters"]
    assert (s.backward_steps, s.optimizer_steps,
            s.grad_accum_counter) == counters
    if counters[2]:
        grads = w["moments"](snap["grad_buf"], v)
        for name, p in named.items():
            assert torch.equal(p.grad, grads[name]), name
    else:
        assert all(p.grad is None for p in named.values())


@pytest.mark.parametrize("which", ["boundary", "mid"])
@pytest.mark.parametrize("workload", ["gpt", "resnet"])
def test_jax_tag_resumes_in_the_port(workload, which, request, tmp_path):
    w = WORKLOADS[workload]
    run = request.getfixturevalue(f"{workload}_run")
    model, s = _load_converted(w, run, which, tmp_path)
    _assert_state_equals_jax(w, model, s, run["snap"][which])
    start = BOUNDARY if which == "boundary" else BOUNDARY + 1
    losses = []
    for b in w["batches"]()[start:]:
        x, y = w["port_batch"](b)
        loss = s.loss(s.model(x), *y)
        s.backward(loss)
        s.step()
        losses.append(float(loss))
    assert s.optimizer_steps == CONTINUE_TO // ACCUM
    np.testing.assert_allclose(losses, run["losses"][which], rtol=LOSS_RTOL)


@pytest.mark.parametrize("precision", ["bf16", "fp16"])
def test_16bit_jax_tag_loads_exactly(precision, tmp_path):
    """In bf16 and fp16 the tag's fp32 masters, statistics, momentum,
    gradients and the scaler state load bit for bit."""
    w = WORKLOADS["resnet"]
    variables = w["init"](w["jax_model"]())
    s = _jax_stoke(w, variables, precision)
    for b in w["batches"]()[:BOUNDARY + 1]:
        _jax_micro(s, b)
    tag = s.save(str(tmp_path / "jax"), name="run")
    snap = _snapshot(s)
    run = {"variables0": _host(variables), "tags": {"mid": tag}}
    model, ours = _load_converted(w, run, "mid", tmp_path / "port",
                                  precision)
    _assert_state_equals_jax(w, model, ours, snap)
    assert ours.loss_scale == float(snap["scaler"]["scale"])


def _jax_path(path):
    """A JAX key path as the converter's tuple of names (tuple indices
    dropped, attribute and dict keys kept)."""
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.GetAttrKey):
            out.append(k.name)
        elif isinstance(k, jax.tree_util.DictKey):
            out.append(str(k.key))
    return tuple(out)


@pytest.mark.parametrize("workload", ["gpt", "resnet"])
def test_converter_leaf_order_is_jax_flatten_order(workload, request):
    w = WORKLOADS[workload]
    snap = request.getfixturevalue(f"{workload}_run")["snap"]["mid"]
    model, s = _port_stoke(w, request.getfixturevalue(f"{workload}_run"))
    for key, tree in (("variables", snap["variables"]),
                      ("opt_state", snap["opt_state"]),
                      ("grad_buf", snap["grad_buf"])):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [_jax_path(p) for p, _ in flat] == jax_flatten_order(
            model, key, s.optimizer), key


@pytest.mark.parametrize("case", ["model", "adam", "sgd_plain"])
def test_converter_refuses_what_it_cannot_carry(case, tmp_path):
    """Another model class, or an optimizer with no optax counterpart
    here, raises naming what it got, before any file is read."""
    from stoke_tpu_torch.models.vit import ViT

    model = (ViT(num_classes=10, patch_size=8, image_size=16)
             if case == "model" else WORKLOADS["gpt"]["port_model"]())
    opt = {"model": torch.optim.AdamW, "adam": torch.optim.Adam,
           "sgd_plain": torch.optim.SGD}[case](model.parameters(), lr=0.1)
    err, match = {"model": (TypeError, "ViT"), "adam": (ValueError, "Adam"),
                  "sgd_plain": (ValueError, "momentum")}[case]
    with pytest.raises(err, match=match):
        jax_checkpoint_to_port(str(tmp_path / "missing"), str(tmp_path),
                               model, opt)
