"""Port parity: the vision models and flax's BatchNorm.

Each model is built and initialised by the JAX package from a seed (every
leaf then redrawn from a numpy seed, so that no BatchNorm scale is 0 and no
running statistic is at its initial value), carried over by
``stoke_tpu_torch.convert.cnn_state_dict_from_jax`` /
``vit_state_dict_from_jax``, and the port's module held against
``apply`` on the same numpy inputs (NHWC for flax, NCHW for the port).

Tolerances, as a bound on ``max |port - jax|`` over ``max |jax|`` of each
tensor (fp32 sums in different orders):

- fp32 BatchNorm outputs and statistics: 1e-5;
- bf16 BatchNorm outputs: 2^-8, one bf16 rounding step at the largest
  output (both compute in fp32 and round once; the fp32 values may fall
  on either side of a rounding boundary); its statistics, reduced in fp32
  from the same bf16 inputs, 1e-5;
- BasicNN, ResNet and ViT logits and statistics in fp32: 1e-4 (up to ~20
  conv or dense layers, each normalised or summed in another order);
  the largest seen is below 1e-5;
- ResNet-18 with the ImageNet stem at 16x16, 5e-4: its last stage is 1x1,
  so each BatchNorm there normalises 4 values a channel, and fp32 itself
  moves the logits by 8.8e-5 against the same module in float64 (JAX's
  fp32 logits: 6.6e-5 from that float64 reference).
"""

import numpy as np
import pytest
import torch
from torch.func import functional_call

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from stoke_tpu.models.basic import BasicNN as JaxBasicNN
from stoke_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from stoke_tpu.models.resnet import ResNet as JaxResNet
from stoke_tpu.models.resnet import ResNet18 as JaxResNet18
from stoke_tpu.models import resnet as jax_resnet
from stoke_tpu.models.vit import ViT as JaxViT
from stoke_tpu_torch.convert import (
    cnn_state_dict_from_jax,
    vit_state_dict_from_jax,
)
from stoke_tpu_torch.models import resnet as port_resnet
from stoke_tpu_torch.models.basic import BasicNN
from stoke_tpu_torch.models.resnet import (
    BatchNorm,
    BottleneckBlock,
    ResNet,
    ResNet18,
    same_pads,
)
from stoke_tpu_torch.models.vit import ViT

pytestmark = pytest.mark.torch_port

FP32_TOL = 1e-5
BF16_OUT_TOL = 2.0**-8
MODEL_TOL = 1e-4
STEM_TOL = 5e-4


def rel_err(port, ref) -> float:
    port = np.asarray(port.detach().float() if torch.is_tensor(port)
                      else port, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def random_variables(model, x, seed, **kw):
    """The variables of ``model`` (shapes from ``jax.eval_shape`` of its
    init: no compile), every leaf drawn from a numpy seed: kernels from
    N(0, 1 / fan_in), biases, running means and other leaves from
    N(0, 0.1^2), BatchNorm scales and running variances from U(0.5, 1.5),
    so that no scale is 0 and no statistic at its initial value."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, **kw))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        std = (np.prod(leaf.shape[:-1]) ** -0.5 if name == "kernel"
               else 0.1)
        return rng.normal(0, std, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


# --------------------------------------------------------------------------- #
# BatchNorm
# --------------------------------------------------------------------------- #


def _bn_case(seed, C=5):
    """x [2, 4, 4, C] (32 values a channel, mean and scale per channel),
    and random scale, bias and running statistics."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 4, 4, C)) * rng.uniform(0.5, 3, C)
         + rng.normal(size=C)).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
              "bias": rng.normal(size=C).astype(np.float32)}
    stats = {"mean": rng.normal(size=C).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}
    return x, params, stats


def _port_bn(params, stats, train):
    bn = BatchNorm(params["scale"].shape[0])
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    return bn.train(train)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_matches_flax(train, dtype):
    x, params, stats = _bn_case(seed=1)
    flax_bn = flax_nn.BatchNorm(use_running_average=not train, momentum=0.9,
                                epsilon=1e-5)
    jdt = jnp.dtype(dtype)
    jparams = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    out, updated = flax_bn.apply(
        {"params": jparams, "batch_stats": stats}, jnp.asarray(x, jdt),
        mutable=["batch_stats"])
    tdt = getattr(torch, dtype)
    bn = _port_bn(params, stats, train)
    got = functional_call(
        bn, {k: torch.from_numpy(v).to(tdt) for k, v in
             (("weight", params["scale"]), ("bias", params["bias"]))},
        (nchw(x).to(tdt),))
    assert got.dtype == tdt
    tol = FP32_TOL if dtype == "float32" else BF16_OUT_TOL
    assert rel_err(got.permute(0, 2, 3, 1), np.asarray(out, np.float32)) <= tol
    new = updated["batch_stats"]
    assert bn.running_mean.dtype == torch.float32
    assert rel_err(bn.running_mean, new["mean"]) <= FP32_TOL
    assert rel_err(bn.running_var, new["var"]) <= FP32_TOL
    if train:
        assert not np.allclose(new["var"], stats["var"])


def test_batchnorm_unbiased_variance_would_fail():
    """torch's BatchNorm2d (unbiased running variance, n = 32 values a
    channel) misses flax's running variance by far more than the bound."""
    x, params, stats = _bn_case(seed=2)
    _, updated = flax_nn.BatchNorm(use_running_average=False, momentum=0.9,
                                   epsilon=1e-5).apply(
        {"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
    ref = torch.nn.BatchNorm2d(x.shape[-1], momentum=0.1, eps=1e-5)
    with torch.no_grad():
        ref.running_mean.copy_(torch.from_numpy(stats["mean"]))
        ref.running_var.copy_(torch.from_numpy(stats["var"]))
    ref(nchw(x))
    assert rel_err(ref.running_var, updated["batch_stats"]["var"]) > 100 * FP32_TOL


@pytest.mark.parametrize("n,k,s,want", [
    (32, 3, 1, (1, 1)), (32, 3, 2, (0, 1)), (33, 3, 2, (1, 1)),
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (16, 1, 2, (0, 0)),
])
def test_same_pads_match_lax(n, k, s, want):
    assert same_pads((n,), (k,), (s,)) == (want,)
    lax_pads = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")
    assert tuple(lax_pads[0]) == want


# --------------------------------------------------------------------------- #
# BasicNN, ResNet
# --------------------------------------------------------------------------- #


def test_basicnn_logits_match():
    x = np.random.default_rng(3).normal(size=(4, 32, 32, 3)).astype(np.float32)
    jax_model = JaxBasicNN(num_classes=10)
    variables = random_variables(jax_model, x, seed=4, train=False)
    ref = np.asarray(jax.jit(jax_model.apply)(variables, x))
    model = BasicNN(num_classes=10)
    model.load_state_dict(cnn_state_dict_from_jax(variables))
    assert rel_err(model(nchw(x)), ref) <= MODEL_TOL


#: name -> (JAX module, port module, tolerance)
RESNETS = {
    "resnet18_cifar": (lambda: JaxResNet18(num_classes=10, num_filters=8,
                                           cifar_stem=True),
                       lambda: ResNet18(num_classes=10, num_filters=8,
                                        cifar_stem=True), MODEL_TOL),
    "resnet18_imagenet_stem": (
        lambda: JaxResNet18(num_classes=10, num_filters=8, cifar_stem=False),
        lambda: ResNet18(num_classes=10, num_filters=8, cifar_stem=False),
        STEM_TOL),
    "bottleneck": (
        lambda: JaxResNet(stage_sizes=(1, 1, 1, 1), block=JaxBottleneck,
                          num_classes=10, num_filters=4, cifar_stem=True),
        lambda: ResNet(stage_sizes=(1, 1, 1, 1), block=BottleneckBlock,
                       num_classes=10, num_filters=4, cifar_stem=True),
        MODEL_TOL),
}


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_train_and_eval_match(name):
    """Train mode: logits and every updated ``batch_stats`` leaf against
    ``apply(..., mutable=["batch_stats"])``; eval mode: logits from the
    running statistics. 16x16 inputs: the ImageNet stem's 7x7/2 conv pads
    (2, 3) and its max pool (0, 1)."""
    jax_ctor, port_ctor, tol = RESNETS[name]
    x = np.random.default_rng(5).normal(size=(4, 16, 16, 3)).astype(
        np.float32)
    jax_model = jax_ctor()
    variables = random_variables(jax_model, x, seed=6, train=False)
    logits, updated = jax.jit(lambda v, x: jax_model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    model = port_ctor()
    model.load_state_dict(cnn_state_dict_from_jax(variables))
    model.train()
    assert rel_err(model(nchw(x)), np.asarray(logits)) <= tol
    want = cnn_state_dict_from_jax({"params": variables["params"],
                                    "batch_stats": updated["batch_stats"]})
    got = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == len(jax.tree_util.tree_leaves(
        updated["batch_stats"]))
    for key in stats:
        assert rel_err(got[key], want[key].numpy()) <= tol, key
        assert not torch.equal(got[key], cnn_state_dict_from_jax(
            variables)[key]), key

    model.load_state_dict(cnn_state_dict_from_jax(variables))
    model.eval()
    ref = np.asarray(jax.jit(lambda v, x: jax_model.apply(
        v, x, train=False))(variables, x))
    assert rel_err(model(nchw(x)), ref) <= tol
    assert rel_err(model(nchw(x)), ref) <= tol  # eval leaves stats


@pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
def test_resnet_parameter_counts_match(depth):
    """Parameters and BatchNorm statistics of the standard family, counted
    from ``jax.eval_shape`` (no compute) against the port's module."""
    jax_model = getattr(jax_resnet, f"ResNet{depth}")(num_classes=1000)
    shapes = jax.eval_shape(
        lambda: jax_model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)), train=False))
    count = lambda tree: sum(int(np.prod(l.shape))
                             for l in jax.tree_util.tree_leaves(tree))
    model = getattr(port_resnet, f"ResNet{depth}")(num_classes=1000,
                                                    device="meta")
    assert sum(p.numel() for p in model.parameters()) == count(
        shapes["params"])
    assert sum(b.numel() for b in model.buffers()) == count(
        shapes["batch_stats"])


# --------------------------------------------------------------------------- #
# ViT
# --------------------------------------------------------------------------- #


def test_vit_tiny_logits_match():
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    jax_model = JaxViT(num_classes=10, size_name="tiny", patch_size=8,
                       dropout_rate=0.0)
    params = random_variables(jax_model, x, seed=8, train=False)["params"]
    model = ViT(num_classes=10, size_name="tiny", patch_size=8,
                dropout_rate=0.0, image_size=32)
    model.load_state_dict(vit_state_dict_from_jax(params))
    for train in (True, False):
        ref = np.asarray(jax.jit(lambda p, x: jax_model.apply(
            {"params": p}, x, train=train))(params, x))
        assert rel_err(model.train(train)(nchw(x)), ref) <= MODEL_TOL


def test_vit_rejects_indivisible_images():
    with pytest.raises(ValueError, match="not divisible by patch_size=8"):
        JaxViT(num_classes=10, patch_size=8).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 30, 32, 3)), train=False)
    with pytest.raises(ValueError, match="not divisible by patch_size=8"):
        ViT(num_classes=10, patch_size=8, image_size=(30, 32))
    model = ViT(num_classes=10, patch_size=8, image_size=32)
    with pytest.raises(ValueError, match="not divisible by patch_size=8"):
        model(torch.zeros(1, 3, 30, 32))
    with pytest.raises(ValueError, match="pos_embed was made for 32x32"):
        model(torch.zeros(1, 3, 16, 16))


# --------------------------------------------------------------------------- #
# the converters' errors
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def resnet_variables():
    x = np.zeros((1, 16, 16, 3), np.float32)
    return random_variables(JaxResNet18(num_classes=10, num_filters=4,
                                        cifar_stem=True), x, seed=9,
                            train=False)


def _edit(tree, path, value=None, delete=False):
    out = jax.tree_util.tree_map(lambda a: a, tree)  # a copy of the dicts
    node = out
    for key in path[:-1]:
        node = node[key]
    if delete:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return out


def test_cnn_converter_errors(resnet_variables):
    v = resnet_variables
    with pytest.raises(KeyError, match="BasicBlock_1/BatchNorm_0/var"):
        cnn_state_dict_from_jax(_edit(
            v, ("batch_stats", "BasicBlock_1", "BatchNorm_0", "var"),
            delete=True))
    basic = random_variables(JaxBasicNN(), np.zeros((1, 32, 32, 3),
                                                   np.float32), seed=11)
    with pytest.raises(KeyError, match="Conv_1/kernel"):
        cnn_state_dict_from_jax(_edit(basic, ("params", "Conv_1", "kernel"),
                                      delete=True))
    # a bias-free conv with its kernel gone leaves no trace in the tree:
    # the strict load names it
    with pytest.raises(RuntimeError, match="conv_init.weight"):
        ResNet18(num_classes=10, num_filters=4, cifar_stem=True).load_state_dict(
            cnn_state_dict_from_jax(_edit(
                v, ("params", "conv_init", "kernel"), delete=True)))
    with pytest.raises(KeyError, match="'params'"):
        cnn_state_dict_from_jax({"batch_stats": v["batch_stats"]})
    with pytest.raises(ValueError, match="Dense_0/embedding"):
        cnn_state_dict_from_jax(_edit(v, ("params", "Dense_0", "embedding"),
                                      np.zeros((3, 3), np.float32)))
    with pytest.raises(ValueError, match="collections"):
        cnn_state_dict_from_jax({**v, "losses": {}})
    with pytest.raises(ValueError, match="norm_init.bias"):
        cnn_state_dict_from_jax(_edit(v, ("params", "norm_init", "bias"),
                                      np.zeros(5, np.float32)))
    with pytest.raises(ValueError, match="Dense_0.bias"):
        cnn_state_dict_from_jax(_edit(v, ("params", "Dense_0", "bias"),
                                      np.zeros(11, np.float32)))
    with pytest.raises(ValueError, match="expected a 4-D conv"):
        cnn_state_dict_from_jax(_edit(v, ("params", "conv_init", "kernel"),
                                      np.zeros((3, 3, 3), np.float32)))
    sd = cnn_state_dict_from_jax(v)
    assert sd["conv_init.weight"].shape == (4, 3, 3, 3)
    np.testing.assert_array_equal(
        sd["conv_init.weight"].numpy(),
        v["params"]["conv_init"]["kernel"].transpose(3, 2, 0, 1))


def test_vit_converter_errors():
    model = JaxViT(num_classes=10, size_name="tiny", patch_size=8)
    params = random_variables(model, np.zeros((1, 16, 16, 3), np.float32),
                              seed=10, train=False)["params"]
    with pytest.raises(KeyError, match="head/bias"):
        vit_state_dict_from_jax(_edit(params, ("head", "bias"), delete=True))
    with pytest.raises(KeyError, match="layer_1/ff_out/kernel"):
        vit_state_dict_from_jax(_edit(params, ("layer_1", "ff_out", "kernel"),
                                      delete=True))
    with pytest.raises(ValueError, match="no place in the port's ViT"):
        vit_state_dict_from_jax({**params, "extra": {
            "kernel": np.zeros((2, 2), np.float32)}})
    with pytest.raises(ValueError, match="qkv/kernel has shape"):
        vit_state_dict_from_jax(_edit(
            params, ("layer_0", "attention", "qkv", "kernel"),
            np.zeros((128, 384), np.float32)))
    with pytest.raises(ValueError, match="cls_token"):
        vit_state_dict_from_jax(_edit(params, ("cls_token",),
                                      np.zeros((1, 2, 128), np.float32)))
    sd = vit_state_dict_from_jax(params)
    port = ViT(num_classes=10, size_name="tiny", patch_size=8, image_size=16)
    port.load_state_dict(sd)
