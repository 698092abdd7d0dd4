"""ResNet v1.5 of the port, with flax's convolution padding and BatchNorm.

Counterpart of ``stoke_tpu/models/resnet.py:26-133``: ``BasicBlock``
(ResNet-18/34) and ``BottleneckBlock`` (50/101/152), the 7x7/2 ImageNet stem
with a 3x3/2 max pool or the 3x3/1 CIFAR stem, global average pooling and a
linear head. The layers are the flax modules' counterparts, on NCHW:

- :class:`Conv` is flax's ``nn.Conv``: weight ``[out, in, kh, kw]`` (flax
  keeps ``[kh, kw, in, out]``) and flax's ``padding="SAME"``, which pads
  ``total = max((ceil(n / s) - 1) * s + k - n, 0)`` as ``(total // 2,
  total - total // 2)``. At stride 2 on an even input that is (0, 1), not
  ``nn.Conv2d(padding=1)``'s (1, 1): such inputs are padded first, then
  convolved with no padding. Convolutions are ``F.conv2d`` (cuDNN on the
  card), as the JAX package computes them outside any Pallas kernel.
- :class:`BatchNorm` is flax's ``nn.BatchNorm`` (``momentum=0.9``,
  ``epsilon=1e-5``): statistics reduced in fp32, the biased variance
  ``E[x^2] - E[x]^2`` clipped at 0, running averages ``m * ra + (1 - m) *
  stat`` in fp32 buffers, no ``num_batches_tracked``; the normalization in
  fp32 (flax promotes ``x - mean`` to the statistics' fp32), cast back to
  the input's dtype. ``torch.nn.BatchNorm2d`` updates ``running_var`` with
  the unbiased variance, so it is not used. On one device the batch is the
  global batch; across ranks (``BatchNorm.sync_group``, which ``Stoke``
  sets under ``distributed="dp"``) the moments are all-reduced, so they
  are the global batch's, as in the JAX package.

Module and parameter names mirror the flax tree (``conv_init``,
``BottleneckBlock_0.Conv_1.weight``, ``norm_proj``, ``Dense_0``), so
:func:`stoke_tpu_torch.convert.cnn_state_dict_from_jax` maps one onto the
other leaf by leaf. Train and eval are the module's mode bit (batch or
running statistics), where the JAX package takes ``train=`` per call.

On the card the input is made ``torch.channels_last`` (cuDNN's bf16
convolutions are NHWC kernels); put the model there too
(``model.to(memory_format=torch.channels_last)``), or cuDNN converts each
weight on every call.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

#: flax ``truncated_normal`` draws from N(0, 1) cut at +-2 and divides the
#: wanted std by this factor, the std of that cut distribution
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's ``lecun_normal`` in place: a normal of variance ``1 / fan_in``
    truncated at two (corrected) standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """lax's ``SAME`` padding, ``(low, high)`` for each spatial dim."""
    pads = []
    for n, k, s in zip(size, kernel, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _pad_same(x: torch.Tensor, kernel, stride, value: float = 0.0):
    """``x`` padded as lax pads it for ``SAME``, and the symmetric padding
    still to pass to the op (``(0, 0)`` once ``x`` was padded)."""
    (h0, h1), (w0, w1) = same_pads(x.shape[-2:], kernel, stride)
    if h0 == h1 and w0 == w1:
        return x, (h0, w0)
    return F.pad(x, (w0, w1, h0, h1), value=value), (0, 0)


def max_pool_same(x: torch.Tensor, kernel=3, stride=2) -> torch.Tensor:
    """flax ``nn.max_pool(x, kernel, strides=stride, padding="SAME")``:
    padded with -inf as lax pads it."""
    kernel, stride = _pair(kernel), _pair(stride)
    # a symmetric padding is left to F.max_pool2d, which pads with -inf
    x, pad = _pad_same(x, kernel, stride, value=float("-inf"))
    return F.max_pool2d(x, kernel, stride, padding=pad)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NCHW: ``weight [out, in, kh, kw]``, an optional
    bias, ``padding`` "SAME" (lax's, see :func:`same_pads`) or "VALID"."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Union[int, Tuple[int, int]],
                 stride: Union[int, Tuple[int, int]] = 1,
                 padding: str = "SAME", bias: bool = True, device=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"Conv: padding must be 'SAME' or 'VALID', got "
                             f"{padding!r}")
        self.kernel, self.stride = _pair(kernel), _pair(stride)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, *self.kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_channels, device=device))
                     if bias else None)

    def forward(self, x):
        pad = (0, 0)
        if self.padding == "SAME":
            x, pad = _pad_same(x, self.kernel, self.stride)
        return F.conv2d(x, self.weight, self.bias, self.stride, pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis (dim 1) of NCHW or NC,
    as the JAX package's ResNet sets it: ``momentum`` 0.9 (flax's: the
    weight of the old running value) and ``epsilon`` 1e-5.

    ``weight`` (flax ``scale``, initialised to ``scale_init``) and ``bias``
    are parameters; ``running_mean`` and ``running_var`` are fp32 buffers
    that training updates in place (so a replayed CUDA graph updates them
    too).

    ``sync_group``: None (the batch is this process's), or the process
    group of a data-parallel run. In training the per-channel ``E[x]`` and
    ``E[x^2]`` are then all-reduced over it by the autograd-aware
    ``torch.distributed.nn.functional.all_reduce`` and divided by its size:
    the global batch's moments, and the global batch's backward. The JAX
    package always computes the global batch's (its ``sync_batch_stats``
    and ``convert_to_sync_batchnorm`` only inform), and so does the port
    under dp whatever those flags say."""

    momentum = 0.9
    eps = 1e-5
    sync_group = None

    def __init__(self, features: int, scale_init: float = 1.0, device=None):
        super().__init__()
        self.scale_init = scale_init
        self.weight = nn.Parameter(
            torch.full((features,), float(scale_init), device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(
            features, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.ones(
            features, dtype=torch.float32, device=device))

    def forward(self, x):
        dims = [d for d in range(x.ndim) if d != 1]
        if self.training:
            xf = x.float()
            mean, sq = xf.mean(dims), (xf * xf).mean(dims)
            if self.sync_group is not None:
                from torch.distributed import get_world_size
                from torch.distributed.nn.functional import all_reduce

                both = all_reduce(torch.stack([mean, sq]),
                                  group=self.sync_group)
                mean, sq = both / get_world_size(self.sync_group)
            var = (sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(
                    m * self.running_mean + (1 - m) * mean.detach())
                self.running_var.copy_(
                    m * self.running_var + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        shape = [1, -1] + [1] * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class BasicBlock(nn.Module):
    """Two 3x3 convs; the second BN starts at scale 0. ``conv_proj`` /
    ``norm_proj`` map the residual where the shape changes."""

    expansion = 1

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, filters, 3, strides, bias=False,
                           device=device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, bias=False, device=device)
        self.BatchNorm_1 = BatchNorm(filters, scale_init=0.0, device=device)
        _add_projection(self, in_channels, filters, strides, device)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        return F.relu(_residual(self, x) + y)


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (the stride, v1.5), 1x1 to ``4 * filters``; the last BN
    starts at scale 0."""

    expansion = 4

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, filters, 1, bias=False,
                           device=device)
        self.BatchNorm_0 = BatchNorm(filters, device=device)
        self.Conv_1 = Conv(filters, filters, 3, strides, bias=False,
                           device=device)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self.Conv_2 = Conv(filters, 4 * filters, 1, bias=False,
                           device=device)
        self.BatchNorm_2 = BatchNorm(4 * filters, scale_init=0.0,
                                     device=device)
        _add_projection(self, in_channels, 4 * filters, strides, device)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        return F.relu(_residual(self, x) + y)


def _add_projection(block: nn.Module, in_channels: int, out_channels: int,
                    strides: int, device) -> None:
    """``conv_proj`` (1x1, the block's stride) and ``norm_proj`` where the
    residual's shape differs from the block's output: flax's
    ``residual.shape != y.shape`` (every stride-2 block doubles the
    channels, so the stride or the width decides)."""
    block.has_proj = strides != 1 or in_channels != out_channels
    if block.has_proj:
        block.conv_proj = Conv(in_channels, out_channels, 1, strides,
                               bias=False, device=device)
        block.norm_proj = BatchNorm(out_channels, device=device)


def _residual(block: nn.Module, x):
    return block.norm_proj(block.conv_proj(x)) if block.has_proj else x


class ResNet(nn.Module):
    """Configurable ResNet v1.5 (the JAX package's ``ResNet``).

    Args:
        stage_sizes: blocks per stage, e.g. (3, 4, 6, 3) for ResNet-50.
        block: :class:`BasicBlock` or :class:`BottleneckBlock`.
        num_classes: classifier width.
        num_filters: stem width (64 for the standard family).
        cifar_stem: 3x3/1 stem without the max pool (for 32x32 inputs).
        device: where the parameters are created.

    RGB input; the parameters start from flax's defaults
    (:func:`init_flax_defaults`, seed 0).
    """

    def __init__(self, stage_sizes: Sequence[int], block=BasicBlock,
                 num_classes: int = 1000, num_filters: int = 64,
                 cifar_stem: bool = False, device=None):
        super().__init__()
        self.cifar_stem = cifar_stem
        if cifar_stem:
            self.conv_init = Conv(3, num_filters, 3, bias=False,
                                  device=device)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, bias=False,
                                  device=device)
        self.norm_init = BatchNorm(num_filters, device=device)
        names, width = [], num_filters
        for stage, n_blocks in enumerate(stage_sizes):
            for b in range(n_blocks):
                strides = 2 if stage > 0 and b == 0 else 1
                filters = num_filters * 2**stage
                name = f"{block.__name__}_{len(names)}"
                self.add_module(name, block(width, filters, strides,
                                            device=device))
                names.append(name)
                width = filters * block.expansion
        self.block_names = tuple(names)
        self.Dense_0 = nn.Linear(width, num_classes, device=device)
        init_flax_defaults(self, 0)

    def forward(self, x):
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.norm_init(self.conv_init(x)))
        if not self.cifar_stem:
            x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean((2, 3)))


@torch.no_grad()
def init_flax_defaults(model: nn.Module, seed: int) -> None:
    """flax's default initialisation, drawn by a generator seeded with
    ``seed`` on the parameters' device: ``lecun_normal`` conv and dense
    kernels, zero biases, BatchNorm scale at its ``scale_init`` and shift
    0, running mean 0 and variance 1, LayerNorm scale 1 and shift 0. Other
    parameters stay."""
    dev = next(model.parameters()).device
    if dev.type == "meta":  # shapes only: nothing to draw
        return
    gen = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Conv, nn.Linear)):
            lecun_normal_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(m.scale_init)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3), block=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3), block=BottleneckBlock)
