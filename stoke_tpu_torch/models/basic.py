"""BasicNN of the port: the small CIFAR-10 CNN of the reference quick-start.

Counterpart of ``stoke_tpu/models/basic.py:9-27``: conv(6, 5x5) -> pool ->
conv(16, 5x5) -> pool -> fc120 -> fc84 -> fc(num_classes), VALID convs and
2x2 max pools, on NCHW. The flax module flattens its NHWC feature map in
(h, w, c) order before ``Dense_0``; so does this one (a permute to NHWC,
then flatten), and ``Dense_0``'s kernel converts by a plain transpose.
Names mirror the flax tree (``Conv_0``, ``Dense_2``) for
:func:`stoke_tpu_torch.convert.cnn_state_dict_from_jax`.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from stoke_tpu_torch.models.resnet import Conv, init_flax_defaults


class BasicNN(nn.Module):
    """The reference quick-start CNN on 32x32 RGB images (CIFAR-10: the
    feature map ``Dense_0`` takes is 5 x 5 x 16); flax's default
    initialisation (seed 0)."""

    def __init__(self, num_classes: int = 10, device=None):
        super().__init__()
        self.Conv_0 = Conv(3, 6, 5, padding="VALID", device=device)
        self.Conv_1 = Conv(6, 16, 5, padding="VALID", device=device)
        self.Dense_0 = nn.Linear(5 * 5 * 16, 120, device=device)
        self.Dense_1 = nn.Linear(120, 84, device=device)
        self.Dense_2 = nn.Linear(84, num_classes, device=device)
        init_flax_defaults(self, 0)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c), as flax
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)
