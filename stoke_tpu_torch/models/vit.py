"""Vision Transformer (ViT) classifier of the port.

Counterpart of ``stoke_tpu/models/vit.py:22-78``: a patch convolution
(stride = patch size) on NCHW, a CLS token, learned positions, embedding
dropout, the post-LN blocks of :mod:`.bert` (``layers.<i>`` for flax's
``layer_<i>``), ``ln_final`` (eps ``1e-6``) and a linear head on the CLS
row. Attention is dense by default, as the JAX package runs it; any
``attention_fn`` the blocks take is accepted.

The flax module makes ``pos_embed`` at its first call from the image it
sees; a torch module makes it at construction, so the port takes
``image_size`` and refuses an image of another size. Dropout is the port's
:class:`~stoke_tpu_torch.models.bert.Dropout`, so ``Stoke`` hands it its
generator.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple, Union

import torch
from torch import nn

from stoke_tpu_torch.models.bert import (
    BERT_SIZES,
    Dropout,
    TransformerBlock,
    dense_attention,
    refuse_remat,
)
from stoke_tpu_torch.models.resnet import Conv, init_flax_defaults


class ViT(nn.Module):
    """ViT over the ``BERT_SIZES`` width table.

    Args:
        num_classes / size_name / patch_size / dropout_rate /
            attention_fn: as the JAX package's ``ViT``.
        remat: must be False (ROADMAP Queue 1 item 13).
        image_size: the input's side, or ``(H, W)``; each must be a
            multiple of ``patch_size``.
        device: where the parameters are created.

    RGB input; the parameters start from flax's defaults (seed 0): the
    blocks' and the head's as :func:`.resnet.init_flax_defaults` draws
    them, the CLS token and the positions from N(0, 0.02^2).
    """

    def __init__(self, num_classes: int = 1000, size_name: str = "tiny",
                 patch_size: int = 4, dropout_rate: float = 0.1,
                 attention_fn: Callable = dense_attention,
                 remat: bool = False,
                 image_size: Union[int, Tuple[int, int]] = 32,
                 device=None):
        super().__init__()
        if remat:
            refuse_remat("ViT")
        size = BERT_SIZES[size_name]
        H, W = ((image_size, image_size) if isinstance(image_size, int)
                else tuple(image_size))
        _check_divisible(H, W, patch_size)
        self.patch_size = patch_size
        self.image_size = (H, W)
        n_tokens = (H // patch_size) * (W // patch_size) + 1
        self.patch_embed = Conv(3, size.hidden, patch_size,
                                patch_size, device=device)
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, size.hidden, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, n_tokens, size.hidden, device=device))
        self.emb_dropout = Dropout(dropout_rate)
        self.layers = nn.ModuleList(
            TransformerBlock(size.hidden, size.heads, size.ff, dropout_rate,
                             attention_fn, device=device)
            for _ in range(size.num_layers)
        )
        self.ln_final = nn.LayerNorm(size.hidden, eps=1e-6, device=device)
        self.head = nn.Linear(size.hidden, num_classes, device=device)
        init_flax_defaults(self, 0)
        gen = torch.Generator(device=self.cls_token.device).manual_seed(1)
        with torch.no_grad():
            self.cls_token.normal_(0.0, 0.02, generator=gen)
            self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def forward(self, x):
        B, _, H, W = x.shape
        _check_divisible(H, W, self.patch_size)
        if (H, W) != self.image_size:
            raise ValueError(
                f"ViT: image {H}x{W}, but pos_embed was made for "
                f"{self.image_size[0]}x{self.image_size[1]} (image_size)"
            )
        h = self.patch_embed(x).flatten(2).transpose(1, 2)  # [B, n, hidden]
        h = torch.cat([self.cls_token.expand(B, -1, -1), h], dim=1)
        h = self.emb_dropout(h + self.pos_embed)
        for layer in self.layers:
            h = layer(h, None)
        h = self.ln_final(h)
        return self.head(h[:, 0])


def _check_divisible(H: int, W: int, patch_size: int) -> None:
    if H % patch_size or W % patch_size:
        raise ValueError(
            f"ViT: image {H}x{W} not divisible by patch_size={patch_size}"
        )


ViTTiny = partial(ViT, size_name="tiny")
ViTBase = partial(ViT, size_name="base", patch_size=16, image_size=224)
