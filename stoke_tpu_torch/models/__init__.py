"""Models of the port."""

from stoke_tpu_torch.models.basic import BasicNN
from stoke_tpu_torch.models.bert import (
    BERT_SIZES,
    BertBase,
    BertEncoder,
    BertForSequenceClassification,
    BertSize,
    BertTiny,
    dense_attention,
)
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.models.resnet import (
    BatchNorm,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from stoke_tpu_torch.models.vit import ViT, ViTBase, ViTTiny

__all__ = [
    "BasicNN",
    "BatchNorm",
    "BERT_SIZES",
    "BertBase",
    "BertEncoder",
    "BertForSequenceClassification",
    "BertSize",
    "BertTiny",
    "dense_attention",
    "GPT",
    "causal_lm_loss",
    "ResNet",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet101",
    "ResNet152",
    "ViT",
    "ViTBase",
    "ViTTiny",
]
