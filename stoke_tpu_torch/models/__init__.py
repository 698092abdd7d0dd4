"""Models of the port."""

from stoke_tpu_torch.models.basic import BasicNN
from stoke_tpu_torch.models.bert import (
    BERT_SIZES,
    BertBase,
    BertEncoder,
    BertForSequenceClassification,
    BertSize,
    BertTiny,
    bert_tensor_parallel_rules,
    dense_attention,
)
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss
from stoke_tpu_torch.models.moe import (
    MoEFFN,
    MoETransformerBlock,
    moe_expert_parallel_rules,
)
from stoke_tpu_torch.models.pipelined_lm import (
    PipelinedLM,
    pipeline_parallel_rules,
)
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

# BERT, GPT and ViT share TransformerBlock's parameter paths
# (attention/{qkv,out}, ff_{in,out}), so the Megatron rules apply to each
# (the JAX package's aliases)
gpt_tensor_parallel_rules = bert_tensor_parallel_rules
vit_tensor_parallel_rules = bert_tensor_parallel_rules

__all__ = [
    "BasicNN",
    "BatchNorm",
    "BERT_SIZES",
    "BertBase",
    "BertEncoder",
    "BertForSequenceClassification",
    "BertSize",
    "BertTiny",
    "bert_tensor_parallel_rules",
    "gpt_tensor_parallel_rules",
    "vit_tensor_parallel_rules",
    "dense_attention",
    "GPT",
    "causal_lm_loss",
    "MoEFFN",
    "MoETransformerBlock",
    "moe_expert_parallel_rules",
    "PipelinedLM",
    "pipeline_parallel_rules",
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
