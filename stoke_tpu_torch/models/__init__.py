"""Models of the port."""

from stoke_tpu_torch.models.bert import BERT_SIZES, BertSize
from stoke_tpu_torch.models.gpt import GPT

__all__ = ["BERT_SIZES", "BertSize", "GPT"]
