"""Models of the port."""

from stoke_tpu_torch.models.bert import BERT_SIZES, BertSize
from stoke_tpu_torch.models.gpt import GPT, causal_lm_loss

__all__ = ["BERT_SIZES", "BertSize", "GPT", "causal_lm_loss"]
