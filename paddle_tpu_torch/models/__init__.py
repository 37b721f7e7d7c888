"""Models of the port (counterpart of ``paddle_tpu/models``: GPT and
the BERT/ERNIE encoders)."""
from .bert import (BertConfig, BertEmbeddings, BertForSequenceClassification,
                   BertModel, BertPooler, ErnieConfig,
                   ErnieForSequenceClassification, ErnieModel)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, GPTPretrainingCriterion

__all__ = ["BertConfig", "BertEmbeddings", "BertForSequenceClassification",
           "BertModel", "BertPooler", "ErnieConfig",
           "ErnieForSequenceClassification", "ErnieModel", "GPTConfig",
           "GPTForCausalLM", "GPTModel", "GPTPretrainingCriterion"]
