"""Model families of the port: GPT (serving) and BERT (pretraining)."""
from .gpt import (  # noqa: F401
    GPTConfig, GPTModel, GPTForCausalLM, gpt_small, gpt_medium,
)
from .bert import (  # noqa: F401
    BertConfig, BertModel, BertForPretraining, bert_base, bert_large,
)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_small",
           "gpt_medium", "BertConfig", "BertModel", "BertForPretraining",
           "bert_base", "bert_large"]
