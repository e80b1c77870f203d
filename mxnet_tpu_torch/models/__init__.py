"""Model families of the port: GPT (serving, training), BERT
(pretraining) and the Transformer encoder-decoder (translation)."""
from .gpt import (  # noqa: F401
    GPTConfig, GPTModel, GPTForCausalLM, gpt_small, gpt_medium,
)
from .bert import (  # noqa: F401
    BertConfig, BertModel, BertForPretraining, bert_base, bert_large,
)
from .transformer import (  # noqa: F401
    TransformerConfig, TransformerEncoder, TransformerDecoder,
    TransformerNMT, transformer_base,
)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_small",
           "gpt_medium", "BertConfig", "BertModel", "BertForPretraining",
           "bert_base", "bert_large", "TransformerConfig",
           "TransformerEncoder", "TransformerDecoder", "TransformerNMT",
           "transformer_base"]
