"""Model families of the port (GPT so far)."""
from .gpt import (  # noqa: F401
    GPTConfig, GPTModel, GPTForCausalLM, gpt_small, gpt_medium,
)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_small",
           "gpt_medium"]
