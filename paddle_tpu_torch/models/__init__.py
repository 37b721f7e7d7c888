"""Models of the port (counterpart of ``paddle_tpu/models``)."""
from .gpt import GPTConfig, GPTForCausalLM, GPTModel

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel"]
