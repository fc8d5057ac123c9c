"""The serving engine on one card: a Llama-class decoder with INT8 or INT4
weights and an INT8 KV cache (dense, or paged with a prefix cache),
continuous batching, burst decode."""

from .config import LlamaConfig
from .engine import Request, SamplingParams, ServingEngine
from .model import init_llama_params, quantize_llama_params

__all__ = ['LlamaConfig', 'ServingEngine', 'Request', 'SamplingParams',
           'init_llama_params', 'quantize_llama_params']
