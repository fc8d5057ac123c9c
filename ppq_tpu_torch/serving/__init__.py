"""The serving engine's dense decode path: a Llama-class decoder with INT8
weights and an INT8 KV cache, continuous batching, burst decode."""

from .config import LlamaConfig
from .engine import Request, SamplingParams, ServingEngine
from .model import init_llama_params, quantize_llama_params

__all__ = ['LlamaConfig', 'ServingEngine', 'Request', 'SamplingParams',
           'init_llama_params', 'quantize_llama_params']
