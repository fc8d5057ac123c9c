"""The serving engine on one card: a Llama-class decoder with INT8 or INT4
weights (W8A8 prefill, MoE FFNs) and an INT8 KV cache (dense, or paged with
a prefix cache), continuous batching, burst decode; the calibrated weight
quantizers (AWQ, SmoothQuant, GPTQ), HF checkpoint conversion and
speculative decoding."""

from .awq import awq_quantize_llama_params, smoothquant_llama_params
from .config import LlamaConfig
from .convert import (config_from_hf, load_hf_llama,
                      params_from_hf_state_dict)
from .engine import Request, SamplingParams, ServingEngine
from .gptq import gptq_quantize_llama_params
from .model import init_llama_params, quantize_llama_params
from .speculative import speculative_generate

__all__ = ['LlamaConfig', 'ServingEngine', 'Request', 'SamplingParams',
           'init_llama_params', 'quantize_llama_params',
           'awq_quantize_llama_params', 'gptq_quantize_llama_params',
           'smoothquant_llama_params', 'config_from_hf', 'load_hf_llama',
           'params_from_hf_state_dict', 'speculative_generate']
