"""Carry a quantized graph's state across from the JAX package.

The two packages share one graph IR, so a graph quantized by `ppq_tpu` can
be read with `parameters_of` / `quantization_configs_of` (duck-typed: they
read attributes and import nothing of it) and loaded into the port's graph
of the same model with `load_parameters` / `load_quantization_configs`.
The port's simulated forward can then be held alone against TPUExecutor's.
A serving parameter tree, KV cache or paged pool crosses as numpy arrays,
and a block allocator's state as it is (`llama.py`). The JAX package's
flax QAT variables cross into the port's QAT layers and back (`qat.py`).
`onnx_shim` stands in for the `onnx` package over the port's protobuf
schema, and `reference_parity` (run as a module) drives the reference PPQ
implementation beside the port on one ONNX file.
"""

from .carry import (block_caches_from_numpy, block_caches_to_numpy,
                    load_parameters, load_quantization_configs, parameters_of,
                    quantization_configs_of)
from .onnx_shim import install_onnx_shim
from .qat import qat_params_from_flax, qat_params_to_flax
from .llama import (block_allocator_from, kv_cache_from_numpy,
                    kv_cache_to_numpy, llama_params_from_numpy,
                    llama_params_to_numpy, paged_pools_from_numpy,
                    paged_pools_to_numpy)

__all__ = ['load_parameters', 'load_quantization_configs', 'parameters_of',
           'quantization_configs_of', 'block_caches_to_numpy',
           'block_caches_from_numpy', 'llama_params_from_numpy',
           'llama_params_to_numpy', 'kv_cache_from_numpy',
           'kv_cache_to_numpy', 'paged_pools_from_numpy',
           'paged_pools_to_numpy', 'block_allocator_from',
           'qat_params_from_flax', 'qat_params_to_flax',
           'install_onnx_shim']
