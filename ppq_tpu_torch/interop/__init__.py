"""Carry a quantized graph's state across from the JAX package.

The two packages share one graph IR, so a graph quantized by `ppq_tpu` can
be read with `parameters_of` / `quantization_configs_of` (duck-typed: they
read attributes and import nothing of it) and loaded into the port's graph
of the same model with `load_parameters` / `load_quantization_configs`.
The port's simulated forward can then be held alone against TPUExecutor's.
"""

from .carry import (load_parameters, load_quantization_configs,
                    parameters_of, quantization_configs_of)

__all__ = ['load_parameters', 'load_quantization_configs', 'parameters_of',
           'quantization_configs_of']
