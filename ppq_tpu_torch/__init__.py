"""ppq_tpu_torch — the PyTorch and CUDA port of ppq_tpu, for NVIDIA Hopper.

It carries the JAX package's graph IR, scheduler, quantizers, calibration,
simulated quantized forward, frontends and exporters over to PyTorch, with the fake-quant and
histogram work in CUDA kernels written for sm_90a (kernels/, csrc/). It
imports neither JAX nor ppq_tpu; ppq_tpu stays as the reference it is held
against. Entry points run on the card unless the caller passes
`device='cpu'`.
"""

__version__ = '0.1.0'

from .core import (DataType, QuantizationPolicy, QuantizationProperty,
                   QuantizationStates, QuantizationVisibility, RoundingPolicy,
                   TargetPlatform, TensorQuantizationConfig)
from .ir import BaseGraph, Operation, QuantableOperation, Variable
from .executor import TorchExecutor
from .api import (DEQUANTIZE_GRAPH, QuantizationSetting,
                  QuantizationSettingFactory, dispatch_graph, export,
                  export_ppq_graph, format_graph, load_graph,
                  load_native_graph, load_onnx_graph, manop, quantize,
                  quantize_graph, quantize_native_model, quantize_onnx_model)

__all__ = [
    '__version__',
    'DataType', 'QuantizationPolicy', 'QuantizationProperty',
    'QuantizationStates', 'QuantizationVisibility', 'RoundingPolicy',
    'TargetPlatform', 'TensorQuantizationConfig',
    'BaseGraph', 'Operation', 'QuantableOperation', 'Variable',
    'TorchExecutor', 'DEQUANTIZE_GRAPH', 'QuantizationSetting',
    'QuantizationSettingFactory', 'dispatch_graph', 'export',
    'export_ppq_graph', 'format_graph', 'load_graph', 'load_native_graph',
    'load_onnx_graph', 'manop', 'quantize', 'quantize_graph',
    'quantize_native_model', 'quantize_onnx_model',
]
